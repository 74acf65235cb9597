// K2: the fused uint8 -> two-view augmentation, on Hopper (sm_90a).
//
// Replaces byol_tpu/ops/fused_augment.py `_two_view_kernel` (:179): per
// image n and view v, from the raw image and the view's pre-drawn operands
// (ops/fused_augment.py builds them; no randomness in here):
//   x = img[n] as fp32, divided by 255 for uint8 input;
//   crop[a,b,c] = clip(sum_i sum_j wy[n,v,i,a] x[i,j,c] wx[n,v,j,b], 0, 1)
//     (the flip is folded into wx's column order, so nothing flips here);
//   if prm[JITTER] > 0.5, each stage clipped to [0, 1]: brightness * fb;
//     contrast toward the mean over the whole view of
//     gray = 0.2989 r + 0.587 g + 0.114 b; saturation toward gray; the
//     YIQ hue rotation by theta when `hue`;
//   if prm[GRAY] > 0.5, all three channels become gray.
// The gaussian blur and the final clip stay outside (a cuDNN conv).
//
// Design.  A view's rows are split over kParts blocks: 2B x kParts blocks
// (512 at batch 64, about four per SM, so their load latencies overlap).
//   Pass 1 (two_view_crop_kernel) walks bands of kRows output rows of its
//   part.
//   (A) The height contraction of the band, sum_i wy[i, a] x[i, j, c],
//   goes into a shared tile of kRows x W x 3 fp32 (21.5 KB at 224 px):
//   each thread owns up to three (j, c) columns and the band's rows, the
//   band's wy rows are staged in shared memory and read as broadcast
//   float4s.  uint8 pixels go through a 256-entry table of v / 255 (an
//   IEEE division, as the reference divides).  (B) The width contraction,
//   sum_j tile[a, j, c] wx[j, b]: each thread owns an output column b, its
//   wx column streams from L1/L2, the tile is read as broadcast float4s.
//   Then the clip, brightness and its clip when the jitter gate is on, the
//   store, and a per-thread float64 sum of gray; a fixed-order tree over
//   the block writes the part's sum to its own slot (no atomics).
//   Pass 2 (two_view_color_kernel, same grid) sums the view's kParts slots
//   in a fixed order into the mean gray, so results repeat bit for bit, and
//   re-reads its rows in place for contrast, saturation, hue and
//   grayscale.  The contrast mean needs the whole view before any pixel
//   can finish: hence two passes, and two launches.
//   Arithmetic is fp32 on the CUDA cores (no TF32, no tensor cores): the
//   reference pins the crop at HIGHEST precision.
//
// Bound on an H100 SXM at the ResNet-50 training shape (batch 64, 224 px
// raw and view): the two dense contractions are 2 views x 2 x 224^3 x 3 x
// 2 FLOP per image, 17.3 GFLOP, 0.258 ms at 67 TFLOP/s fp32; the bytes
// (9.6 MB of uint8, 51.4 MB of weights, 77.1 MB of views) take 0.041 ms at
// 3.35 TB/s.  So it is bound by operations, and the design spends them on
// FMAs with one shared-memory load per four: float4 broadcasts of the wy
// rows (pass A) and of the tile (pass B).  Most of those FMAs multiply
// zero weights (an upsampling crop has at most 2 taps per column); walking
// only the non-zero band of each column is a later lever, not this kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;              // output rows per band
constexpr int kCols = 3;              // pass-A columns per thread per sweep
constexpr int kParts = 4;             // blocks per view
constexpr int kJitter = 0, kFb = 1, kFc = 2, kFs = 3, kTheta = 4, kGray = 5;
constexpr int kNParam = 6;

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float gray_of(float r, float g, float b) {
  return 0.2989f * r + 0.587f * g + 0.114f * b;
}

template <bool kU8>
__device__ __forceinline__ float load_px(const void* img, size_t idx,
                                         const float* lut) {
  if constexpr (kU8) {
    return lut[__ldg(static_cast<const uint8_t*>(img) + idx)];
  } else {
    return __ldg(static_cast<const float*>(img) + idx);
  }
}

// rows [lo, hi) of part `part` of a view of S rows
__device__ __forceinline__ void part_rows(int S, int part, int& lo, int& hi) {
  const int per = (S + kParts - 1) / kParts;
  lo = min(S, part * per);
  hi = min(S, lo + per);
}

template <bool kU8>
__global__ void __launch_bounds__(kThreads)
two_view_crop_kernel(const void* __restrict__ img,
                     const float* __restrict__ wy,
                     const float* __restrict__ wx,
                     const float* __restrict__ prm, float* o1, float* o2,
                     double* __restrict__ part_sum, int H, int W, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);       // kThreads
  float* lut = reinterpret_cast<float*>(red + kThreads);    // 256
  float* wys = lut + 256;                                   // H x kRows
  float* tile = wys + static_cast<size_t>(H) * kRows;       // W*3 x kRows

  const int nv = blockIdx.x / kParts;   // image * 2 + view
  const int n = nv >> 1;
  const int tid = threadIdx.x;
  const int ncols = W * 3;
  int lo, hi;
  part_rows(S, blockIdx.x % kParts, lo, hi);
  const float* wy_n = wy + static_cast<size_t>(nv) * H * S;
  const float* wx_n = wx + static_cast<size_t>(nv) * W * S;
  const float* p = prm + static_cast<size_t>(nv) * kNParam;
  float* out = ((nv & 1) == 0 ? o1 : o2) + static_cast<size_t>(n) * S * S * 3;
  const size_t img_off = static_cast<size_t>(n) * H * ncols;
  const void* img_n =
      kU8 ? static_cast<const void*>(static_cast<const uint8_t*>(img) +
                                     img_off)
          : static_cast<const void*>(static_cast<const float*>(img) +
                                     img_off);
  const bool jitter = p[kJitter] > 0.5f;
  const float fb = p[kFb];

  if (kU8) {
    for (int i = tid; i < 256; i += kThreads)
      lut[i] = __fdiv_rn(static_cast<float>(i), 255.0f);
  }

  double gsum = 0.0;                    // this thread's sum of gray
  for (int a0 = lo; a0 < hi; a0 += kRows) {
    for (int e = tid; e < H * kRows; e += kThreads) {
      const int i = e / kRows, r = e % kRows;
      wys[e] = (a0 + r < hi) ? wy_n[static_cast<size_t>(i) * S + a0 + r]
                             : 0.0f;
    }
    __syncthreads();

    // pass A: tile[col * kRows + r] = sum_i wys[i][r] * x[i][col]
    for (int c0 = 0; c0 < ncols; c0 += kCols * kThreads) {
      float acc[kCols][kRows];
      int col[kCols];
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        col[k] = c0 + k * kThreads + tid;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[k][r] = 0.0f;
      }
#pragma unroll 2
      for (int i = 0; i < H; ++i) {
        const float4 w0 = *reinterpret_cast<const float4*>(wys + i * kRows);
        const float4 w1 =
            *reinterpret_cast<const float4*>(wys + i * kRows + 4);
        const float w[kRows] = {w0.x, w0.y, w0.z, w0.w,
                                w1.x, w1.y, w1.z, w1.w};
        const size_t row = static_cast<size_t>(i) * ncols;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const float xv =
              col[k] < ncols ? load_px<kU8>(img_n, row + col[k], lut) : 0.0f;
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[k][r] = fmaf(w[r], xv, acc[k][r]);
        }
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (col[k] < ncols) {
          float4* dst = reinterpret_cast<float4*>(tile + col[k] * kRows);
          dst[0] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
          dst[1] = make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
        }
      }
    }
    __syncthreads();

    // pass B: crop[a0 + r][b][c] = sum_j tile[j*3 + c][r] * wx[j][b]
    for (int b = tid; b < S; b += kThreads) {
      float acc[kRows][3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.0f;
#pragma unroll 2
      for (int j = 0; j < W; ++j) {
        const float wv = __ldg(wx_n + static_cast<size_t>(j) * S + b);
        const float4* t4 =
            reinterpret_cast<const float4*>(tile + j * 3 * kRows);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float4 t0 = t4[2 * c], t1 = t4[2 * c + 1];
          acc[0][c] = fmaf(t0.x, wv, acc[0][c]);
          acc[1][c] = fmaf(t0.y, wv, acc[1][c]);
          acc[2][c] = fmaf(t0.z, wv, acc[2][c]);
          acc[3][c] = fmaf(t0.w, wv, acc[3][c]);
          acc[4][c] = fmaf(t1.x, wv, acc[4][c]);
          acc[5][c] = fmaf(t1.y, wv, acc[5][c]);
          acc[6][c] = fmaf(t1.z, wv, acc[6][c]);
          acc[7][c] = fmaf(t1.w, wv, acc[7][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int a = a0 + r;
        if (a >= hi) break;
        float px[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float val = clip01(acc[r][c]);
          if (jitter) val = clip01(val * fb);
          px[c] = val;
        }
        float* dst = out + (static_cast<size_t>(a) * S + b) * 3;
        dst[0] = px[0];
        dst[1] = px[1];
        dst[2] = px[2];
        if (jitter) gsum += static_cast<double>(gray_of(px[0], px[1], px[2]));
      }
    }
    __syncthreads();
  }

  red[tid] = gsum;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) part_sum[blockIdx.x] = red[0];
}

__global__ void __launch_bounds__(kThreads)
two_view_color_kernel(const float* __restrict__ prm,
                      const double* __restrict__ part_sum, float* o1,
                      float* o2, int S, int hue) {
  const int nv = blockIdx.x / kParts;
  const float* p = prm + static_cast<size_t>(nv) * kNParam;
  const bool jitter = p[kJitter] > 0.5f;
  const bool to_gray = p[kGray] > 0.5f;
  if (!jitter && !to_gray) return;      // uniform over the block
  int lo, hi;
  part_rows(S, blockIdx.x % kParts, lo, hi);
  float* out = ((nv & 1) == 0 ? o1 : o2) +
               static_cast<size_t>(nv >> 1) * S * S * 3;
  double total = 0.0;
  for (int k = 0; k < kParts; ++k) total += part_sum[nv * kParts + k];
  const float mean = static_cast<float>(total / (static_cast<double>(S) * S));
  const float fc = p[kFc], fs = p[kFs];
  float cs = 1.0f, sn = 0.0f;
  if (hue) {
    cs = cosf(p[kTheta]);
    sn = sinf(p[kTheta]);
  }
  for (int e = lo * S + threadIdx.x; e < hi * S; e += kThreads) {
    float* px = out + static_cast<size_t>(e) * 3;
    float r = px[0], g = px[1], b = px[2];
    if (jitter) {
      const float cm = (1.0f - fc) * mean;
      r = clip01(fc * r + cm);
      g = clip01(fc * g + cm);
      b = clip01(fc * b + cm);
      const float sg = (1.0f - fs) * gray_of(r, g, b);
      r = clip01(fs * r + sg);
      g = clip01(fs * g + sg);
      b = clip01(fs * b + sg);
      if (hue) {
        const float y = 0.299f * r + 0.587f * g + 0.114f * b;
        float i = 0.596f * r - 0.274f * g - 0.322f * b;
        float q = 0.211f * r - 0.523f * g + 0.312f * b;
        const float i2 = cs * i + sn * q;
        q = -sn * i + cs * q;
        i = i2;
        r = clip01(y + 0.956f * i + 0.621f * q);
        g = clip01(y - 0.272f * i - 0.647f * q);
        b = clip01(y - 1.106f * i + 1.703f * q);
      }
    }
    if (to_gray) r = g = b = gray_of(r, g, b);
    px[0] = r;
    px[1] = g;
    px[2] = b;
  }
}

}  // namespace

// K2.  img: (B, H, W, 3) uint8 (uint8_in != 0) or fp32 in [0, 1]; wy: (B,
// 2, H, S), wx: (B, 2, W, S), prm: (B, 2, 6) fp32; o1, o2: (B, S, S, 3)
// fp32, written whole; part_sum: (B, 2, 4) float64 scratch.  All
// contiguous.
extern "C" int byol_two_view(const void* img, int uint8_in, const float* wy,
                             const float* wx, const float* prm, float* o1,
                             float* o2, double* part_sum, int batch, int H,
                             int W, int S, int hue, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(double) * kThreads +
      sizeof(float) * (256 + static_cast<size_t>(H) * kRows +
                       static_cast<size_t>(W) * 3 * kRows);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  void (*kern)(const void*, const float*, const float*, const float*, float*,
               float*, double*, int, int, int) =
      uint8_in ? two_view_crop_kernel<true> : two_view_crop_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = batch * 2 * kParts;
  kern<<<blocks, kThreads, smem, s>>>(img, wy, wx, prm, o1, o2, part_sum, H,
                                      W, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  two_view_color_kernel<<<blocks, kThreads, 0, s>>>(prm, part_sum, o1, o2,
                                                    S, hue);
  return static_cast<int>(cudaGetLastError());
}
