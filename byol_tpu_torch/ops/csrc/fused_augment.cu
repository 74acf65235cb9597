// K2: the fused uint8 -> two-view augmentation, on Hopper (sm_90a).
//
// Replaces byol_tpu/ops/fused_augment.py `_two_view_kernel` (:179): per
// image n and view v, from the raw image and the view's pre-drawn scalars
// (no randomness in here):
//   x = img[n] as fp32, divided by 255 for uint8 input;
//   crop[a,b,c] = clip(sum_i sum_j wy[i,a] x[i,j,c] wx[j,b], 0, 1), wy and
//     wx the antialiased triangle weights of the view's crop window (y0,
//     x0, ch, cw), the flip a reversal of wx's columns;
//   if prm[JITTER] > 0.5, each stage clipped to [0, 1]: brightness * fb;
//     contrast toward the mean over the whole view of
//     gray = 0.2989 r + 0.587 g + 0.114 b; saturation toward gray; the
//     YIQ hue rotation by theta when `hue`;
//   if prm[GRAY] > 0.5, all three channels become gray.
// The gaussian blur and the final clip stay outside (a cuDNN conv).
//
// Bound on an H100 SXM at the ResNet-50 training shape (batch 64, 224 px
// raw and view, both views): the bytes are 9.6 MB of uint8 in and 77.1 MB
// of fp32 views out, 0.026 ms at 3.35 TB/s.  The work is a band walk: a
// crop that upsamples has at most 2 non-zero taps per output row and
// column (about 0.15 GFLOP for the batch, 2 us at 67 TFLOP/s fp32), so the
// call is bound by bytes.  The dense contraction of the first design
// (17.3 GFLOP) multiplied zeros 99 % of the time.
//
// Design.
// - Weights are built in the kernel, from the crop scalars, with the
//   arithmetic of ops/fused_augment.py::crop_bands (IEEE divisions and
//   products, no contraction into FMAs, the column total summed in tap
//   order), renormalised and masked as jax.image's compute_weight_mat
//   does.  No weight tensor exists in device memory.  When no side of the
//   image is larger than the view (every crop upsamples, kernel scale 1:
//   the 224 -> 224 training shape), the only taps that can be non-zero are
//   floor(sf) and floor(sf) + 1, and only those two are computed; the
//   others are 0 and add nothing to the total.  Otherwise a window of T
//   source indices (T = floor(2 * kernel_scale) + 3, from the shapes)
//   holds every non-zero tap and is trimmed to its non-zero run.
// - A view's rows are split over kParts blocks (1024 blocks at batch 64);
//   a block's threads take one output column each and walk the block's
//   rows down it.  A column's taps stay in registers; a row's taps are
//   built once per block in shared memory.  Two-tap path: the source rows
//   the block's rows read (at most R + 3 for R upsampled rows) are first
//   copied whole into shared memory, 16 bytes a thread, all in flight at
//   once; then a thread keeps the two source rows of its column pair in
//   registers and reads only the source row that a new output row brings,
//   so each uint8 pixel is converted about once per output row that reads
//   it, instead of four times.
// - Two launches, because the contrast mean needs the whole view before
//   any pixel can finish.  Pass 1 (kFinal = false) computes the crop and
//   brightness of the views whose jitter gate is on and writes nothing but
//   a float64 sum of gray per block (each thread in row order, then a
//   fixed-order tree; no atomics).  Pass 2 sums a view's kParts sums in a
//   fixed order into the mean, so results repeat bit for bit, recomputes
//   the crop from the image (in L2: 9.6 MB) and writes each view once.
//   Recomputing costs a second band walk; writing the view in pass 1 and
//   re-reading it would move 154 MB more.
// - Arithmetic is fp32 on the CUDA cores (the reference pins the crop at
//   HIGHEST precision).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;      // one output column a thread
constexpr int kParts = 8;             // blocks per view
constexpr int kMaxTaps = 16;          // band window; the wrapper checks
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kJitter = 0, kFb = 1, kFc = 2, kFs = 3, kTheta = 4, kGray = 5;
constexpr int kNParam = 6;
constexpr int kY0 = 0, kX0 = 1, kCh = 2, kCw = 3, kFlip = 4;
constexpr int kNCrop = 5;
// jax.image's degenerate-weight threshold, 1000 * 2^-23, exactly
constexpr float kWeightEps = 1.1920928955078125e-4f;

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float gray_of(float r, float g, float b) {
  return 0.2989f * r + 0.587f * g + 0.114f * b;
}

// v / 255 for a byte v, correctly rounded (as the reference's IEEE
// division): v * fl(1/255), then one FMA correction of the remainder;
// checked against the division for all 256 bytes.
__device__ __forceinline__ float unit_of_byte(uint8_t v) {
  const float x = static_cast<float>(v);
  const float r = 0.003921568859368563f;       // fl(1 / 255)
  const float q = __fmul_rn(x, r);
  return fmaf(fmaf(-q, 255.0f, x), r, q);
}

template <bool kU8, typename Px>
__device__ __forceinline__ float unit(Px v) {
  if constexpr (kU8) {
    return unit_of_byte(v);
  } else {
    return v;
  }
}

// Shared memory of a block of R output rows: the gray tree's kMaxThreads
// doubles, R row bands (row_w R x py, row_start, row_n), then either the
// column bands (S x px weights, col_start, col_n) or, on the two-tap path,
// the staged source rows from stage_offset on: stage_rows(R) rows (a part
// of R upsampled rows reads at most R + 3 source rows).
__host__ __device__ inline size_t band_bytes(int R, int py) {
  return sizeof(double) * kMaxThreads + sizeof(float) * R * py +
         sizeof(int) * 2 * R;
}
__host__ __device__ inline size_t stage_offset(int R) {
  return (band_bytes(R, 2) + 15) / 16 * 16;
}
__host__ __device__ inline int stage_rows(int R) { return R + 4; }

template <bool kU8>
__device__ __forceinline__ float load_px(const void* img, size_t idx) {
  if constexpr (kU8) {
    return unit_of_byte(__ldg(static_cast<const uint8_t*>(img) + idx));
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

// One dimension's resampling geometry: scale = out_size / extent,
// translation = -start * scale, as crop_bands takes them.
struct Axis {
  float inv, ks, translation;
  __device__ Axis(float out_size, float start, float extent) {
    const float scale = __fdiv_rn(out_size, extent);
    translation = __fmul_rn(-start, scale);
    inv = __fdiv_rn(1.0f, scale);
    ks = fmaxf(inv, 1.0f);
  }
  __device__ float sample(int a) const {
    return __fsub_rn(
        __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(a), 0.5f), inv),
                  __fmul_rn(translation, inv)),
        0.5f);
  }
};

// triangle weight of source index i for sample position sf
__device__ __forceinline__ float tap(float sf, int i, float ks) {
  const float x = __fdiv_rn(fabsf(__fsub_rn(sf, static_cast<float>(i))), ks);
  return fmaxf(__fsub_rn(1.0f, fabsf(x)), 0.0f);
}

__device__ __forceinline__ bool inside(float sf, int in_size) {
  return sf >= -0.5f && sf <= __fsub_rn(static_cast<float>(in_size), 0.5f);
}

// Two-tap band of output index `a` (kernel scale 1: every non-zero weight
// is at i0 = floor(sf) or i0 + 1), as a window of 2 inside [0, in_size):
// *start and w[0..2).  The same values as crop_bands' window of T taps.
__device__ __forceinline__ void band2(int a, int in_size, const Axis& ax,
                                      int* start, float (&w)[2]) {
  const float sf = ax.sample(a);
  const int i0 = static_cast<int>(floorf(sf));
  float t[2];
  float total = 0.0f;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = i0 + u;
    t[u] = (i >= 0 && i < in_size) ? tap(sf, i, ax.ks) : 0.0f;
    total = __fadd_rn(total, t[u]);
  }
  const bool keep = inside(sf, in_size) && fabsf(total) > kWeightEps;
  const float denom = total != 0.0f ? total : 1.0f;
#pragma unroll
  for (int u = 0; u < 2; ++u) t[u] = keep ? __fdiv_rn(t[u], denom) : 0.0f;
  const int s = min(max(t[0] != 0.0f ? i0 : i0 + 1, 0), in_size - 2);
#pragma unroll
  for (int u = 0; u < 2; ++u)
    w[u] = s + u == i0 ? t[0] : (s + u == i0 + 1 ? t[1] : 0.0f);
  *start = s;
}

// Band of output index `a` in a window of T taps from `first`, trimmed to
// its non-zero run: *start, *n and w[0..n), zeros after it up to `pitch`.
__device__ void band(int a, int in_size, int T, const Axis& ax, int* start,
                     int* n, float* w, int pitch) {
  const float sf = ax.sample(a);
  const int first = min(
      max(static_cast<int>(floorf(__fsub_rn(sf, ax.ks))), 0), in_size - T);
  float tw[kMaxTaps];
  float total = 0.0f;
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    if (t < T) {
      tw[t] = tap(sf, first + t, ax.ks);
      total = __fadd_rn(total, tw[t]);
    }
  }
  const bool keep = inside(sf, in_size) && fabsf(total) > kWeightEps;
  const float denom = total != 0.0f ? total : 1.0f;
  int lo = T, hi = -1;
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    if (t < T) {
      tw[t] = keep ? __fdiv_rn(tw[t], denom) : 0.0f;
      if (tw[t] != 0.0f) {
        lo = min(lo, t);
        hi = t;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t)
    if (t < pitch) w[t] = t + lo <= hi ? tw[t + lo] : 0.0f;
  *start = first + min(lo, T - 1);
  *n = max(hi - lo + 1, 0);
}

// The colour stages of one pixel after the crop's clip (see the header).
struct Jitter {
  bool on, to_gray;
  float fb, fc, fs, cs, sn, mean;
  bool hue;
  __device__ __forceinline__ void apply(float& r, float& g, float& b) const {
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
};

// The end of one output pixel: clip, brightness; pass 1 adds its gray to
// *gsum, pass 2 finishes the jitter and the grayscale and stores it.
template <bool kFinal>
__device__ __forceinline__ void finish_px(float (&px)[3], const Jitter& j,
                                          double* gsum, float* dst) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    px[c] = clip01(px[c]);
    if (j.on) px[c] = clip01(px[c] * j.fb);
  }
  if (!kFinal) {
    *gsum += static_cast<double>(gray_of(px[0], px[1], px[2]));
    return;
  }
  float r = px[0], g = px[1], b = px[2];
  if (j.on) j.apply(r, g, b);
  if (j.to_gray) r = g = b = gray_of(r, g, b);
  dst[0] = r;
  dst[1] = g;
  dst[2] = b;
}

// One pass over the rows [lo, hi) of one part of one view (see the
// header): pass 1 (kFinal = false) sums gray, pass 2 writes.  kTwo: every
// band has at most 2 taps (no side of the image larger than the view).
template <bool kU8, bool kTwo, bool kFinal>
__global__ void __launch_bounds__(kMaxThreads)
two_view_kernel(const void* __restrict__ img, const float* __restrict__ crop,
                const float* __restrict__ prm, float* o1, float* o2,
                double* __restrict__ part_sum, int H, int W, int S, int Ty,
                int Tx, int hue) {
  const int nv = blockIdx.x / kParts;   // image * 2 + view
  const int n = nv >> 1;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const float* p = prm + static_cast<size_t>(nv) * kNParam;
  Jitter j;
  j.on = p[kJitter] > 0.5f;
  if (!kFinal && !j.on) return;         // no contrast, no mean to take
  const float* cr = crop + static_cast<size_t>(nv) * kNCrop;
  int lo, hi;
  part_rows(S, blockIdx.x % kParts, lo, hi);
  const int R = (S + kParts - 1) / kParts;
  const int py = kTwo ? 2 : Ty, pitch_x = kTwo ? 2 : Tx;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);         // kMaxThreads
  float* row_w = reinterpret_cast<float*>(red + kMaxThreads); // R x py
  int* row_start = reinterpret_cast<int*>(row_w + static_cast<size_t>(R) * py);
  int* row_n = row_start + R;
  float* col_w = reinterpret_cast<float*>(row_n + R);        // !kTwo: S x Tx
  int* col_start = reinterpret_cast<int*>(col_w + static_cast<size_t>(S) * pitch_x);
  int* col_n = col_start + S;

  const Axis ay(static_cast<float>(S), cr[kY0], cr[kCh]);
  const Axis ax(static_cast<float>(S), cr[kX0], cr[kCw]);
  const bool flip = cr[kFlip] > 0.5f;
  for (int r = tid; r < hi - lo; r += nthreads) {
    if (kTwo) {
      float w[2];
      band2(lo + r, H, ay, row_start + r, w);
      row_w[2 * r] = w[0];
      row_w[2 * r + 1] = w[1];
    } else {
      band(lo + r, H, Ty, ay, row_start + r, row_n + r, row_w + r * py, py);
    }
  }
  if (!kTwo)
    for (int b = tid; b < S; b += nthreads)
      band(flip ? S - 1 - b : b, W, Tx, ax, col_start + b, col_n + b,
           col_w + b * pitch_x, pitch_x);
  __syncthreads();

  const size_t img_off = static_cast<size_t>(n) * H * W * 3;
  const void* img_n =
      kU8 ? static_cast<const void*>(static_cast<const uint8_t*>(img) +
                                     img_off)
          : static_cast<const void*>(static_cast<const float*>(img) +
                                     img_off);
  j.fb = p[kFb];
  j.mean = 0.0f;
  j.fc = j.fs = j.cs = 1.0f;
  j.sn = 0.0f;
  j.hue = hue != 0;
  j.to_gray = false;
  float* out = nullptr;
  if (kFinal) {
    j.to_gray = p[kGray] > 0.5f;
    out = ((nv & 1) == 0 ? o1 : o2) + static_cast<size_t>(n) * S * S * 3;
    if (j.on) {
      double total = 0.0;
      for (int k = 0; k < kParts; ++k) total += part_sum[nv * kParts + k];
      j.mean = static_cast<float>(total / (static_cast<double>(S) * S));
      j.fc = p[kFc];
      j.fs = p[kFs];
      if (j.hue) {
        j.cs = cosf(p[kTheta]);
        j.sn = sinf(p[kTheta]);
      }
    }
  }

  const size_t rs = static_cast<size_t>(W) * 3;   // source row stride
  using Px = typename std::conditional<kU8, uint8_t, float>::type;
  // two-tap path: the source rows the part reads, copied whole into
  // shared memory in one burst (coalesced, all in flight at once), unless
  // more than stage_rows (never when upsampling): then read in place
  const Px* src = static_cast<const Px*>(img_n);
  if (kTwo) {
    int y_lo = H, y_hi = -1;
    for (int r = 0; r < hi - lo; ++r) {
      y_lo = min(y_lo, row_start[r]);
      y_hi = max(y_hi, row_start[r]);
    }
    const int nrows = y_hi + 2 - y_lo;
    if (nrows > 0 && nrows <= stage_rows(R)) {
      Px* stage = reinterpret_cast<Px*>(smem_raw + stage_offset(R));
      const Px* from = src + static_cast<size_t>(y_lo) * rs;
      const size_t count = static_cast<size_t>(nrows) * rs;
      if ((reinterpret_cast<uintptr_t>(from) | (count * sizeof(Px))) % 16 == 0) {
        const size_t n16 = count * sizeof(Px) / 16;
        for (size_t i = tid; i < n16; i += nthreads)
          reinterpret_cast<uint4*>(stage)[i] =
              __ldg(reinterpret_cast<const uint4*>(from) + i);
      } else {
        for (size_t i = tid; i < count; i += nthreads) stage[i] = __ldg(from + i);
      }
      src = stage - static_cast<size_t>(y_lo) * rs;   // indexed by source row
      __syncthreads();
    }
  }
  double gsum = 0.0;                    // pass 1: this thread's sum of gray
  for (int b = tid; b < S; b += nthreads) {
    float* dst = kFinal ? out + (static_cast<size_t>(lo) * S + b) * 3 : nullptr;
    if (kTwo) {
      int xs;
      float wx[2];
      band2(flip ? S - 1 - b : b, W, ax, &xs, wx);
      // source rows cy and cy + 1 at columns xs, xs + 1: [u * 3 + c]
      float top[6], bot[6];
      int cy = -2;
      const size_t col = static_cast<size_t>(xs) * 3;
      for (int r = 0; r < hi - lo; ++r, dst += kFinal ? S * 3 : 0) {
        const int ys = row_start[r];
        if (ys != cy) {                 // uniform across the block
          const size_t at = static_cast<size_t>(ys) * rs + col;
          if (ys == cy + 1) {
#pragma unroll
            for (int e = 0; e < 6; ++e) top[e] = bot[e];
          } else {
#pragma unroll
            for (int e = 0; e < 6; ++e) top[e] = unit<kU8>(src[at + e]);
          }
#pragma unroll
          for (int e = 0; e < 6; ++e) bot[e] = unit<kU8>(src[at + rs + e]);
          cy = ys;
        }
        const float wy0 = row_w[2 * r], wy1 = row_w[2 * r + 1];
        float px[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float h0 = fmaf(wy1, bot[c], fmaf(wy0, top[c], 0.0f));
          const float h1 = fmaf(wy1, bot[3 + c], fmaf(wy0, top[3 + c], 0.0f));
          px[c] = fmaf(h1, wx[1], fmaf(h0, wx[0], 0.0f));
        }
        finish_px<kFinal>(px, j, &gsum, dst);
      }
    } else {
      const int xs = col_start[b], xn = col_n[b];
      const float* wx = col_w + b * pitch_x;
      for (int r = 0; r < hi - lo; ++r, dst += kFinal ? S * 3 : 0) {
        const size_t base = static_cast<size_t>(row_start[r]) * rs +
                            static_cast<size_t>(xs) * 3;
        const int yn = row_n[r];
        const float* wy = row_w + r * py;
        float px[3] = {0.0f, 0.0f, 0.0f};
        for (int u = 0; u < xn; ++u) {
          float h[3] = {0.0f, 0.0f, 0.0f};
          for (int t = 0; t < yn; ++t) {
            const size_t at = base + t * rs + u * 3;
#pragma unroll
            for (int c = 0; c < 3; ++c)
              h[c] = fmaf(wy[t], load_px<kU8>(img_n, at + c), h[c]);
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) px[c] = fmaf(h[c], wx[u], px[c]);
        }
        finish_px<kFinal>(px, j, &gsum, dst);
      }
    }
  }

  if (!kFinal) {
    // a tree over kMaxThreads slots, those past nthreads zero (nthreads >=
    // kMaxThreads / 2, so every slot is written)
    red[tid] = gsum;
    if (tid + nthreads < kMaxThreads) red[tid + nthreads] = 0.0;
    __syncthreads();
    for (int w = kMaxThreads / 2; w > 0; w >>= 1) {
      if (tid < w) red[tid] += red[tid + w];
      __syncthreads();
    }
    if (tid == 0) part_sum[blockIdx.x] = red[0];
  }
}

// dynamic shared memory of a block (see band_bytes)
size_t smem_bytes(bool two, bool u8, int W, int S, int Ty, int Tx) {
  const int R = (S + kParts - 1) / kParts;
  if (two)
    return stage_offset(R) + static_cast<size_t>(stage_rows(R)) * W * 3 *
                                 (u8 ? sizeof(uint8_t) : sizeof(float));
  return band_bytes(R, Ty) + (sizeof(float) * Tx + 2 * sizeof(int)) * S;
}

template <bool kU8, bool kTwo>
cudaError_t launch(const void* img, const float* crop, const float* prm,
                   float* o1, float* o2, double* part_sum, int batch, int H,
                   int W, int S, int Ty, int Tx, int hue, cudaStream_t s) {
  const size_t smem = smem_bytes(kTwo, kU8, W, S, Ty, Tx);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // one column a thread: S rounded up to whole warps, at least half of
  // kMaxThreads (the gray tree's bound)
  const int threads = min(kMaxThreads, max(kMaxThreads / 2, (S + 31) / 32 * 32));
  void (*passes[2])(const void*, const float*, const float*, float*, float*,
                    double*, int, int, int, int, int, int) = {
      two_view_kernel<kU8, kTwo, false>, two_view_kernel<kU8, kTwo, true>};
  const int blocks = batch * 2 * kParts;
  for (auto kern : passes) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kern<<<blocks, threads, smem, s>>>(img, crop, prm, o1, o2, part_sum, H,
                                       W, S, Ty, Tx, hue);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// K2.  img: (B, H, W, 3) uint8 (uint8_in != 0) or fp32 in [0, 1]; crop:
// (B, 2, 5) fp32 (y0, x0, ch, cw, flip), windows inside the image; prm:
// (B, 2, 6) fp32; o1, o2: (B, S, S, 3) fp32, written whole; part_sum: (B,
// 2, parts) float64 scratch, where parts must be the kernel's kParts (the
// blocks of a view; ops/fused_augment.py::PARTS); Ty, Tx: the band windows
// of crop_bands (<= 16).  All contiguous.
extern "C" int byol_two_view(const void* img, int uint8_in, const float* crop,
                             const float* prm, float* o1, float* o2,
                             double* part_sum, int parts, int batch, int H,
                             int W, int S, int Ty, int Tx, int hue,
                             void* stream) {
  if (parts != kParts || batch <= 0 || H <= 0 || W <= 0 || S <= 0 || Ty < 1 || Tx < 1 ||
      Ty > kMaxTaps || Tx > kMaxTaps || Ty > H || Tx > W)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // no side of the image larger than the view: every crop upsamples, and
  // a band holds at most 2 taps (the source rows of a part staged)
  const bool two = H <= S && W <= S && H >= 2 && W >= 2 &&
                   smem_bytes(true, uint8_in != 0, W, S, Ty, Tx) <= kMaxSmem;
  const cudaError_t err =
      uint8_in
          ? (two ? launch<true, true>(img, crop, prm, o1, o2, part_sum, batch,
                                      H, W, S, Ty, Tx, hue, s)
                 : launch<true, false>(img, crop, prm, o1, o2, part_sum,
                                       batch, H, W, S, Ty, Tx, hue, s))
          : (two ? launch<false, true>(img, crop, prm, o1, o2, part_sum,
                                       batch, H, W, S, Ty, Tx, hue, s)
                 : launch<false, false>(img, crop, prm, o1, o2, part_sum,
                                        batch, H, W, S, Ty, Tx, hue, s));
  return static_cast<int>(err);
}
