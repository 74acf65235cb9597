// BatchNorm in train mode on channels-last bf16 activations, fused with the
// ReLU and the residual add that follow it in a ResNet, on Hopper (sm_90a).
//
// Replaces no TPU kernel.  byol_tpu/models/ has no BatchNorm kernel: on the
// TPU, XLA fuses the norm, the ReLU, the residual add and the bf16 casts
// into the convolutions' neighbouring fusions.  The port ran them as
// separate PyTorch ops over fp32 copies (cast, statistics, normalise, ReLU
// or add + ReLU, cast back, and the mirror of each in the backward); these
// kernels take their place on ResNet training's main path
// (ops/batch_norm.py says when).
//
// A channels-last (N, C, H, W) tensor is an (M = N*H*W, C) row-major
// matrix.  With kVec = 8, a thread holds 8 neighbouring channels: one
// 16-byte load of bf16 (two of fp32).  A block of 256 threads spans
// `lanes` channel vectors (the largest power of two dividing C / 8, at
// most 32: a warp reads whole 128-512-byte runs of a row, or whole rows)
// by 256 / lanes rows; blockIdx.y picks the block's channel group and
// blockIdx.x its chunk of rows.  A thread's channels stay fixed, so each
// kernel loads its per-channel coefficients into registers once.
//
// Forward (byol_bn_forward):
//   1. byol_bn_stats_kernel: per thread, Welford over its rows of the
//      chunk in fp32, four rows' loads in flight; the threads of a channel
//      vector merge in a fixed shared-memory tree (Chan's rule); one
//      (mean, M2) partial per chunk and channel.
//   2. byol_bn_stats_finalize_kernel: one block a channel vector; each
//      thread merges every 256th chunk's partial in order (Chan's rule),
//      then a fixed tree: mean, biased variance, rstd = 1 / sqrt(var +
//      eps); the running statistics moved in place by flax's rule (keep *
//      old + take * batch, the biased variance) when `update` is set.
//   3. byol_bn_apply_kernel: y = (x - mean) * (w * rstd) + bias, then
//      + residual (fp32) and/or ReLU; stored as bf16 (where every consumer
//      casts to bf16: the same value today's fp32 result rounds to) or as
//      fp32, and with a copy pointer once more as bf16 (the next block's
//      conv reads it in place of its own cast); with ReLU and a mask
//      pointer, one byte a thread-row holding the 8 channels' "output > 0"
//      bits (NaN passes, as torch's threshold_backward lets it).
// Backward (byol_bn_backward), g the output's gradient (bf16 or fp32):
//   1. byol_bn_grad_sums_kernel: gm = g (+ the copy's bf16 gradient,
//      added in fp32, as autograd adds a cast's) masked by the saved bits;
//      per channel partials of sum(gm) and sum(gm * (x - mean)); with a
//      residual, gm is also its gradient, written as fp32 here.
//   2. byol_bn_grad_finalize_kernel: the partials summed as the statistics'
//      are merged; dbias = S, dweight = rstd * D, and the apply's
//      coefficients a = w * rstd, gbar = S / M, proj = rstd^2 D / M.
//   3. byol_bn_grad_apply_kernel: dx = a * (gm - gbar - (x - mean) * proj),
//      stored as bf16 (the conv's output, and so its gradient, is bf16).
// No atomics anywhere: the same inputs give the same bits every run.
//
// Bound on an H100 SXM (3.35 TB/s): bytes; a few flops an element against
// the card's ~20 per byte.  Bytes an element the kernels move, bf16 input,
// mask 1/8:
//   forward  x read twice (4) + out (bf16 2 / fp32 4) + mask + residual (4)
//            + copy (2) = 6.1 (ReLU, bf16 out), 8.1 (ReLU, fp32 out), 14.1
//            (+ residual + copy), 8 (plain, fp32 out); without autograd, no
//            mask;
//   backward g twice (bf16 4 / fp32 8) + the copy's g twice (4) + x twice
//            (4) + mask twice + dx (2) + residual gradient (4) = 10.25 (bf16
//            g), 14.25 (fp32 g), 22.25 (+ residual + copy).
// At ResNet-50's stem for one view of 256 images (M = 3,211,264, C = 64:
// 205.5 M elements, ReLU, fp32 out) the forward moves 1.67 GB, 0.50 ms;
// today's chain moved ~30 bytes an element.  The design is about those
// bytes: one read for the statistics, one read and one write to apply,
// 16-byte accesses on neighbouring addresses, and enough chunks (about
// 2,100 blocks) for several waves at every ResNet-50 shape, from C = 64 at
// M = 3.2 M to C = 2048 at M = 12,544.  The partials (P x C x 2 floats,
// 1 MB at the stem) and the finalize launches are small beside the stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                            // channels a thread holds
constexpr int kUnroll = 4;                         // rows' loads in flight

struct Tile {
  int lanes;   // channel vectors a block spans
  int groups;  // blocks across the channels
  int rows;    // rows a block covers per step
};

__host__ __device__ inline Tile make_tile(int channels) {
  const int vecs = channels / kVec;
  int lanes = vecs & -vecs;
  if (lanes > 32) lanes = 32;
  return Tile{lanes, vecs / lanes, kThreads / lanes};
}

// A thread's place: its channel offset and first row, and its chunk's end.
struct Place {
  int c0;
  int sub;
  long long row;
  long long end;
};

__device__ __forceinline__ Place place(const Tile& t, long long rows,
                                       long long chunk) {
  const int lane = threadIdx.x % t.lanes;
  const int sub = threadIdx.x / t.lanes;
  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = begin + chunk < rows ? begin + chunk : rows;
  return Place{(static_cast<int>(blockIdx.y) * t.lanes + lane) * kVec, sub,
               begin + sub, end};
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 u;
  u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  u.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  u.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void load_channels(const float* src, int c0,
                                              float v[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = src[c0 + j];
}

// Chan's merge of a partial of nb rows (mb, m2b: 8 channels) into one of n
// rows; the count's weights are the same for all 8 channels.
__device__ __forceinline__ void chan_merge(float& n, float mean[kVec],
                                           float m2[kVec], float nb,
                                           const float mb[kVec],
                                           const float m2b[kVec]) {
  if (nb == 0.f) return;
  const float wb = nb / (n + nb);
  const float cross = n * wb;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float delta = mb[j] - mean[j];
    mean[j] = fmaf(delta, wb, mean[j]);
    m2[j] = m2[j] + m2b[j] + delta * delta * cross;
  }
  n += nb;
}

__device__ __forceinline__ void welford(float& n, float mean[kVec],
                                        float m2[kVec], const float v[kVec]) {
  n += 1.f;
  const float inv = __frcp_rn(n);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float d = v[j] - mean[j];
    mean[j] = fmaf(d, inv, mean[j]);
    m2[j] = fmaf(d, v[j] - mean[j], m2[j]);
  }
}

// The block's threads that share a channel vector (`span` of them,
// `stride` apart) merge their (n, mean, m2) in a fixed shared-memory tree;
// the one with sub == 0 ends with the total.
__device__ __forceinline__ void tree_merge(float& n, float mean[kVec],
                                           float m2[kVec], int sub, int span,
                                           int stride) {
  __shared__ float s_n[kThreads];
  __shared__ float s_mean[kVec][kThreads];
  __shared__ float s_m2[kVec][kThreads];
  const int me = threadIdx.x;
  s_n[me] = n;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s_mean[j][me] = mean[j];
    s_m2[j][me] = m2[j];
  }
  __syncthreads();
  for (int h = span / 2; h > 0; h >>= 1) {
    if (sub < h) {
      const int other = me + h * stride;
      float mb[kVec], m2b[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        mb[j] = s_mean[j][other];
        m2b[j] = s_m2[j][other];
      }
      chan_merge(n, mean, m2, s_n[other], mb, m2b);
      s_n[me] = n;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s_mean[j][me] = mean[j];
        s_m2[j][me] = m2[j];
      }
    }
    __syncthreads();
  }
}

// The same tree for plain sums of (s, d).
__device__ __forceinline__ void tree_sum(float s[kVec], float d[kVec], int sub,
                                         int span, int stride) {
  __shared__ float s_s[kVec][kThreads];
  __shared__ float s_d[kVec][kThreads];
  const int me = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kVec; ++j) { s_s[j][me] = s[j]; s_d[j][me] = d[j]; }
  __syncthreads();
  for (int h = span / 2; h > 0; h >>= 1) {
    if (sub < h) {
      const int other = me + h * stride;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s[j] += s_s[j][other];
        d[j] += s_d[j][other];
        s_s[j][me] = s[j];
        s_d[j][me] = d[j];
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
byol_bn_stats_kernel(const __nv_bfloat16* __restrict__ x,
                     float* __restrict__ part_mean,
                     float* __restrict__ part_m2, long long rows,
                     int channels, long long chunk) {
  const Tile t = make_tile(channels);
  const Place pl = place(t, rows, chunk);
  const __nv_bfloat16* px = x + pl.c0;
  float n = 0.f, mean[kVec], m2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) mean[j] = m2[j] = 0.f;
  long long r = pl.row;
  for (; r + (kUnroll - 1) * t.rows < pl.end; r += kUnroll * t.rows) {
    float v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load8(px + (r + u * t.rows) * channels, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) welford(n, mean, m2, v[u]);
  }
  for (; r < pl.end; r += t.rows) {
    float v[kVec];
    load8(px + r * channels, v);
    welford(n, mean, m2, v);
  }
  tree_merge(n, mean, m2, pl.sub, t.rows, t.lanes);
  if (pl.sub == 0) {
    const long long at = static_cast<long long>(blockIdx.x) * channels + pl.c0;
    store8(part_mean + at, mean);
    store8(part_m2 + at, m2);
  }
}

// One block a channel vector: each thread merges every kThreads-th chunk's
// partial in order, then the block's tree.
__global__ void __launch_bounds__(kThreads)
byol_bn_stats_finalize_kernel(const float* __restrict__ part_mean,
                              const float* __restrict__ part_m2, int parts,
                              long long chunk, long long rows, int channels,
                              float* __restrict__ mean_out,
                              float* __restrict__ rstd_out,
                              float* __restrict__ running_mean,
                              float* __restrict__ running_var, int update,
                              float keep, float take, float eps) {
  const int c0 = blockIdx.x * kVec;
  float n = 0.f, mean[kVec], m2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) mean[j] = m2[j] = 0.f;
#pragma unroll 4
  for (int p = threadIdx.x; p < parts; p += kThreads) {
    const long long left = rows - static_cast<long long>(p) * chunk;
    const long long at = static_cast<long long>(p) * channels + c0;
    float mb[kVec], m2b[kVec];
    load8(part_mean + at, mb);
    load8(part_m2 + at, m2b);
    chan_merge(n, mean, m2, static_cast<float>(left < chunk ? left : chunk),
               mb, m2b);
  }
  tree_merge(n, mean, m2, threadIdx.x, kThreads, 1);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = c0 + j;
      const float var = m2[j] / static_cast<float>(rows);
      mean_out[c] = mean[j];
      rstd_out[c] = 1.f / sqrtf(var + eps);
      if (update) {
        running_mean[c] = fmaf(take, mean[j], keep * running_mean[c]);
        running_var[c] = fmaf(take, var, keep * running_var[c]);
      }
    }
  }
}

template <typename OutT, bool kResidual, bool kRelu>
__global__ void __launch_bounds__(kThreads)
byol_bn_apply_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias,
                     const float* __restrict__ residual,
                     OutT* __restrict__ out, __nv_bfloat16* __restrict__ copy,
                     uint8_t* __restrict__ mask, long long rows, int channels,
                     long long chunk) {
  const Tile t = make_tile(channels);
  const Place pl = place(t, rows, chunk);
  float mu[kVec], a[kVec], b[kVec], rs[kVec];
  load_channels(mean, pl.c0, mu);
  load_channels(rstd, pl.c0, rs);
  load_channels(weight, pl.c0, a);
  load_channels(bias, pl.c0, b);
#pragma unroll
  for (int j = 0; j < kVec; ++j) a[j] *= rs[j];
  const int vecs = channels / kVec;
  for (long long r0 = pl.row; r0 < pl.end; r0 += kUnroll * t.rows) {
    float v[kUnroll][kVec], res[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * t.rows;
      if (r < pl.end) {
        load8(x + r * channels + pl.c0, v[u]);
        if (kResidual) load8(residual + r * channels + pl.c0, res[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * t.rows;
      if (r >= pl.end) break;
      uint32_t bits = 0;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float y = fmaf(v[u][j] - mu[j], a[j], b[j]);
        if (kResidual) y += res[u][j];
        if (kRelu) {
          if (y <= 0.f) y = 0.f;       // NaN stays, and passes its gradient
          else bits |= 1u << j;
        }
        v[u][j] = y;
      }
      store8(out + r * channels + pl.c0, v[u]);
      if (copy != nullptr) store8(copy + r * channels + pl.c0, v[u]);
      if (kRelu && mask != nullptr)
        mask[r * vecs + pl.c0 / kVec] = static_cast<uint8_t>(bits);
    }
  }
}

// A row's gradient: g (+ the bf16 copy's gradient, added in fp32), masked
// by the saved bits.
template <typename GradT, bool kMask>
__device__ __forceinline__ void masked(const GradT* grad,
                                       const __nv_bfloat16* grad_copy,
                                       const uint8_t* mask, long long r,
                                       int channels, int c0, float g[kVec]) {
  load8(grad + r * channels + c0, g);
  if (grad_copy != nullptr) {
    float h[kVec];
    load8(grad_copy + r * channels + c0, h);
#pragma unroll
    for (int j = 0; j < kVec; ++j) g[j] += h[j];
  }
  if (kMask) {
    const uint32_t bits = mask[r * (channels / kVec) + c0 / kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (!((bits >> j) & 1u)) g[j] = 0.f;
  }
}

template <typename GradT, bool kMask, bool kResidual>
__global__ void __launch_bounds__(kThreads)
byol_bn_grad_sums_kernel(const GradT* __restrict__ grad,
                         const __nv_bfloat16* __restrict__ grad_copy,
                         const __nv_bfloat16* __restrict__ x,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ mean,
                         float* __restrict__ dres,
                         float* __restrict__ part_sum,
                         float* __restrict__ part_dot, long long rows,
                         int channels, long long chunk) {
  const Tile t = make_tile(channels);
  const Place pl = place(t, rows, chunk);
  float mu[kVec], s[kVec], d[kVec];
  load_channels(mean, pl.c0, mu);
#pragma unroll
  for (int j = 0; j < kVec; ++j) s[j] = d[j] = 0.f;
  for (long long r0 = pl.row; r0 < pl.end; r0 += kUnroll * t.rows) {
    float g[kUnroll][kVec], v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * t.rows;
      if (r < pl.end) {
        masked<GradT, kMask>(grad, grad_copy, mask, r, channels, pl.c0, g[u]);
        load8(x + r * channels + pl.c0, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * t.rows;
      if (r >= pl.end) break;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s[j] += g[u][j];
        d[j] = fmaf(g[u][j], v[u][j] - mu[j], d[j]);
      }
      if (kResidual) store8(dres + r * channels + pl.c0, g[u]);
    }
  }
  tree_sum(s, d, pl.sub, t.rows, t.lanes);
  if (pl.sub == 0) {
    const long long at = static_cast<long long>(blockIdx.x) * channels + pl.c0;
    store8(part_sum + at, s);
    store8(part_dot + at, d);
  }
}

// One block a channel vector, as the statistics' finalize.
__global__ void __launch_bounds__(kThreads)
byol_bn_grad_finalize_kernel(const float* __restrict__ part_sum,
                             const float* __restrict__ part_dot, int parts,
                             long long rows, int channels,
                             const float* __restrict__ rstd,
                             const float* __restrict__ weight,
                             float* __restrict__ dweight,
                             float* __restrict__ dbias,
                             float* __restrict__ coef) {
  const int c0 = blockIdx.x * kVec;
  float s[kVec], d[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s[j] = d[j] = 0.f;
#pragma unroll 4
  for (int p = threadIdx.x; p < parts; p += kThreads) {
    const long long at = static_cast<long long>(p) * channels + c0;
    float sp[kVec], dp[kVec];
    load8(part_sum + at, sp);
    load8(part_dot + at, dp);
#pragma unroll
    for (int j = 0; j < kVec; ++j) { s[j] += sp[j]; d[j] += dp[j]; }
  }
  tree_sum(s, d, threadIdx.x, kThreads, 1);
  if (threadIdx.x == 0) {
    const float m = static_cast<float>(rows);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int c = c0 + j;
      const float r = rstd[c];
      dbias[c] = s[j];
      dweight[c] = d[j] * r;
      coef[c] = weight[c] * r;
      coef[channels + c] = s[j] / m;
      coef[2 * channels + c] = r * r * d[j] / m;
    }
  }
}

template <typename GradT, bool kMask>
__global__ void __launch_bounds__(kThreads)
byol_bn_grad_apply_kernel(const GradT* __restrict__ grad,
                          const __nv_bfloat16* __restrict__ grad_copy,
                          const __nv_bfloat16* __restrict__ x,
                          const uint8_t* __restrict__ mask,
                          const float* __restrict__ mean,
                          const float* __restrict__ coef,
                          __nv_bfloat16* __restrict__ dx, long long rows,
                          int channels, long long chunk) {
  const Tile t = make_tile(channels);
  const Place pl = place(t, rows, chunk);
  float mu[kVec], a[kVec], gbar[kVec], proj[kVec];
  load_channels(mean, pl.c0, mu);
  load_channels(coef, pl.c0, a);
  load_channels(coef + channels, pl.c0, gbar);
  load_channels(coef + 2 * channels, pl.c0, proj);
  for (long long r0 = pl.row; r0 < pl.end; r0 += kUnroll * t.rows) {
    float g[kUnroll][kVec], v[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * t.rows;
      if (r < pl.end) {
        masked<GradT, kMask>(grad, grad_copy, mask, r, channels, pl.c0, g[u]);
        load8(x + r * channels + pl.c0, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * t.rows;
      if (r >= pl.end) break;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v[u][j] = a[j] * (g[u][j] - gbar[j] - (v[u][j] - mu[j]) * proj[j]);
      store8(dx + r * channels + pl.c0, v[u]);
    }
  }
}

bool bad_shape(long long rows, int channels, int parts, long long chunk) {
  return rows <= 0 || channels <= 0 || channels % kVec != 0 || parts <= 0 ||
         chunk <= 0 || static_cast<long long>(parts) * chunk < rows ||
         static_cast<long long>(parts - 1) * chunk >= rows;
}

struct ApplyArgs {
  const __nv_bfloat16* x;
  const float *mean, *rstd, *weight, *bias, *residual;
  void* out;
  __nv_bfloat16* copy;
  uint8_t* mask;
  long long rows;
  int channels;
  long long chunk;
};

template <typename OutT, bool kResidual, bool kRelu>
void launch_apply(dim3 grid, cudaStream_t s, const ApplyArgs& a) {
  byol_bn_apply_kernel<OutT, kResidual, kRelu><<<grid, kThreads, 0, s>>>(
      a.x, a.mean, a.rstd, a.weight, a.bias, a.residual,
      static_cast<OutT*>(a.out), a.copy, a.mask, a.rows, a.channels, a.chunk);
}

template <typename OutT>
void launch_apply(dim3 grid, cudaStream_t s, const ApplyArgs& a, int relu) {
  if (a.residual != nullptr) {
    if (relu) launch_apply<OutT, true, true>(grid, s, a);
    else launch_apply<OutT, true, false>(grid, s, a);
  } else {
    if (relu) launch_apply<OutT, false, true>(grid, s, a);
    else launch_apply<OutT, false, false>(grid, s, a);
  }
}

struct GradArgs {
  const void* grad;
  const __nv_bfloat16* grad_copy;
  const __nv_bfloat16* x;
  const uint8_t* mask;
  const float *mean, *rstd, *weight;
  __nv_bfloat16* dx;
  float *dres, *dweight, *dbias, *coef, *part_sum, *part_dot;
  long long rows;
  int channels, parts;
  long long chunk;
};

template <typename GradT, bool kMask>
cudaError_t launch_grad(dim3 grid, cudaStream_t s, const GradArgs& a) {
  const GradT* g = static_cast<const GradT*>(a.grad);
  if (a.dres != nullptr)
    byol_bn_grad_sums_kernel<GradT, kMask, true><<<grid, kThreads, 0, s>>>(
        g, a.grad_copy, a.x, a.mask, a.mean, a.dres, a.part_sum, a.part_dot,
        a.rows, a.channels, a.chunk);
  else
    byol_bn_grad_sums_kernel<GradT, kMask, false><<<grid, kThreads, 0, s>>>(
        g, a.grad_copy, a.x, a.mask, a.mean, a.dres, a.part_sum, a.part_dot,
        a.rows, a.channels, a.chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  byol_bn_grad_finalize_kernel<<<a.channels / kVec, kThreads, 0, s>>>(
      a.part_sum, a.part_dot, a.parts, a.rows, a.channels, a.rstd, a.weight,
      a.dweight, a.dbias, a.coef);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  byol_bn_grad_apply_kernel<GradT, kMask><<<grid, kThreads, 0, s>>>(
      g, a.grad_copy, a.x, a.mask, a.mean, a.coef, a.dx, a.rows, a.channels,
      a.chunk);
  return cudaGetLastError();
}

}  // namespace

// Forward.  x (rows, channels) bf16; weight, bias, running_mean,
// running_var (channels,) fp32; residual (rows, channels) fp32 or null;
// out (rows, channels), bf16 if out_bf16 else fp32; copy (rows, channels)
// bf16 or null: the output once more, rounded to bf16; mask (rows,
// channels / 8) uint8 or null (written only with relu); out mean, rstd
// (channels,) fp32; part_mean, part_m2 (parts, channels) fp32 scratch; the
// chunks [p * chunk, (p + 1) * chunk) cover the rows, the last one not
// empty.
extern "C" int byol_bn_forward(const void* x, const float* weight,
                               const float* bias, const float* residual,
                               void* out, int out_bf16, void* copy, int relu,
                               uint8_t* mask, float* mean, float* rstd,
                               float* running_mean, float* running_var,
                               float* part_mean, float* part_m2,
                               long long rows, int channels, int parts,
                               long long chunk, int update, float keep,
                               float take, float eps, void* stream) {
  if (bad_shape(rows, channels, parts, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tile t = make_tile(channels);
  const dim3 grid(parts, t.groups);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  byol_bn_stats_kernel<<<grid, kThreads, 0, s>>>(xb, part_mean, part_m2, rows,
                                                 channels, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  byol_bn_stats_finalize_kernel<<<channels / kVec, kThreads, 0, s>>>(
      part_mean, part_m2, parts, chunk, rows, channels, mean, rstd,
      running_mean, running_var, update, keep, take, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const ApplyArgs a{xb, mean, rstd, weight, bias, residual, out,
                    static_cast<__nv_bfloat16*>(copy), mask, rows, channels,
                    chunk};
  if (out_bf16) launch_apply<__nv_bfloat16>(grid, s, a, relu);
  else launch_apply<float>(grid, s, a, relu);
  return static_cast<int>(cudaGetLastError());
}

// Backward.  grad (rows, channels), bf16 if grad_bf16 else fp32; grad_copy
// (rows, channels) bf16, the copy's gradient, or null; x the forward's bf16
// input; mask the forward's bits, or null without ReLU; mean, rstd the
// forward's; weight (channels,) fp32; out dx (rows, channels) bf16, dres
// (rows, channels) fp32 or null (no residual gradient wanted), dweight,
// dbias (channels,) fp32; coef (3, channels) and part_sum, part_dot
// (parts, channels) fp32 scratch.
extern "C" int byol_bn_backward(const void* grad, int grad_bf16,
                                const void* grad_copy, const void* x,
                                const uint8_t* mask, const float* mean,
                                const float* rstd, const float* weight,
                                void* dx, float* dres, float* dweight,
                                float* dbias, float* coef, float* part_sum,
                                float* part_dot, long long rows, int channels,
                                int parts, long long chunk, void* stream) {
  if (bad_shape(rows, channels, parts, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Tile t = make_tile(channels);
  const GradArgs a{grad, static_cast<const __nv_bfloat16*>(grad_copy),
                   static_cast<const __nv_bfloat16*>(x), mask, mean, rstd,
                   weight, static_cast<__nv_bfloat16*>(dx), dres, dweight,
                   dbias, coef, part_sum, part_dot, rows, channels, parts,
                   chunk};
  const dim3 grid(parts, t.groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (grad_bf16)
    err = mask != nullptr ? launch_grad<__nv_bfloat16, true>(grid, s, a)
                          : launch_grad<__nv_bfloat16, false>(grid, s, a);
  else
    err = mask != nullptr ? launch_grad<float, true>(grid, s, a)
                          : launch_grad<float, false>(grid, s, a);
  return static_cast<int>(err);
}
