// K1a + K1b: the fused LARS+EMA weight update, on Hopper (sm_90a).
//
// Replaces byol_tpu/ops/fused_update.py: `_segment_norms_kernel` (K1a,
// :198) and `_fused_apply_kernel` (K1b, :215), both over the flat fp32
// buffer of ops/fused_update.py's SegmentMap: every parameter leaf is one
// segment, zero-padded to whole 128-lane rows, and a row belongs to exactly
// one segment (`row_seg`).
//
// K1a, segment norms -> trust ratios.  Two launches, no atomics, so the same
// inputs give bit-identical norms every run (resume stays byte-exact):
//   1. one warp per 128-lane row: each lane loads 4 floats of p and g
//      (16-byte loads, a row is one 512-byte coalesced read per operand),
//      forms g + wd*p with the row's segment weight decay (0 on excluded
//      segments), and a butterfly of warp shuffles sums |p|^2 and
//      |g + wd p|^2 in a fixed order; lane 0 writes the row's pair;
//   2. one block per segment sums its rows' pairs in float64, each thread
//      over a fixed stride, then a fixed shared-memory tree; thread 0 takes
//      the square roots and the trust ratio (1 unless both norms are > 0;
//      scale 1 on excluded segments).
// K1b, fused apply.  One thread per 4 elements (16-byte loads and stores),
// grid-stride: u = (g + wd p) * scale; m' = mu m + u; p' = p - lr m';
// t' = tau t + (1 - tau) (p' or, under ema_pre, p); p, m, t in place.
//
// Bound on an H100 SXM (3.35 TB/s) at ResNet-50 BYOL, 35,089,024 elements:
// K1a reads p and g once, 280.7 MB -> 0.084 ms; K1b reads p, g, m, t and
// writes p, m, t, 982.5 MB -> 0.293 ms.  Both are bandwidth-bound (a few
// flops per 4-byte element), so the design is about full-width coalesced
// 16-byte accesses and one pass each; the row-partial round trip of K1a
// (8 bytes a row, 2.2 MB) and the per-segment reduction are small beside
// the 280 MB stream.
//
// K1a split (the ZeRO-1 update, byol_tpu/ops/fused_update.py:417): JAX
// all-reduces the per-segment partial sums over the data axis between the
// norm pass and the trust ratio, which K1a computes in one launch.  So K1a
// also has two entries of its own: byol_segment_sums runs pass 1 and the
// per-segment float64 reduce over one rank's range of rows, stopped before
// the square root, and byol_segment_epilogue turns the summed (nseg, 2)
// sums into norms and scales with the fused reduce's own arithmetic; the
// caller all-reduces the sums between them.  K1b then runs unchanged on
// the range.  Bound at 35,089,024 elements over W ranks: the range's p and
// g, 280.7 / W MB -> 0.084 / W ms; the epilogue reads 173 x 16 bytes.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;             // elements per row
constexpr int kVecPerRow = kLanes / 4;  // float4 per row = one per lane
constexpr int kRowThreads = 256;        // 8 rows per block in K1a pass 1
constexpr int kReduceThreads = 256;     // K1a pass 2
constexpr int kApplyThreads = 256;

__global__ void __launch_bounds__(kRowThreads)
row_norms_kernel(const float4* __restrict__ p, const float4* __restrict__ g,
                 const int* __restrict__ row_seg,
                 const float* __restrict__ seg_wd,
                 float2* __restrict__ row_partial, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;             // uniform across the warp
  const float wd = seg_wd[row_seg[row]];
  const size_t i = static_cast<size_t>(row) * kVecPerRow + lane;
  const float4 pv = p[i];
  const float4 gv = g[i];
  const float gx = gv.x + wd * pv.x, gy = gv.y + wd * pv.y;
  const float gz = gv.z + wd * pv.z, gw = gv.w + wd * pv.w;
  float pp = pv.x * pv.x + pv.y * pv.y + pv.z * pv.z + pv.w * pv.w;
  float gg = gx * gx + gy * gy + gz * gz + gw * gw;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pp += __shfl_xor_sync(0xffffffffu, pp, off);
    gg += __shfl_xor_sync(0xffffffffu, gg, off);
  }
  if (lane == 0) row_partial[row] = make_float2(pp, gg);
}

// The block's sums of the rows [lo, hi) of row_partial, in float64: each
// thread over a fixed stride, then a fixed shared-memory tree.  Every
// thread returns with the totals in sp[0], sg[0].
__device__ __forceinline__ void block_segment_sums(
    const float2* __restrict__ row_partial, int lo, int hi, double* sp,
    double* sg) {
  const int tid = threadIdx.x;
  double pp = 0.0, gg = 0.0;
  for (int r = lo + tid; r < hi; r += kReduceThreads) {
    const float2 v = row_partial[r];
    pp += v.x;
    gg += v.y;
  }
  sp[tid] = pp;
  sg[tid] = gg;
  __syncthreads();
#pragma unroll
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (tid < w) {
      sp[tid] += sp[tid + w];
      sg[tid] += sg[tid + w];
    }
    __syncthreads();
  }
}

// Segment s's norms and applied trust scale from its float64 sums: the
// ratio is 1 unless both norms are > 0, the scale 1 on excluded segments.
__device__ __forceinline__ void finish_segment(
    double sum_p, double sum_g, int s, const int* __restrict__ seg_adapted,
    float* __restrict__ seg_norms, float* __restrict__ seg_scale,
    float trust_coef, float eps) {
  const float pn = static_cast<float>(sqrt(sum_p));
  const float gn = static_cast<float>(sqrt(sum_g));
  seg_norms[2 * s] = pn;
  seg_norms[2 * s + 1] = gn;
  const float ratio =
      (pn > 0.0f && gn > 0.0f) ? trust_coef * pn / (gn + eps) : 1.0f;
  seg_scale[s] = seg_adapted[s] ? ratio : 1.0f;
}

__global__ void __launch_bounds__(kReduceThreads)
segment_reduce_kernel(const float2* __restrict__ row_partial,
                      const int* __restrict__ seg_row_start,
                      const int* __restrict__ seg_adapted,
                      float* __restrict__ seg_norms,
                      float* __restrict__ seg_scale, float trust_coef,
                      float eps) {
  __shared__ double sp[kReduceThreads];
  __shared__ double sg[kReduceThreads];
  const int s = blockIdx.x;
  block_segment_sums(row_partial, seg_row_start[s], seg_row_start[s + 1], sp,
                     sg);
  if (threadIdx.x == 0)
    finish_segment(sp[0], sg[0], s, seg_adapted, seg_norms, seg_scale,
                   trust_coef, eps);
}

// K1a split, first half: block s reduces local segment s of a row range
// (rows [seg_row_start[s], seg_row_start[s + 1]) of the range) and writes
// its float64 sums at its global id.  Segments outside the range keep the
// zeros the entry sets, so the all-reduce of the (nseg, 2) sums over the
// ranks' ranges gives every segment's sums over the whole buffer.
__global__ void __launch_bounds__(kReduceThreads)
segment_sums_kernel(const float2* __restrict__ row_partial,
                    const int* __restrict__ seg_row_start,
                    const int* __restrict__ seg_ids,
                    double* __restrict__ seg_sums) {
  __shared__ double sp[kReduceThreads];
  __shared__ double sg[kReduceThreads];
  const int s = blockIdx.x;
  block_segment_sums(row_partial, seg_row_start[s], seg_row_start[s + 1], sp,
                     sg);
  if (threadIdx.x == 0) {
    const int id = seg_ids[s];
    seg_sums[2 * id] = sp[0];
    seg_sums[2 * id + 1] = sg[0];
  }
}

// K1a split, second half: one thread per segment turns the (all-reduced)
// float64 sums into norms and scales with segment_reduce_kernel's own
// arithmetic, so one rank's split path equals the fused K1a bit for bit.
__global__ void __launch_bounds__(kReduceThreads)
segment_epilogue_kernel(const double* __restrict__ seg_sums,
                        const int* __restrict__ seg_adapted,
                        float* __restrict__ seg_norms,
                        float* __restrict__ seg_scale, int nseg,
                        float trust_coef, float eps) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nseg) return;
  finish_segment(seg_sums[2 * s], seg_sums[2 * s + 1], s, seg_adapted,
                 seg_norms, seg_scale, trust_coef, eps);
}

__device__ __forceinline__ void apply_one(float& p, float g, float& m,
                                          float& t, float wd, float sc,
                                          float lr, float tau, float mu,
                                          bool ema_pre) {
  const float u = (g + wd * p) * sc;
  const float m_new = mu * m + u;
  const float p_new = p - lr * m_new;
  const float src = ema_pre ? p : p_new;
  t = t * tau + (1.0f - tau) * src;
  m = m_new;
  p = p_new;
}

__global__ void __launch_bounds__(kApplyThreads)
fused_apply_kernel(float4* __restrict__ p, const float4* __restrict__ g,
                   float4* __restrict__ m, float4* __restrict__ t,
                   const int* __restrict__ row_seg,
                   const float* __restrict__ seg_wd,
                   const float* __restrict__ seg_scale, long long n_vec,
                   float lr, float tau, float mu, int ema_pre) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_vec; i += stride) {
    const int seg = row_seg[i / kVecPerRow];
    const float wd = seg_wd[seg];
    const float sc = seg_scale[seg];
    float4 pv = p[i];
    const float4 gv = g[i];
    float4 mv = m[i];
    float4 tv = t[i];
    const bool pre = ema_pre != 0;
    apply_one(pv.x, gv.x, mv.x, tv.x, wd, sc, lr, tau, mu, pre);
    apply_one(pv.y, gv.y, mv.y, tv.y, wd, sc, lr, tau, mu, pre);
    apply_one(pv.z, gv.z, mv.z, tv.z, wd, sc, lr, tau, mu, pre);
    apply_one(pv.w, gv.w, mv.w, tv.w, wd, sc, lr, tau, mu, pre);
    p[i] = pv;
    m[i] = mv;
    t[i] = tv;
  }
}

}  // namespace

// K1a.  p, g: (rows, 128) fp32; row_seg: (rows,) int32; seg_wd, seg_adapted:
// (nseg,); seg_row_start: (nseg + 1,) int32; row_partial: (rows, 2) fp32
// scratch; out seg_norms (nseg, 2) = (|p|, |g + wd p|), seg_scale (nseg,).
extern "C" int byol_segment_norms(const float* p, const float* g,
                                  const int* row_seg, const float* seg_wd,
                                  const int* seg_row_start,
                                  const int* seg_adapted, float* row_partial,
                                  float* seg_norms, float* seg_scale,
                                  int rows, int nseg, float trust_coef,
                                  float eps, void* stream) {
  if (rows <= 0 || nseg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows_per_block = kRowThreads / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  row_norms_kernel<<<blocks, kRowThreads, 0, s>>>(
      reinterpret_cast<const float4*>(p), reinterpret_cast<const float4*>(g),
      row_seg, seg_wd, reinterpret_cast<float2*>(row_partial), rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_reduce_kernel<<<nseg, kReduceThreads, 0, s>>>(
      reinterpret_cast<const float2*>(row_partial), seg_row_start,
      seg_adapted, seg_norms, seg_scale, trust_coef, eps);
  return static_cast<int>(cudaGetLastError());
}

// K1a split, first half, on a range of rows: p, g (rows, 128) fp32, the
// range's rows; row_seg (rows,) int32 global segment ids; seg_wd (nseg,);
// seg_row_start (nloc + 1,) int32 range-relative; seg_ids (nloc,) int32;
// row_partial (rows, 2) fp32 scratch; out seg_sums (nseg, 2) float64 =
// (sum p^2, sum (g + wd p)^2), zero on segments outside the range.
extern "C" int byol_segment_sums(const float* p, const float* g,
                                 const int* row_seg, const float* seg_wd,
                                 const int* seg_row_start, const int* seg_ids,
                                 float* row_partial, double* seg_sums,
                                 int rows, int nloc, int nseg, void* stream) {
  if (rows < 0 || nloc < 0 || nseg <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      seg_sums, 0, sizeof(double) * 2 * static_cast<size_t>(nseg), s);
  if (err != cudaSuccess || rows == 0) return static_cast<int>(err);
  const int rows_per_block = kRowThreads / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  row_norms_kernel<<<blocks, kRowThreads, 0, s>>>(
      reinterpret_cast<const float4*>(p), reinterpret_cast<const float4*>(g),
      row_seg, seg_wd, reinterpret_cast<float2*>(row_partial), rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_sums_kernel<<<nloc, kReduceThreads, 0, s>>>(
      reinterpret_cast<const float2*>(row_partial), seg_row_start, seg_ids,
      seg_sums);
  return static_cast<int>(cudaGetLastError());
}

// K1a split, second half: seg_sums (nseg, 2) float64 -> seg_norms (nseg, 2)
// and seg_scale (nseg,) fp32, as byol_segment_norms computes them.
extern "C" int byol_segment_epilogue(const double* seg_sums,
                                     const int* seg_adapted, float* seg_norms,
                                     float* seg_scale, int nseg,
                                     float trust_coef, float eps,
                                     void* stream) {
  if (nseg <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (nseg + kReduceThreads - 1) / kReduceThreads;
  segment_epilogue_kernel<<<blocks, kReduceThreads, 0, s>>>(
      seg_sums, seg_adapted, seg_norms, seg_scale, nseg, trust_coef, eps);
  return static_cast<int>(cudaGetLastError());
}

// K1b.  p, g, m, t: (rows, 128) fp32, p/m/t updated in place; row_seg
// (rows,) int32; seg_wd, seg_scale (nseg,) fp32; lr, tau, mu host scalars.
extern "C" int byol_fused_apply(float* p, const float* g, float* m, float* t,
                                const int* row_seg, const float* seg_wd,
                                const float* seg_scale, int rows, float lr,
                                float tau, float mu, int ema_pre,
                                void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_vec = static_cast<long long>(rows) * kVecPerRow;
  const long long want = (n_vec + kApplyThreads - 1) / kApplyThreads;
  const int blocks = static_cast<int>(want < 65535LL * 32 ? want
                                                           : 65535LL * 32);
  fused_apply_kernel<<<blocks, kApplyThreads, 0, s>>>(
      reinterpret_cast<float4*>(p), reinterpret_cast<const float4*>(g),
      reinterpret_cast<float4*>(m), reinterpret_cast<float4*>(t), row_seg,
      seg_wd, seg_scale, n_vec, lr, tau, mu, ema_pre);
  return static_cast<int>(cudaGetLastError());
}
