// Flash attention forward for Hopper (sm_90a): blockwise online softmax,
// no (S, S) score matrix in device memory.
//
// Replaces the TPU kernel byol_tpu/ops/flash_attention.py::_flash_kernel
// (entry flash_attention, pl.pallas_call at flash_attention.py:120).  Same
// function: scores q.k^T * d^-0.5 accumulated in fp32, keys at pos >= seq
// masked to -1e30, fp32 running max / normalizer / accumulator, p rounded to
// v's dtype before the p.v product, output in the input dtype.
//
// Bound at the serving slice's shape (ViT-B/16, 224 px: B = bucket, H = 12,
// S = 197, D = 64, bf16).  Bytes: q, k, v read once and o written once,
// 4*B*H*S*D*2 = 77.5 MB at B = 64.  Operations: two products of
// 2*B*H*S*S*D each, 7.6 GFLOP at B = 64.  On an H100 SXM (3.35 TB/s,
// 989 TFLOP/s bf16) that is 23.1 us of memory traffic against 7.7 us of
// tensor-core work, so the call is memory-bound, at about 23 us.
//
// What the design does about that bound:
// - each block owns one (batch*head, 64-row query tile) and walks every
//   key/value tile in a loop (the TPU's sequential K grid dimension), so the
//   scores and probabilities never leave the SM; q is read once, k and v once
//   per query tile (ceil(197/64) = 4 tiles, the repeats mostly hit L2);
// - ragged keys are masked in the kernel, so no padded copy of q/k/v is made
//   in memory (the TPU wrapper pads S to the block size: 256 for 197);
// - q/k/v are read through their (b, h, s) strides, so the ViT passes views
//   of its fused qkv projection without a transpose copy;
// - bf16 (the serving path): both products run on the tensor cores with
//   mma.sync m16n8k16 (4 warps, 16 query rows each), tiles staged through
//   shared memory with 16-byte loads and read with ldmatrix; p goes from the
//   score accumulators to the p.v operand in registers, rounded to bf16
//   there, as the TPU kernel rounds it;
// - fp32 (--no-half): one query row per thread on the CUDA cores, k/v rows
//   broadcast from shared memory; bounded by its FMA issue rate.
// wgmma, TMA, a pipelined load/compute overlap and warp specialisation are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;           // query rows per block and key/value rows
                                   // per staged tile
constexpr float NEG_INF = -1e30f;  // as the TPU kernel: exp() stays defined

struct Strides {                   // element strides; the head dim is contiguous
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync), 4 warps x 16 query rows
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ROWS rows of one (b, h) slice, from row0 on, into shared memory (pitch P
// elements) with 16-byte loads; rows at or past seq are zero.  The wrapper
// guarantees 16-byte aligned rows.
template <int D, int P>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long stride_s, int row0,
                                           int seq) {
  constexpr int CHUNKS = D / 8;    // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += MMA_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < seq)
      val = *reinterpret_cast<const uint4*>(src + (long long)row * stride_s + c);
    *reinterpret_cast<uint4*>(dst + r * P + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, Strides sq, Strides sk,
                      Strides sv, Strides so, int heads, int seq,
                      float scale) {
  // pitch padded by 8 elements (16 bytes): the 8 row addresses of one
  // ldmatrix fall on distinct bank groups
  constexpr int P = D + 8;
  constexpr int KD = D / 16;       // k-steps over the head dim
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* k_s = q_s + ROWS * P;
  __nv_bfloat16* v_s = k_s + ROWS * P;

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* qp = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;

  stage_bf16<D, P>(q_s, qp, sq.s, q0, seq);
  __syncthreads();
  // this warp's 16 query rows as mma A fragments, kept in registers
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * P
                            + kk * 16 + (lane / 16) * 8);

  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  // each thread holds two rows of the warp's tile: lane/4 and lane/4 + 8
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < seq; k0 += ROWS) {
    __syncthreads();  // every warp is done with the previous k/v tile
    stage_bf16<D, P>(k_s, kp, sk.s, k0, seq);
    stage_bf16<D, P>(v_s, vp, sv.s, k0, seq);
    __syncthreads();

    // s = q k^T: 16 x 64 per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, k_s + (np * 16 + (lane % 8) + (lane / 16) * 8) * P
                            + kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale, mask the ragged keys, row max over the 4 lanes sharing a row
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = k0 + j * 8 + (lane % 4) * 2 + e < seq;
        s[j][e] = valid ? s[j][e] * scale : NEG_INF;
        s[j][2 + e] = valid ? s[j][2 + e] * scale : NEG_INF;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      acc[t][0] *= a0;
      acc[t][1] *= a0;
      acc[t][2] *= a1;
      acc[t][3] *= a1;
    }

    // p = exp(s - m): summed in fp32 into l, rounded to bf16 as the A
    // fragments of p.v (the accumulator layout of two n-tiles is the A
    // layout of one 16-key step)
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p00 = expf(s[j][0] - m0), p01 = expf(s[j][1] - m0);
      const float p10 = expf(s[j][2] - m1), p11 = expf(s[j][3] - m1);
      l0 += p00 + p01;
      l1 += p10 + p11;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p00, p01);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
    }

    // acc += p v: 16 x D per warp, v read transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_s + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8)
                                      * P + dp * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * dp], pf[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + warp * 16 + lane / 4, r1 = r0 + 8;
  __nv_bfloat16* op = o + b * so.b + h * so.h;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int t = 0; t < D / 8; ++t) {
    const int col = t * 8 + (lane % 4) * 2;
    if (r0 < seq)
      *reinterpret_cast<__nv_bfloat162*>(op + (long long)r0 * so.s + col) =
          __floats2bfloat162_rn(acc[t][0] * inv0, acc[t][1] * inv0);
    if (r1 < seq)
      *reinterpret_cast<__nv_bfloat162*>(op + (long long)r1 * so.s + col) =
          __floats2bfloat162_rn(acc[t][2] * inv1, acc[t][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, one query row per thread
// ---------------------------------------------------------------------------

constexpr int CHUNK = 16;          // keys scored per online-softmax update

// ROWS rows of one (b, h) slice, from row0 on, into shared memory with the
// given pitch; rows at or past seq are zero.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, int pitch,
                                          const float* src,
                                          long long stride_s, int row0,
                                          int seq) {
  for (int i = threadIdx.x; i < ROWS * D; i += ROWS) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * pitch + c] = row < seq ? src[(long long)row * stride_s + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(ROWS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     int heads, int seq, float scale) {
  // q rows are read one row per thread: pad the pitch by 4 floats so the
  // float4 reads of 8 neighbouring rows fall on distinct banks.  k and v rows
  // are read by all threads at once (broadcast) and need no padding.
  constexpr int QP = D + 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + ROWS * QP;
  float* v_s = k_s + ROWS * D;

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * ROWS;
  const int row = threadIdx.x;
  const float* qp = q + b * sq.b + h * sq.h;
  const float* kp = k + b * sk.b + h * sk.h;
  const float* vp = v + b * sv.b + h * sv.h;

  stage_f32<D>(q_s, QP, qp, sq.s, q0, seq);
  const float4* q4 = reinterpret_cast<const float4*>(q_s + row * QP);

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < seq; k0 += ROWS) {
    __syncthreads();  // the previous tile is consumed (q staged, first time)
    stage_f32<D>(k_s, D, kp, sk.s, k0, seq);
    stage_f32<D>(v_s, D, vp, sv.s, k0, seq);
    __syncthreads();
    const int n_valid = min(ROWS, seq - k0);
    for (int c0 = 0; c0 < n_valid; c0 += CHUNK) {
      float s[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) s[j] = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 qv = q4[d4];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          const float4 kv =
              reinterpret_cast<const float4*>(k_s + (c0 + j) * D)[d4];
          s[j] = fmaf(qv.x, kv.x, s[j]);
          s[j] = fmaf(qv.y, kv.y, s[j]);
          s[j] = fmaf(qv.z, kv.z, s[j]);
          s[j] = fmaf(qv.w, kv.w, s[j]);
        }
      }
      float m_cur = NEG_INF;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        s[j] = (c0 + j < n_valid) ? s[j] * scale : NEG_INF;
        m_cur = fmaxf(m_cur, s[j]);
      }
      const float m_next = fmaxf(m, m_cur);
      const float alpha = expf(m - m_next);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float p = expf(s[j] - m_next);
        l += p;
        const float4* v4 = reinterpret_cast<const float4*>(v_s + (c0 + j) * D);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = v4[d4];
          acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_next;
    }
  }

  if (q0 + row < seq) {
    float* out = o + b * so.b + h * so.h + (long long)(q0 + row) * so.s;
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = acc[d] * inv;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int smem, const void* q,
                   const void* k, const void* v, void* o, const long long* st,
                   int batch, int heads, int seq, int head_dim,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + ROWS - 1) / ROWS, batch * heads);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, heads,
      seq, static_cast<float>(1.0 / sqrt(static_cast<double>(head_dim))));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* o,
                       const long long* st, int batch, int heads, int seq,
                       int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(
        flash_fwd_bf16_kernel<D>, MMA_THREADS,
        static_cast<int>(sizeof(__nv_bfloat16) * 3 * ROWS * (D + 8)), q, k, v,
        o, st, batch, heads, seq, D, stream);
  return launch<float>(flash_fwd_f32_kernel<D>, ROWS,
                       static_cast<int>(sizeof(float) * ROWS * (3 * D + 4)), q,
                       k, v, o, st, batch, heads, seq, D, stream);
}

}  // namespace

// q, k, v, o: (batch, heads, seq, head_dim) with the (b, h, s) element
// strides in strides[0..2] (q), [3..5] (k), [6..8] (v), [9..11] (o) and a
// contiguous head dim; bf16 rows 16-byte aligned.  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int byol_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o,
                                        const long long* strides, int batch,
                                        int heads, int seq, int head_dim,
                                        int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 32:
      err = launch_dim<32>(q, k, v, o, strides, batch, heads, seq, is_bf16, s);
      break;
    case 64:
      err = launch_dim<64>(q, k, v, o, strides, batch, heads, seq, is_bf16, s);
      break;
    case 128:
      err = launch_dim<128>(q, k, v, o, strides, batch, heads, seq, is_bf16, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
