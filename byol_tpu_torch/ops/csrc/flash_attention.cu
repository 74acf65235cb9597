// Flash attention forward for Hopper (sm_90a): no (S, S) score matrix in
// device memory.
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
// bf16 design (the serving path), against that bound:
// - Each byte is loaded once.  For S <= 256 a work item is a whole (b, h)
//   head, or a range of its query rows when B*H is too small to fill the
//   card (ops/flash_attention.py::launch_plan decides); the item's q, K and
//   V are resident in shared memory (S = 197, D = 64: 224 rows of q and
//   208 of k and v at a 72-element pitch, 92 KB), so K/V cross from device
//   memory to the SM once per item instead of once per 64-row query tile.
//   For S > 256 a block owns 128 query rows and streams K/V through a ring
//   of 3 stages of 64 keys.
// - Copies are asynchronous: cp.async (16 B, cache-global).  The resident
//   grid is persistent (one block of 8 warps per SM walking items) with two
//   buffer sets: the next item's copies, one commit group, are issued
//   before the current item is computed, so its loads run under the tensor
//   work.  The ring keeps 2 chunks in flight ahead of the one computed.
//   cp.async rather than TMA: q/k/v are strided views of the ViT's fused
//   qkv (row stride 4608 B) whose base changes with every call, so a
//   tensor map would be encoded per launch (cuTensorMapEncodeTiled), and
//   16-byte copies already keep a whole item in flight per SM.
// - No wasted tiles: queries are padded to 32-row groups (a warp takes two
//   16-row m-tiles, so every K/V fragment it reads feeds both: 7 warps for
//   S = 197), keys to 16 (n-tiles of 8, k-steps of 16), not to 64; rows
//   past seq are zero-filled by cp.async's source-size operand, never
//   loaded.  Chunks of 64 keys below seq are compiled without a bound
//   check.
// - The softmax runs online over the 64-key chunks of the resident K/V,
//   with exp2 and log2(e) folded into the scale; p is rounded to bf16
//   before p.v, as the TPU kernel rounds it.
// - Tensor cores through mma.sync m16n8k16 + ldmatrix.  wgmma was tried
//   in two forms (m64n64 products per 64-key chunk with the online
//   softmax; one m64n256 score product per 64-row tile with an exact
//   one-pass softmax), both with q, K and V staged by cp.async into the
//   no-swizzle core-matrix layout; both ran slower on the H100 than this
//   design, so mma.sync stays.  The kernel does not reach its byte bound
//   (chip_smoke.py prints the time beside it); which of the product rate
//   and the softmax holds it back is an open question in PERF.md.  The
//   output goes back through the warp's own q rows in shared memory, as
//   16-byte stores.
// fp32 (--no-half): one query row per thread on the CUDA cores, k/v rows
// broadcast from shared memory; bounded by its FMA issue rate, and slower
// than its plain version (ROADMAP.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;           // fp32: query rows per block and key/value
                                   // rows per staged tile
constexpr float NEG_INF = -1e30f;  // as the TPU kernel: exp() stays defined
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {                   // element strides; the head dim is contiguous
  long long b, h, s;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync), 16 query rows per warp and m-tile
// ---------------------------------------------------------------------------

constexpr int NW = 8;              // warps per block on the ring path
constexpr int MMA_THREADS = NW * 32;
constexpr int KC = 64;             // keys per chunk (one commit group)
constexpr int RESIDENT_STAGES = 4; // S <= 4 * KC: the whole head is resident
constexpr int RING_STAGES = 3;     // S > 256: a ring of 3 chunks
constexpr int RING_ROWS = NW * 16; // query rows of a block on the ring path
constexpr int MAX_SMEM = 227 * 1024;  // a block's dynamic shared memory

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

// 16 bytes global -> shared, asynchronously; src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows of one (b, h) slice, from row0 on, into shared memory (pitch
// P elements) with 16-byte cp.async by THREADS threads; rows at or past
// seq are zero-filled.  The wrapper guarantees 16-byte aligned rows.
template <int D, int P, int THREADS>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            long long stride_s, int row0,
                                            int rows, int seq) {
  constexpr int CHUNKS = D / 8;    // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const int row = row0 + r;
    const bool valid = row < seq;
    cp_async_16(dst + r * P + c,
                valid ? src + (long long)row * stride_s + c : src,
                valid ? 16 : 0);
  }
}

// 2^x on the SFU (ex2.approx.ftz: 2 ulp, far below p's bf16 rounding)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One warp's MT m-tiles of 16 query rows: their q fragments, fp32
// accumulators and running max / sum.  Each thread holds two rows of a
// tile: lane/4 (index 0) and lane/4 + 8 (index 1).
template <int D, int MT>
struct Tiles {
  uint32_t qf[MT][D / 16][4];
  float acc[MT][D / 8][4];
  float m[MT][2];                  // raw score units
  float l[MT][2];
};

// The 16 rows at q_tile + mt * 16 rows as mma A fragments and a zero
// state, for each of the MT tiles.
template <int D, int P, int MT>
__device__ __forceinline__ void init_tiles(Tiles<D, MT>& t,
                                           const __nv_bfloat16* q_tile,
                                           int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(t.qf[mt][kk],
                  q_tile + (mt * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * P
                      + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      t.acc[mt][i][0] = t.acc[mt][i][1] = t.acc[mt][i][2] =
          t.acc[mt][i][3] = 0.f;
    t.m[mt][0] = t.m[mt][1] = NEG_INF;
    t.l[mt][0] = t.l[mt][1] = 0.f;
  }
}

// The online softmax update of a warp's MT m-tiles for one chunk of KC
// keys from k0, in the log2 domain: scores s (the mma accumulator layout)
// masked past seq (only the last chunk is ragged; FULL says at compile
// time that this one is not), the running max and sum, acc rescaled, and
// p = 2^((s - m) * scale * log2(e)) rounded to bf16 into pf, the A
// fragments of the p.v product (two n-tiles of 8 keys per 16-key step).
template <int D, int MT, bool FULL>
__device__ __forceinline__ void softmax_chunk(Tiles<D, MT>& t,
                                              float (&s)[MT][8][4],
                                              uint32_t (&pf)[MT][4][4],
                                              int k0, int seq,
                                              float scale_log2, int lane) {
  // only the last chunk has keys at or past seq (n-tiles past 16 * nk16
  // too, left at 0 by the products): they score -1e30
  const bool ragged = !FULL && k0 + KC > seq;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (ragged && k0 + j * 8 + (lane % 4) * 2 + e >= seq)
          s[mt][j][e] = s[mt][j][2 + e] = NEG_INF;
        mx0 = fmaxf(mx0, s[mt][j][e]);
        mx1 = fmaxf(mx1, s[mt][j][2 + e]);
      }
    }
    // row max over the 4 lanes sharing a row
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(t.m[mt][0], mx0), mn1 = fmaxf(t.m[mt][1], mx1);
    const float a0 = ex2((t.m[mt][0] - mn0) * scale_log2);
    const float a1 = ex2((t.m[mt][1] - mn1) * scale_log2);
    t.m[mt][0] = mn0;
    t.m[mt][1] = mn1;
    t.l[mt][0] *= a0;
    t.l[mt][1] *= a1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      t.acc[mt][i][0] *= a0;
      t.acc[mt][i][1] *= a0;
      t.acc[mt][i][2] *= a1;
      t.acc[mt][i][3] *= a1;
    }
    // p = 2^((s - m) * scale * log2(e)): summed in fp32 into l, rounded to
    // bf16 as the A fragments of p.v (the accumulator layout of two
    // n-tiles is the A layout of one 16-key step)
    const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p00 = ex2(fmaf(s[mt][j][0], scale_log2, -ms0));
      const float p01 = ex2(fmaf(s[mt][j][1], scale_log2, -ms0));
      const float p10 = ex2(fmaf(s[mt][j][2], scale_log2, -ms1));
      const float p11 = ex2(fmaf(s[mt][j][3], scale_log2, -ms1));
      t.l[mt][0] += p00 + p01;
      t.l[mt][1] += p10 + p11;
      pf[mt][j / 2][(j % 2) * 2] = pack_bf16(p00, p01);
      pf[mt][j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
    }
  }
}

// A warp's MT m-tiles against the keys [k0, k0 + 16 * nk16) at kc/vc
// (nk16 <= 4; FULL: a chunk of KC keys all below seq, so nk16 = 4 and
// nothing is masked, known at compile time, which leaves the chunks before
// the last without a bound check or a select): scores by mma.sync, the
// online softmax update, then acc += p v.  Each K and V fragment read from
// shared memory feeds all MT tiles; a k-step's fragments are loaded before
// its products, so the ldmatrix latencies overlap.
template <int D, int P, int MT, bool FULL>
__device__ __forceinline__ void attend_chunk(Tiles<D, MT>& t,
                                             const __nv_bfloat16* kc,
                                             const __nv_bfloat16* vc, int k0,
                                             int nk16, int seq,
                                             float scale_log2, int lane) {
  if (FULL) nk16 = KC / 16;
  // s = q k^T: 16 x (16 * nk16) per tile, n-tiles of 8 keys
  float s[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t bk[4][4];
#pragma unroll
    for (int np = 0; np < 4; ++np)
      if (np < nk16)
        ldmatrix_x4(bk[np], kc + (np * 16 + (lane % 8) + (lane / 16) * 8) * P
                                + kk * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np < nk16) {
          mma_bf16(s[mt][2 * np], t.qf[mt][kk], bk[np][0], bk[np][1]);
          mma_bf16(s[mt][2 * np + 1], t.qf[mt][kk], bk[np][2], bk[np][3]);
        }
      }
    }
  }

  uint32_t pf[MT][4][4];
  softmax_chunk<D, MT, FULL>(t, s, pf, k0, seq, scale_log2, lane);

  // acc += p v: 16 x D per tile, v read transposed by ldmatrix
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < nk16) {
      uint32_t bv[D / 16][4];
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp)
        ldmatrix_x4_trans(bv[dp], vc + (kk * 16 + (lane % 8)
                                        + ((lane / 8) % 2) * 8) * P
                                      + dp * 16 + (lane / 16) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          mma_bf16(t.acc[mt][2 * dp], pf[mt][kk], bv[dp][0], bv[dp][1]);
          mma_bf16(t.acc[mt][2 * dp + 1], pf[mt][kk], bv[dp][2], bv[dp][3]);
        }
      }
    }
  }
}

// Each tile, normalised, into its own q rows at q_tile (read only by this
// warp, and already in registers), then 16-byte stores of the rows below
// seq to op (row row0 on).
template <int D, int P, int MT>
__device__ __forceinline__ void store_tiles(Tiles<D, MT>& t,
                                            __nv_bfloat16* q_tile,
                                            __nv_bfloat16* op,
                                            long long stride_s, int row0,
                                            int seq, int lane) {
  const int r = lane / 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = t.l[mt][0], l1 = t.l[mt][1];
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    __nv_bfloat16* tile = q_tile + mt * 16 * P;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(tile + r * P + col) =
          __floats2bfloat162_rn(t.acc[mt][i][0] * inv0,
                                t.acc[mt][i][1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * P + col) =
          __floats2bfloat162_rn(t.acc[mt][i][2] * inv1,
                                t.acc[mt][i][3] * inv1);
    }
  }
  __syncwarp();
  constexpr int CHUNKS = D / 8;
#pragma unroll
  for (int i = lane; i < MT * 16 * CHUNKS; i += 32) {
    const int rr = i / CHUNKS, cc = (i % CHUNKS) * 8;
    if (row0 + rr < seq)
      *reinterpret_cast<uint4*>(op + (long long)(row0 + rr) * stride_s + cc) =
          *reinterpret_cast<const uint4*>(q_tile + rr * P + cc);
  }
}

// S <= 256: a persistent grid.  Work item i is part i % splits of head
// i / splits, rows_per_block query rows of it (a multiple of 16 * MT);
// block j takes items j, j + gridDim.x, ...  An item's q, K and V (seq
// rounded up to 16 rows) are resident in one of NSETS buffer sets of shared
// memory; with two, the next item's copies are issued before the current
// one is computed, so the SM's loads and tensor work overlap.  Each warp
// takes MT m-tiles at once (S = 197, D = 64: 7 warps of 2 tiles, every K/V
// fragment read once for both) and walks the keys in 64-key chunks without
// a barrier.
template <int D, int NWARPS, int MT, int NSETS>
__global__ void __launch_bounds__(NWARPS * 32, 1)
flash_fwd_bf16_resident(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o, Strides sq,
                        Strides sk, Strides sv, Strides so, int heads,
                        int seq, int rows_per_block, int splits, int n_items,
                        float scale_log2) {
  // pitch padded by 8 elements (16 bytes): the 8 row addresses of one
  // ldmatrix fall on distinct bank groups
  constexpr int P = D + 8;
  constexpr int THREADS = NWARPS * 32;
  constexpr int GROUP = 16 * MT;   // query rows of one warp
  const int seq16 = (seq + 15) & ~15;
  const int n_chunks = (seq + KC - 1) / KC;
  const int n_full = seq / KC;          // chunks of KC keys below seq
  const int set_elems = (rows_per_block + 2 * seq16) * P;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* sets = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  auto issue = [&](int item, __nv_bfloat16* set) {
    const int bh = item / splits, q0 = (item % splits) * rows_per_block;
    const int b = bh / heads, h = bh % heads;
    const int groups = (min(seq, q0 + rows_per_block) - q0 + GROUP - 1) / GROUP;
    __nv_bfloat16* k_s = set + rows_per_block * P;
    stage_async<D, P, THREADS>(set, q + b * sq.b + h * sq.h, sq.s, q0,
                               groups * GROUP, seq);
    stage_async<D, P, THREADS>(k_s, k + b * sk.b + h * sk.h, sk.s, 0, seq16,
                               seq);
    stage_async<D, P, THREADS>(k_s + seq16 * P, v + b * sv.b + h * sv.h,
                               sv.s, 0, seq16, seq);
    cp_async_commit();
  };

  int item = blockIdx.x;
  if (item < n_items) issue(item, sets);
  for (int it = 0; item < n_items; ++it, item += gridDim.x) {
    __nv_bfloat16* set = sets + (NSETS == 2 ? (it & 1) * set_elems : 0);
    cp_async_wait<0>();             // this item's copies, the only ones
    __syncthreads();                // pending; every warp done with it - 1
    const int next = item + gridDim.x;
    if (NSETS == 2 && next < n_items)
      issue(next, sets + ((it + 1) & 1) * set_elems);

    const int bh = item / splits, q0 = (item % splits) * rows_per_block;
    const int b = bh / heads, h = bh % heads;
    const int groups = (min(seq, q0 + rows_per_block) - q0 + GROUP - 1) / GROUP;
    const __nv_bfloat16* k_s = set + rows_per_block * P;
    const __nv_bfloat16* v_s = k_s + seq16 * P;
    for (int g = warp; g < groups; g += NWARPS) {
      __nv_bfloat16* q_tile = set + g * GROUP * P;
      Tiles<D, MT> t;
      init_tiles<D, P, MT>(t, q_tile, lane);
      int c = 0;
      for (; c < n_full; ++c)
        attend_chunk<D, P, MT, true>(t, k_s + c * KC * P, v_s + c * KC * P,
                                     c * KC, KC / 16, seq, scale_log2, lane);
      if (c < n_chunks)
        attend_chunk<D, P, MT, false>(t, k_s + c * KC * P, v_s + c * KC * P,
                                      c * KC, (seq16 - c * KC) / 16, seq,
                                      scale_log2, lane);
      store_tiles<D, P, MT>(t, q_tile, o + b * so.b + h * so.h, so.s,
                            q0 + g * GROUP, seq, lane);
    }
    if (NSETS == 1 && next < n_items) {
      __syncthreads();              // the set is consumed
      issue(next, set);
    }
  }
}

// S > 256: one block per 128 query rows (8 warps x 16) of one head; K/V
// stream through a ring of NST stages of KC keys, one commit group per
// chunk, NST - 1 chunks ahead of the one being computed.
template <int D, int NST, int MINB>
__global__ void __launch_bounds__(MMA_THREADS, MINB)
flash_fwd_bf16_ring(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, Strides sq, Strides sk,
                    Strides sv, Strides so, int heads, int seq,
                    float scale_log2) {
  constexpr int P = D + 8;
  const int seq16 = (seq + 15) & ~15;
  const int n_chunks = (seq + KC - 1) / KC;
  const int n_full = seq / KC;          // chunks of KC keys below seq
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* k_s = q_s + RING_ROWS * P;
  __nv_bfloat16* v_s = k_s + NST * KC * P;

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * RING_ROWS;
  const int n_mt = (min(seq, q0 + RING_ROWS) - q0 + 15) / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* kp = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vp = v + b * sv.b + h * sv.h;

  auto stage_chunk = [&](int c) {
    const int rows = min(KC, seq16 - c * KC);
    const int slot = (c % NST) * KC * P;
    stage_async<D, P, MMA_THREADS>(k_s + slot, kp, sk.s, c * KC, rows, seq);
    stage_async<D, P, MMA_THREADS>(v_s + slot, vp, sv.s, c * KC, rows, seq);
  };
  // prologue: q and chunk 0 in the first group, then NST - 2 more
  stage_async<D, P, MMA_THREADS>(q_s, q + b * sq.b + h * sq.h, sq.s, q0,
                                 n_mt * 16, seq);
  stage_chunk(0);
  cp_async_commit();
#pragma unroll
  for (int c = 1; c < NST - 1; ++c) {
    if (c < n_chunks) stage_chunk(c);
    cp_async_commit();
  }

  const bool active = warp < n_mt;
  __nv_bfloat16* q_tile = q_s + warp * 16 * P;
  Tiles<D, 1> t;
  for (int c = 0; c < n_chunks; ++c) {
    // one commit group per chunk, empty past the last: chunk c is then
    // complete once at most NST - 1 groups are pending
    if (c + NST - 1 < n_chunks) stage_chunk(c + NST - 1);
    cp_async_commit();
    cp_async_wait<NST - 1>();
    __syncthreads();
    if (active) {
      if (c == 0) init_tiles<D, P, 1>(t, q_tile, lane);
      const int slot = (c % NST) * KC * P;
      if (c < n_full)
        attend_chunk<D, P, 1, true>(t, k_s + slot, v_s + slot, c * KC,
                                    KC / 16, seq, scale_log2, lane);
      else
        attend_chunk<D, P, 1, false>(t, k_s + slot, v_s + slot, c * KC,
                                     (seq16 - c * KC) / 16, seq, scale_log2,
                                     lane);
    }
    __syncthreads();                // stage c % NST is refilled next
  }
  if (active)
    store_tiles<D, P, 1>(t, q_tile, o + b * so.b + h * so.h, so.s,
                         q0 + warp * 16, seq, lane);
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

Strides strides_of(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <int D>
cudaError_t launch_resident(const void* q, const void* k, const void* v,
                            void* o, const long long* st, int batch,
                            int heads, int seq, int rows_per_block,
                            int sms, cudaStream_t stream) {
  // 8 warps of up to 255 registers; two m-tiles a warp up to D = 64
  constexpr int NWARPS = 8, MT = D <= 64 ? 2 : 1;
  const int set_bytes = static_cast<int>(sizeof(__nv_bfloat16)) * (D + 8) *
                        (rows_per_block + 2 * ((seq + 15) & ~15));
  const bool two_sets = 2 * set_bytes <= MAX_SMEM;
  auto kernel = two_sets ? flash_fwd_bf16_resident<D, NWARPS, MT, 2>
                         : flash_fwd_bf16_resident<D, NWARPS, MT, 1>;
  const int smem = two_sets ? 2 * set_bytes : set_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int splits = (seq + rows_per_block - 1) / rows_per_block;
  const int n_items = batch * heads * splits;
  kernel<<<min(n_items, sms), NWARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      strides_of(st, 0), strides_of(st, 1), strides_of(st, 2),
      strides_of(st, 3), heads, seq, rows_per_block, splits, n_items,
      static_cast<float>(LOG2E / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_ring(const void* q, const void* k, const void* v, void* o,
                        const long long* st, int batch, int heads, int seq,
                        cudaStream_t stream) {
  // two blocks per SM up to D = 64 (<= 128 registers a thread); one at 128
  auto kernel = flash_fwd_bf16_ring<D, RING_STAGES, D <= 64 ? 2 : 1>;
  const int smem = static_cast<int>(sizeof(__nv_bfloat16)) * (D + 8) *
                   (RING_ROWS + 2 * RING_STAGES * KC);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + RING_ROWS - 1) / RING_ROWS, batch * heads);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      strides_of(st, 0), strides_of(st, 1), strides_of(st, 2),
      strides_of(st, 3), heads, seq,
      static_cast<float>(LOG2E / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       const long long* st, int batch, int heads, int seq,
                       cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * ROWS * (3 * D + 4);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + ROWS - 1) / ROWS, batch * heads);
  flash_fwd_f32_kernel<D><<<grid, ROWS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), strides_of(st, 0),
      strides_of(st, 1), strides_of(st, 2), strides_of(st, 3), heads, seq,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* o,
                       const long long* st, int batch, int heads, int seq,
                       int is_bf16, int rows_per_block, int sms,
                       cudaStream_t stream) {
  if (!is_bf16) return launch_f32<D>(q, k, v, o, st, batch, heads, seq, stream);
  if (seq > RESIDENT_STAGES * KC) {
    if (rows_per_block != RING_ROWS) return cudaErrorInvalidValue;
    return launch_ring<D>(q, k, v, o, st, batch, heads, seq, stream);
  }
  if (rows_per_block <= 0 || rows_per_block % 32 != 0 ||
      rows_per_block > RESIDENT_STAGES * KC || sms <= 0)
    return cudaErrorInvalidValue;
  return launch_resident<D>(q, k, v, o, st, batch, heads, seq, rows_per_block,
                            sms, stream);
}

}  // namespace

// q, k, v, o: (batch, heads, seq, head_dim) with the (b, h, s) element
// strides in strides[0..2] (q), [3..5] (k), [6..8] (v), [9..11] (o) and a
// contiguous head dim; bf16 rows 16-byte aligned.  bf16: each block takes
// rows_per_block query rows of one head (a multiple of 16; at most 128 when
// seq > 256), as ops/flash_attention.py::launch_plan decides for a card of
// `sms` SMs, which the resident path's persistent grid fills; fp32 ignores
// both.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int byol_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o,
                                        const long long* strides, int batch,
                                        int heads, int seq, int head_dim,
                                        int is_bf16, int rows_per_block,
                                        int sms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 32:
      err = launch_dim<32>(q, k, v, o, strides, batch, heads, seq, is_bf16,
                           rows_per_block, sms, s);
      break;
    case 64:
      err = launch_dim<64>(q, k, v, o, strides, batch, heads, seq, is_bf16,
                           rows_per_block, sms, s);
      break;
    case 128:
      err = launch_dim<128>(q, k, v, o, strides, batch, heads, seq, is_bf16,
                            rows_per_block, sms, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
