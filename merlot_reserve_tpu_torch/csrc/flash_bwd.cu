// Label-masked flash-attention backward for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of the backward,
// merlot_reserve_tpu/ops/attention.py `_flash_bwd_dq_kernel` (:281) and
// `_flash_bwd_dkv_kernel` (:320), launched by `_flash_backward` (:370). Per
// (batch b, head h), with lse from the forward:
//
//   delta_i  = rowsum(dO_i * O_i)
//   s(i, j)  = (q_i . k_j) * scale, -1e10 where the label mask is false
//   p(i, j)  = exp(s(i, j) - lse_i)          (recomputed, never stored)
//   dp(i, j) = dO_i . v_j
//   ds(i, j) = p(i, j) * (dp(i, j) - delta_i)
//   dq_i = scale * sum_j ds(i, j) k_j
//   dk_j = scale * sum_i ds(i, j) q_i
//   dv_j = sum_i p(i, j) dO_i
//
// The mask is valid_q(i) & valid_k(j) & seg_q(i) == seg_k(j); the keys carry
// labels of their own (k_is_valid, k_segment_ids: a ring hop's shard), which
// default to the queries' in the wrapper. A row that sees no key has
// lse = -1e10 in f32 (the forward's -1e10 + log L rounds to it), so its p
// is exp(0) = 1 for every key, as in the TPU kernels and the plain version
// (flash_attention_backward_reference). In the model dO is 0 on those rows.
//
// bf16, three launches on one stream:
//   flash_bwd_prep: one pass over dO and O writes, per query row, delta,
//     lse * log2(e) and the row's labels ([B, H, Lpad] RowStat, rows past L
//     padded with lse2 = +inf so that their p is 0), and zeroes the f32 dq
//     accumulator [B, H, Lpad, 64] (Lpad = L rounded up to 64; each 64-row
//     tile in the fused pass's fragment order, see add_dq_part).
//   flash_bwd_bf16: the fused pass. A block owns 64 keys per consumer
//     warpgroup (two warpgroups, 128 keys, for L > 64; one for the span
//     tower's L = 16) of one (b, h); TMA loads its K and V once, and one
//     producer thread streams 64-row Q and dO tiles, with their RowStats,
//     through a 3-stage ring of mbarriers. Per tile, with wgmma:
//       S^T = K Q^T and dP^T = V dO^T        (shared-memory operands)
//       mask and exp2 in registers: one FFMA of s with scale * log2(e)
//         against the pre-multiplied lse, then ex2.approx
//       dV += P^T dO, dK += dS^T Q and dQ_part = dS K, with P^T and
//         dS^T staged in shared memory in bf16 as the A operands
//     and dQ_part goes into the f32 accumulator from registers with
//     16-byte reductions (red.global.add.v4.f32), 16 KB per warpgroup and
//     tile, in the accumulator fragments' own order.
//     p and ds are computed once: 5 products instead of the 7 of a split
//     dq / dk-dv design, and one exp per score. The two warpgroups of a
//     block overlap each other's exp and ds with their products.
//   flash_bwd_convert: dq = scale * acc, rounded to bf16 in q's layout.
//
// Tile classes, from warp votes on the tile's 64 query labels and the
// warpgroup's 64 key labels: "full" (every pair attended: no per-element
// test), "empty" (no attended pair and no query row of the tile blind, i.e.
// with lse <= -1e9: skipped; a blind row has p = 1 on every key, so a tile
// holding one is never skipped), else "partial" (the per-element test).
//
// Bound on an H100 at the training joint shape (B 48, L 640, H 12, D 64,
// bf16, the dummy batch's labels): 5 products over the pairs with nonzero p
// (about 26 GFLOP each, 27 us at 989 TFLOP/s) against q, k, v, dO read and
// dq, dk, dv written once (283 MB, 85 us at 3.35 TB/s): about 140 us, by
// operations (chip_smoke.py's `_bwd_bounds(...)["both"]`). What the design
// does against the split kernels it replaces: (1) S, dP, P and dS once per
// score; (2) tile classes skip the mask test or the whole tile; (3) two
// warpgroups per block on one Q/dO stream, loads by TMA behind an
// mbarrier ring instead of each warp re-reading tiles through ldmatrix;
// (4) wgmma in place of mma.sync; (5) delta in a kernel over bf16 dO and O,
// not an einsum over f32 copies. Its cost: dq is summed across key blocks
// in device memory (f32 reductions in L2), 2 x 16 KB per tile pair.
//
// The f32 variants are scalar-FMA kernels (one thread per row, its own
// q/dO or k/v row in shared memory) that exist so the card can be checked in
// f32; they read delta from the wrapper.
//
// Interface: q, k, v, dO are [B, L, H, 64] read through their (batch, seq,
// head) strides with a unit head-dim stride (bf16: through 4-D TMA tensor
// maps built here from those strides); out is contiguous [B, L, H, 64];
// lse and delta are contiguous f32 [B, H, L]; labels are contiguous int32
// [B, L]; dq, dk, dv are [B, L, H, 64] contiguous in q's dtype. The
// launchers return the cudaError_t of the launch.

#include <limits.h>
#include <math.h>

#include "sm90.cuh"

// Mirrored field for field by _FlashBwdParams in ops/attention.py.
struct FlashBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* out;               // [B, L, H, D], contiguous (flash_bwd_prep)
  const float* lse;              // [B, H, L]
  const float* delta;            // [B, H, L] (f32 kernels)
  const int32_t* is_valid;       // [B, L], the queries' labels
  const int32_t* segment_ids;    // [B, L]
  const int32_t* k_is_valid;     // [B, L], the keys' labels
  const int32_t* k_segment_ids;  // [B, L]
  void* stats;                   // [B, H, padded_len] RowStat (bf16)
  float* dq_acc;                 // [B, H, padded_len, D] f32 (bf16)
  void* dq;                      // [B, L, H, D]
  void* dk;
  void* dv;
  int64_t q_strides[3];  // batch, seq, head (elements)
  int64_t k_strides[3];
  int64_t v_strides[3];
  int64_t do_strides[3];
  int32_t batch;
  int32_t seq_len;
  int32_t heads;
  int32_t padded_len;  // seq_len rounded up to a multiple of 64
  float scale;
};

namespace {

constexpr int kD = 64;     // head dim
constexpr int kRows = 64;  // rows of a tile, of a warpgroup's keys, of an f32 block
constexpr int kTileBytes = kRows * kD * 2;  // one bf16 64 x 64 tile
constexpr int kTileF32 = 16;      // rows per tile in the f32 kernels
constexpr int kRowF32 = kD + 1;   // f32 own-row stride: thread r reads bank (r + d) % 32
constexpr float kNegInf = -1e10f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kBlindLse2 = -1e9f;  // lse * log2(e) below this: a row that sees no key

// One query row of one (b, h), as the fused pass reads it.
struct __align__(16) RowStat {
  float lse2;   // lse * log2(e); +inf past L
  float delta;  // rowsum(dO * O); 0 past L
  int32_t valid;
  int32_t seg;
};

// --- bf16: preprocess, fused pass, convert -----------------------------------

// Eight threads per query row (b, l, h), h fastest, over l < padded_len:
// delta from 16 bytes of dO and of O each, the row's RowStat, and its 64
// floats of the dq accumulator zeroed.
__global__ void __launch_bounds__(256) flash_bwd_prep_kernel(const FlashBwdParams p) {
  const int L = p.seq_len;
  const int H = p.heads;
  const int Lp = p.padded_len;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 3;
  if (row >= static_cast<int64_t>(p.batch) * Lp * H) return;  // whole groups of 8 leave together
  const unsigned group = 0xFFu << (threadIdx.x & 24);
  const int part = threadIdx.x & 7;
  const int h = static_cast<int>(row % H);
  const int l = static_cast<int>((row / H) % Lp);
  const int b = static_cast<int>(row / (static_cast<int64_t>(H) * Lp));
  const bool in = l < L;

  float dsum = 0.f;
  if (in) {
    const uint4 a = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_strides[0] + l * p.do_strides[1] +
        h * p.do_strides[2] + part * 8);
    const uint4 o = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.out) +
        ((static_cast<int64_t>(b) * L + l) * H + h) * kD + part * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]);
      const float2 y = __bfloat1622float2(o2[i]);
      dsum = fmaf(x.x, y.x, dsum);
      dsum = fmaf(x.y, y.y, dsum);
    }
  }
  dsum += __shfl_xor_sync(group, dsum, 4);
  dsum += __shfl_xor_sync(group, dsum, 2);
  dsum += __shfl_xor_sync(group, dsum, 1);

  const int64_t srow = (static_cast<int64_t>(b) * H + h) * Lp + l;
  float4* acc = reinterpret_cast<float4*>(p.dq_acc + srow * kD + part * 8);
  acc[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  acc[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (part == 0) {
    RowStat r = {INFINITY, 0.f, 0, 0};  // past L: p = exp2(-inf) = 0
    if (in) {
      const int64_t lab = static_cast<int64_t>(b) * L + l;
      r.lse2 = __fmul_rn(p.lse[(static_cast<int64_t>(b) * H + h) * L + l], kLog2e);
      r.delta = dsum;
      r.valid = p.is_valid[lab] > 0 ? 1 : 0;
      r.seg = p.segment_ids[lab];
    }
    static_cast<RowStat*>(p.stats)[srow] = r;
  }
}

// Q/dO stages: with two consumer warpgroups three, so that the loads run
// ahead of a warpgroup that lags the other; with one (L <= 64: a single
// tile) two, so that two blocks fit on an SM.
template <int NWG>
constexpr int kStages = NWG == 1 ? 2 : 3;

template <int NWG>
struct BwdSmem {
  __nv_bfloat16 k[NWG][kRows * kD];  // each warpgroup's 64 keys, 128-byte swizzled
  __nv_bfloat16 v[NWG][kRows * kD];
  __nv_bfloat16 q[kStages<NWG>][kRows * kD];
  __nv_bfloat16 dout[kStages<NWG>][kRows * kD];
  __nv_bfloat16 pt[NWG][kRows * kD];  // P^T of each warpgroup, [key][query]
  __nv_bfloat16 ds[NWG][kRows * kD];  // dS^T of each warpgroup, [key][query]
  RowStat stat[kStages<NWG>][kRows];
  uint64_t full[kStages<NWG>];
  uint64_t empty[kStages<NWG>];
  uint64_t kv_full;
};

// A warpgroup's 64 keys as each of its warps votes them.
struct KeyLabels {
  bool all;   // every key valid and before L
  bool any;   // some key valid
  bool idle;  // no key before L
  int lo, hi;  // the valid keys' segment ids span [lo, hi]
};

enum TileClass { kSkip, kPartial, kFull };

// The class of one tile for one warpgroup, the same in every warp: kSkip
// when no pair is attended and no row is blind (every p is 0), kFull when
// every pair is attended.
__device__ __forceinline__ TileClass tile_class(const RowStat* st, int lane, const KeyLabels& kl) {
  const RowStat ra = st[lane], rb = st[lane + 32];
  const bool qa = ra.valid > 0, qb = rb.valid > 0;
  const bool blind = __any_sync(~0u, ra.lse2 < kBlindLse2 || rb.lse2 < kBlindLse2);
  const bool q_all = __all_sync(~0u, qa && qb);
  const bool q_any = __any_sync(~0u, qa || qb);
  const int lo = __reduce_min_sync(~0u, min(qa ? ra.seg : INT_MAX, qb ? rb.seg : INT_MAX));
  const int hi = __reduce_max_sync(~0u, max(qa ? ra.seg : INT_MIN, qb ? rb.seg : INT_MIN));
  if (kl.idle) return kSkip;
  if (q_all && kl.all && lo == hi && kl.lo == kl.hi && lo == kl.lo) return kFull;
  const bool none = !(q_any && kl.any) || hi < kl.lo || kl.hi < lo;
  return none && !blind ? kSkip : kPartial;
}

// S^T = K Q^T and dP^T = V dO^T for one stage, as two wgmma groups.
__device__ __forceinline__ void issue_s_dp(float (&sc)[32], float (&dp)[32], uint64_t desc_k,
                                           uint64_t desc_v, const void* q, const void* dout) {
  const uint64_t desc_q = desc_sw128(q);
  const uint64_t desc_do = desc_sw128(dout);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss<0, 0>(sc, desc_k + kk * kKStepKMajor, desc_q + kk * kKStepKMajor, kk);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss<0, 0>(dp, desc_v + kk * kKStepKMajor, desc_do + kk * kKStepKMajor, kk);
  wgmma_commit();
}

// A value the compiler can see is the same in every lane of the warp (a
// branch on it around wgmma is then not divergent).
__device__ __forceinline__ int uniform(int x) { return __shfl_sync(~0u, x, 0); }

// dV (+)= P^T dO, dK (+)= dS^T Q and dQ_part = dS K for one stage, as one
// group (dV and dK start over unless `accumulate`). P^T and dS^T are
// [key][query] tiles in shared memory, read K-major as the A of dV and dK
// and MN-major (as dS) as the A of dQ_part.
__device__ __forceinline__ void issue_products(float (&dv)[32], float (&dk)[32], float (&dq)[32],
                                               uint64_t desc_pt, uint64_t desc_ds,
                                               uint64_t desc_k, const void* q, const void* dout,
                                               int accumulate) {
  const uint64_t desc_q = desc_sw128(q);
  const uint64_t desc_do = desc_sw128(dout);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss<0, 1>(dv, desc_pt + kk * kKStepKMajor, desc_do + kk * kKStepMNMajor,
                   accumulate || kk);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss<0, 1>(dk, desc_ds + kk * kKStepKMajor, desc_q + kk * kKStepMNMajor,
                   accumulate || kk);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss<1, 1>(dq, desc_ds + kk * kKStepMNMajor, desc_k + kk * kKStepMNMajor, kk);
  wgmma_commit();
}

// Once tile t's products are done: release its stage, and add dQ_part into
// the f32 accumulator from registers, 16 bytes a lane (red.global.add.v4.f32):
// the accumulator's 64 x 64 tile is stored in this fragment order, float4
// number (4j + w) 32 + lane of the tile holding registers 4j .. 4j + 3 of
// lane `lane` of warp w, so that each warp instruction adds 512 contiguous
// bytes (flash_bwd_convert_kernel reads it back).
__device__ __forceinline__ void add_dq_part(const float (&dq)[32], float* dq_tile, int wwarp,
                                            int lane) {
  float4* dst = reinterpret_cast<float4*>(dq_tile) + wwarp * 32 + lane;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    atomicAdd(dst + j * 128, make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]));
  }
}

// The fused pass. Warps 0 .. 4 NWG - 1 are NWG consumer warpgroups, the last
// warp the producer. In each consumer warpgroup warp w holds keys
// [16w, 16w + 16) of its 64 as the m index of every product; lane (g =
// lane / 4, t = lane % 4) holds keys 16w + g and 16w + g + 8, and of each
// 8-wide n block columns 2t and 2t + 1: accumulator register 4j + 2i + c is
// (key 16w + g + 8i, column 8j + 2t + c).
template <int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, NWG == 1 ? 2 : 1)
    flash_bwd_bf16_kernel(const FlashBwdParams p, const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do) {
  extern __shared__ char smem_raw[];
  BwdSmem<NWG>& sm = *reinterpret_cast<BwdSmem<NWG>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int L = p.seq_len;
  const int H = p.heads;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * NWG * kRows;
  const int n_tiles = (L + kRows - 1) / kRows;
  const int warp = uniform(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * p.padded_len;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages<NWG>; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    mbar_init(&sm.kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // producer: one thread issues every copy
    if (lane == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * NWG * kTileBytes);
      for (int w = 0; w < NWG; ++w) {  // rows past L arrive as zeros
        tma_tile(sm.k[w], &tm_k, h, k0 + w * kRows, b, &sm.kv_full);
        tma_tile(sm.v[w], &tm_v, h, k0 + w * kRows, b, &sm.kv_full);
      }
      const RowStat* stats = static_cast<const RowStat*>(p.stats) + stat0;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages<NWG>;
        if (t >= kStages<NWG>) mbar_wait(&sm.empty[s], ((t / kStages<NWG>) - 1) & 1);
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes + kRows * sizeof(RowStat));
        tma_tile(sm.q[s], &tm_q, h, t * kRows, b, &sm.full[s]);
        tma_tile(sm.dout[s], &tm_do, h, t * kRows, b, &sm.full[s]);
        bulk_load(sm.stat[s], stats + t * kRows, kRows * sizeof(RowStat), &sm.full[s]);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int wwarp = warp & 3;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int kbase = k0 + wg * kRows;
  const int32_t* kvalid = p.k_is_valid + static_cast<int64_t>(b) * L;
  const int32_t* kseg = p.k_segment_ids + static_cast<int64_t>(b) * L;

  // this lane's two keys, and the warpgroup's 64 keys as each warp votes them
  int key[2], k_sg[2];
  bool k_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = kbase + 16 * wwarp + g + 8 * i;
    k_ok[i] = key[i] < L && kvalid[key[i]] > 0;
    k_sg[i] = key[i] < L ? kseg[key[i]] : 0;
  }
  KeyLabels kl;
  {
    const int ka = kbase + lane, kb = kbase + lane + 32;
    const bool oka = ka < L && kvalid[ka] > 0, okb = kb < L && kvalid[kb] > 0;
    kl.all = __all_sync(~0u, oka && okb);
    kl.any = __any_sync(~0u, oka || okb);
    kl.idle = kbase >= L;  // a last block's second warpgroup may have no key
    kl.lo = __reduce_min_sync(~0u, min(oka ? kseg[ka] : INT_MAX, okb ? kseg[kb] : INT_MAX));
    kl.hi = __reduce_max_sync(~0u, max(oka ? kseg[ka] : INT_MIN, okb ? kseg[kb] : INT_MIN));
  }

  const float sl2e = p.scale * kLog2e;
  const float neg2 = __fmul_rn(kNegInf, kLog2e);  // as flash_bwd_prep rounds lse2 = -1e10 * log2(e)
  const uint64_t desc_k = desc_sw128(sm.k[wg]);
  const uint64_t desc_v = desc_sw128(sm.v[wg]);
  const uint64_t desc_pt = desc_sw128(sm.pt[wg]);
  const uint64_t desc_ds = desc_sw128(sm.ds[wg]);
  float* dq_acc = p.dq_acc + stat0 * kD;
  float dk[32], dv[32], sc[32], dp[32], dq[32];

  // Per live tile: S^T, dP^T; P^T while dP^T is in flight; dS^T; both to
  // shared memory; the three products; dQ_part out. The accumulators are
  // written by wgmma alone (p and ds go to registers of their own, dV and
  // dK start from the first live tile's products), so that ptxas need not
  // serialize the wgmma around them.
  mbar_wait(&sm.kv_full, 0);
  int n_done = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages<NWG>;
    mbar_wait(&sm.full[s], (t / kStages<NWG>) & 1);
    const RowStat* st = sm.stat[s];
    const int cls = uniform(tile_class(st, lane, kl));
    if (cls == kSkip) {  // every p of the tile is 0
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[s]);
      continue;
    }
    issue_s_dp(sc, dp, desc_k, desc_v, sm.q[s], sm.dout[s]);

    float pv[32];  // P^T
    wgmma_wait<1>();
    fence_acc(sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const RowStat r = st[8 * j + 2 * t4 + c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i + c;
          if (cls == kFull) {
            pv[e] = ex2(fmaf(sc[e], sl2e, -r.lse2));
          } else {
            const bool att = k_ok[i] && r.valid > 0 && r.seg == k_sg[i];
            pv[e] = ex2(att ? fmaf(sc[e], sl2e, -r.lse2) : __fsub_rn(neg2, r.lse2));
          }
        }
      }
    }
    // P^T and dS^T = P^T (dP^T - delta) to shared memory in bf16, as the
    // products' A operands
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 delta = make_float2(st[8 * j + 2 * t4].delta, st[8 * j + 2 * t4 + 1].delta);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = 4 * j + 2 * i, row = 16 * wwarp + g + 8 * i, col = 8 * j + 2 * t4;
        st_sw128(sm.pt[wg], row, col, pack_bf16(pv[e], pv[e + 1]));
        st_sw128(sm.ds[wg], row, col, pack_bf16(pv[e] * (dp[e] - delta.x),
                                                 pv[e + 1] * (dp[e + 1] - delta.y)));
      }
    }
    fence_async_smem();
    bar_sync(1 + wg, 128);

    issue_products(dv, dk, dq, desc_pt, desc_ds, desc_k, sm.q[s], sm.dout[s], n_done > 0);
    wgmma_wait<0>();
    fence_acc(dv);
    fence_acc(dk);
    fence_acc(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
    add_dq_part(dq, dq_acc + static_cast<int64_t>(t) * kRows * kD, wwarp, lane);
    ++n_done;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= L) continue;
    const int64_t off = ((static_cast<int64_t>(b) * L + key[i]) * H + h) * kD;
    __nv_bfloat16* ok = static_cast<__nv_bfloat16*>(p.dk) + off;
    __nv_bfloat16* ov = static_cast<__nv_bfloat16*>(p.dv) + off;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = 4 * j + 2 * i;
      const bool any = n_done > 0;  // else no product ran: every p of these keys is 0
      *reinterpret_cast<uint32_t*>(ok + 8 * j + 2 * t4) =
          pack_bf16(any ? dk[e] * p.scale : 0.f, any ? dk[e + 1] * p.scale : 0.f);
      *reinterpret_cast<uint32_t*>(ov + 8 * j + 2 * t4) =
          pack_bf16(any ? dv[e] : 0.f, any ? dv[e + 1] : 0.f);
    }
  }
}

// dq [B, L, H, D] bf16 = scale * acc; one block per 64-row tile (b, h,
// query tile) of the accumulator, which is in add_dq_part's fragment order
// (float4 (4j + w) 32 + lane: row 16w + lane / 4 and that + 8, columns
// 8j + 2 (lane % 4) + {0, 1}). The tile is read in 16-byte loads into shared
// memory as rows, and written as rows of 128 bytes; the 16-row groups past L
// (three of four at the span tower's L = 16) are not read.
__global__ void __launch_bounds__(256) flash_bwd_convert_kernel(const FlashBwdParams p) {
  const int L = p.seq_len;
  const int H = p.heads;
  const int n_tiles = p.padded_len / kRows;
  const int qt = static_cast<int>(blockIdx.x % n_tiles);
  const int h = static_cast<int>((blockIdx.x / n_tiles) % H);
  const int b = static_cast<int>(blockIdx.x / (static_cast<unsigned>(n_tiles) * H));
  const int rows = min(kRows, L - qt * kRows);
  __shared__ float tile[kRows][kD + 1];  // row stride 65: scattered writes spread over banks

  const float4* src = reinterpret_cast<const float4*>(
      p.dq_acc + ((static_cast<int64_t>(b) * H + h) * p.padded_len + qt * kRows) * kD);
  for (int f = threadIdx.x; f < kRows * kD / 4; f += blockDim.x) {
    const int w = (f >> 5) & 3;
    if (16 * w >= rows) continue;
    const int j = f >> 7, lane = f & 31;
    const int r = 16 * w + (lane >> 2), c = 8 * j + 2 * (lane & 3);
    const float4 x = src[f];
    tile[r][c] = x.x;
    tile[r][c + 1] = x.y;
    tile[r + 8][c] = x.z;
    tile[r + 8][c + 1] = x.w;
  }
  __syncthreads();
  const float s = p.scale;
  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.dq);
  for (int f = threadIdx.x; f < rows * (kD / 8); f += blockDim.x) {  // 8 columns a thread
    const int r = f >> 3, c = 8 * (f & 7);
    const uint4 o = make_uint4(pack_bf16(tile[r][c] * s, tile[r][c + 1] * s),
                               pack_bf16(tile[r][c + 2] * s, tile[r][c + 3] * s),
                               pack_bf16(tile[r][c + 4] * s, tile[r][c + 5] * s),
                               pack_bf16(tile[r][c + 6] * s, tile[r][c + 7] * s));
    *reinterpret_cast<uint4*>(
        dq + ((static_cast<int64_t>(b) * L + qt * kRows + r) * H + h) * kD + c) = o;
  }
}

// --- f32 ---------------------------------------------------------------------

// f32 dq: one thread per query row; the block's q and dO rows sit in shared
// memory, keys stream through it kTileF32 at a time (every lane reads the
// same key: broadcast).
__global__ void __launch_bounds__(kRows) flash_bwd_dq_f32_kernel(const FlashBwdParams p) {
  const int L = p.seq_len;
  const int H = p.heads;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kRows;
  const int row = q0 + tid;

  __shared__ float sQo[kRows][kRowF32];
  __shared__ float sDOo[kRows][kRowF32];
  __shared__ __align__(16) float sK[kTileF32][kD];
  __shared__ __align__(16) float sV[kTileF32][kD];
  __shared__ int32_t sKValid[kTileF32];
  __shared__ int32_t sKSeg[kTileF32];

  const float* qg = static_cast<const float*>(p.q) + b * p.q_strides[0] + h * p.q_strides[2];
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_strides[0] + h * p.do_strides[2];
  const float* kg = static_cast<const float*>(p.k) + b * p.k_strides[0] + h * p.k_strides[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.v_strides[0] + h * p.v_strides[2];
  const int64_t lab0 = static_cast<int64_t>(b) * L;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * L;

  for (int i = tid; i < kRows * kD; i += kRows) {
    const int r = i / kD;
    const int d = i % kD;
    const bool in = q0 + r < L;
    sQo[r][d] = in ? qg[(q0 + r) * p.q_strides[1] + d] : 0.f;
    sDOo[r][d] = in ? dog[(q0 + r) * p.do_strides[1] + d] : 0.f;
  }
  const bool in = row < L;
  const int qv = in ? p.is_valid[lab0 + row] : 0;
  const int qs = in ? p.segment_ids[lab0 + row] : -1;
  const float lse = in ? p.lse[stat0 + row] : 0.f;
  const float delta = in ? p.delta[stat0 + row] : 0.f;

  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;

  for (int j0 = 0; j0 < L; j0 += kTileF32) {
    __syncthreads();
    for (int i = tid; i < kTileF32 * kD; i += kRows) {
      const int r = i / kD;
      const int d = i % kD;
      const bool kin = j0 + r < L;
      sK[r][d] = kin ? kg[(j0 + r) * p.k_strides[1] + d] : 0.f;
      sV[r][d] = kin ? vg[(j0 + r) * p.v_strides[1] + d] : 0.f;
    }
    if (tid < kTileF32) {
      const bool kin = j0 + tid < L;
      sKValid[tid] = kin ? p.k_is_valid[lab0 + j0 + tid] : 0;
      sKSeg[tid] = kin ? p.k_segment_ids[lab0 + j0 + tid] : -1;
    }
    __syncthreads();

    const int n_keys = min(kTileF32, L - j0);  // keys past L are skipped
    for (int j = 0; j < n_keys; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        s = fmaf(sQo[tid][d], sK[j][d], s);
        dp = fmaf(sDOo[tid][d], sV[j][d], dp);
      }
      s *= p.scale;
      if (!(qv > 0 && sKValid[j] > 0 && qs == sKSeg[j])) s = kNegInf;
      const float ds = expf(s - lse) * (dp - delta);
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(ds, sK[j][d], acc[d]);
    }
  }

  if (in) {
    float* o = static_cast<float*>(p.dq) + ((static_cast<int64_t>(b) * L + row) * H + h) * kD;
#pragma unroll
    for (int d = 0; d < kD; d += 4) {
      *reinterpret_cast<float4*>(o + d) = make_float4(acc[d] * p.scale, acc[d + 1] * p.scale,
                                                      acc[d + 2] * p.scale, acc[d + 3] * p.scale);
    }
  }
}

// f32 dk/dv: one thread per key row; the block's k and v rows sit in shared
// memory, queries (with their labels, lse and delta) stream through it.
__global__ void __launch_bounds__(kRows) flash_bwd_dkv_f32_kernel(const FlashBwdParams p) {
  const int L = p.seq_len;
  const int H = p.heads;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kRows;
  const int row = k0 + tid;

  __shared__ float sKo[kRows][kRowF32];
  __shared__ float sVo[kRows][kRowF32];
  __shared__ __align__(16) float sQ[kTileF32][kD];
  __shared__ __align__(16) float sDO[kTileF32][kD];
  __shared__ int32_t sQValid[kTileF32];
  __shared__ int32_t sQSeg[kTileF32];
  __shared__ float sQLse[kTileF32];
  __shared__ float sQDelta[kTileF32];

  const float* qg = static_cast<const float*>(p.q) + b * p.q_strides[0] + h * p.q_strides[2];
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_strides[0] + h * p.do_strides[2];
  const float* kg = static_cast<const float*>(p.k) + b * p.k_strides[0] + h * p.k_strides[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.v_strides[0] + h * p.v_strides[2];
  const int64_t lab0 = static_cast<int64_t>(b) * L;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * L;

  for (int i = tid; i < kRows * kD; i += kRows) {
    const int r = i / kD;
    const int d = i % kD;
    const bool in = k0 + r < L;
    sKo[r][d] = in ? kg[(k0 + r) * p.k_strides[1] + d] : 0.f;
    sVo[r][d] = in ? vg[(k0 + r) * p.v_strides[1] + d] : 0.f;
  }
  const bool in = row < L;
  const int kv = in ? p.k_is_valid[lab0 + row] : 0;
  const int ks = in ? p.k_segment_ids[lab0 + row] : -1;

  float dk[kD], dv[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    dk[d] = 0.f;
    dv[d] = 0.f;
  }

  for (int i0 = 0; i0 < L; i0 += kTileF32) {
    __syncthreads();
    for (int i = tid; i < kTileF32 * kD; i += kRows) {
      const int r = i / kD;
      const int d = i % kD;
      const bool qin = i0 + r < L;
      sQ[r][d] = qin ? qg[(i0 + r) * p.q_strides[1] + d] : 0.f;
      sDO[r][d] = qin ? dog[(i0 + r) * p.do_strides[1] + d] : 0.f;
    }
    if (tid < kTileF32) {
      const bool qin = i0 + tid < L;
      sQValid[tid] = qin ? p.is_valid[lab0 + i0 + tid] : 0;
      sQSeg[tid] = qin ? p.segment_ids[lab0 + i0 + tid] : -1;
      sQLse[tid] = qin ? p.lse[stat0 + i0 + tid] : 0.f;
      sQDelta[tid] = qin ? p.delta[stat0 + i0 + tid] : 0.f;
    }
    __syncthreads();

    const int n_q = min(kTileF32, L - i0);  // queries past L are skipped
    for (int i = 0; i < n_q; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        s = fmaf(sQ[i][d], sKo[tid][d], s);
        dp = fmaf(sDO[i][d], sVo[tid][d], dp);
      }
      s *= p.scale;
      if (!(sQValid[i] > 0 && kv > 0 && sQSeg[i] == ks)) s = kNegInf;
      const float pe = expf(s - sQLse[i]);
      const float ds = pe * (dp - sQDelta[i]);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        dv[d] = fmaf(pe, sDO[i][d], dv[d]);
        dk[d] = fmaf(ds, sQ[i][d], dk[d]);
      }
    }
  }

  if (in) {
    const int64_t off = ((static_cast<int64_t>(b) * L + row) * H + h) * kD;
    float* ok = static_cast<float*>(p.dk) + off;
    float* ov = static_cast<float*>(p.dv) + off;
#pragma unroll
    for (int d = 0; d < kD; d += 4) {
      *reinterpret_cast<float4*>(ok + d) = make_float4(dk[d] * p.scale, dk[d + 1] * p.scale,
                                                       dk[d + 2] * p.scale, dk[d + 3] * p.scale);
      *reinterpret_cast<float4*>(ov + d) = make_float4(dv[d], dv[d + 1], dv[d + 2], dv[d + 3]);
    }
  }
}

// --- host side ---------------------------------------------------------------

template <int NWG>
cudaError_t launch_fused(const FlashBwdParams* p, const CUtensorMap (&maps)[4],
                         cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(BwdSmem<NWG>)) + 1024;  // + room to align to 1024
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_bf16_kernel<NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p->seq_len + NWG * kRows - 1) / (NWG * kRows), p->heads, p->batch);
  flash_bwd_bf16_kernel<NWG>
      <<<grid, 128 * NWG + 32, smem, stream>>>(*p, maps[0], maps[1], maps[2], maps[3]);
  return cudaGetLastError();
}

unsigned blocks_of(int64_t threads) { return static_cast<unsigned>((threads + 255) / 256); }

dim3 grid_f32(const FlashBwdParams* p) {
  return dim3((p->seq_len + kRows - 1) / kRows, p->heads, p->batch);
}

}  // namespace

extern "C" {

// Size of FlashBwdParams, so the Python side can check its ctypes mirror.
size_t flash_bwd_params_size() { return sizeof(FlashBwdParams); }

// Dynamic shared memory of the fused pass with nwg consumer warpgroups.
size_t flash_bwd_smem_bytes(int nwg) {
  return (nwg == 1 ? sizeof(BwdSmem<1>) : sizeof(BwdSmem<2>)) + 1024;
}

cudaError_t flash_bwd_prep(const FlashBwdParams* p, cudaStream_t stream) {
  const int64_t threads = 8LL * p->batch * p->padded_len * p->heads;
  flash_bwd_prep_kernel<<<blocks_of(threads), 256, 0, stream>>>(*p);
  return cudaGetLastError();
}

cudaError_t flash_bwd_bf16(const FlashBwdParams* p, cudaStream_t stream) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap maps[4];
  const int B = p->batch, L = p->seq_len, H = p->heads;
  if (!seq_map(encode, &maps[0], p->q, p->q_strides, B, L, H, kRows) ||
      !seq_map(encode, &maps[1], p->k, p->k_strides, B, L, H, kRows) ||
      !seq_map(encode, &maps[2], p->v, p->v_strides, B, L, H, kRows) ||
      !seq_map(encode, &maps[3], p->dout, p->do_strides, B, L, H, kRows)) {
    return cudaErrorInvalidValue;
  }
  return p->seq_len > kRows ? launch_fused<2>(p, maps, stream) : launch_fused<1>(p, maps, stream);
}

cudaError_t flash_bwd_convert(const FlashBwdParams* p, cudaStream_t stream) {
  const int64_t tiles = static_cast<int64_t>(p->batch) * p->heads * (p->padded_len / kRows);
  flash_bwd_convert_kernel<<<static_cast<unsigned>(tiles), 256, 0, stream>>>(*p);
  return cudaGetLastError();
}

cudaError_t flash_bwd_dq_f32(const FlashBwdParams* p, cudaStream_t stream) {
  flash_bwd_dq_f32_kernel<<<grid_f32(p), kRows, 0, stream>>>(*p);
  return cudaGetLastError();
}

cudaError_t flash_bwd_dkv_f32(const FlashBwdParams* p, cudaStream_t stream) {
  flash_bwd_dkv_f32_kernel<<<grid_f32(p), kRows, 0, stream>>>(*p);
  return cudaGetLastError();
}

}  // extern "C"
