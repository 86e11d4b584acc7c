// The bf16 attention forward core for Hopper (sm_90a), shared by
// flash_fwd.cu (one sequence) and ring_fwd.cu (a ring of shards).
//
// A block owns 64 * NWG query rows of one (b, h): NWG consumer warpgroups
// of 64 rows each, and one producer warp. The producer loads the block's Q
// once by TMA, then streams key tiles of N rows of K and V by TMA through a
// ring of kStages stages in shared memory (128-byte swizzled, the layout
// wgmma reads), each with a full and an empty mbarrier. Its 32 lanes also
// stage each tile's key labels beside it ({1 valid, 0 masked, -1 past the
// keys' end; segment id} per key) and whether the whole tile is valid and
// of one segment. Each consumer warpgroup, per tile:
//   S = Q K^T                 wgmma, both operands in shared memory
//   x = S * scale * log2(e)   in the accumulator registers; masked pairs
//                             -1e10 * log2(e), keys past the end -inf (the
//                             label test is skipped when the warp's rows and
//                             the whole tile are valid and of one segment)
//   online softmax            running max m and sum l per row in f32, exp2
//   O += P V                  wgmma with P packed to bf16 in registers as
//                             the A operand and V read MN-major
// and at the end of its rows out = O / l (l = 0 taken as 1) and, in natural
// log, lse = m * ln 2 + log l; a row that sees no key keeps m at the masked
// constant, so its lse is -1e10 + log l (-1e10 in f32), bit for bit what
// the backward's preprocess expects.
//
// Blocks are persistent: each walks units (a query tile, or for the ring a
// query tile's whole walk over n shards) with a stride of the grid, and the
// producer runs ahead into the next unit's loads while the consumers finish
// the last one. Producer and consumers count tiles and units the same way,
// which gives every mbarrier wait its parity.

#pragma once

#include <limits.h>
#include <math.h>

#include "sm90.cuh"

namespace {
namespace fwd {

constexpr int kD = 64;       // head dim
constexpr int kWgRows = 64;  // query rows of a consumer warpgroup
constexpr float kNegInf = -1e10f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kStages = 4;  // K/V tiles in flight (3 timed within 1% of 4 on an H100)

template <int NWG, int N>
struct Smem {
  __nv_bfloat16 q[NWG][kWgRows * kD];  // each warpgroup's 64 query rows
  __nv_bfloat16 k[kStages][N * kD];
  __nv_bfloat16 v[kStages][N * kD];
  int2 lab[kStages][N];          // per key {1 valid, 0 masked, -1 past the end; segment}
  int32_t uniform[kStages];      // 1: every key of the tile valid, before the end, of seg[]
  int32_t seg[kStages];
  uint64_t full[kStages];        // 32 producer arrivals and the tile's bytes
  uint64_t empty[kStages];       // one arrival per consumer warp
  uint64_t q_full;
  uint64_t q_empty;
};

template <int NWG, int N>
constexpr int kSmemBytes = static_cast<int>(sizeof(Smem<NWG, N>)) + 1024;  // + room to align

template <int NWG, int N>
__device__ __forceinline__ Smem<NWG, N>& smem_of(char* raw) {
  return *reinterpret_cast<Smem<NWG, N>*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                           ~static_cast<uintptr_t>(1023));
}

template <int NWG, int N>
__device__ __forceinline__ void init_barriers(Smem<NWG, N>& sm) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], 4 * NWG);
    }
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, 4 * NWG);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Where one step's keys come from: K and V tensor maps with the coordinates
// of key 0 (coordinate `row_dim` counts keys), the keys' labels, and the
// end of the keys (`limit`: keys at or past it get probability 0). `l2`:
// the labels were written by other blocks of this launch, so they are read
// through L2 only.
struct TileSource {
  const CUtensorMap* k;
  const CUtensorMap* v;
  int c[4];
  int row_dim;
  const int32_t* valid;
  const int32_t* seg;
  int limit;
  bool l2;
};

// The producer warp's lanes load tile `c` (key rows k0 .. k0 + N) into its
// stage: K and V by lane 0's TMA, issued first, then the labels by the
// lanes (ordinary loads, which wait for their data); every lane arrives
// after its label stores. With `kAfterStores`, lane 0 first waits until
// every bulk store it issued (from earlier stages) has read its shared
// memory.
template <int NWG, int N, bool kAfterStores>
__device__ __forceinline__ void produce_tile(Smem<NWG, N>& sm, uint32_t c, const TileSource& src,
                                             int k0, int lane) {
  constexpr int S = kStages;
  const int st = c % S;
  if (c >= static_cast<uint32_t>(S)) mbar_wait(&sm.empty[st], ((c / S) - 1) & 1);
  if (lane == 0) {
    if constexpr (kAfterStores) bulk_wait_read();
    mbar_add_tx(&sm.full[st], 2 * N * kD * 2);
    int c4[4] = {src.c[0], src.c[1], src.c[2], src.c[3]};
    c4[src.row_dim] += k0;
    tma_load_4d(sm.k[st], src.k, c4[0], c4[1], c4[2], c4[3], &sm.full[st]);
    tma_load_4d(sm.v[st], src.v, c4[0], c4[1], c4[2], c4[3], &sm.full[st]);
  }
  int ok = 1, lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int r = 0; r < N / 32; ++r) {
    const int j = lane + 32 * r;
    const int key = k0 + j;
    int2 e = make_int2(-1, 0);
    if (key < src.limit) {
      const int vv = src.l2 ? __ldcg(src.valid + key) : __ldg(src.valid + key);
      const int sg = src.l2 ? __ldcg(src.seg + key) : __ldg(src.seg + key);
      e = make_int2(vv > 0 ? 1 : 0, sg);
    }
    sm.lab[st][j] = e;
    ok &= e.x == 1;
    lo = min(lo, e.y);
    hi = max(hi, e.y);
  }
  ok = __all_sync(~0u, ok);
  lo = __reduce_min_sync(~0u, lo);
  hi = __reduce_max_sync(~0u, hi);
  if (lane == 0) {
    sm.uniform[st] = ok && lo == hi;
    sm.seg[st] = lo;
  }
  mbar_arrive(&sm.full[st]);
}

// S = Q K^T for one warpgroup: 64 rows against N keys, k = d in 4 steps.
__device__ __forceinline__ void issue_scores(float (&s)[32], uint64_t desc_q, uint64_t desc_k) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss<0, 0>(s, desc_q + kk * kKStepKMajor, desc_k + kk * kKStepKMajor, kk);
}

__device__ __forceinline__ void issue_scores(float (&s)[64], uint64_t desc_q, uint64_t desc_k) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss_n128(s, desc_q + kk * kKStepKMajor, desc_k + kk * kKStepKMajor, kk);
}

// A consumer thread's two query rows (g and g + 8 of its warp's 16) and
// its running softmax state. In every accumulator, register 4j + 2i + c is
// (row g + 8i, column 8j + 2t + c), with g = lane / 4 and t = lane % 4.
struct RowState {
  int ok[2];   // the row is before the end and valid
  int seg[2];
  float m[2];  // running max of x, in the exp2 domain
  float l[2];  // this lane's part of the row sum
  float acc[32];
};

__device__ __forceinline__ void start_rows(RowState& r, const int32_t* valid, const int32_t* seg,
                                           int row0, int limit) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const bool in = row < limit;
    r.ok[i] = in && valid[row] > 0;
    r.seg[i] = in ? seg[row] : -1;
    r.m[i] = __fmul_rn(kNegInf, kLog2e);
    r.l[i] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) r.acc[e] = 0.f;
}

// The online softmax of one tile's scores s (the accumulator of S = Q K^T,
// complete): scale and mask to x, the new running max, `corr` = exp2(old
// max - new max) (r.l is rescaled by it here, r.acc by the caller), p =
// exp2(x - max) added to r.l and packed to bf16 as the A operand of P V:
// keys [16kk, 16kk + 16) are score registers 8kk .. 8kk + 7.
template <int NWG, int N>
__device__ __forceinline__ void softmax_tile(const Smem<NWG, N>& sm, int st, float (&s)[N / 2],
                                             RowState& r, float sl2e, int lane,
                                             float (&corr)[2], uint32_t (&pa)[N / 16][4]) {
  const int t4 = lane & 3;
  const float neg2 = __fmul_rn(kNegInf, kLog2e);
  const int tile_seg = sm.seg[st];
  const bool fast = __all_sync(~0u, sm.uniform[st] && r.ok[0] && r.ok[1] &&
                                        r.seg[0] == tile_seg && r.seg[1] == tile_seg);
  float mx[2] = {r.m[0], r.m[1]};
  if (fast) {  // every pair attended
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      s[e] *= sl2e;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int4 lab = *reinterpret_cast<const int4*>(&sm.lab[st][8 * j + 2 * t4]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int e = 4 * j + 2 * i + cc;
          const int state = cc ? lab.z : lab.x;
          const int sg = cc ? lab.w : lab.y;
          const float x = r.ok[i] && state > 0 && r.seg[i] == sg ? s[e] * sl2e : neg2;
          s[e] = state < 0 ? -INFINITY : x;
          mx[i] = fmaxf(mx[i], s[e]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(~0u, mx[i], 2));
    corr[i] = ex2(r.m[i] - mx[i]);
    r.m[i] = mx[i];
    r.l[i] *= corr[i];
  }
#pragma unroll
  for (int e = 0; e < N / 2; ++e) {
    const int i = (e >> 1) & 1;
    s[e] = ex2(s[e] - mx[i]);
    r.l[i] += s[e];
  }
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
  }
}

// Tiles c .. c + count - 1 for one consumer warpgroup: per tile S, the
// softmax, P V, then the stage is released. The accumulators are written
// by ordinary code only while no wgmma is in flight, so that ptxas need not
// serialize the wgmma (its C7514 note).
template <int NWG, int N>
__device__ __forceinline__ void consume_tiles(Smem<NWG, N>& sm, uint32_t c, int count,
                                              uint64_t desc_q, RowState& r, float sl2e,
                                              int lane) {
  constexpr int S = kStages;
  float s[N / 2];
  float corr[2];
  uint32_t pa[N / 16][4];
  for (int i = 0; i < count; ++i, ++c) {
    const int st = c % S;
    mbar_wait(&sm.full[st], (c / S) & 1);
    wgmma_fence();
    issue_scores(s, desc_q, desc_sw128(sm.k[st]));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    softmax_tile(sm, st, s, r, sl2e, lane, corr, pa);
#pragma unroll
    for (int e = 0; e < 32; ++e) r.acc[e] *= corr[(e >> 1) & 1];
    const uint64_t desc_v = desc_sw128(sm.v[st]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      wgmma_rs<1>(r.acc, pa[kk], desc_v + kk * kKStepMNMajor, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(r.acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  }
}

// out = acc / l for the rows before `limit` (row0 = the thread's first row,
// `out_row` its element offset in out; rows + 8 are 8 * row_stride further),
// and lse (natural log) when `lse` is given.
__device__ __forceinline__ void finish_rows(RowState& r, int row0, int limit,
                                            __nv_bfloat16* out_row, int64_t row_stride,
                                            float* lse_row, int lane) {
  const int t4 = lane & 3;
  const float neg2 = __fmul_rn(kNegInf, kLog2e);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = r.l[i];
    l += __shfl_xor_sync(~0u, l, 1);
    l += __shfl_xor_sync(~0u, l, 2);
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    if (row0 + 8 * i >= limit) continue;
    __nv_bfloat16* o = out_row + 8 * i * row_stride;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j + 2 * t4) = __floats2bfloat162_rn(
          r.acc[4 * j + 2 * i] * inv, r.acc[4 * j + 2 * i + 1] * inv);
    }
    if (lse_row != nullptr && t4 == 0) {
      // a row that sees no key: m is the masked constant, lse -1e10 + log l
      const float m = r.m[i] == neg2 ? kNegInf : r.m[i] * kLn2;
      lse_row[8 * i] = m + logf(l_safe);
    }
  }
}

}  // namespace fwd
}  // namespace
