// Label-masked flash-attention backward for Hopper (sm_90a): two kernels.
//
// Replaces the Pallas TPU kernels merlot_reserve_tpu/ops/attention.py
// `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (launched by
// `_flash_backward`). Per (batch b, head h), with lse from the forward and
// delta_i = rowsum(dO_i * O_i) computed before the launch:
//
//   s(i, j)  = (q_i . k_j) * scale, -1e10 where the label mask is false
//   p(i, j)  = exp(s(i, j) - lse_i)          (recomputed, never stored)
//   dp(i, j) = dO_i . v_j
//   ds(i, j) = p(i, j) * (dp(i, j) - delta_i)
//   dq_i = scale * sum_j ds(i, j) k_j        (flash_bwd_dq)
//   dk_j = scale * sum_i ds(i, j) q_i        (flash_bwd_dkv)
//   dv_j = sum_i p(i, j) dO_i                (flash_bwd_dkv)
//
// Keys and queries at index >= L are skipped (p = 0), as in flash_fwd.cu: no
// padding to a block multiple. A row that sees no key has lse = -1e10 in f32
// (the forward's -1e10 + log L rounds to it), so its p is exp(0) = 1 for
// every key: the TPU kernel does the same, and the plain version
// (flash_attention_backward_reference) recomputes p the same way. In the
// model dO is 0 on those rows, so they contribute nothing.
//
// Bound on an H100 at the training joint shape (B=48, L=640, H=12, D=64,
// bf16, the dummy batch's labels): each product over the attended pairs is
// about 26 GFLOP (27 us at 989 TFLOP/s). dq needs three (q.k, dO.v, ds.k)
// and reads q, k, v, dO and writes dq, 236 MB (70 us at 3.35 TB/s); dk/dv
// needs four (q.k and dO.v again, p.dO, ds.q) and moves 283 MB. Both are
// near the ridge, so a kernel must keep p and ds (the L x L matrices) out of
// device memory and run its products on the tensor cores. The design, as in
// flash_fwd.cu: one block owns 64 rows (queries for dq, keys for dk/dv) of
// one (b, h) and walks the other side in 64-wide tiles, double buffered in
// shared memory with cp.async; every product is mma.sync m16n8k16 (bf16 in,
// f32 accumulate) with B fragments from ldmatrix (.trans where the product
// contracts over the tile's rows); p and ds go from the f32 accumulators of
// one product straight into the A fragments of the next, rounded to bf16.
// The block's own 64 rows are loaded once into A-fragment registers,
// staged through the second tile buffer before the loop, so each kernel
// stays under 48 KB of static shared memory.
// What it does not do yet: wgmma, TMA, warp specialisation, skipping tiles
// that the labels mask out entirely, sharing one recompute of p between dq
// and dk/dv. The f32 variants are scalar-FMA kernels (one thread per row,
// its own q/dO or k/v row in shared memory) that exist so the card can be
// checked in f32.
//
// Interface: q, k, v, dO are [B, L, H, 64] read through their (batch, seq,
// head) strides with a unit head-dim stride; lse and delta are contiguous
// f32 [B, H, L]; labels are contiguous int32 [B, L]; dq, dk, dv are
// [B, L, H, 64] contiguous in q's dtype. The launchers return the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrored field for field by _FlashBwdParams in ops/attention.py.
struct FlashBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;            // [B, H, L]
  const float* delta;          // [B, H, L]
  const int32_t* is_valid;     // [B, L]
  const int32_t* segment_ids;  // [B, L]
  void* dq;                    // [B, L, H, D]
  void* dk;
  void* dv;
  int64_t q_strides[3];  // batch, seq, head (elements)
  int64_t k_strides[3];
  int64_t v_strides[3];
  int64_t do_strides[3];
  int32_t batch;
  int32_t seq_len;
  int32_t heads;
  float scale;
};

namespace {

constexpr int kD = 64;     // head dim
constexpr int kRows = 64;  // rows a block owns
constexpr int kTile = 64;  // rows of the other side per shared-memory tile
constexpr int kPad = 8;    // bf16 row padding: a 144-byte row stride spreads reads over all banks
constexpr int kTileF32 = 16;  // rows per tile in the f32 kernels
constexpr int kRowF32 = kD + 1;  // f32 own-row stride: thread r reads bank (r + d) % 32
constexpr float kNegInf = -1e10f;

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses registers; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the row address of
// matrix l / 8 and receives row l / 4, columns 2(l % 4), 2(l % 4) + 1 of each
// (with .trans: rows 2(l % 4), 2(l % 4) + 1 of column l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

typedef __nv_bfloat16 Tile[kTile][kD + kPad];

// 64 rows of one (b, h) into a shared tile; rows past L are zero-filled
// (source size 0) with their addresses clamped to row 0.
__device__ __forceinline__ void load_rows(Tile& dst, const __nv_bfloat16* src, int64_t stride,
                                          int r0, int L, int tid) {
  for (int i = tid; i < kTile * (kD / 8); i += 128) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    const bool in = r0 + r < L;
    cp_async_16(&dst[r][c], src + (in ? r0 + r : 0) * stride + c, in ? 16 : 0);
  }
}

// A fragments of a warp's 16 rows [r_lo, r_lo + 8] x 64 columns of a tile:
// frag[kk] covers columns [16kk, 16kk + 16).
__device__ __forceinline__ void load_a_frags(uint32_t frag[kD / 16][4], const Tile& src, int r_lo,
                                             int t) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    frag[kk][0] = ld_u32(&src[r_lo][c]);
    frag[kk][1] = ld_u32(&src[r_lo + 8][c]);
    frag[kk][2] = ld_u32(&src[r_lo][c + 8]);
    frag[kk][3] = ld_u32(&src[r_lo + 8][c + 8]);
  }
}

// acc[j] = A . B^T with the tile's 64 rows as B's n index: 8 accumulator
// tiles of 8 rows; one ldmatrix gives B fragments for two 16-wide slices of d.
__device__ __forceinline__ void mma_a_bt(float acc[kTile / 8][4], const uint32_t a[kD / 16][4],
                                         const Tile& b, int lane) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < kD / 32; ++kp) {
      uint32_t bf[4];
      ldmatrix_x4(bf, &b[j * 8 + (lane & 7)][kp * 32 + (lane >> 3) * 8]);
      mma_bf16_16816(acc[j], a[2 * kp], bf[0], bf[1]);
      mma_bf16_16816(acc[j], a[2 * kp + 1], bf[2], bf[3]);
    }
  }
}

// out[n] += P . B, where P is given as f32 accumulators over the tile's 64
// rows (p[2kk], p[2kk + 1] = rows [16kk, 16kk + 16) of the contraction) and B
// is the tile itself [rows][d], read through ldmatrix.trans.
__device__ __forceinline__ void mma_p_b(float out[kD / 8][4], const float p[kTile / 8][4],
                                        const Tile& b, int lane) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int np = 0; np < kD / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, &b[kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                              [(2 * np + (lane >> 4)) * 8]);
      mma_bf16_16816(out[2 * np], pa, bf[0], bf[1]);
      mma_bf16_16816(out[2 * np + 1], pa, bf[2], bf[3]);
    }
  }
}

// Writes a warp's 16 rows of a [B, L, H, D] bf16 output from f32 accumulators.
__device__ __forceinline__ void store_rows(void* base, const float acc[kD / 8][4], float mul,
                                           const int row[2], int b, int h, int L, int H, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= L) continue;
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(base) +
                       ((static_cast<int64_t>(b) * L + row[i]) * H + h) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(o + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
    }
  }
}

// dq: 4 warps; warp w owns query rows [16w, 16w + 16) of the block's 64. In
// the m16n8k16 layout lane (g = lane / 4, t = lane % 4) holds rows g and
// g + 8 of its warp's 16, columns 2t, 2t + 1 of each 8-wide tile. Q and dO
// are staged through the second K/V buffer into A-fragment registers; then
// K/V tiles are double buffered with cp.async.
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16_kernel(const FlashBwdParams p) {
  const int L = p.seq_len;
  const int H = p.heads;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  __shared__ __align__(16) Tile sK[2];
  __shared__ __align__(16) Tile sV[2];
  // per key: {1 valid, 0 masked, -1 past L; segment id}
  __shared__ __align__(16) int2 sKLab[2][kTile];

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_strides[0] +
                            h * p.q_strides[2];
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_strides[0] +
                             h * p.do_strides[2];
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_strides[0] +
                            h * p.k_strides[2];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_strides[0] +
                            h * p.v_strides[2];
  const int32_t* valid = p.is_valid + static_cast<int64_t>(b) * L;
  const int32_t* seg = p.segment_ids + static_cast<int64_t>(b) * L;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * L;

  auto load_kv_tile = [&](int k0, int buf) {
    load_rows(sK[buf], kg, p.k_strides[1], k0, L, tid);
    load_rows(sV[buf], vg, p.v_strides[1], k0, L, tid);
    if (tid < kTile) {
      const int j = k0 + tid;
      sKLab[buf][tid] = j < L ? make_int2(valid[j] > 0 ? 1 : 0, seg[j]) : make_int2(-1, 0);
    }
  };

  // stage this block's Q and dO rows in buffer 1, and K/V tile 0 in buffer 0
  load_rows(sK[1], qg, p.q_strides[1], q0, L, tid);
  load_rows(sV[1], dog, p.do_strides[1], q0, L, tid);
  load_kv_tile(0, 0);
  cp_async_commit();

  const int r_lo = warp * 16 + g;  // this lane's rows within the block: r_lo, r_lo + 8
  int q_row[2], q_valid[2], q_seg[2];
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    q_row[i] = q0 + r_lo + 8 * i;
    const bool in = q_row[i] < L;
    q_valid[i] = in ? valid[q_row[i]] : 0;
    q_seg[i] = in ? seg[q_row[i]] : -1;
    lse[i] = in ? p.lse[stat0 + q_row[i]] : 0.f;
    delta[i] = in ? p.delta[stat0 + q_row[i]] : 0.f;
  }

  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[kD / 16][4], doa[kD / 16][4];
  load_a_frags(qa, sK[1], r_lo, t);
  load_a_frags(doa, sV[1], r_lo, t);
  __syncthreads();  // buffer 1 is free for K/V tile 1

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  const int n_tiles = (L + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_kv_tile((it + 1) * kTile, buf ^ 1);  // its buffer was released at the end of it - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
    mma_a_bt(s, qa, sK[buf], lane);    // S = Q K^T
    mma_a_bt(dp, doa, sV[buf], lane);  // dP = dO V^T

    // p = exp(s_masked - lse), then ds = p (dp - delta), in place in s
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const int4 lab = *reinterpret_cast<const int4*>(&sKLab[buf][j * 8 + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int k_state = (e & 1) ? lab.z : lab.x;
        const int k_seg = (e & 1) ? lab.w : lab.y;
        float x = s[j][e] * p.scale;
        if (!(q_valid[i] > 0 && k_state > 0 && q_seg[i] == k_seg)) x = kNegInf;
        const float pe = k_state < 0 ? 0.f : __expf(x - lse[i]);  // keys past L: skipped
        s[j][e] = pe * (dp[j][e] - delta[i]);
      }
    }
    mma_p_b(acc, s, sK[buf], lane);  // dQ += dS K
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  store_rows(p.dq, acc, p.scale, q_row, b, h, L, H, t);
}

// dk/dv: 4 warps; warp w owns key rows [16w, 16w + 16) of the block's 64.
// Everything is transposed against dq: S^T = K Q^T and dP^T = V dO^T, with
// the key rows as the mma's m index and the tile's queries as n. K and V are
// staged through the second Q/dO buffer into A-fragment registers; then
// Q/dO tiles, with each query's labels, lse and delta, are double buffered.
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16_kernel(const FlashBwdParams p) {
  const int L = p.seq_len;
  const int H = p.heads;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  __shared__ __align__(16) Tile sQ[2];
  __shared__ __align__(16) Tile sDO[2];
  // per query: {1 valid, 0 masked, -1 past L; segment id}, and {lse, delta}
  __shared__ __align__(16) int2 sQLab[2][kTile];
  __shared__ __align__(16) float2 sQStat[2][kTile];

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_strides[0] +
                            h * p.q_strides[2];
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_strides[0] +
                             h * p.do_strides[2];
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_strides[0] +
                            h * p.k_strides[2];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_strides[0] +
                            h * p.v_strides[2];
  const int32_t* valid = p.is_valid + static_cast<int64_t>(b) * L;
  const int32_t* seg = p.segment_ids + static_cast<int64_t>(b) * L;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * L;

  auto load_q_tile = [&](int q_start, int buf) {
    load_rows(sQ[buf], qg, p.q_strides[1], q_start, L, tid);
    load_rows(sDO[buf], dog, p.do_strides[1], q_start, L, tid);
    if (tid < kTile) {
      const int i = q_start + tid;
      const bool in = i < L;
      sQLab[buf][tid] = in ? make_int2(valid[i] > 0 ? 1 : 0, seg[i]) : make_int2(-1, 0);
      sQStat[buf][tid] = in ? make_float2(p.lse[stat0 + i], p.delta[stat0 + i])
                            : make_float2(0.f, 0.f);
    }
  };

  // stage this block's K and V rows in buffer 1, and Q/dO tile 0 in buffer 0
  load_rows(sQ[1], kg, p.k_strides[1], k0, L, tid);
  load_rows(sDO[1], vg, p.v_strides[1], k0, L, tid);
  load_q_tile(0, 0);
  cp_async_commit();

  const int r_lo = warp * 16 + g;  // this lane's keys within the block: r_lo, r_lo + 8
  int k_row[2], k_valid[2], k_seg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    k_row[i] = k0 + r_lo + 8 * i;
    const bool in = k_row[i] < L;
    k_valid[i] = in ? valid[k_row[i]] : 0;
    k_seg[i] = in ? seg[k_row[i]] : -1;
  }

  cp_async_wait<0>();
  __syncthreads();
  uint32_t ka[kD / 16][4], va[kD / 16][4];
  load_a_frags(ka, sQ[1], r_lo, t);
  load_a_frags(va, sDO[1], r_lo, t);
  __syncthreads();  // buffer 1 is free for Q/dO tile 1

  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.f;
      dv[n][e] = 0.f;
    }
  }

  const int n_tiles = (L + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_q_tile((it + 1) * kTile, buf ^ 1);  // its buffer was released at the end of it - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
    mma_a_bt(s, ka, sQ[buf], lane);    // S^T = K Q^T
    mma_a_bt(dp, va, sDO[buf], lane);  // dP^T = V dO^T

    // p^T = exp(s^T_masked - lse_q) in s; ds^T = p^T (dp^T - delta_q) in dp
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const int4 lab = *reinterpret_cast<const int4*>(&sQLab[buf][j * 8 + 2 * t]);
      const float4 st = *reinterpret_cast<const float4*>(&sQStat[buf][j * 8 + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int q_state = (e & 1) ? lab.z : lab.x;
        const int q_seg = (e & 1) ? lab.w : lab.y;
        const float q_lse = (e & 1) ? st.z : st.x;
        const float q_delta = (e & 1) ? st.w : st.y;
        float x = s[j][e] * p.scale;
        if (!(q_state > 0 && k_valid[i] > 0 && q_seg == k_seg[i])) x = kNegInf;
        const float pe = q_state < 0 ? 0.f : __expf(x - q_lse);  // queries past L: skipped
        s[j][e] = pe;
        dp[j][e] = pe * (dp[j][e] - q_delta);
      }
    }
    mma_p_b(dv, s, sDO[buf], lane);  // dV += P^T dO
    mma_p_b(dk, dp, sQ[buf], lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  store_rows(p.dk, dk, p.scale, k_row, b, h, L, H, t);
  store_rows(p.dv, dv, 1.f, k_row, b, h, L, H, t);
}

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
  const int32_t* valid = p.is_valid + static_cast<int64_t>(b) * L;
  const int32_t* seg = p.segment_ids + static_cast<int64_t>(b) * L;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * L;

  for (int i = tid; i < kRows * kD; i += kRows) {
    const int r = i / kD;
    const int d = i % kD;
    const bool in = q0 + r < L;
    sQo[r][d] = in ? qg[(q0 + r) * p.q_strides[1] + d] : 0.f;
    sDOo[r][d] = in ? dog[(q0 + r) * p.do_strides[1] + d] : 0.f;
  }
  const bool in = row < L;
  const int qv = in ? valid[row] : 0;
  const int qs = in ? seg[row] : -1;
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
      sKValid[tid] = kin ? valid[j0 + tid] : 0;
      sKSeg[tid] = kin ? seg[j0 + tid] : -1;
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
  const int32_t* valid = p.is_valid + static_cast<int64_t>(b) * L;
  const int32_t* seg = p.segment_ids + static_cast<int64_t>(b) * L;
  const int64_t stat0 = (static_cast<int64_t>(b) * H + h) * L;

  for (int i = tid; i < kRows * kD; i += kRows) {
    const int r = i / kD;
    const int d = i % kD;
    const bool in = k0 + r < L;
    sKo[r][d] = in ? kg[(k0 + r) * p.k_strides[1] + d] : 0.f;
    sVo[r][d] = in ? vg[(k0 + r) * p.v_strides[1] + d] : 0.f;
  }
  const bool in = row < L;
  const int kv = in ? valid[row] : 0;
  const int ks = in ? seg[row] : -1;

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
      sQValid[tid] = qin ? valid[i0 + tid] : 0;
      sQSeg[tid] = qin ? seg[i0 + tid] : -1;
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

dim3 grid_of(const FlashBwdParams* p) {
  return dim3((p->seq_len + kRows - 1) / kRows, p->heads, p->batch);
}

}  // namespace

extern "C" {

// Size of FlashBwdParams, so the Python side can check its ctypes mirror.
size_t flash_bwd_params_size() { return sizeof(FlashBwdParams); }

cudaError_t flash_bwd_dq_bf16(const FlashBwdParams* params, cudaStream_t stream) {
  flash_bwd_dq_bf16_kernel<<<grid_of(params), 128, 0, stream>>>(*params);
  return cudaGetLastError();
}

cudaError_t flash_bwd_dkv_bf16(const FlashBwdParams* params, cudaStream_t stream) {
  flash_bwd_dkv_bf16_kernel<<<grid_of(params), 128, 0, stream>>>(*params);
  return cudaGetLastError();
}

cudaError_t flash_bwd_dq_f32(const FlashBwdParams* params, cudaStream_t stream) {
  flash_bwd_dq_f32_kernel<<<grid_of(params), kRows, 0, stream>>>(*params);
  return cudaGetLastError();
}

cudaError_t flash_bwd_dkv_f32(const FlashBwdParams* params, cudaStream_t stream) {
  flash_bwd_dkv_f32_kernel<<<grid_of(params), kRows, 0, stream>>>(*params);
  return cudaGetLastError();
}

}  // extern "C"
