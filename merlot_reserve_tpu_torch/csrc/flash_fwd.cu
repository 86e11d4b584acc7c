// Label-masked flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel merlot_reserve_tpu/ops/attention.py
// `_flash_kernel` (launched by `_flash_forward`). Per (batch b, head h):
//
//   s(i, j)   = (q_i . k_j) * scale
//   mask(i,j) = valid(i) > 0 && k_valid(j) > 0 && seg(i) == k_seg(j)
//   s(i, j)   = -1e10 where the mask is false (not -inf: a row with no
//               visible key averages V over all L keys, as the dense path does)
//   out_i     = sum_j softmax_j(s(i, .)) v_j,   lse_i = m_i + log l_i
//
// with the online-softmax state (m, l, acc) in f32. The keys carry labels of
// their own (k_valid, k_seg; the queries' own labels for self-attention): a
// ring hop of the sequence-parallel attention scores its local queries
// against another rank's K/V shard, as `_flash_forward`'s k_is_valid /
// k_segment_ids do. Keys at index >= L are skipped (probability exactly 0),
// never scored at -1e10: the TPU kernel padded L to its block size and so
// averaged masked rows over the padded length; this kernel averages them
// over exactly L keys, like the dense path.
//
// Bound on an H100 at the serving shape (B=8, L=640, H=12, D=64, bf16): the
// two products do 4*B*H*L^2*D = 10.07 GFLOP (10.2 us at 989 TFLOP/s) and the
// kernel must move q, k, v and out once, 31.5 MB (9.4 us at 3.35 TB/s), so
// it is bound by the tensor cores, barely. The design keeps the L x L score
// matrix out of device memory entirely: one block owns 64 query rows of one
// (b, h), walks the keys in 64-wide tiles staged in shared memory, and keeps
// scores, probabilities and the running (m, l, acc) in registers. Both
// products run on the tensor cores through mma.sync m16n8k16 (bf16 in, f32
// accumulate), with K and V fragments read by ldmatrix (V through .trans, so
// V needs no transpose); the probabilities are reused from the score
// accumulators as the A operand of the second product. K/V tiles are double
// buffered with cp.async, so the next tile's load overlaps this tile's math.
// The mask costs one 16-byte shared load per pair of keys: the tile's labels
// are staged as {state, segment} per key beside it.
// What it does not do yet: wgmma, TMA, warp specialisation, skipping tiles
// that the labels mask out entirely. The f32 variant is a scalar-FMA kernel
// (one thread per query row) that exists so the card can be checked in f32.
//
// Interface: q, k, v are [B, L, H, 64] read through their (batch, seq, head)
// strides with a unit head-dim stride; the four label arrays are contiguous
// int32 [B, L]; out is [B, L, H, 64] contiguous in q's dtype; lse is
// contiguous f32 [B, H, L].
// The launchers return the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrored field for field by _FlashParams in ops/attention.py.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* is_valid;       // [B, L], the queries'
  const int32_t* segment_ids;    // [B, L]
  const int32_t* k_is_valid;     // [B, L], the keys'
  const int32_t* k_segment_ids;  // [B, L]
  void* out;                     // [B, L, H, D]
  float* lse;                    // [B, H, L]
  int64_t q_strides[3];          // batch, seq, head (elements)
  int64_t k_strides[3];
  int64_t v_strides[3];
  int32_t batch;
  int32_t seq_len;
  int32_t heads;
  float scale;
};

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kPad = 8;       // bf16 row padding: a 144-byte row stride spreads mma reads over all banks
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

// 4 warps; warp w owns query rows [16w, 16w + 16) of the block's tile. In the
// m16n8k16 fragment layout lane (g = lane / 4, t = lane % 4) holds rows g and
// g + 8 of its warp's 16, columns 2t, 2t + 1 of each 8-wide accumulator tile.
// K/V tiles are double-buffered: cp.async brings tile i + 1 into shared
// memory while the tensor cores work on tile i.
__global__ void __launch_bounds__(128) flash_fwd_bf16_kernel(const FlashParams p) {
  const int L = p.seq_len;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockQ][kD + kPad];
  __shared__ __align__(16) __nv_bfloat16 sK[2][kBlockK][kD + kPad];
  __shared__ __align__(16) __nv_bfloat16 sV[2][kBlockK][kD + kPad];
  // per key: {1 valid, 0 masked, -1 past L; segment id}
  __shared__ __align__(16) int2 sKLab[2][kBlockK];

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_strides[0] + h * p.q_strides[2];
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_strides[0] + h * p.k_strides[2];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_strides[0] + h * p.v_strides[2];
  const int32_t* valid = p.is_valid + static_cast<int64_t>(b) * L;
  const int32_t* seg = p.segment_ids + static_cast<int64_t>(b) * L;
  const int32_t* key_valid = p.k_is_valid + static_cast<int64_t>(b) * L;
  const int32_t* key_seg = p.k_segment_ids + static_cast<int64_t>(b) * L;

  // rows past L are zero-filled (source size 0), their addresses clamped to row 0
  auto load_kv_tile = [&](int k0, int buf) {
    for (int i = tid; i < kBlockK * (kD / 8); i += blockDim.x) {
      const int r = i / (kD / 8);
      const int c = (i % (kD / 8)) * 8;
      const bool in = k0 + r < L;
      const int64_t row = in ? k0 + r : 0;
      cp_async_16(&sK[buf][r][c], kg + row * p.k_strides[1] + c, in ? 16 : 0);
      cp_async_16(&sV[buf][r][c], vg + row * p.v_strides[1] + c, in ? 16 : 0);
    }
    if (tid < kBlockK) {
      const int j = k0 + tid;
      sKLab[buf][tid] = j < L ? make_int2(key_valid[j] > 0 ? 1 : 0, key_seg[j]) : make_int2(-1, 0);
    }
  };

  for (int i = tid; i < kBlockQ * (kD / 8); i += blockDim.x) {
    const int r = i / (kD / 8);
    const int c = (i % (kD / 8)) * 8;
    const bool in = q0 + r < L;
    const int64_t row = in ? q0 + r : 0;
    cp_async_16(&sQ[r][c], qg + row * p.q_strides[1] + c, in ? 16 : 0);
  }
  load_kv_tile(0, 0);
  cp_async_commit();

  const int r_lo = warp * 16 + g;  // this lane's rows within the tile: r_lo, r_lo + 8
  int q_row[2], q_valid[2], q_seg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    q_row[i] = q0 + r_lo + 8 * i;
    const bool in = q_row[i] < L;
    q_valid[i] = in ? valid[q_row[i]] : 0;
    q_seg[i] = in ? seg[q_row[i]] : -1;
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-lane partial row sums; reduced over the quad at the end
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  uint32_t qa[kD / 16][4];  // A fragments of Q, one per 16-wide slice of d

  const int n_tiles = (L + kBlockK - 1) / kBlockK;
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_kv_tile((it + 1) * kBlockK, buf ^ 1);  // its buffer was released at the end of it - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        qa[kk][0] = ld_u32(&sQ[r_lo][c]);
        qa[kk][1] = ld_u32(&sQ[r_lo + 8][c]);
        qa[kk][2] = ld_u32(&sQ[r_lo][c + 8]);
        qa[kk][3] = ld_u32(&sQ[r_lo + 8][c + 8]);
      }
    }

    // S = Q K^T for this tile: 8 accumulator tiles of 8 keys; one ldmatrix
    // gives the K fragments of two 16-wide slices of d.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < kD / 32; ++kp) {
        uint32_t kb[4];
        ldmatrix_x4(kb, &sK[buf][j * 8 + (lane & 7)][kp * 32 + (lane >> 3) * 8]);
        mma_bf16_16816(s[j], qa[2 * kp], kb[0], kb[1]);
        mma_bf16_16816(s[j], qa[2 * kp + 1], kb[2], kb[3]);
      }
    }

    // scale, mask, and the running max per row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      const int4 lab = *reinterpret_cast<const int4*>(&sKLab[buf][j * 8 + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int k_state = (e & 1) ? lab.z : lab.x;
        const int k_seg = (e & 1) ? lab.w : lab.y;
        float x = s[j][e] * p.scale;
        if (k_state < 0) {
          x = -INFINITY;  // past the ragged edge: contributes nothing
        } else if (!(q_valid[i] > 0 && k_state > 0 && q_seg[i] == k_seg)) {
          x = kNegInf;
        }
        s[j][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = __expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[j][e] - m[e >> 1]);
        s[j][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: the score accumulators of key tiles 2kk, 2kk+1 are exactly
    // the A fragment of keys [16kk, 16kk + 16); ldmatrix.trans reads V's
    // B fragments from its row-major tile, two 8-wide slices of d at a time.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < kD / 16; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &sV[buf][kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                                     [(2 * np + (lane >> 4)) * 8]);
        mma_bf16_16816(acc[2 * np], pa, vb[0], vb[1]);
        mma_bf16_16816(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  const int H = p.heads;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
    if (q_row[i] < L) {
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.out) +
                            ((static_cast<int64_t>(b) * L + q_row[i]) * H + h) * kD;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
      }
      if (t == 0) p.lse[(static_cast<int64_t>(b) * H + h) * L + q_row[i]] = m[i] + logf(l_safe);
    }
  }
}

// f32: one thread per query row, scalar FMAs, keys streamed through shared
// memory one 64-key tile at a time (every lane reads the same key: broadcast).
__global__ void __launch_bounds__(kBlockQ) flash_fwd_f32_kernel(const FlashParams p) {
  const int L = p.seq_len;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kBlockQ + tid;

  __shared__ __align__(16) float sK[kBlockK][kD];
  __shared__ __align__(16) float sV[kBlockK][kD];
  __shared__ int32_t sKValid[kBlockK];
  __shared__ int32_t sKSeg[kBlockK];

  const float* qg = static_cast<const float*>(p.q) + b * p.q_strides[0] + h * p.q_strides[2];
  const float* kg = static_cast<const float*>(p.k) + b * p.k_strides[0] + h * p.k_strides[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.v_strides[0] + h * p.v_strides[2];
  const int32_t* valid = p.is_valid + static_cast<int64_t>(b) * L;
  const int32_t* seg = p.segment_ids + static_cast<int64_t>(b) * L;
  const int32_t* key_valid = p.k_is_valid + static_cast<int64_t>(b) * L;
  const int32_t* key_seg = p.k_segment_ids + static_cast<int64_t>(b) * L;

  const bool in = row < L;
  float q[kD];
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (in) x = *reinterpret_cast<const float4*>(qg + row * p.q_strides[1] + d);
    q[d] = x.x;
    q[d + 1] = x.y;
    q[d + 2] = x.z;
    q[d + 3] = x.w;
  }
  const int qv = in ? valid[row] : 0;
  const int qs = in ? seg[row] : -1;

  float m = kNegInf;
  float l = 0.f;
  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    __syncthreads();
    for (int i = tid; i < kBlockK * (kD / 4); i += blockDim.x) {
      const int r = i / (kD / 4);
      const int c = (i % (kD / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (k0 + r < L) {
        kv = *reinterpret_cast<const float4*>(kg + (k0 + r) * p.k_strides[1] + c);
        vv = *reinterpret_cast<const float4*>(vg + (k0 + r) * p.v_strides[1] + c);
      }
      *reinterpret_cast<float4*>(&sK[r][c]) = kv;
      *reinterpret_cast<float4*>(&sV[r][c]) = vv;
    }
    if (tid < kBlockK) {
      const bool kin = k0 + tid < L;
      sKValid[tid] = kin ? key_valid[k0 + tid] : 0;
      sKSeg[tid] = kin ? key_seg[k0 + tid] : -1;
    }
    __syncthreads();

    const int n_keys = min(kBlockK, L - k0);  // keys past L are skipped
    for (int j = 0; j < n_keys; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) s = fmaf(q[d], sK[j][d], s);
      s *= p.scale;
      if (!(qv > 0 && sKValid[j] > 0 && qs == sKSeg[j])) s = kNegInf;
      if (s > m) {
        const float corr = expf(m - s);
        l *= corr;
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[d] *= corr;
        m = s;
      }
      const float pe = expf(s - m);
      l += pe;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(pe, sV[j][d], acc[d]);
    }
  }

  if (in) {
    const int H = p.heads;
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = 1.f / l_safe;
    float* orow = static_cast<float*>(p.out) + ((static_cast<int64_t>(b) * L + row) * H + h) * kD;
#pragma unroll
    for (int d = 0; d < kD; d += 4) {
      *reinterpret_cast<float4*>(orow + d) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
    }
    p.lse[(static_cast<int64_t>(b) * H + h) * L + row] = m + logf(l_safe);
  }
}

}  // namespace

extern "C" {

// Size of FlashParams, so the Python side can check its ctypes mirror.
size_t flash_fwd_params_size() { return sizeof(FlashParams); }

cudaError_t flash_fwd_bf16(const FlashParams* params, cudaStream_t stream) {
  const dim3 grid((params->seq_len + kBlockQ - 1) / kBlockQ, params->heads, params->batch);
  flash_fwd_bf16_kernel<<<grid, 128, 0, stream>>>(*params);
  return cudaGetLastError();
}

cudaError_t flash_fwd_f32(const FlashParams* params, cudaStream_t stream) {
  const dim3 grid((params->seq_len + kBlockQ - 1) / kBlockQ, params->heads, params->batch);
  flash_fwd_f32_kernel<<<grid, kBlockQ, 0, stream>>>(*params);
  return cudaGetLastError();
}

}  // extern "C"
