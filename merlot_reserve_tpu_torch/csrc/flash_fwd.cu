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
// Bound on an H100: the two products do 4 * B * H * (attended pairs) * 64
// operations; at the long-video shape (B 8, L 2560, H 12, bf16) that is
// about 161 GFLOP, 163 us at 989 TFLOP/s, against 126 MB of q, k, v and out
// (38 us at 3.35 TB/s): bound by the tensor cores. At the serving shape
// (B 8, L 640) 10.07 GFLOP (10.2 us) against 31.5 MB (9.4 us), barely so.
// The design (fwd_core.cuh) keeps the L x L scores out of device memory and
// feeds the tensor cores the way Hopper wants: a persistent block per SM
// owns 128 query rows at a time (two consumer warpgroups of 64 rows and a
// producer warp); Q arrives once by TMA, K and V tiles of 128 keys stream
// through a 4-stage mbarrier ring, 128-byte swizzled; S = Q K^T and
// O += P V run as wgmma (P from registers, V read MN-major), the mask and
// the exp2 online softmax in the accumulator registers in between. The two
// warpgroups overlap each other's softmax with their products; the label
// test is skipped on tiles whose keys and the warp's rows are all valid and
// of one segment. L <= 64 (the span tower) takes one warpgroup of 64 rows,
// two blocks per SM. Not done: overlapping a warpgroup's own softmax with
// its next product, skipping tiles that the labels mask out entirely.
// The f32 variant is a scalar-FMA kernel (one thread per query row) that
// exists so the card can be checked in f32.
//
// Interface: q, k, v are [B, L, H, 64] read through their (batch, seq, head)
// strides with a unit head-dim stride (bf16: through 4-D TMA tensor maps
// built here from those strides); the four label arrays are contiguous
// int32 [B, L]; out is [B, L, H, 64] contiguous in q's dtype; lse is
// contiguous f32 [B, H, L].
// The launchers return the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fwd_core.cuh"

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
constexpr int kBlockQ = 64;   // query rows per block of the f32 kernel
constexpr int kBlockK = 64;   // keys per shared-memory tile of the f32 kernel
constexpr float kNegInf = -1e10f;

// bf16: block b walks the units (query tile, h, b) b, b + grid, ...; the
// units of one (b, h) are neighbours, so the blocks in flight share K and V
// in L2. Warps 0 .. 4 NWG - 1 are the consumer warpgroups, the last warp the
// producer.
template <int NWG, int N>
__global__ void __launch_bounds__(128 * NWG + 32, NWG == 1 ? 2 : 1)
    flash_fwd_bf16_kernel(const FlashParams p, const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v) {
  extern __shared__ char smem_raw[];
  fwd::Smem<NWG, N>& sm = fwd::smem_of<NWG, N>(smem_raw);
  constexpr int kRows = fwd::kWgRows * NWG;
  const int L = p.seq_len;
  const int H = p.heads;
  const int q_tiles = (L + kRows - 1) / kRows;
  const int units = p.batch * H * q_tiles;
  const int n_tiles = (L + N - 1) / N;
  const int warp = __shfl_sync(~0u, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  fwd::init_barriers(sm);

  if (warp == 4 * NWG) {  // producer
    uint32_t c = 0, k = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
      const int qt = u % q_tiles, h = (u / q_tiles) % H, b = u / (q_tiles * H);
      if (lane == 0) {
        if (k > 0) mbar_wait(&sm.q_empty, (k - 1) & 1);
        mbar_expect_tx(&sm.q_full, kRows * fwd::kD * 2);
        tma_tile(sm.q[0], &tm_q, h, qt * kRows, b, &sm.q_full);  // rows past L as zeros
      }
      const int64_t lab = static_cast<int64_t>(b) * L;
      const fwd::TileSource src = {&tm_k, &tm_v, {0, h, 0, b}, 2, p.k_is_valid + lab,
                                   p.k_segment_ids + lab, L, false};
      for (int t = 0; t < n_tiles; ++t, ++c) {
        fwd::produce_tile<NWG, N, false>(sm, c, src, t * N, lane);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int wwarp = warp & 3;
  const uint64_t desc_q = desc_sw128(sm.q[wg]);
  const float sl2e = p.scale * fwd::kLog2e;
  uint32_t c = 0, k = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
    const int qt = u % q_tiles, h = (u / q_tiles) % H, b = u / (q_tiles * H);
    const int row0 = qt * kRows + wg * fwd::kWgRows + 16 * wwarp + (lane >> 2);
    const int64_t lab = static_cast<int64_t>(b) * L;
    fwd::RowState r;
    fwd::start_rows(r, p.is_valid + lab, p.segment_ids + lab, row0, L);
    mbar_wait(&sm.q_full, k & 1);
    fwd::consume_tiles<NWG, N>(sm, c, n_tiles, desc_q, r, sl2e, lane);
    c += n_tiles;
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.q_empty);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + ((lab + row0) * H + h) * kD;
    float* lse = p.lse + (static_cast<int64_t>(b) * H + h) * L + row0;
    fwd::finish_rows(r, row0, L, out, static_cast<int64_t>(H) * kD, lse, lane);
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

// The grid: one block per unit, at most as many as are resident at once
// (asked of the occupancy calculator once per device).
template <int NWG, int N>
cudaError_t launch_bf16(const FlashParams* p, cudaStream_t stream) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int B = p->batch, L = p->seq_len, H = p->heads;
  constexpr int kRows = fwd::kWgRows * NWG;
  CUtensorMap maps[3];
  if (!seq_map(encode, &maps[0], p->q, p->q_strides, B, L, H, kRows) ||
      !seq_map(encode, &maps[1], p->k, p->k_strides, B, L, H, N) ||
      !seq_map(encode, &maps[2], p->v, p->v_strides, B, L, H, N)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_fwd_bf16_kernel<NWG, N>;
  constexpr int threads = 128 * NWG + 32;
  constexpr int smem = fwd::kSmemBytes<NWG, N>;
  constexpr int kDevices = 64;
  static int resident[kDevices] = {};  // blocks resident at once, 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    }
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  const int64_t units = static_cast<int64_t>(B) * H * ((L + kRows - 1) / kRows);
  const int grid = static_cast<int>(units < resident[dev] ? units : resident[dev]);
  kernel<<<grid, threads, smem, stream>>>(*p, maps[0], maps[1], maps[2]);
  return cudaGetLastError();
}

extern "C" {

// Size of FlashParams, so the Python side can check its ctypes mirror.
size_t flash_fwd_params_size() { return sizeof(FlashParams); }

// L <= 64 (the span tower): one warpgroup and one 64-key tile per block,
// two blocks per SM; else two warpgroups and 128-key tiles.
cudaError_t flash_fwd_bf16(const FlashParams* params, cudaStream_t stream) {
  if (params->seq_len <= fwd::kWgRows) return launch_bf16<1, 64>(params, stream);
  return launch_bf16<2, 128>(params, stream);
}

cudaError_t flash_fwd_f32(const FlashParams* params, cudaStream_t stream) {
  const dim3 grid((params->seq_len + kBlockQ - 1) / kBlockQ, params->heads, params->batch);
  flash_fwd_f32_kernel<<<grid, kBlockQ, 0, stream>>>(*params);
  return cudaGetLastError();
}

}  // extern "C"
