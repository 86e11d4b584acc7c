// Sequence-parallel ring attention forward, the whole ring in one kernel,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel merlot_reserve_tpu/ops/ring_attention.py
// `_rdma_ring_kernel` (launched by `ring_flash_attention_rdma`). The L
// positions are split over n ranks, Lloc = L / n rows each. For every rank r
// and (batch b, head h), r's queries attend to all L keys, reached over n
// ring steps: at step s, rank r computes on the K/V shard that started at
// rank (r - s) mod n, and passes that shard on to its right-hand neighbour
// (r + 1) mod n. Mask and softmax are those of flash_fwd.cu: scores are
// masked to -1e10 unless valid(i) && k_valid(j) && seg(i) == k_seg(j), the
// online softmax (m, l, acc) is kept in f32, and out = acc / l with l = 0
// replaced by 1. So a row that sees no key gets the mean of V over all L.
//
// Virtual ranks on one card. The TPU kernel runs one program per chip and
// copies K/V into the neighbour chip's VMEM by remote DMA. Here the n ranks
// are n groups of blocks on one H100. Rank r's two slots of K, V and labels
// live in device memory ([n, 2, B, H, Lloc, 64] and [n, 2, B, H, 2, Lloc]):
// one SM's 228 KB could not hold a shard and its double buffer (at Lloc 640
// one copy of K and V is 160 KB in bf16) the way the TPU's VMEM holds them. A
// "remote copy" is the block of ring member (r, b, h) storing its resident
// shard into slot (s + 1) % 2 of member (r + 1, b, h). The labels travel
// with each (b, h) member's copy, not once per b as in the TPU kernel (whose
// one program per chip moves every head in lockstep): the members of one b
// advance on their own, and a label slot shared by the heads would be
// refilled by a faster head's ring while a slower one still reads it.
//
// Protocol, per ring member, step for step as `_rdma_ring_kernel`:
//   1 <= s < n-1: wait until the right neighbour has freed the slot to fill
//   s < n-1:      copy the resident shard into that slot, then signal ready
//   every s:      online softmax of the rank's Lloc query rows against the
//                 resident shard
//   s < n-1:      wait until the left neighbour's copy into our other slot
//                 is ready
//   s <= n-3:     signal the left neighbour that our resident slot is free
// The resident shard at step 0 is the rank's own rows of k, v and the labels,
// read in place (the TPU kernel first copies them into its slot 0; the wait
// at s = 1 is then for a slot that is free from the start, kept to mirror it).
// Flags are counters, one per (rank, b, h, kind, slot), zeroed by the wrapper
// on the stream before each launch (torch.zeros); a wait is for the count
// that the step number fixes. A writer stores its data, __syncthreads, then
// one thread fences and adds 1 to the flag. A reader has one thread spin on
// an acquire load and fence, then __syncthreads. Every read of a slot goes
// through L2 (cp.async.cg, ld.global.cg), never through the SM's own L1.
//
// Deadlock. A block that spins on a neighbour that is not resident would
// hang the card. The grid is launched with cudaLaunchCooperativeKernel, which
// refuses a grid that cannot be co-resident; the wrapper sizes it to at most
// what the occupancy calculator allows, in a multiple of n. Block c is rank
// c % n and walks the rings (b, h) = c / n, c / n + grid / n, ..., so the n
// members of one ring are handled by n co-resident blocks at the same point
// of their walks. Every spin is bounded by %globaltimer (timeout_ns) and ends
// in __trap(): a protocol fault fails the launch instead of hanging it.
//
// Work and bound. Per member and step: the shard copy (Lloc rows of K and V
// and Lloc labels), then, for each 64-row block of its queries, the tile loop
// of flash_fwd.cu over the shard's Lloc keys (mma.sync m16n8k16 bf16 with f32
// accumulation, ldmatrix, cp.async double buffering). The block's (m, l, acc)
// is carried from step to step in f32 scratch in device memory, in the mma
// fragment layout (36 floats per thread, stored coalesced). The card must at
// least move q and out once, read each shard n times (once per rank that
// computes on it), and write and read n (n - 1) shard copies; the operations
// are those of full attention over the attended pairs. At B 8, L 2560, n 4
// the bytes bound it (about 0.2 ms at 3.35 TB/s). Not done yet: overlapping
// the copy with the compute inside a block (other blocks on the SM overlap
// it), wgmma, TMA, skipping tiles that the labels mask out, and rings across
// several cards (peer pointers and .sys-scope fences).
//
// The f32 variant is scalar (one thread per query row, as in flash_fwd.cu),
// for exact checks on the card.
//
// Interface: q, k, v are [B, L, H, 64] read through their (batch, seq, head)
// strides with a unit head-dim stride; is_valid and segment_ids contiguous
// int32 [B, L]; out [B, L, H, 64] contiguous in q's dtype. The launchers
// return the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrored field for field by _RingParams in ops/ring_attention.py.
struct RingParams {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* is_valid;     // [B, L]
  const int32_t* segment_ids;  // [B, L]
  void* out;                   // [B, L, H, 64]
  void* k_slots;               // [n, 2, B, H, Lloc, 64] in q's dtype
  void* v_slots;               // [n, 2, B, H, Lloc, 64]
  int32_t* lab_slots;          // [n, 2, B, H, 2, Lloc]: validity, segment id
  int32_t* flags;              // [n, B, H, 2, 2]: (ready, capacity) x slot; 0 at launch
  float* scratch;              // [grid, q blocks * state floats per q block]
  int64_t q_strides[3];        // batch, seq, head (elements)
  int64_t k_strides[3];
  int64_t v_strides[3];
  int32_t batch;
  int32_t seq_len;
  int32_t heads;
  int32_t n_ranks;
  int32_t grid;                // blocks launched, a multiple of n_ranks
  float scale;
  int64_t timeout_ns;          // bound of every wait
};

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBlockQ = 64;   // query rows per block of the tile loop
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kPad = 8;       // bf16 row padding: a 144-byte row stride spreads mma reads over all banks
constexpr float kNegInf = -1e10f;
constexpr int kThreadsBf16 = 128;
constexpr int kStateBf16 = (kD / 8) * 4 + 4;  // per thread: acc[8][4], m[2], l[2]
constexpr int kThreadsF32 = kBlockQ;
constexpr int kStateF32 = kD + 2;             // per thread (one row): acc[64], m, l
constexpr int kReady = 0;
constexpr int kCapacity = 1;

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

// 16-byte global -> shared copy through L2 only; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Four 8x8 bf16 matrices from shared memory (see flash_fwd.cu).
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

// ---------------------------------------------------------------------------
// flags
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t global_timer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int32_t ld_acquire(const int32_t* p) {
  int32_t v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int32_t* flag_ptr(const RingParams& p, int rank, int b, int h,
                                             int kind, int slot) {
  return p.flags +
         ((((static_cast<int64_t>(rank) * p.batch + b) * p.heads + h) * 2 + kind) * 2 + slot);
}

// The whole block waits until *flag >= target; traps once timeout_ns passed.
__device__ void wait_flag(const int32_t* flag, int target, int64_t timeout_ns) {
  if (threadIdx.x == 0) {
    if (ld_acquire(flag) < target) {
      const uint64_t t0 = global_timer_ns();
      while (ld_acquire(flag) < target) {
        if (global_timer_ns() - t0 > static_cast<uint64_t>(timeout_ns)) __trap();
        __nanosleep(100);
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// After every thread's stores of the block: make them visible, add 1 to *flag.
__device__ void post_flag(int32_t* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(flag, 1);
  }
}

// ---------------------------------------------------------------------------
// shards and slots
// ---------------------------------------------------------------------------

// Lloc rows of K and V and their labels, read-only.
template <typename T>
struct Shard {
  const T* k;
  const T* v;
  int64_t k_stride;  // elements from one row to the next
  int64_t v_stride;
  const int32_t* valid;
  const int32_t* seg;
};

// One slot of one ring member: Lloc contiguous rows of K and V, its labels.
template <typename T>
struct Slot {
  T* k;
  T* v;
  int32_t* valid;
  int32_t* seg;
};

template <typename T>
__device__ Shard<T> own_shard(const RingParams& p, int rank, int b, int h, int Lloc) {
  const int64_t row0 = static_cast<int64_t>(rank) * Lloc;
  const T* k = static_cast<const T*>(p.k) + b * p.k_strides[0] + row0 * p.k_strides[1] +
               h * p.k_strides[2];
  const T* v = static_cast<const T*>(p.v) + b * p.v_strides[0] + row0 * p.v_strides[1] +
               h * p.v_strides[2];
  const int64_t lab = static_cast<int64_t>(b) * p.seq_len + row0;
  return {k, v, p.k_strides[1], p.v_strides[1], p.is_valid + lab, p.segment_ids + lab};
}

template <typename T>
__device__ Slot<T> slot_of(const RingParams& p, int rank, int slot, int b, int h, int Lloc) {
  const int64_t rs = static_cast<int64_t>(rank) * 2 + slot;
  const int64_t member = (rs * p.batch + b) * p.heads + h;
  const int64_t kv = member * Lloc * kD;
  const int64_t lab = member * 2 * Lloc;
  return {static_cast<T*>(p.k_slots) + kv, static_cast<T*>(p.v_slots) + kv,
          p.lab_slots + lab, p.lab_slots + lab + Lloc};
}

template <typename T>
__device__ Shard<T> as_shard(const Slot<T>& s) {
  return {s.k, s.v, kD, kD, s.valid, s.seg};
}

template <typename T>
__device__ void copy_shard(const Slot<T>& dst, const Shard<T>& src, int Lloc) {
  constexpr int kChunks = kD * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks per row
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < Lloc * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kPerChunk;
    const int4 kx = __ldcg(reinterpret_cast<const int4*>(src.k + r * src.k_stride + c));
    const int4 vx = __ldcg(reinterpret_cast<const int4*>(src.v + r * src.v_stride + c));
    *reinterpret_cast<int4*>(dst.k + static_cast<int64_t>(r) * kD + c) = kx;
    *reinterpret_cast<int4*>(dst.v + static_cast<int64_t>(r) * kD + c) = vx;
  }
  for (int i = threadIdx.x; i < Lloc; i += blockDim.x) {
    dst.valid[i] = __ldcg(src.valid + i);
    dst.seg[i] = __ldcg(src.seg + i);
  }
}

// The ring: block c is rank c % n of the rings c / n, c / n + grid / n, ...
// compute(resident shard, rank, b, h, Lloc, first step, last step) runs the
// online softmax of one step.
template <typename T, typename Compute>
__device__ void ring_walk(const RingParams& p, Compute&& compute) {
  const int n = p.n_ranks;
  const int Lloc = p.seq_len / n;
  const int rank = blockIdx.x % n;
  const int right = (rank + 1) % n;
  const int left = (rank + n - 1) % n;
  for (int ring = blockIdx.x / n; ring < p.batch * p.heads; ring += p.grid / n) {
    const int b = ring / p.heads;
    const int h = ring % p.heads;
    for (int s = 0; s < n; ++s) {
      const int send = s & 1;
      const int recv = send ^ 1;
      const Shard<T> res = s == 0 ? own_shard<T>(p, rank, b, h, Lloc)
                                  : as_shard(slot_of<T>(p, rank, send, b, h, Lloc));
      if (s >= 1 && s < n - 1) {
        // the right neighbour freed its slot `recv` at each of its steps
        // t <= s - 1 with t % 2 == (s - 1) % 2
        wait_flag(flag_ptr(p, rank, b, h, kCapacity, recv), (s - 1) / 2 + 1, p.timeout_ns);
      }
      if (s < n - 1) {
        copy_shard(slot_of<T>(p, right, recv, b, h, Lloc), res, Lloc);
        post_flag(flag_ptr(p, right, b, h, kReady, recv));
      }
      compute(res, rank, b, h, Lloc, s == 0, s == n - 1);
      if (s < n - 1) {
        // the left neighbour filled our slot `recv` at each of its steps
        // t <= s with t % 2 == s % 2
        wait_flag(flag_ptr(p, rank, b, h, kReady, recv), s / 2 + 1, p.timeout_ns);
      }
      if (s <= n - 3) post_flag(flag_ptr(p, left, b, h, kCapacity, send));
    }
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// 4 warps; warp w owns query rows [16w, 16w + 16) of each 64-row block. In
// the m16n8k16 fragment layout lane (g = lane / 4, t = lane % 4) holds rows g
// and g + 8 of its warp's 16, columns 2t, 2t + 1 of each 8-wide tile.
// Three blocks per SM: the registers are capped at 168 (a few bytes spill).
// Uncapped, the kernel takes about 200 and two blocks fit; on an H100 the
// long-video shape (B 8, L 2560, n 4) then took about 40% longer.
__global__ void __launch_bounds__(kThreadsBf16, 3) ring_fwd_bf16_kernel(const RingParams p) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockQ][kD + kPad];
  __shared__ __align__(16) __nv_bfloat16 sK[2][kBlockK][kD + kPad];
  __shared__ __align__(16) __nv_bfloat16 sV[2][kBlockK][kD + kPad];
  // per key: {1 valid, 0 masked, -1 past Lloc; segment id}
  __shared__ __align__(16) int2 sKLab[2][kBlockK];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r_lo = warp * 16 + g;  // this lane's rows within a block: r_lo, r_lo + 8
  const int q_blocks = (p.seq_len / p.n_ranks + kBlockQ - 1) / kBlockQ;
  float* const state_base =
      p.scratch + static_cast<int64_t>(blockIdx.x) * q_blocks * kStateBf16 * kThreadsBf16 + tid;

  auto compute = [&](const Shard<__nv_bfloat16>& res, int rank, int b, int h, int Lloc,
                     bool first, bool last) {
    const int64_t row0 = static_cast<int64_t>(rank) * Lloc;
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_strides[0] +
                              row0 * p.q_strides[1] + h * p.q_strides[2];
    const int32_t* valid = p.is_valid + static_cast<int64_t>(b) * p.seq_len + row0;
    const int32_t* seg = p.segment_ids + static_cast<int64_t>(b) * p.seq_len + row0;

    // keys past Lloc are zero-filled (source size 0), their addresses clamped to row 0
    auto load_kv_tile = [&](int k0, int buf) {
      for (int i = tid; i < kBlockK * (kD / 8); i += kThreadsBf16) {
        const int r = i / (kD / 8);
        const int c = (i % (kD / 8)) * 8;
        const bool in = k0 + r < Lloc;
        const int64_t row = in ? k0 + r : 0;
        cp_async_16(&sK[buf][r][c], res.k + row * res.k_stride + c, in ? 16 : 0);
        cp_async_16(&sV[buf][r][c], res.v + row * res.v_stride + c, in ? 16 : 0);
      }
      if (tid < kBlockK) {
        const int j = k0 + tid;
        sKLab[buf][tid] = j < Lloc ? make_int2(__ldcg(res.valid + j) > 0 ? 1 : 0,
                                               __ldcg(res.seg + j))
                                   : make_int2(-1, 0);
      }
    };

    const int n_tiles = (Lloc + kBlockK - 1) / kBlockK;
    for (int qb = 0; qb < q_blocks; ++qb) {
      // sQ and both tile buffers are free: the last tile of the previous
      // block ended in __syncthreads
      const int q0 = qb * kBlockQ;
      for (int i = tid; i < kBlockQ * (kD / 8); i += kThreadsBf16) {
        const int r = i / (kD / 8);
        const int c = (i % (kD / 8)) * 8;
        const bool in = q0 + r < Lloc;
        const int64_t row = in ? q0 + r : 0;
        cp_async_16(&sQ[r][c], qg + row * p.q_strides[1] + c, in ? 16 : 0);
      }
      load_kv_tile(0, 0);
      cp_async_commit();

      int q_row[2], q_valid[2], q_seg[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        q_row[i] = q0 + r_lo + 8 * i;
        const bool in = q_row[i] < Lloc;
        q_valid[i] = in ? valid[q_row[i]] : 0;
        q_seg[i] = in ? seg[q_row[i]] : -1;
      }

      // the running (m, l, acc): fresh at the first step, else carried over
      float* const state = state_base + static_cast<int64_t>(qb) * kStateBf16 * kThreadsBf16;
      float m[2], l[2];  // l: per-lane partial row sums, reduced over the quad at the end
      float acc[kD / 8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = first ? kNegInf : state[(32 + i) * kThreadsBf16];
        l[i] = first ? 0.f : state[(34 + i) * kThreadsBf16];
      }
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = first ? 0.f : state[(n * 4 + e) * kThreadsBf16];
      }
      uint32_t qa[kD / 16][4];  // A fragments of Q, one per 16-wide slice of d

      for (int it = 0; it < n_tiles; ++it) {
        const int buf = it & 1;
        if (it + 1 < n_tiles) {
          load_kv_tile((it + 1) * kBlockK, buf ^ 1);  // released at the end of it - 1
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

        // S = Q K^T for this tile
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

        // O += P V (see flash_fwd.cu)
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

      if (!last) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          state[(32 + i) * kThreadsBf16] = m[i];
          state[(34 + i) * kThreadsBf16] = l[i];
        }
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) state[(n * 4 + e) * kThreadsBf16] = acc[n][e];
        }
        continue;
      }
      const int H = p.heads;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
        if (q_row[i] < Lloc) {
          __nv_bfloat16* orow =
              static_cast<__nv_bfloat16*>(p.out) +
              ((static_cast<int64_t>(b) * p.seq_len + row0 + q_row[i]) * H + h) * kD;
#pragma unroll
          for (int n = 0; n < kD / 8; ++n) {
            *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
                __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
          }
        }
      }
    }
  };
  ring_walk<__nv_bfloat16>(p, compute);
}

// f32: one thread per query row, scalar FMAs, keys streamed through shared
// memory one 64-key tile at a time (every lane reads the same key: broadcast).
__global__ void __launch_bounds__(kThreadsF32) ring_fwd_f32_kernel(const RingParams p) {
  __shared__ __align__(16) float sK[kBlockK][kD];
  __shared__ __align__(16) float sV[kBlockK][kD];
  __shared__ int32_t sKValid[kBlockK];
  __shared__ int32_t sKSeg[kBlockK];

  const int tid = threadIdx.x;
  const int q_blocks = (p.seq_len / p.n_ranks + kBlockQ - 1) / kBlockQ;
  float* const state_base =
      p.scratch + static_cast<int64_t>(blockIdx.x) * q_blocks * kStateF32 * kThreadsF32 + tid;

  auto compute = [&](const Shard<float>& res, int rank, int b, int h, int Lloc, bool first,
                     bool last) {
    const int64_t row0 = static_cast<int64_t>(rank) * Lloc;
    const float* qg = static_cast<const float*>(p.q) + b * p.q_strides[0] +
                      row0 * p.q_strides[1] + h * p.q_strides[2];
    const int32_t* valid = p.is_valid + static_cast<int64_t>(b) * p.seq_len + row0;
    const int32_t* seg = p.segment_ids + static_cast<int64_t>(b) * p.seq_len + row0;

    for (int qb = 0; qb < q_blocks; ++qb) {
      const int row = qb * kBlockQ + tid;
      const bool in = row < Lloc;
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

      float* const state = state_base + static_cast<int64_t>(qb) * kStateF32 * kThreadsF32;
      float m = first ? kNegInf : state[kD * kThreadsF32];
      float l = first ? 0.f : state[(kD + 1) * kThreadsF32];
      float acc[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = first ? 0.f : state[d * kThreadsF32];

      for (int k0 = 0; k0 < Lloc; k0 += kBlockK) {
        __syncthreads();
        for (int i = tid; i < kBlockK * (kD / 4); i += kThreadsF32) {
          const int r = i / (kD / 4);
          const int c = (i % (kD / 4)) * 4;
          float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
          float4 vv = kv;
          if (k0 + r < Lloc) {
            kv = __ldcg(reinterpret_cast<const float4*>(res.k + (k0 + r) * res.k_stride + c));
            vv = __ldcg(reinterpret_cast<const float4*>(res.v + (k0 + r) * res.v_stride + c));
          }
          *reinterpret_cast<float4*>(&sK[r][c]) = kv;
          *reinterpret_cast<float4*>(&sV[r][c]) = vv;
        }
        if (tid < kBlockK) {
          const bool kin = k0 + tid < Lloc;
          sKValid[tid] = kin ? __ldcg(res.valid + k0 + tid) : 0;
          sKSeg[tid] = kin ? __ldcg(res.seg + k0 + tid) : -1;
        }
        __syncthreads();

        const int n_keys = min(kBlockK, Lloc - k0);  // keys past Lloc are skipped
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

      if (!last) {
        state[kD * kThreadsF32] = m;
        state[(kD + 1) * kThreadsF32] = l;
#pragma unroll
        for (int d = 0; d < kD; ++d) state[d * kThreadsF32] = acc[d];
      } else if (in) {
        const float inv = 1.f / (l == 0.f ? 1.f : l);
        float* orow = static_cast<float*>(p.out) +
                      ((static_cast<int64_t>(b) * p.seq_len + row0 + row) * p.heads + h) * kD;
#pragma unroll
        for (int d = 0; d < kD; d += 4) {
          *reinterpret_cast<float4*>(orow + d) =
              make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
        }
      }
    }
  };
  ring_walk<float>(p, compute);
}

template <typename Kernel>
cudaError_t launch_cooperative(Kernel kernel, int threads, const RingParams* params,
                               cudaStream_t stream) {
  RingParams p = *params;
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                      dim3(p.grid), dim3(threads), args, 0,
                                                      stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

// Size of RingParams, so the Python side can check its ctypes mirror.
size_t ring_fwd_params_size() { return sizeof(RingParams); }

// For the current device: the most blocks of the f32 (f32 != 0) or bf16
// kernel that can be resident at once, and the scratch floats each block
// needs per 64-row block of queries.
cudaError_t ring_fwd_launch_info(int f32, int32_t* max_blocks, int32_t* state_floats) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) {
    err = f32 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_fwd_f32_kernel,
                                                              kThreadsF32, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_fwd_bf16_kernel,
                                                              kThreadsBf16, 0);
  }
  *max_blocks = per_sm * sms;
  *state_floats = f32 ? kStateF32 * kThreadsF32 : kStateBf16 * kThreadsBf16;
  return err;
}

cudaError_t ring_fwd_bf16(const RingParams* params, cudaStream_t stream) {
  return launch_cooperative(ring_fwd_bf16_kernel, kThreadsBf16, params, stream);
}

cudaError_t ring_fwd_f32(const RingParams* params, cudaStream_t stream) {
  return launch_cooperative(ring_fwd_f32_kernel, kThreadsF32, params, stream);
}

}  // extern "C"
