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
// "remote copy" is a store into slot (s + 1) % 2 of member (r + 1, b, h).
// The labels travel with each (b, h) member's copy, not once per b as in the
// TPU kernel (whose one program per chip moves every head in lockstep): the
// members of one b advance on their own, and a label slot shared by the
// heads would be refilled by a faster head's ring while a slower one still
// reads it.
//
// The unit of work is a q-group: the rows [128 g, 128 g + 128) of Lloc of one
// member (rank, b, h) (64 rows in the f32 kernel), for the whole walk of n
// steps. Its block loads those queries once and keeps (m, l, acc) in
// registers from step 0 to step n - 1; a member has G = ceil(Lloc / 128)
// q-group blocks, a ring n * G.
//
// Protocol, per ring member, step for step as `_rdma_ring_kernel`:
//   1 <= s < n-1: wait until the right neighbour has freed the slot to fill
//   s < n-1:      copy the resident shard into that slot, signal ready
//   every s:      online softmax of the q-group's rows against the resident
//                 shard
//   1 <= s:       the left neighbour's copy into the resident slot is ready
//                 before it is read
//   s <= n-3:     signal the left neighbour that our resident slot is free
// The resident shard at step 0 is the rank's own rows of k, v and the labels,
// read in place (the TPU kernel first copies them into its slot 0; the wait
// at s = 1 is then for a slot that is free from the start, kept to mirror it).
// Flags are counters, zeroed by the wrapper on the stream before each launch
// (torch.zeros): per (rank, b, h, slot) one for capacity, which each of the
// member's G q-group blocks signals once per step, and one per 128-key tile
// of the shard for ready; a wait is for the count that the step number
// fixes.
//
// bf16 (fwd_core.cuh: two consumer warpgroups, one producer warp). The
// producer walks the steps: it streams the resident shard's key tiles by TMA
// (from the k and v maps at step 0, from the slot maps after), each once its
// ready flag allows, and the copy reads nothing extra: tile t, once in
// shared memory, is stored into the neighbour's slot by TMA by the q-group
// block t mod G, which also writes the tile's labels there from the stage.
// Its stores are complete (bulk wait_group 0), then fence.proxy.async and a
// release add signal that tile ready; a reader acquires the flag and fences
// the async proxy before its TMA loads the tile. So a step's first tiles
// arrive while the neighbours still copy its last ones, and the producer
// keeps its lead over the consumers across the steps. A slot is freed once
// every tile load of the step has landed (the producer waits for the full
// barriers of the step's last stages). The slot maps are 4-D (d, Lloc,
// member, rank and slot), so a tile that runs past Lloc is cut there by TMA
// and never touches the next member's rows.
// f32: the scalar kernel of flash_fwd.cu, one thread per query row, which
// copies its share of the shard (its own 64 rows) before the step's
// compute, through L2 (ld.global.cg), and signals a step's copy on the ready
// flag of tile 0, counting the G blocks.
//
// Deadlock. A block that spins on a neighbour that is not resident would
// hang the card. The grid is launched with cudaLaunchCooperativeKernel, which
// refuses a grid that cannot be co-resident; the wrapper sizes it to at most
// what the occupancy calculator allows (with the kernel's dynamic shared
// memory), in whole rings of n * G blocks. Block c walks the units c,
// c + grid, ..., unit u being q-group (u % (n G)) / n of rank u % n of ring
// (b, h) = u / (n G): the blocks of one ring are co-resident and at the same
// point of their walks. Every spin is bounded by %globaltimer (timeout_ns)
// and ends in __trap(): a protocol fault fails the launch instead of hanging
// it.
//
// Work and bound. The card must at least move q and out once, read each
// shard n times (once per rank that computes on it), and write and read
// n (n - 1) shard copies; the operations are those of full attention over
// the attended pairs. At B 8, L 2560, n 4 the operations bound it (161 GFLOP,
// 163 us at 989 TFLOP/s) over the ring's bytes (0.69 GB, 207 us at 3.35 TB/s
// counting every shard read and copy; L2 serves most of the G-fold reads of
// a shard). Not done yet: skipping tiles that the labels mask out, and rings
// across several cards (peer pointers and .sys-scope fences).
//
// Interface: q, k, v are [B, L, H, 64] read through their (batch, seq, head)
// strides with a unit head-dim stride; is_valid and segment_ids contiguous
// int32 [B, L]; out [B, L, H, 64] contiguous in q's dtype. The launchers
// return the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fwd_core.cuh"

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
  int32_t* flags;              // [n, B, H, 2, 1 + T]: per slot capacity, ready of each key tile; 0 at launch
  int64_t q_strides[3];        // batch, seq, head (elements)
  int64_t k_strides[3];
  int64_t v_strides[3];
  int32_t batch;
  int32_t seq_len;
  int32_t heads;
  int32_t n_ranks;
  int32_t grid;                // blocks launched, a multiple of n_ranks * q-groups
  float scale;
  int64_t timeout_ns;          // bound of every wait
};

namespace {

constexpr int kD = 64;           // head dim
constexpr int kBlockK = 64;      // keys per shared-memory tile of the f32 kernel
constexpr float kNegInf = -1e10f;
constexpr int kGroupBf16 = 128;  // query rows of a bf16 q-group (two warpgroups)
constexpr int kGroupF32 = 64;    // query rows of an f32 q-group (one per thread)
constexpr int kKeyTile = 128;    // keys per tile of the bf16 kernel
constexpr int kCapacity = 0;     // a slot's flag entry 0; entry 1 + t: tile t is ready

// ---------------------------------------------------------------------------
// flags
// ---------------------------------------------------------------------------

__device__ __forceinline__ int32_t ld_acquire(const int32_t* p) {
  int32_t v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Flags [n, B, H, 2, 1 + T] (T = ceil(Lloc / kKeyTile)): for each member's
// slot, entry 0 counts the capacity posts, entry 1 + t the ready posts of
// key tile t (the f32 kernel, which copies whole steps, counts its ready
// posts in entry 1).
__device__ __forceinline__ int32_t* flag_ptr(const RingParams& p, int rank, int b, int h,
                                             int slot, int entry) {
  const int tiles = (p.seq_len / p.n_ranks + kKeyTile - 1) / kKeyTile;
  return p.flags +
         (((static_cast<int64_t>(rank) * p.batch + b) * p.heads + h) * 2 + slot) * (1 + tiles) +
         entry;
}

// One thread waits until *flag >= target (traps once timeout_ns passed),
// then orders what it and its block read next after what the flag released,
// in both proxies.
__device__ void spin_flag(const int32_t* flag, int target, int64_t timeout_ns) {
  if (ld_acquire(flag) < target) {
    const uint64_t t0 = global_ns();
    while (ld_acquire(flag) < target) {
      if (global_ns() - t0 > static_cast<uint64_t>(timeout_ns)) __trap();
      __nanosleep(100);
    }
  }
  __threadfence();
  fence_async_global();
}

// The whole block waits until *flag >= target.
__device__ void wait_flag(const int32_t* flag, int target, int64_t timeout_ns) {
  if (threadIdx.x == 0) spin_flag(flag, target, timeout_ns);
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

// A unit of work: q-group g of member (rank, b, h).
struct Unit {
  int rank, g, b, h;
};

__device__ __forceinline__ Unit unit_of(int u, int n, int groups, int heads) {
  const int ring = u / (n * groups);
  const int i = u % (n * groups);
  return {i % n, i / n, ring / heads, ring % heads};
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

// Warps 0 .. 7 are the two consumer warpgroups, warp 8 the producer.
__global__ void __launch_bounds__(128 * 2 + 32, 1)
    ring_fwd_bf16_kernel(const RingParams p, const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_k_slots,
                         const __grid_constant__ CUtensorMap tm_v_slots) {
  constexpr int NWG = 2;
  constexpr int N = kKeyTile;
  constexpr int S = fwd::kStages;
  extern __shared__ char smem_raw[];
  fwd::Smem<NWG, N>& sm = fwd::smem_of<NWG, N>(smem_raw);
  const int n = p.n_ranks;
  const int L = p.seq_len;
  const int H = p.heads;
  const int Lloc = L / n;
  const int groups = (Lloc + kGroupBf16 - 1) / kGroupBf16;
  const int units = n * groups * p.batch * H;
  const int n_tiles = (Lloc + N - 1) / N;
  const int members = p.batch * H;
  const int warp = __shfl_sync(~0u, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  fwd::init_barriers(sm);

  if (warp == 4 * NWG) {  // producer: the ring's protocol and every copy
    const CUtensorMap* k_slots = &tm_k_slots;
    const CUtensorMap* v_slots = &tm_v_slots;
    uint32_t c = 0, k = 0;
    for (int u = blockIdx.x; u < units; u += p.grid, ++k) {
      const Unit w = unit_of(u, n, groups, H);
      const int member = w.b * H + w.h;
      const int right = (w.rank + 1) % n;
      const int left = (w.rank + n - 1) % n;
      const int64_t lab0 = static_cast<int64_t>(w.b) * L + static_cast<int64_t>(w.rank) * Lloc;
      if (lane == 0) {
        if (k > 0) mbar_wait(&sm.q_empty, (k - 1) & 1);
        mbar_expect_tx(&sm.q_full, kGroupBf16 * kD * 2);
        tma_tile(sm.q[0], &tm_q, w.h, w.rank * Lloc + w.g * kGroupBf16, w.b, &sm.q_full);
      }
      for (int s = 0; s < n; ++s) {
        const int send = s & 1;
        const int recv = send ^ 1;
        // s >= 1: the fills of a slot by a neighbour's steps t <= s - 1
        // with t % 2 == (s - 1) % 2
        const int fills = (s - 1) / 2 + 1;
        fwd::TileSource src;
        if (s == 0) {
          src = {&tm_k, &tm_v, {0, w.h, w.rank * Lloc, w.b}, 2, p.is_valid + lab0,
                 p.segment_ids + lab0, Lloc, false};
        } else {
          const int32_t* lab =
              p.lab_slots + ((static_cast<int64_t>(w.rank) * 2 + send) * members + member) * 2 * Lloc;
          src = {&tm_k_slots, &tm_v_slots, {0, 0, member, w.rank * 2 + send}, 1, lab, lab + Lloc,
                 Lloc, true};
        }
        int32_t* dst_lab =
            p.lab_slots + ((static_cast<int64_t>(right) * 2 + recv) * members + member) * 2 * Lloc;
        const uint32_t c0 = c;
        bool room = s == 0;  // the right neighbour's slot `recv` is free
        // tile t to the right neighbour once it has landed: K and V by TMA
        // store, its labels by the lanes from the stage (each lane the
        // entries it staged)
        auto store = [&](int t) {
          if (!room) {  // it read that slot at its step s - 1, each q-group once
            if (lane == 0) {
              spin_flag(flag_ptr(p, w.rank, w.b, w.h, recv, kCapacity), groups * fills,
                        p.timeout_ns);
            }
            __syncwarp();
            room = true;
          }
          const uint32_t cc = c0 + t;
          const int st = cc % S;
          if (lane == 0) {
            mbar_wait(&sm.full[st], (cc / S) & 1);
            tma_store_4d(k_slots, sm.k[st], 0, t * N, member, right * 2 + recv);
            tma_store_4d(v_slots, sm.v[st], 0, t * N, member, right * 2 + recv);
            bulk_commit();
          }
          for (int j = lane; j < N; j += 32) {
            const int key = t * N + j;
            if (key < Lloc) {
              const int2 e = sm.lab[st][j];
              dst_lab[key] = e.x;
              dst_lab[Lloc + key] = e.y;
            }
          }
        };
        // once the stores are complete: signal tile t ready
        auto post = [&](int t) {
          __threadfence();  // each lane's label stores
          __syncwarp();
          if (lane == 0) {
            bulk_wait();
            fence_async_global();
            __threadfence();
            atomicAdd(flag_ptr(p, right, w.b, w.h, recv, 1 + t), 1);
          }
          __syncwarp();
        };
        // s >= 1: until tile t of our slot `send` is filled, the lanes read
        // the ready flags of the next 32 tiles at once; `ready` tiles are
        // known to be filled
        int ready = s == 0 ? n_tiles : 0;
        auto wait_ready = [&](int t) {
          if (t < ready) return;
          const uint64_t t0 = global_ns();
          while (t >= ready) {
            const int tt = ready + lane;
            const bool filled =
                tt >= n_tiles || ld_acquire(flag_ptr(p, w.rank, w.b, w.h, send, 1 + tt)) >= fills;
            const unsigned unfilled = __ballot_sync(~0u, !filled);
            ready += unfilled ? __ffs(unfilled) - 1 : 32;
            if (t >= ready) {
              if (global_ns() - t0 > static_cast<uint64_t>(p.timeout_ns)) __trap();
              __nanosleep(64);
            }
          }
          if (lane == 0) fence_async_global();  // before the TMA loads of what was filled
          __syncwarp();
        };
        // a tile's store is issued after the next tile's load, and its
        // ready signal after the one after, so that neither waits on a copy
        // in flight
        int to_store = -1, to_post = -1;
        for (int t = 0; t < n_tiles; ++t, ++c) {
          wait_ready(t);
          fwd::produce_tile<NWG, N, true>(sm, c, src, t * N, lane);
          if (to_post >= 0) post(to_post);
          to_post = to_store;
          if (to_store >= 0) store(to_store);
          to_store = s < n - 1 && t % groups == w.g ? t : -1;
        }
        if (to_post >= 0) post(to_post);
        if (to_store >= 0) {
          store(to_store);
          post(to_store);
        }
        if (s <= n - 3 && lane == 0) {  // every load of the resident slot has landed: free it
          if (s >= 1) {
            for (uint32_t cc = c - min(static_cast<uint32_t>(S), c - c0); cc < c; ++cc) {
              mbar_wait(&sm.full[cc % S], (cc / S) & 1);
            }
          }
          fence_async_global();
          __threadfence();
          atomicAdd(flag_ptr(p, left, w.b, w.h, send, kCapacity), 1);
        }
        __syncwarp();
      }
    }
    if (lane == 0) bulk_wait();
    return;
  }

  const int wg = warp >> 2;
  const int wwarp = warp & 3;
  const uint64_t desc_q = desc_sw128(sm.q[wg]);
  const float sl2e = p.scale * fwd::kLog2e;
  uint32_t c = 0, k = 0;
  for (int u = blockIdx.x; u < units; u += p.grid, ++k) {
    const Unit w = unit_of(u, n, groups, H);
    const int row0 = w.g * kGroupBf16 + wg * fwd::kWgRows + 16 * wwarp + (lane >> 2);
    const int64_t lab0 = static_cast<int64_t>(w.b) * L + static_cast<int64_t>(w.rank) * Lloc;
    fwd::RowState r;
    fwd::start_rows(r, p.is_valid + lab0, p.segment_ids + lab0, row0, Lloc);
    mbar_wait(&sm.q_full, k & 1);
    fwd::consume_tiles<NWG, N>(sm, c, n * n_tiles, desc_q, r, sl2e, lane);
    c += n * n_tiles;
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.q_empty);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + ((lab0 + row0) * H + w.h) * kD;
    fwd::finish_rows(r, row0, Lloc, out, static_cast<int64_t>(H) * kD, nullptr, lane);
  }
}

// ---------------------------------------------------------------------------
// f32
// ---------------------------------------------------------------------------

// Lloc rows of K and V and their labels, read-only.
struct Shard {
  const float* k;
  const float* v;
  int64_t k_stride;  // elements from one row to the next
  int64_t v_stride;
  const int32_t* valid;
  const int32_t* seg;
};

// One slot of one ring member: Lloc contiguous rows of K and V, its labels.
struct Slot {
  float* k;
  float* v;
  int32_t* valid;
  int32_t* seg;
};

__device__ Shard own_shard(const RingParams& p, int rank, int b, int h, int Lloc) {
  const int64_t row0 = static_cast<int64_t>(rank) * Lloc;
  const float* k = static_cast<const float*>(p.k) + b * p.k_strides[0] + row0 * p.k_strides[1] +
                   h * p.k_strides[2];
  const float* v = static_cast<const float*>(p.v) + b * p.v_strides[0] + row0 * p.v_strides[1] +
                   h * p.v_strides[2];
  const int64_t lab = static_cast<int64_t>(b) * p.seq_len + row0;
  return {k, v, p.k_strides[1], p.v_strides[1], p.is_valid + lab, p.segment_ids + lab};
}

__device__ Slot slot_of(const RingParams& p, int rank, int slot, int b, int h, int Lloc) {
  const int64_t rs = static_cast<int64_t>(rank) * 2 + slot;
  const int64_t member = (rs * p.batch + b) * p.heads + h;
  const int64_t kv = member * Lloc * kD;
  const int64_t lab = member * 2 * Lloc;
  return {static_cast<float*>(p.k_slots) + kv, static_cast<float*>(p.v_slots) + kv,
          p.lab_slots + lab, p.lab_slots + lab + Lloc};
}

__device__ Shard as_shard(const Slot& s) { return {s.k, s.v, kD, kD, s.valid, s.seg}; }

// Rows [r0, r1) of a shard into a slot, through L2.
__device__ void copy_rows(const Slot& dst, const Shard& src, int r0, int r1) {
  constexpr int kChunks = kD / 4;  // 16-byte chunks per row
  for (int i = r0 * kChunks + threadIdx.x; i < r1 * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    const int4 kx = __ldcg(reinterpret_cast<const int4*>(src.k + r * src.k_stride + c));
    const int4 vx = __ldcg(reinterpret_cast<const int4*>(src.v + r * src.v_stride + c));
    *reinterpret_cast<int4*>(dst.k + static_cast<int64_t>(r) * kD + c) = kx;
    *reinterpret_cast<int4*>(dst.v + static_cast<int64_t>(r) * kD + c) = vx;
  }
  for (int i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    dst.valid[i] = __ldcg(src.valid + i);
    dst.seg[i] = __ldcg(src.seg + i);
  }
}

// One thread per query row of a 64-row q-group, scalar FMAs, keys streamed
// through shared memory one 64-key tile at a time (every lane reads the
// same key: broadcast).
__global__ void __launch_bounds__(kGroupF32) ring_fwd_f32_kernel(const RingParams p) {
  __shared__ __align__(16) float sK[kBlockK][kD];
  __shared__ __align__(16) float sV[kBlockK][kD];
  __shared__ int32_t sKValid[kBlockK];
  __shared__ int32_t sKSeg[kBlockK];

  const int n = p.n_ranks;
  const int Lloc = p.seq_len / n;
  const int groups = (Lloc + kGroupF32 - 1) / kGroupF32;
  const int units = n * groups * p.batch * p.heads;
  const int tid = threadIdx.x;
  for (int u = blockIdx.x; u < units; u += p.grid) {
    const Unit w = unit_of(u, n, groups, p.heads);
    const int rank = w.rank, b = w.b, h = w.h;
    const int right = (rank + 1) % n;
    const int left = (rank + n - 1) % n;
    const int64_t row0 = static_cast<int64_t>(rank) * Lloc;
    const int row = w.g * kGroupF32 + tid;
    const bool in = row < Lloc;
    const float* qg = static_cast<const float*>(p.q) + b * p.q_strides[0] +
                      row0 * p.q_strides[1] + h * p.q_strides[2];
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
    const int64_t lab = static_cast<int64_t>(b) * p.seq_len + row0;
    const int qv = in ? p.is_valid[lab + row] : 0;
    const int qs = in ? p.segment_ids[lab + row] : -1;
    float m = kNegInf;
    float l = 0.f;
    float acc[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] = 0.f;

    for (int s = 0; s < n; ++s) {
      const int send = s & 1;
      const int recv = send ^ 1;
      const Shard res = s == 0 ? own_shard(p, rank, b, h, Lloc)
                               : as_shard(slot_of(p, rank, send, b, h, Lloc));
      if (s >= 1 && s < n - 1) {
        // the right neighbour freed its slot `recv` at each of its steps
        // t <= s - 1 with t % 2 == (s - 1) % 2, each of its q-groups once
        wait_flag(flag_ptr(p, rank, b, h, recv, kCapacity), groups * ((s - 1) / 2 + 1),
                  p.timeout_ns);
      }
      if (s < n - 1) {  // this q-group's rows of the shard
        copy_rows(slot_of(p, right, recv, b, h, Lloc), res, w.g * kGroupF32,
                  min(Lloc, (w.g + 1) * kGroupF32));
        post_flag(flag_ptr(p, right, b, h, recv, 1));
      }
      for (int k0 = 0; k0 < Lloc; k0 += kBlockK) {
        __syncthreads();
        for (int i = tid; i < kBlockK * (kD / 4); i += kGroupF32) {
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
          float sc = 0.f;
#pragma unroll
          for (int d = 0; d < kD; ++d) sc = fmaf(q[d], sK[j][d], sc);
          sc *= p.scale;
          if (!(qv > 0 && sKValid[j] > 0 && qs == sKSeg[j])) sc = kNegInf;
          if (sc > m) {
            const float corr = expf(m - sc);
            l *= corr;
#pragma unroll
            for (int d = 0; d < kD; ++d) acc[d] *= corr;
            m = sc;
          }
          const float pe = expf(sc - m);
          l += pe;
#pragma unroll
          for (int d = 0; d < kD; ++d) acc[d] = fmaf(pe, sV[j][d], acc[d]);
        }
      }
      if (s < n - 1) {
        // the left neighbour's q-groups filled our slot `recv` at each of
        // its steps t <= s with t % 2 == s % 2
        wait_flag(flag_ptr(p, rank, b, h, recv, 1), groups * (s / 2 + 1), p.timeout_ns);
      }
      if (s <= n - 3) post_flag(flag_ptr(p, left, b, h, send, kCapacity));
    }

    if (in) {
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
}

// The slots [n, 2, B, H, Lloc, 64] seen as (d, Lloc, member, rank and
// slot), boxes of N rows cut at Lloc.
bool slot_map(EncodeTiledFn encode, CUtensorMap* map, const void* base, const RingParams* p,
              int rows) {
  const cuuint64_t lloc = p->seq_len / p->n_ranks;
  const cuuint64_t members = static_cast<cuuint64_t>(p->batch) * p->heads;
  const cuuint64_t dims[4] = {64, lloc, members, 2 * static_cast<cuuint64_t>(p->n_ranks)};
  const cuuint64_t bytes[3] = {128, lloc * 128, members * lloc * 128};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  return bf16_map(encode, map, base, dims, bytes, box);
}

cudaError_t launch_bf16(const RingParams* params, cudaStream_t stream) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const RingParams* p = params;
  const int B = p->batch, L = p->seq_len, H = p->heads;
  CUtensorMap maps[5];
  if (!seq_map(encode, &maps[0], p->q, p->q_strides, B, L, H, kGroupBf16) ||
      !seq_map(encode, &maps[1], p->k, p->k_strides, B, L, H, kKeyTile) ||
      !seq_map(encode, &maps[2], p->v, p->v_strides, B, L, H, kKeyTile) ||
      !slot_map(encode, &maps[3], p->k_slots, p, kKeyTile) ||
      !slot_map(encode, &maps[4], p->v_slots, p, kKeyTile)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = ring_fwd_bf16_kernel;
  constexpr int smem = fwd::kSmemBytes<2, kKeyTile>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  RingParams pc = *p;
  void* args[] = {&pc, &maps[0], &maps[1], &maps[2], &maps[3], &maps[4]};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(pc.grid),
                                    dim3(128 * 2 + 32), args, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

// Size of RingParams, so the Python side can check its ctypes mirror.
size_t ring_fwd_params_size() { return sizeof(RingParams); }

// For the current device: the most blocks of the f32 (f32 != 0) or bf16
// kernel that can be resident at once (with its dynamic shared memory), and
// the query rows of its q-group.
cudaError_t ring_fwd_launch_info(int f32, int32_t* max_blocks, int32_t* group_rows) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  constexpr int smem = fwd::kSmemBytes<2, kKeyTile>;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess && !f32) {
    err = cudaFuncSetAttribute(ring_fwd_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) {
    err = f32 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_fwd_f32_kernel,
                                                              kGroupF32, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, ring_fwd_bf16_kernel, 128 * 2 + 32, smem);
  }
  *max_blocks = per_sm * sms;
  *group_rows = f32 ? kGroupF32 : kGroupBf16;
  return err;
}

cudaError_t ring_fwd_bf16(const RingParams* params, cudaStream_t stream) {
  return launch_bf16(params, stream);
}

cudaError_t ring_fwd_f32(const RingParams* params, cudaStream_t stream) {
  RingParams p = *params;
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ring_fwd_f32_kernel), dim3(p.grid), dim3(kGroupF32), args, 0,
      stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // extern "C"
