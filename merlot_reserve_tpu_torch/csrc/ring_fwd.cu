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
// Two modes, one protocol and one compute core:
// * Virtual ranks (rank < 0): the n ranks are n groups of blocks of one
//   launch on one H100; q, k, v, labels and out hold all L rows, and the
//   slots of every rank live in one allocation ([n, 2, B, H, Lloc, 64]).
// * One rank per process (rank >= 0): each process launches the q-groups of
//   its own rank on its own [B, Lloc, H, 64] shard. Its slots ([1, 2, B, H,
//   Lloc, 64], labels, flags) are one allocation that the neighbours opened
//   by CUDA IPC; the right neighbour's slots and flags and the left
//   neighbour's flags arrive as peer pointers. The processes may sit on
//   several cards or share one (its contexts are then time-sliced, and a
//   block that spins is switched out while the neighbour's kernel runs).
//   Flags that another process writes are read with ld.acquire.sys and
//   raised with a system-scope fence and red.release.sys.
// Both compute the same rows in the same hop order, tile for tile, so a
// rank's shard of the output is the virtual launch's rows bit for bit.
//
// The slots. The TPU kernel copies K/V into the neighbour chip's VMEM by
// remote DMA. Here a rank's two slots of K, V and labels live in device
// memory: one SM's 228 KB could not hold a shard and its double buffer (at
// Lloc 640 one copy of K and V is 160 KB in bf16) the way the TPU's VMEM
// holds them. A "remote copy" is a store into slot (s + 1) % 2 of member
// (r + 1, b, h). The labels travel with each (b, h) member's copy, not once
// per b as in the TPU kernel (whose one program per chip moves every head
// in lockstep): the members of one b advance on their own, and a label slot
// shared by the heads would be refilled by a faster head's ring while a
// slower one still reads it.
//
// The unit of work is a q-group: the rows [128 g, 128 g + 128) of Lloc of one
// member (rank, b, h) (64 rows in the f32 kernel), for the whole walk of n
// steps. Its block loads those queries once and keeps (m, l, acc) in
// registers from step 0 to step n - 1; a member has G = ceil(Lloc / 128)
// q-group blocks, a ring n * G.
//
// Protocol, per ring member and step s, as `_rdma_ring_kernel`:
//   s < n-1:  wait until the right neighbour has consumed the fill of the
//             slot to fill that came before; copy the resident shard into
//             it and signal each copied tile ready
//   every s:  online softmax of the q-group's rows against the resident
//             shard
//   s >= 1:   the left neighbour's copy into the resident slot is ready
//             before it is read; once read, signal the left neighbour that
//             the slot is consumed
// The resident shard at step 0 is the rank's own rows of k, v and the labels,
// read in place (the TPU kernel first copies them into its slot 0).
// Flags are counters that only grow: per (rank, b, h, slot) one for
// capacity (consumptions of the right neighbour's slot, each signalled once
// by each of its G q-group blocks), held by the sender, and one per 128-key
// tile for ready (fills), held by the receiver. A call waits for the count
// that the number of earlier launches on the same buffers (`epoch`) and the
// step fix: slot x is filled F_x times a call (F_1 = n / 2, F_0 = (n - 1) / 2),
// so fill j of slot x in call e is fill e F_x + j. Across processes nothing
// zeroes them between calls: a neighbour may already be writing the next
// call's fills, so every consumption is signalled, the last two steps' too.
// The virtual mode allocates them zeroed for each launch, passes epoch 0
// and signals only the consumptions that a later step of the launch waits
// for (steps 1 .. n - 3).
//
// bf16 (fwd_core.cuh: two consumer warpgroups, one producer warp). The
// producer walks the steps: it streams the resident shard's key tiles by TMA
// (from the k and v maps at step 0, from the slot maps after), each once its
// ready flag allows, and the copy reads nothing extra: tile t, once in
// shared memory, is stored into the neighbour's slot by the q-group block
// t mod G, which also writes the tile's labels there from the stage. The
// store is a TMA store, or (peer_store, the route where a tensor map over a
// peer's address is refused, as across cards it may be) the producer's
// lanes' 16-byte stores from the swizzled stage. Its stores are complete
// (bulk wait_group 0), then fence.proxy.async and a release add signal that
// tile ready; a reader acquires the flag and fences the async proxy before
// its TMA loads the tile. So a step's first tiles arrive while the
// neighbours still copy its last ones, and the producer keeps its lead over
// the consumers across the steps. A slot is consumed once every tile load of
// the step has landed (the producer waits for the full barriers of the
// step's last stages). The slot maps are 4-D (d, Lloc, member, rank and
// slot), so a tile that runs past Lloc is cut there by TMA and never touches
// the next member's rows.
// f32: the scalar kernel of flash_fwd.cu, one thread per query row, which
// copies its share of the shard (its own 64 rows) before the step's
// compute, through L2 (ld.global.cg), and signals a step's copy on the ready
// flag of tile 0, counting the G blocks.
//
// Deadlock. A block that spins on a neighbour that is not resident would
// hang the card. The grid is launched with cudaLaunchCooperativeKernel, which
// refuses a grid that cannot be co-resident; the wrapper sizes it to at most
// what the occupancy calculator allows (with the kernel's dynamic shared
// memory), in whole rings of R * G blocks (R = n virtual ranks, or the 1
// rank of a process; every process of a ring launches the same grid). Block
// c walks the units c, c + grid, ..., unit u being q-group (u % (R G)) / R
// of rank u % R of ring (b, h) = u / (R G): the blocks of one ring, in every
// process, are resident in the same pass of their walks. Every spin is
// bounded by %globaltimer (timeout_ns) and ends in __trap(): a protocol
// fault, or a neighbour that never runs, fails the launch instead of hanging
// it.
//
// Work and bound. The card must at least move q and out once, read each
// shard n times (once per rank that computes on it), and write and read
// n (n - 1) shard copies; the operations are those of full attention over
// the attended pairs. At B 8, L 2560, n 4 the operations bound it (161 GFLOP,
// 163 us at 989 TFLOP/s) over the ring's bytes (0.69 GB, 207 us at 3.35 TB/s
// counting every shard read and copy; L2 serves most of the G-fold reads of
// a shard). Not done yet: skipping tiles that the labels mask out.
//
// Interface: q, k, v are [B, rows, H, 64] read through their (batch, seq,
// head) strides with a unit head-dim stride, rows = L (virtual) or Lloc
// (a process's shard); is_valid and segment_ids contiguous int32 [B, rows];
// out [B, rows, H, 64] contiguous in q's dtype. The launchers return the
// cudaError_t of the launch; the bf16 launcher writes the store route it
// took into params->peer_store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "fwd_core.cuh"

// Mirrored field for field by _RingParams in ops/ring_attention.py.
struct RingParams {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* is_valid;     // [B, rows]
  const int32_t* segment_ids;  // [B, rows]
  void* out;                   // [B, rows, H, 64]
  void* k_slots;               // [R, 2, B, H, Lloc, 64] in q's dtype
  void* v_slots;               // [R, 2, B, H, Lloc, 64]
  int32_t* lab_slots;          // [R, 2, B, H, 2, Lloc]: validity, segment id
  int32_t* flags;              // [R, B, H, 2, 1 + T]: per slot capacity, ready of each key tile
  void* right_k_slots;         // the right neighbour's (a process's rank; else k_slots)
  void* right_v_slots;
  int32_t* right_lab_slots;
  int32_t* right_flags;
  int32_t* left_flags;         // the left neighbour's flags (a process's rank; else flags)
  int64_t q_strides[3];        // batch, seq, head (elements)
  int64_t k_strides[3];
  int64_t v_strides[3];
  int32_t batch;
  int32_t seq_len;             // L, the whole sequence
  int32_t heads;
  int32_t n_ranks;
  int32_t grid;                // blocks launched, a multiple of R * q-groups
  int32_t rank;                // -1: the n virtual ranks; else this process's rank
  uint32_t epoch;              // launches on these flags before this one
  int32_t peer_store;          // 1: 16-byte stores to the neighbour's slots, not TMA
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

// kSys: the flag is written by another process (or card).
template <bool kSys>
__device__ __forceinline__ int32_t ld_acquire(const int32_t* p) {
  int32_t v;
  if constexpr (kSys) {
    asm volatile("ld.acquire.sys.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  } else {
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  }
  return v;
}

// Whether a counter has reached `target`. Across processes (kSys) the
// counters grow over every call on the buffers, so the comparison is
// wrap-safe; a virtual launch's counters start at 0 and stay small.
template <bool kSys>
__device__ __forceinline__ bool reached(int32_t count, uint32_t target) {
  if constexpr (kSys) return static_cast<int32_t>(static_cast<uint32_t>(count) - target) >= 0;
  return count >= static_cast<int32_t>(target);
}

// This thread's earlier stores, then +1 on *flag, at the flag's scope.
template <bool kSys>
__device__ __forceinline__ void release_add(int32_t* flag) {
  if constexpr (kSys) {
    __threadfence_system();
    asm volatile("red.release.sys.global.add.s32 [%0], 1;" ::"l"(flag) : "memory");
  } else {
    __threadfence();
    atomicAdd(flag, 1);
  }
}

template <bool kSys>
__device__ __forceinline__ void fence_stores() {
  if constexpr (kSys) {
    __threadfence_system();
  } else {
    __threadfence();
  }
}

// Fills of slot x in one call: steps s < n - 1 with (s + 1) % 2 == x.
__device__ __forceinline__ uint32_t fills_per_call(int n, int slot) {
  return slot ? n / 2 : (n - 1) / 2;
}

// Flags [R, B, H, 2, 1 + T] (T = ceil(Lloc / kKeyTile)) from `base`: for
// each member's slot, entry 0 counts the capacity posts, entry 1 + t the
// ready posts of key tile t (the f32 kernel, which copies whole steps,
// counts its ready posts in entry 1). `ri`: the rank's index in the array.
__device__ __forceinline__ int32_t* flag_ptr(int32_t* base, const RingParams& p, int ri,
                                             int member, int slot, int entry) {
  const int tiles = (p.seq_len / p.n_ranks + kKeyTile - 1) / kKeyTile;
  return base + ((static_cast<int64_t>(ri) * p.batch * p.heads + member) * 2 + slot) * (1 + tiles) +
         entry;
}

// One thread waits until *flag reaches target (traps once timeout_ns
// passed), then orders what it and its block read next after what the flag
// released, in both proxies.
template <bool kSys>
__device__ void spin_flag(const int32_t* flag, uint32_t target, int64_t timeout_ns) {
  if (!reached<kSys>(ld_acquire<kSys>(flag), target)) {
    const uint64_t t0 = global_ns();
    while (!reached<kSys>(ld_acquire<kSys>(flag), target)) {
      if (global_ns() - t0 > static_cast<uint64_t>(timeout_ns)) __trap();
      __nanosleep(100);
    }
  }
  __threadfence();
  fence_async_global();
}

// The whole block waits until *flag reaches target.
template <bool kSys>
__device__ void wait_flag(const int32_t* flag, uint32_t target, int64_t timeout_ns) {
  if (threadIdx.x == 0) spin_flag<kSys>(flag, target, timeout_ns);
  __syncthreads();
}

// After every thread's stores of the block: make them visible, add 1 to
// *flag. Across processes each thread fences its own stores at system scope
// first; within one card thread 0's fence after the barrier covers them.
template <bool kSys>
__device__ void post_flag(int32_t* flag) {
  if constexpr (kSys) fence_stores<true>();
  __syncthreads();
  if (threadIdx.x == 0) release_add<kSys>(flag);
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

// Where a unit's rank sits: its ring position, and the index of its own,
// its right and its left neighbour's slots and flags in their arrays (in a
// process, each array holds one rank: index 0).
struct Ranks {
  int me, right, left;       // ring positions
  int own_i, right_i, left_i;
  int row0;                  // the rank's first row in q, k, v, the labels and out
};

template <bool kProc>
__device__ __forceinline__ Ranks ranks_of(const RingParams& p, const Unit& w, int Lloc) {
  const int n = p.n_ranks;
  const int me = kProc ? p.rank : w.rank;
  const int right = (me + 1) % n;
  const int left = (me + n - 1) % n;
  if constexpr (kProc) return {me, right, left, 0, 0, 0, 0};
  return {me, right, left, me, right, left, me * Lloc};
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

// Warps 0 .. 7 are the two consumer warpgroups, warp 8 the producer.
template <bool kProc>
__global__ void __launch_bounds__(128 * 2 + 32, 1)
    ring_fwd_bf16_kernel(const RingParams p, const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_k_slots,
                         const __grid_constant__ CUtensorMap tm_v_slots,
                         const __grid_constant__ CUtensorMap tm_k_right,
                         const __grid_constant__ CUtensorMap tm_v_right) {
  constexpr int NWG = 2;
  constexpr int N = kKeyTile;
  constexpr int S = fwd::kStages;
  extern __shared__ char smem_raw[];
  fwd::Smem<NWG, N>& sm = fwd::smem_of<NWG, N>(smem_raw);
  const int n = p.n_ranks;
  const int R = kProc ? 1 : n;  // ranks in this launch
  const int L = p.seq_len;
  const int H = p.heads;
  const int Lloc = L / n;
  const int rows = kProc ? Lloc : L;
  const int groups = (Lloc + kGroupBf16 - 1) / kGroupBf16;
  const int units = R * groups * p.batch * H;
  const int n_tiles = (Lloc + N - 1) / N;
  const int members = p.batch * H;
  const int warp = __shfl_sync(~0u, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  fwd::init_barriers(sm);

  if (warp == 4 * NWG) {  // producer: the ring's protocol and every copy
    int32_t* const right_flags = kProc ? p.right_flags : p.flags;
    int32_t* const left_flags = kProc ? p.left_flags : p.flags;
    int32_t* const right_labs = kProc ? p.right_lab_slots : p.lab_slots;
    const CUtensorMap* k_dst = kProc ? &tm_k_right : &tm_k_slots;
    const CUtensorMap* v_dst = kProc ? &tm_v_right : &tm_v_slots;
    const uint32_t epoch = kProc ? p.epoch : 0u;  // a virtual launch's flags start at 0
    uint32_t c = 0, k = 0;
    for (int u = blockIdx.x; u < units; u += p.grid, ++k) {
      const Unit w = unit_of(u, R, groups, H);
      const Ranks rk = ranks_of<kProc>(p, w, Lloc);
      const int member = w.b * H + w.h;
      const int64_t lab0 = static_cast<int64_t>(w.b) * rows + rk.row0;
      if (lane == 0) {
        if (k > 0) mbar_wait(&sm.q_empty, (k - 1) & 1);
        mbar_expect_tx(&sm.q_full, kGroupBf16 * kD * 2);
        tma_tile(sm.q[0], &tm_q, w.h, rk.row0 + w.g * kGroupBf16, w.b, &sm.q_full);
      }
      for (int s = 0; s < n; ++s) {
        const int send = s & 1;
        const int recv = send ^ 1;
        fwd::TileSource src;
        if (s == 0) {
          src = {&tm_k, &tm_v, {0, w.h, rk.row0, w.b}, 2, p.is_valid + lab0,
                 p.segment_ids + lab0, Lloc, false};
        } else {
          const int32_t* lab =
              p.lab_slots + ((static_cast<int64_t>(rk.own_i) * 2 + send) * members + member) * 2 * Lloc;
          src = {&tm_k_slots, &tm_v_slots, {0, 0, member, rk.own_i * 2 + send}, 1, lab,
                 lab + Lloc, Lloc, true};
        }
        int32_t* dst_lab =
            right_labs + ((static_cast<int64_t>(rk.right_i) * 2 + recv) * members + member) * 2 * Lloc;
        const int64_t dst_row0 =
            ((static_cast<int64_t>(rk.right_i) * 2 + recv) * members + member) * Lloc;
        const uint32_t c0 = c;
        // the right neighbour's slot `recv` is free (in a virtual launch,
        // at step 0: nothing has filled it yet)
        bool room = !kProc && s == 0;
        // tile t to the right neighbour once it has landed: K and V by TMA
        // store (or the lanes' 16-byte stores), its labels by the lanes from
        // the stage (each lane the entries it staged)
        auto store = [&](int t) {
          if (!room) {  // it consumed the fills of that slot before this one, each q-group once
            if (lane == 0) {
              const uint32_t before = epoch * fills_per_call(n, recv) + s / 2;
              spin_flag<kProc>(flag_ptr(p.flags, p, rk.own_i, member, recv, kCapacity),
                               groups * before, p.timeout_ns);
            }
            __syncwarp();
            room = true;
          }
          const uint32_t cc = c0 + t;
          const int st = cc % S;
          if (kProc && p.peer_store) {  // every lane reads the stage: every lane waits for it
            mbar_wait(&sm.full[st], (cc / S) & 1);
            const char* ks = reinterpret_cast<const char*>(sm.k[st]);
            const char* vs = reinterpret_cast<const char*>(sm.v[st]);
            __nv_bfloat16* kd = static_cast<__nv_bfloat16*>(kProc ? p.right_k_slots : p.k_slots) +
                                (dst_row0 + t * N) * kD;
            __nv_bfloat16* vd = static_cast<__nv_bfloat16*>(kProc ? p.right_v_slots : p.v_slots) +
                                (dst_row0 + t * N) * kD;
            for (int i = lane; i < N * 8; i += 32) {  // 8 chunks of 16 bytes a row
              const int r = i >> 3;
              const int ch = i & 7;
              if (t * N + r < Lloc) {
                const int off = r * 128 + ((ch ^ (r & 7)) << 4);  // the 128-byte swizzle
                *reinterpret_cast<int4*>(kd + r * kD + ch * 8) =
                    *reinterpret_cast<const int4*>(ks + off);
                *reinterpret_cast<int4*>(vd + r * kD + ch * 8) =
                    *reinterpret_cast<const int4*>(vs + off);
              }
            }
          } else if (lane == 0) {
            mbar_wait(&sm.full[st], (cc / S) & 1);
            tma_store_4d(k_dst, sm.k[st], 0, t * N, member, rk.right_i * 2 + recv);
            tma_store_4d(v_dst, sm.v[st], 0, t * N, member, rk.right_i * 2 + recv);
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
          fence_stores<kProc>();  // each lane's label (and 16-byte) stores
          __syncwarp();
          if (lane == 0) {
            bulk_wait();
            fence_async_global();
            release_add<kProc>(flag_ptr(right_flags, p, rk.right_i, member, recv, 1 + t));
          }
          __syncwarp();
        };
        // s >= 1: until tile t of our slot `send` is filled, the lanes read
        // the ready flags of the next 32 tiles at once; `ready` tiles are
        // known to be filled
        const uint32_t filled_by =
            epoch * fills_per_call(n, send) + static_cast<uint32_t>((s - 1) / 2 + 1);
        int ready = s == 0 ? n_tiles : 0;
        auto wait_ready = [&](int t) {
          if (t < ready) return;
          const uint64_t t0 = global_ns();
          while (t >= ready) {
            const int tt = ready + lane;
            const bool filled =
                tt >= n_tiles ||
                reached<kProc>(
                    ld_acquire<kProc>(flag_ptr(p.flags, p, rk.own_i, member, send, 1 + tt)),
                    filled_by);
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
        // every load of the resident slot has landed: consumed. Within one
        // launch nothing waits for the consumptions of the last two steps;
        // across processes the next call's fills do
        if (s >= 1 && (kProc || s <= n - 3) && lane == 0) {
          for (uint32_t cc = c - min(static_cast<uint32_t>(S), c - c0); cc < c; ++cc) {
            mbar_wait(&sm.full[cc % S], (cc / S) & 1);
          }
          fence_async_global();
          release_add<kProc>(flag_ptr(left_flags, p, rk.left_i, member, send, kCapacity));
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
    const Unit w = unit_of(u, R, groups, H);
    const Ranks rk = ranks_of<kProc>(p, w, Lloc);
    const int row0 = w.g * kGroupBf16 + wg * fwd::kWgRows + 16 * wwarp + (lane >> 2);
    const int64_t lab0 = static_cast<int64_t>(w.b) * rows + rk.row0;
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

__device__ Shard own_shard(const RingParams& p, int row0, int rows, int b, int h) {
  const float* k = static_cast<const float*>(p.k) + b * p.k_strides[0] + row0 * p.k_strides[1] +
                   h * p.k_strides[2];
  const float* v = static_cast<const float*>(p.v) + b * p.v_strides[0] + row0 * p.v_strides[1] +
                   h * p.v_strides[2];
  const int64_t lab = static_cast<int64_t>(b) * rows + row0;
  return {k, v, p.k_strides[1], p.v_strides[1], p.is_valid + lab, p.segment_ids + lab};
}

// Slot `slot` of member (b, h) at index `ri` of the slot arrays from these bases.
__device__ Slot slot_of(const RingParams& p, void* k_slots, void* v_slots, int32_t* lab_slots,
                        int ri, int slot, int b, int h, int Lloc) {
  const int64_t rs = static_cast<int64_t>(ri) * 2 + slot;
  const int64_t member = (rs * p.batch + b) * p.heads + h;
  const int64_t kv = member * Lloc * kD;
  const int64_t lab = member * 2 * Lloc;
  return {static_cast<float*>(k_slots) + kv, static_cast<float*>(v_slots) + kv, lab_slots + lab,
          lab_slots + lab + Lloc};
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
template <bool kProc>
__global__ void __launch_bounds__(kGroupF32) ring_fwd_f32_kernel(const RingParams p) {
  __shared__ __align__(16) float sK[kBlockK][kD];
  __shared__ __align__(16) float sV[kBlockK][kD];
  __shared__ int32_t sKValid[kBlockK];
  __shared__ int32_t sKSeg[kBlockK];

  const int n = p.n_ranks;
  const int R = kProc ? 1 : n;
  const int Lloc = p.seq_len / n;
  const int rows = kProc ? Lloc : p.seq_len;
  const int groups = (Lloc + kGroupF32 - 1) / kGroupF32;
  const int units = R * groups * p.batch * p.heads;
  const int tid = threadIdx.x;
  int32_t* const right_flags = kProc ? p.right_flags : p.flags;
  int32_t* const left_flags = kProc ? p.left_flags : p.flags;
  void* const right_k = kProc ? p.right_k_slots : p.k_slots;
  void* const right_v = kProc ? p.right_v_slots : p.v_slots;
  int32_t* const right_labs = kProc ? p.right_lab_slots : p.lab_slots;
  const uint32_t epoch = kProc ? p.epoch : 0u;  // a virtual launch's flags start at 0
  for (int u = blockIdx.x; u < units; u += p.grid) {
    const Unit w = unit_of(u, R, groups, p.heads);
    const Ranks rk = ranks_of<kProc>(p, w, Lloc);
    const int b = w.b, h = w.h;
    const int member = b * p.heads + h;
    const int64_t row0 = rk.row0;
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
    const int64_t lab = static_cast<int64_t>(b) * rows + row0;
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
      const Shard res =
          s == 0 ? own_shard(p, rk.row0, rows, b, h)
                 : as_shard(slot_of(p, p.k_slots, p.v_slots, p.lab_slots, rk.own_i, send, b, h,
                                    Lloc));
      if (s < n - 1) {
        // the right neighbour consumed the fills of its slot `recv` before
        // this one, each of its q-groups once (in a virtual launch nothing
        // has filled it at step 0)
        if (kProc || s >= 1) {
          const uint32_t before = epoch * fills_per_call(n, recv) + s / 2;
          wait_flag<kProc>(flag_ptr(p.flags, p, rk.own_i, member, recv, kCapacity),
                           groups * before, p.timeout_ns);
        }
        // this q-group's rows of the shard
        copy_rows(slot_of(p, right_k, right_v, right_labs, rk.right_i, recv, b, h, Lloc), res,
                  w.g * kGroupF32, min(Lloc, (w.g + 1) * kGroupF32));
        post_flag<kProc>(flag_ptr(right_flags, p, rk.right_i, member, recv, 1));
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
      if (s >= 1 && (kProc || s <= n - 3)) {  // the resident slot is read: consumed
        post_flag<kProc>(flag_ptr(left_flags, p, rk.left_i, member, send, kCapacity));
      }
      if (s < n - 1) {
        // the left neighbour's q-groups filled our slot `recv` at each of
        // its steps t <= s with t % 2 == s % 2
        const uint32_t filled_by = epoch * fills_per_call(n, recv) + s / 2 + 1;
        wait_flag<kProc>(flag_ptr(p.flags, p, rk.own_i, member, recv, 1), groups * filled_by,
                         p.timeout_ns);
      }
    }

    if (in) {
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      float* orow = static_cast<float*>(p.out) +
                    ((static_cast<int64_t>(b) * rows + row0 + row) * p.heads + h) * kD;
#pragma unroll
      for (int d = 0; d < kD; d += 4) {
        *reinterpret_cast<float4*>(orow + d) =
            make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
      }
    }
  }
}

// The slots [R, 2, B, H, Lloc, 64] from `base` seen as (d, Lloc, member,
// rank and slot), boxes of `rows` rows cut at Lloc.
bool slot_map(EncodeTiledFn encode, CUtensorMap* map, const void* base, const RingParams* p,
              int ranks, int rows) {
  const cuuint64_t lloc = p->seq_len / p->n_ranks;
  const cuuint64_t members = static_cast<cuuint64_t>(p->batch) * p->heads;
  const cuuint64_t dims[4] = {64, lloc, members, 2 * static_cast<cuuint64_t>(ranks)};
  const cuuint64_t bytes[3] = {128, lloc * 128, members * lloc * 128};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  return bf16_map(encode, map, base, dims, bytes, box);
}

template <bool kProc>
cudaError_t launch_bf16(RingParams* p, cudaStream_t stream) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int B = p->batch, H = p->heads;
  const int R = kProc ? 1 : p->n_ranks;
  const int rows = kProc ? p->seq_len / p->n_ranks : p->seq_len;
  CUtensorMap maps[7];
  if (!seq_map(encode, &maps[0], p->q, p->q_strides, B, rows, H, kGroupBf16) ||
      !seq_map(encode, &maps[1], p->k, p->k_strides, B, rows, H, kKeyTile) ||
      !seq_map(encode, &maps[2], p->v, p->v_strides, B, rows, H, kKeyTile) ||
      !slot_map(encode, &maps[3], p->k_slots, p, R, kKeyTile) ||
      !slot_map(encode, &maps[4], p->v_slots, p, R, kKeyTile)) {
    return cudaErrorInvalidValue;
  }
  maps[5] = maps[3];
  maps[6] = maps[4];
  // the route of the copies to the right neighbour: TMA stores through a
  // map over its slots, unless the caller asked for 16-byte stores or the
  // driver refuses the map
  if (kProc && !p->peer_store &&
      (!slot_map(encode, &maps[5], p->right_k_slots, p, R, kKeyTile) ||
       !slot_map(encode, &maps[6], p->right_v_slots, p, R, kKeyTile))) {
    p->peer_store = 1;
  }
  auto kernel = ring_fwd_bf16_kernel<kProc>;
  constexpr int smem = fwd::kSmemBytes<2, kKeyTile>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  RingParams pc = *p;
  void* args[] = {&pc, &maps[0], &maps[1], &maps[2], &maps[3], &maps[4], &maps[5], &maps[6]};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(pc.grid),
                                    dim3(128 * 2 + 32), args, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <bool kProc>
cudaError_t launch_f32(const RingParams* params, cudaStream_t stream) {
  RingParams p = *params;
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ring_fwd_f32_kernel<kProc>), dim3(p.grid), dim3(kGroupF32),
      args, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// The round trip of a flag between two processes, the handshake the ring
// is built on: a buffer's word 0 is its flag, words 1 .. 1024 a payload.
// Rank 0 stores the payload of round i into the peer's buffer and raises
// the peer's flag; rank 1 waits for it, checks the payload and answers in
// kind; `rounds` times. times[i]: ns from the start to round i's send (0:
// to the end); bad: the payload words that differed.
__global__ void ring_pingpong_kernel(int32_t* own, int32_t* peer, int rank, int rounds,
                                     int64_t timeout_ns, uint64_t* times, int32_t* bad) {
  if (threadIdx.x != 0) return;
  const uint64_t t0 = global_ns();
  int32_t errors = 0;
  auto receive = [&](int i) {
    spin_flag<true>(own, static_cast<uint32_t>(i), timeout_ns);
    for (int j = 0; j < 1024; ++j) errors += own[1 + j] != i * 7 + j;
  };
  for (int i = 1; i <= rounds; ++i) {
    if (rank == 1) receive(i);
    if (rank == 0 && i > 1) receive(i - 1);
    for (int j = 0; j < 1024; ++j) peer[1 + j] = i * 7 + j;
    release_add<true>(peer);
    times[i] = global_ns() - t0;
  }
  if (rank == 0) receive(rounds);
  times[0] = global_ns() - t0;
  *bad = errors;
}

}  // namespace

extern "C" {

// Size of RingParams, so the Python side can check its ctypes mirror.
size_t ring_fwd_params_size() { return sizeof(RingParams); }

// For the current device: the most blocks of the f32 (f32 != 0) or bf16
// kernel that can be resident at once (with its dynamic shared memory), and
// the query rows of its q-group. Both modes of a kernel use the same
// resources.
cudaError_t ring_fwd_launch_info(int f32, int32_t* max_blocks, int32_t* group_rows) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  constexpr int smem = fwd::kSmemBytes<2, kKeyTile>;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  for (int proc = 0; proc < 2 && err == cudaSuccess && !f32; ++proc) {
    err = cudaFuncSetAttribute(proc ? ring_fwd_bf16_kernel<true> : ring_fwd_bf16_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  int other = 0;
  if (err == cudaSuccess) {
    err = f32 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_fwd_f32_kernel<false>,
                                                              kGroupF32, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, ring_fwd_bf16_kernel<false>, 128 * 2 + 32, smem);
  }
  if (err == cudaSuccess) {
    err = f32 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&other, ring_fwd_f32_kernel<true>,
                                                              kGroupF32, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &other, ring_fwd_bf16_kernel<true>, 128 * 2 + 32, smem);
  }
  *max_blocks = (per_sm < other ? per_sm : other) * sms;
  *group_rows = f32 ? kGroupF32 : kGroupBf16;
  return err;
}

// Virtual ranks (params->rank < 0) or this process's rank.
cudaError_t ring_fwd_bf16(RingParams* params, cudaStream_t stream) {
  return params->rank < 0 ? launch_bf16<false>(params, stream) : launch_bf16<true>(params, stream);
}

cudaError_t ring_fwd_f32(RingParams* params, cudaStream_t stream) {
  return params->rank < 0 ? launch_f32<false>(params, stream) : launch_f32<true>(params, stream);
}

// --- buffers shared with the neighbours' processes (CUDA IPC) ---------------

// `bytes` of device memory on the current device, zeroed before this
// returns, and its IPC handle (64 bytes into `handle`).
cudaError_t ring_ipc_alloc(size_t bytes, void** ptr, void* handle) {
  cudaError_t err = cudaMalloc(ptr, bytes);
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess) err = cudaIpcGetMemHandle(&h, *ptr);
  if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return err;
}

// Maps a neighbour's allocation from its handle. The runtime takes one
// flag, cudaIpcMemLazyEnablePeerAccess: peer access to the neighbour's card
// is enabled where its memory lies on another card.
cudaError_t ring_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

cudaError_t ring_ipc_close(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

cudaError_t ring_ipc_free(void* ptr) { return cudaFree(ptr); }

size_t ring_ipc_handle_size() { return sizeof(cudaIpcMemHandle_t); }

// ring_pingpong_kernel on two ranks' buffers (at least 1025 words each),
// launched cooperatively, as the ring kernels are.
cudaError_t ring_ipc_pingpong(void* own, void* peer, int rank, int rounds, int64_t timeout_ns,
                              uint64_t* times, int32_t* bad, cudaStream_t stream) {
  int32_t* own_i = static_cast<int32_t*>(own);
  int32_t* peer_i = static_cast<int32_t*>(peer);
  void* args[] = {&own_i, &peer_i, &rank, &rounds, &timeout_ns, &times, &bad};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ring_pingpong_kernel), dim3(1), dim3(32), args, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // extern "C"
