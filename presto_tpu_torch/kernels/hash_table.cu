// Open-addressing hash table insert and probe for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of presto_tpu/ops/pallas_hash.py:
//   - insert: insert_table (pallas_call at :197, body _insert_body :109)
//   - probe:  probe_table  (pallas_call at :261, body _probe_body :223)
//
// Insert. The reference's round semantics decide where every key lands, and
// the outputs stay bit-identical to them (and to insert_table_reference,
// which mirrors this kernel step for step): in round d every pending row
// bids for slot (h + d) & (S - 1) if that slot was empty at the start of the
// round, the lowest bidding row id claims it, and every pending row whose
// slot now holds its full key resolves to it. Four facts shape the kernel:
//   - a row pending in round d has walked exactly d slots, so the worklist
//     holds (row, home slot) pairs and nothing else;
//   - a bid is (d << 32 | row) and claims[c] keeps the lowest bid: a slot
//     claimed in an earlier round compares lower than any later bid, so
//     every pending row bids without first reading whether its slot is
//     empty, and claims is never reset;
//   - after the bids, claims[c] names the row that owns slot c, and a row
//     resolves iff its input key equals the owner's. A row that stays
//     pending bids for the next round at once: that bid cannot lower a
//     claim that a row of this round reads. So a round is one phase,
//     resolve-and-bid, and one barrier;
//   - the slot arrays follow from claims, so they are written once, after
//     the rounds, in order: no scattered 4- and 8-byte stores (each one a
//     read-modify-write of a sector in device memory) during the rounds.
// All rounds run in one cooperative launch (cooperative_groups grid
// barriers), each over the rows still pending: survivors are appended to
// the other of two worklists with one shared atomic per warp and one global
// atomic per block. Once at most kTailRows rows are pending, block 0 runs
// the remaining rounds alone at block barriers with the worklist in shared
// memory, and the other blocks leave. A second, ordinary launch writes the
// slot arrays and takes the longest occupied run. That is 2 device launches
// per insert where the first port issued 3 per round.
//
// What bounds the insert on an H100 SXM is not bytes (its outputs and
// inputs at n = 2^21 rows, S = 2^22 slots and one component move 77.6 MB,
// 23 us at 3.35 TB/s) but round 0's ~1.9 M scattered 64-bit atomics and
// reads, then latency: one grid barrier per round while the worklist is
// large, then the tail's rounds, each a chain of dependent scattered
// accesses (the owner, its key, the next bid) and a block barrier.
// kTailRows = 1024 (4 rows per thread of the one block) measured as fast
// as 256 and faster than 2048 (kernel_sweep.py): at Q3's shape it leaves 15
// rounds on the grid and 22 to the tail.
//
// Probe. A fixed-trip linear scan from h(key), one probe row per thread: a
// key match returns the stored build row, an empty slot ends the scan as a
// miss. What bounds it is the scattered 32-byte sectors of the table (50 MB
// at S = 2^22, about the size of the L2) that the walks reach, not their
// latency: the card keeps enough rows in flight at one row per thread.
// So a visit reads slot_keys only after slot_rows shows the slot occupied,
// which skips the key sector of every empty slot that ends a miss, and the
// hash is taken from the key in a register. Walking several rows per thread
// with both loads of a visit issued together measured slower (PERF.md).
//
// Plain C interface: each entry point launches on the given stream, does not
// synchronise, allocates nothing, and returns the cudaError_t of its
// launches (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kTailRows = 1024;       // worklist size at which block 0 takes over
constexpr int kEmpty = -1;
constexpr unsigned long long kClaimFree = ~0ULL;  // claims entry of an empty slot
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x = (x ^ (x >> 33)) * 0xFF51AFD7ED558CCDULL;
  x = (x ^ (x >> 33)) * 0xC4CEB9FE1A85EC53ULL;
  return x ^ (x >> 33);
}

// Home slot of a row: presto_tpu/ops/pallas_hash.py _hash_base over _mix64.
// comps is (ncomps, n) row-major: component c of row r is comps[c * n + r].
__device__ __forceinline__ int home_slot(const long long* comps, int ncomps,
                                         int n, int row, int slots) {
  unsigned long long acc = mix64((unsigned long long)__ldg(&comps[row]));
  for (int c = 1; c < ncomps; ++c) {
    acc = mix64(acc ^ ((unsigned long long)__ldg(&comps[(long long)c * n + row]) *
                       0x9E3779B97F4A7C15ULL));
  }
  return (int)(acc & (unsigned long long)(slots - 1));
}

struct InsertArgs {
  const long long* comps;     // (ncomps, n)
  const unsigned char* mask;  // (n,)
  int ncomps, n, slots, trips;
  long long* slot_comps;      // (ncomps, slots)
  int* slot_rows;             // (slots,)
  int* gid;                   // (n,)
  int* stats;                 // (3,)
  unsigned long long* claims; // (slots,) scratch: (round << 32 | row) of each owner
  int2* work;                 // (2, n) scratch: two worklists of (row, home)
  int* counts;                // (trips + 1,): rows pending at the start of round d
};

// Adds v summed over the block to *dst with one atomic. Every thread of
// the block calls it.
__device__ void block_add(int v, int* dst) {
  __shared__ int s_sum;
  if (threadIdx.x == 0) s_sum = 0;
  __syncthreads();
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(&s_sum, v);
  __syncthreads();
  if (threadIdx.x == 0 && s_sum) atomicAdd(dst, s_sum);
}

// A bid of `row` for its slot in round d: claims keeps the lowest bid, and
// bids of earlier rounds compare lower, so a slot claimed before keeps its
// owner and only the round's bids for an empty slot compete: the lowest row
// id wins. So a row bids for round d + 1 while round d is still being
// resolved: its bid cannot lower a claim that holds a bid of round d or
// earlier, and a slot without one is read by no row of round d.
__device__ __forceinline__ void bid(const InsertArgs& a, int d, int row, int home) {
  atomicMin(&a.claims[(home + d) & (a.slots - 1)],
            ((unsigned long long)d << 32) | (unsigned)row);
}

// Round d for one row that bid in it: claims[c] names the owner of its slot
// c, and the row resolves iff its input key equals the owner's; otherwise
// it bids for round d + 1, if there is one. Returns whether it stays
// pending.
__device__ __forceinline__ bool resolve(const InsertArgs& a, int d, int row,
                                        int home, int* won) {
  int c = (home + d) & (a.slots - 1);
  int owner = (int)(unsigned)__ldcg(&a.claims[c]);
  bool same = true;
  if (owner == row) {
    ++*won;
  } else {
    for (int k = 0; k < a.ncomps && same; ++k) {
      same = __ldg(&a.comps[(long long)k * a.n + owner]) ==
             __ldg(&a.comps[(long long)k * a.n + row]);
    }
  }
  if (same) {
    a.gid[row] = c;
    return false;
  }
  if (d + 1 < a.trips) bid(a, d + 1, row, home);
  return true;
}

// Round 0's bids on the whole grid: every row's gid starts at -1, every
// masked row bids, and counts[0] counts them.
__device__ void grid_bids0(const InsertArgs& a) {
  int live = 0;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x; row < a.n;
       row += (long long)gridDim.x * blockDim.x) {
    a.gid[row] = kEmpty;
    if (__ldg(&a.mask[row])) {
      ++live;
      bid(a, 0, (int)row, home_slot(a.comps, a.ncomps, a.n, (int)row, a.slots));
    }
  }
  block_add(live, &a.counts[0]);
  cg::this_grid().sync();
}

// Round d on the whole grid over the items [0, count), which have bid in
// it: kFirst, round 0, whose items are the rows themselves (live where
// masked); later rounds read (row, home) from worklist d & 1. Survivors go
// to worklist (d + 1) & 1 and are counted in counts[d + 1]. One grid
// barrier ends the round. Data written during the kernel is read with
// __ldcg (from L2): L1 is not coherent across blocks.
template <bool kFirst>
__device__ void grid_round(const InsertArgs& a, int d, int count, int* won) {
  const int2* in = a.work + (long long)(d & 1) * a.n;
  int2* out = a.work + (long long)((d + 1) & 1) * a.n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  __shared__ int s_count, s_base;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < count;
       base += stride) {  // block-uniform trips
    long long i = base + threadIdx.x;
    int row = 0, home = 0;
    bool still = false;
    if (i < count) {
      bool pending = true;
      if (kFirst) {
        row = (int)i;
        pending = __ldg(&a.mask[row]) != 0;
        if (pending) home = home_slot(a.comps, a.ncomps, a.n, row, a.slots);
      } else {
        int2 item = __ldcg(&in[i]);
        row = item.x;
        home = item.y;
      }
      still = pending && resolve(a, d, row, home, won);
    }
    // append the survivors: one shared atomic per warp, one global per block
    unsigned ballot = __ballot_sync(0xffffffffu, still);
    int warp_off = 0;
    if (lane == 0 && ballot) warp_off = atomicAdd(&s_count, __popc(ballot));
    warp_off = __shfl_sync(0xffffffffu, warp_off, 0);
    __syncthreads();
    if (threadIdx.x == 0) {
      s_base = s_count ? atomicAdd(&a.counts[d + 1], s_count) : 0;
      s_count = 0;
    }
    __syncthreads();
    if (still) {
      out[s_base + warp_off + __popc(ballot & ((1u << lane) - 1u))] =
          make_int2(row, home);
    }
  }
  cg::this_grid().sync();
}

// Rounds d.. on block 0 alone, one block barrier each, with the worklist
// (at most kTailRows rows) in shared memory. d == 0: round 0's bids are
// made here, from the mask; otherwise the `count` rows of worklist d & 1
// have bid in round d. Returns the rows still pending after the last round.
__device__ int tail_rounds(const InsertArgs& a, int d, int count, int* won) {
  __shared__ int2 s_work[2][kTailRows];
  __shared__ int s_n[3];  // survivors of round d go to s_n[(d + 1) % 3]
  if (threadIdx.x == 0) s_n[0] = s_n[1] = s_n[2] = 0;
  __syncthreads();
  if (d == 0) {
    for (int row = threadIdx.x; row < a.n; row += blockDim.x) {
      a.gid[row] = kEmpty;
      if (__ldg(&a.mask[row])) {
        int home = home_slot(a.comps, a.ncomps, a.n, row, a.slots);
        bid(a, 0, row, home);
        s_work[0][atomicAdd(&s_n[0], 1)] = make_int2(row, home);
      }
    }
    __syncthreads();
    count = s_n[0];
    if (threadIdx.x == 0) a.counts[0] = count;
  } else if (d < a.trips) {
    const int2* in = a.work + (long long)(d & 1) * a.n;
    for (int i = threadIdx.x; i < count; i += blockDim.x) s_work[d & 1][i] = __ldcg(&in[i]);
    __syncthreads();
  }
  for (; d < a.trips && count > 0; ++d) {
    const int2* cur = s_work[d & 1];
    int2* next = s_work[(d + 1) & 1];
    int* n_next = &s_n[(d + 1) % 3];
    // the counter of round d + 1, last read before the previous barrier
    if (threadIdx.x == 0) s_n[(d + 2) % 3] = 0;
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      int2 item = cur[i];
      if (resolve(a, d, item.x, item.y, won)) next[atomicAdd(n_next, 1)] = item;
    }
    __syncthreads();
    count = *n_next;
    if (threadIdx.x == 0) a.counts[d + 1] = count;
  }
  return count;
}

__global__ void __launch_bounds__(kBlock) ht_insert_rounds(InsertArgs a) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  for (long long s = tid; s < a.slots; s += nthreads) a.claims[s] = kClaimFree;
  for (long long i = tid; i <= a.trips; i += nthreads) a.counts[i] = 0;
  if (tid < 3) a.stats[tid] = 0;
  cg::this_grid().sync();

  int won = 0;  // slots this thread's rows claimed
  int d = 0;
  int count = a.n;
  if (count > kTailRows) {
    grid_bids0(a);
    grid_round<true>(a, 0, a.n, &won);  // round 0 visits every row
    for (d = 1, count = __ldcg(&a.counts[1]); d < a.trips && count > kTailRows;
         count = __ldcg(&a.counts[++d])) {  // after a grid barrier: the same in every block
      grid_round<false>(a, d, count, &won);
    }
  }
  if (blockIdx.x == 0) count = tail_rounds(a, d, count, &won);
  block_add(won, &a.stats[2]);
  if (tid == 0) a.stats[0] = count > 0;  // overflow
}

// Second launch, after every round: the slot arrays from the owners in
// claims, written once and coalesced (empty slots: key 0, row -1), and the
// longest circular run of occupied slots (_max_occupied_run). Each warp
// takes words of 32 slots (the whole table when it is smaller): the runs
// inside a word come from its occupancy bits, and a run that starts in the
// word and reaches its last slot is followed word by word to its end. A
// table with no empty slot has no terminating run: the reference's
// doubled-array cummax then reads 2 * S.
__global__ void __launch_bounds__(kBlock) ht_insert_finish(InsertArgs a) {
  const int lane = threadIdx.x & 31;
  const int width = a.slots < 32 ? a.slots : 32;
  const unsigned all = width == 32 ? 0xffffffffu : (1u << width) - 1u;
  const long long words = a.slots / width;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const bool full = a.stats[2] == a.slots;
  auto occupied = [&](long long word) {
    long long s = word * width + lane;
    return __ballot_sync(0xffffffffu,
                         lane < width && a.claims[s] != kClaimFree);
  };
  int best = 0;
  for (long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       w < words; w += nwarps) {  // warp-uniform trips
    long long s = w * width + lane;
    int row = kEmpty;
    if (lane < width) {
      unsigned long long owner = a.claims[s];
      if (owner != kClaimFree) row = (int)(unsigned)owner;
      a.slot_rows[s] = row;
      for (int k = 0; k < a.ncomps; ++k) {
        a.slot_comps[(long long)k * a.slots + s] =
            row < 0 ? 0 : __ldg(&a.comps[(long long)k * a.n + row]);
      }
    }
    unsigned occ = __ballot_sync(0xffffffffu, row >= 0);
    if (full) continue;
    int run;  // the run through the word's last slot, if it starts in this word
    if (occ != all) {
      int inside = 0;  // longest run of ones inside the word
      for (unsigned x = occ; x; x &= x >> 1) ++inside;
      best = max(best, inside);
      run = __clz(~(occ << (32 - width)));
    } else {
      run = a.claims[(w * width + a.slots - 1) & (a.slots - 1)] == kClaimFree ? width : 0;
    }
    for (long long step = 1; run > 0 && step <= words; ++step) {
      unsigned next = occupied((w + step) % words);
      if (next != all) {
        run += __ffs(~next) - 1;
        break;
      }
      run += width;
    }
    best = max(best, run);
  }
  best = __reduce_max_sync(0xffffffffu, best);
  __shared__ int s_best;
  if (threadIdx.x == 0) s_best = 0;
  __syncthreads();
  if (lane == 0 && best) atomicMax(&s_best, best);
  __syncthreads();
  if (threadIdx.x == 0 && s_best) atomicMax(&a.stats[1], s_best);
  if (blockIdx.x == 0 && threadIdx.x == 0 && full) a.stats[1] = 2 * a.slots;
}

__global__ void __launch_bounds__(kBlock) ht_probe_rows(
    const long long* __restrict__ slot_keys, const int* __restrict__ slot_rows,
    int slots, const long long* __restrict__ keys,
    const unsigned char* __restrict__ mask, int n, int trips,
    int* __restrict__ out) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  int found = kEmpty;
  if (mask[row]) {
    long long key = keys[row];
    int c = (int)(mix64((unsigned long long)key) & (unsigned long long)(slots - 1));
    for (int d = 0; d < trips; ++d) {
      int srow = slot_rows[c];
      if (srow < 0) break;  // an empty slot ends the cluster: a miss
      if (slot_keys[c] == key) {  // read only for an occupied slot
        found = srow;
        break;
      }
      c = (c + 1) & (slots - 1);
    }
  }
  out[row] = found;
}

inline int blocks_for(long long count, int per_block) {
  return (int)((count + per_block - 1) / per_block);
}

// Cooperative grid of the insert: as many blocks as fit on the card at
// once, queried once per device.
std::atomic<int> g_insert_blocks[kMaxDevices];

cudaError_t insert_grid(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int cached = g_insert_blocks[dev].load();
  if (cached > 0) {
    *blocks = cached;
    return cudaSuccess;
  }
  int coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ht_insert_rounds,
                                                           kBlock, 0)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  g_insert_blocks[dev].store(*blocks);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The insert's launch shape on the current device: cooperative grid blocks,
// threads per block, and the worklist size at which block 0 takes over.
int ht_insert_config(int* grid_blocks, int* block_threads, int* tail_rows) {
  *block_threads = kBlock;
  *tail_rows = kTailRows;
  return (int)insert_grid(grid_blocks);
}

// Outputs and scratch, allocated (uninitialised) by the caller:
//   slot_comps (ncomps, slots) int64, slot_rows (slots,) int32,
//   gid (n,) int32, stats (3,) int32, claims (slots,) int64,
//   work (2, n, 2) int32, counts (trips + 1,) int32.
// Refuses (cudaErrorNotSupported) a card without cooperative launch.
int ht_insert(const long long* comps, const unsigned char* mask, int ncomps,
              int n, int slots, int trips, long long* slot_comps,
              int* slot_rows, int* gid, int* stats, long long* claims,
              int* work, int* counts, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = insert_grid(&blocks);
  if (err != cudaSuccess) return (int)err;
  InsertArgs a{comps, mask, ncomps, n, slots, trips, slot_comps, slot_rows,
               gid, stats, reinterpret_cast<unsigned long long*>(claims),
               reinterpret_cast<int2*>(work), counts};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)ht_insert_rounds, dim3(blocks),
                                    dim3(kBlock), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  ht_insert_finish<<<blocks, kBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

int ht_probe(const long long* slot_keys, const int* slot_rows, int slots,
             const long long* keys, const unsigned char* mask, int n,
             int trips, int* out, cudaStream_t stream) {
  if (n == 0) return 0;
  ht_probe_rows<<<blocks_for(n, kBlock), kBlock, 0, stream>>>(
      slot_keys, slot_rows, slots, keys, mask, n, trips, out);
  return (int)cudaGetLastError();
}

const char* ht_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
