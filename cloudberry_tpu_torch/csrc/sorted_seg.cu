// Segmented SUM over rows sorted by group (mid-cardinality GROUP BY:
// TPC-H Q3's l_orderkey x o_orderdate x o_shippriority groups).
//
// Replaces: cloudberry_tpu/exec/pallas_kernels.py sorted_seg_pallas (kernel
// body _sorted_seg_kernel). On the TPU the grid ran in order, so each tile
// ran a segmented Hillis-Steele scan and carried a (last gid, partial sum)
// pair to the next tile; int64 values rode eight 8-bit int32 limbs. Blocks
// on Hopper run in no order, so nothing is carried: the group boundaries
// (starts/ends from the shared group_layout sort) give each group its row
// range, and sums are unsigned 64-bit adds (the wraparound equals the
// reference's int64 sum mod 2^64, in any order).
//
// Bound on the H100: memory. The output holds a count and R sums for every
// one of the cap slots, zero past n_groups; on Q3 cap is the 6M-row input
// and n_groups about 11k, so the bytes are almost all padding. The least
// traffic is the selected rows read once, 16 B of boundaries per group,
// n_groups, and the output written once:
//   (8 R n_rows + 16 G + 8 + 8 (1 + R) cap) bytes / 3.35 TB/s
// (Q3 at SF1: 96 MB, 0.029 ms).
//
// Design. Two kernels, both with grids sized by the card, never by cap;
// n_groups stays a device scalar. seg_main does two things with every
// warp:
//  1. groups, 32 at a time, one lane per group (the lanes' boundary loads
//     and result stores are coalesced). A short group, of at most
//     `short_rows` rows, is summed by its lane alone: TPC-H groups by
//     order key hold 1-7 lines, so a warp per group would leave 25 of 32
//     lanes idle, and near 32 rows a warp-wide pass starts to win. Every
//     longer group gets its sum slots zeroed and is queued, cut into
//     chunks of `chunk_rows` rows. The queue's header word counts both
//     entries and chunks, so one atomic per warp (of a warp-wide sum)
//     hands each lane its entry and first chunk index, and the entries
//     list their chunk ranges in ascending order;
//  2. the padding: slots [n_groups, cap) of each of the 1 + R output rows
//     are zeroed with 16-byte stores, neighbouring threads on neighbouring
//     addresses, in 32 KB chunks the blocks take from a counter (with a
//     fixed share, 4.4 chunks a row per block at Q3's shape, the grid
//     waits on the blocks that drew 5; with the counter, blocks that did
//     groups simply take fewer); a row's unaligned head and tail slot are
//     single stores. Coming second, the padding lets the group phase's
//     load latency hide behind the store traffic.
// seg_chunks then takes the queued chunks, a contiguous run per warp, its
// first entry found by binary search: coalesced loads eight deep a lane,
// a shuffle reduction and one 64-bit atomic per chunk into the group's
// slot (exact: unsigned adds commute). So the work follows the data: a
// skewed input, one group of 6M rows beside thousands of singletons,
// becomes some 6,000 chunks read by every warp of the grid at once.
// The wrapper sizes the queue for every group longer than short_rows that
// disjoint row ranges can hold (cuda_kernels.sorted_seg_plan); should it
// overflow, the warp sums the group itself.
// Fixed costs: a kernel launch or a memset adds microseconds on the card,
// a large share of the gap between the padding's byte bound (0.029 ms at
// Q3's shape) and a zero fill plus index_add_. So no call pays a memset:
// the header words (queue, padding chunks taken) come in two sets per
// device and stream that calls use in turn (cuda_kernels._seg_headers),
// and each seg_main zeroes the other set, whose last reader, the
// previous call's seg_chunks, has finished. And seg_chunks costs no
// launch gap: it is a programmatic dependent launch,
// `chunk_blocks_per_sm` blocks on every SM, and seg_main leaves room for
// them, so they are resident and waiting when it ends. Two blocks an SM
// measured best: one left the skewed and many-medium-group inputs slower,
// three took room from the padding. One cooperative kernel, with a grid
// barrier or with a count of warps done with groups, measured slower than
// this pair.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

typedef unsigned long long u64;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kPadChunk = 2048;  // 16-byte pairs, 32 KB
constexpr int kHeaderWords = 2;

__device__ __forceinline__ u64 warp_sum(u64 v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Zeroes slots [ng, cap) of the 1 + r output rows with 16-byte stores,
// neighbouring threads on neighbouring addresses. The blocks take chunks
// of kPadChunk pairs from a counter, so a block that spent time on groups
// simply takes fewer (with a fixed share the grid waits on the blocks
// that drew one chunk more than the average).
// Block 0's thread 0 takes each row's unaligned head slot and odd tail.
__device__ __forceinline__ void zero_padding(int64_t* __restrict__ out, int r,
                                             int64_t cap, int64_t ng,
                                             u64* __restrict__ counter) {
  if (ng >= cap) return;
  const int64_t per_row = ((cap - ng) / 2 + kPadChunk) / kPadChunk;
  const int64_t chunks = (int64_t)(1 + r) * per_row;
  const longlong2 z = make_longlong2(0, 0);
  __shared__ int64_t next;
  for (;;) {
    if (threadIdx.x == 0) next = (int64_t)atomicAdd(counter, 1ull);
    __syncthreads();
    const int64_t c = next;
    __syncthreads();
    if (c >= chunks) break;
    int64_t* row = out + (c / per_row) * cap;
    const int64_t a = (reinterpret_cast<uintptr_t>(row + ng) & 15) ? ng + 1 : ng;
    const int64_t pairs = (cap - a) >> 1;
    longlong2* p = reinterpret_cast<longlong2*>(row + a);
    const int64_t lo = (c % per_row) * kPadChunk;
    const int64_t hi = lo + kPadChunk < pairs ? lo + kPadChunk : pairs;
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) p[i] = z;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int q = 0; q <= r; ++q) {
      int64_t* row = out + (int64_t)q * cap;
      const bool head = (reinterpret_cast<uintptr_t>(row + ng) & 15) != 0;
      if (head) row[ng] = 0;
      const int64_t a = head ? ng + 1 : ng;
      if (a < cap && ((cap - a) & 1)) row[cap - 1] = 0;
    }
  }
}

// One warp sums rows [lo, hi] of `row`; every lane returns the total.
// Eight independent loads a lane are in flight at a time.
__device__ __forceinline__ u64 warp_range_sum(const int64_t* __restrict__ row,
                                              int64_t lo, int64_t hi,
                                              int lane) {
  u64 a[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int64_t i = lo + lane;
  for (; i + 7 * 32 <= hi; i += 8 * 32) {
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] += (u64)row[i + 32 * k];
  }
  for (; i <= hi; i += 32) a[0] += (u64)row[i];
  u64 t = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) t += a[k];
  return __shfl_sync(kFull, warp_sum(t), 0);
}

// The queue's header word packs (entries << kCountShift) + chunks, so one
// atomic gives a group both its entry index and its first chunk's index:
// entries then list their chunk ranges in ascending order.
constexpr int kCountShift = 36;
constexpr u64 kChunkMask = (1ull << kCountShift) - 1;

// Every warp takes a contiguous run of the queued chunks, finds the entry
// of its first chunk by binary search over the entries' first-chunk
// indices, and walks on from there.
__device__ __forceinline__ void run_chunks(
    const int64_t* __restrict__ vals, int r, int64_t n,
    const int64_t* __restrict__ starts, const int64_t* __restrict__ ends,
    int64_t cap, int64_t chunk_rows, int64_t* __restrict__ out, u64 head,
    const longlong2* __restrict__ entries, int64_t queue_cap) {
  int64_t n_entries = (int64_t)(head >> kCountShift);
  if (n_entries > queue_cap) n_entries = queue_cap;
  const int64_t total = (int64_t)(head & kChunkMask);
  if (n_entries == 0) return;
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t t0 = total * warp / nwarps;
  const int64_t t1 = total * (warp + 1) / nwarps;
  if (t0 >= t1) return;
  int64_t lo = 0, hi = n_entries - 1;  // last entry whose first chunk <= t0
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (entries[mid].y <= t0) lo = mid; else hi = mid - 1;
  }
  int64_t idx = lo;
  longlong2 ent = entries[idx];
  int64_t s = starts[ent.x], e = ends[ent.x];
  for (int64_t t = t0; t < t1; ++t) {
    while (t >= ent.y + (e - s + chunk_rows) / chunk_rows) {
      if (++idx >= n_entries) return;  // chunks of groups the queue dropped
      ent = entries[idx];
      s = starts[ent.x];
      e = ends[ent.x];
    }
    const int64_t row_lo = s + (t - ent.y) * chunk_rows;
    const int64_t row_hi = row_lo + chunk_rows - 1 < e ? row_lo + chunk_rows - 1 : e;
    for (int q = 0; q < r; ++q) {
      const u64 acc = warp_range_sum(vals + (int64_t)q * n, row_lo, row_hi, lane);
      if (lane == 0 && acc != 0ull) {
        atomicAdd(reinterpret_cast<u64*>(out + (int64_t)(1 + q) * cap + ent.x), acc);
      }
    }
  }
}

__global__ void seg_main(const int64_t* __restrict__ vals, int r, int64_t n,
                         const int64_t* __restrict__ starts,
                         const int64_t* __restrict__ ends,
                         const int64_t* __restrict__ n_groups, int64_t cap,
                         int64_t short_rows, int64_t chunk_rows,
                         int64_t* __restrict__ out, u64* __restrict__ header,
                         u64* __restrict__ spare,
                         longlong2* __restrict__ entries, int64_t queue_cap) {
  // seg_chunks may be launched now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;");
  // the other header set: the previous call's seg_chunks, its last reader,
  // has finished; zeroed here, it is ready for the next call
  if (blockIdx.x == 0 && threadIdx.x < kHeaderWords) spare[threadIdx.x] = 0ull;
  int64_t ng = *n_groups;
  ng = ng < 0 ? 0 : (ng > cap ? cap : ng);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = nthreads >> 5;
  for (int64_t base = (tid >> 5) << 5; base < ng; base += nwarps << 5) {
    const int64_t g = base + lane;
    const bool valid = g < ng;
    const int64_t s = valid ? starts[g] : 0;
    const int64_t e = valid ? ends[g] : -1;  // inclusive
    const int64_t size = e - s + 1;
    const bool shrt = valid && size <= short_rows;
    // queue every longer group: one atomic per warp, then each lane's
    // entry and first chunk from an exclusive scan over the lanes
    const u64 chunks = (valid && !shrt) ? (u64)((size + chunk_rows - 1) / chunk_rows) : 0ull;
    const unsigned longer = __ballot_sync(kFull, valid && !shrt);
    bool queued = false;
    if (longer) {
      u64 before = chunks;  // inclusive scan of chunks, then exclusive
      for (int off = 1; off < 32; off <<= 1) {
        const u64 up = __shfl_up_sync(kFull, before, off);
        if (lane >= off) before += up;
      }
      const u64 total = __shfl_sync(kFull, before, 31);
      before -= chunks;
      const int leader = __ffs(longer) - 1;
      u64 old = 0;
      if (lane == leader) {
        old = atomicAdd(header, ((u64)__popc(longer) << kCountShift) + total);
      }
      old = __shfl_sync(kFull, old, leader);
      if (valid && !shrt) {
        const u64 idx = (old >> kCountShift) + __popc(longer & ((1u << lane) - 1));
        if (idx < (u64)queue_cap) {
          entries[idx] = make_longlong2(g, (long long)((old & kChunkMask) + before));
          queued = true;
        }
      }
    }
    const bool medium = valid && !shrt && !queued;  // the queue was full
    if (valid) out[g] = size;
    for (int q = 0; q < r; ++q) {
      const int64_t* row = vals + (int64_t)q * n;
      u64 acc = 0;
      if (shrt) {  // four independent loads at a time
        u64 a1 = 0, a2 = 0, a3 = 0;
        int64_t i = s;
        for (; i + 3 <= e; i += 4) {
          acc += (u64)row[i];
          a1 += (u64)row[i + 1];
          a2 += (u64)row[i + 2];
          a3 += (u64)row[i + 3];
        }
        for (; i <= e; ++i) acc += (u64)row[i];
        acc += a1 + a2 + a3;
      }
      if (valid && !medium) out[(int64_t)(1 + q) * cap + g] = (int64_t)acc;
    }
    for (unsigned m = __ballot_sync(kFull, medium); m; m &= m - 1) {
      const int src = __ffs(m) - 1;
      const int64_t ms = __shfl_sync(kFull, s, src);
      const int64_t me = __shfl_sync(kFull, e, src);
      for (int q = 0; q < r; ++q) {
        const u64 acc = warp_range_sum(vals + (int64_t)q * n, ms, me, lane);
        if (lane == 0) out[(int64_t)(1 + q) * cap + base + src] = (int64_t)acc;
      }
    }
  }

  // the padding last: these stores do not hold a warp up, so the group
  // phase's load latency above hides behind the store traffic
  zero_padding(out, r, cap, ng, header + 1);
}

__global__ void seg_chunks(const int64_t* __restrict__ vals, int r, int64_t n,
                           const int64_t* __restrict__ starts,
                           const int64_t* __restrict__ ends, int64_t cap,
                           int64_t chunk_rows, int64_t* __restrict__ out,
                           u64* __restrict__ header,
                           const longlong2* __restrict__ entries,
                           int64_t queue_cap) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // seg_main is done
  run_chunks(vals, r, n, starts, ends, cap, chunk_rows, out, header[0],
             entries, queue_cap);
}

}  // namespace

// vals: int64[r, n] in group-sorted order, zero on unselected rows;
// starts/ends: int64[cap] inclusive row ranges (valid below *n_groups);
// out: int64[1 + r, cap], the counts row then the r sum rows; header:
// uint64[2] (queue word, padding chunks taken), zero before the call;
// spare: the other uint64[2] set, zeroed by the call for the next one;
// chunk_blocks_per_sm: the seg_chunks blocks on each SM; entries:
// int64[2 queue_cap] scratch. Returns cudaGetLastError(); a cap of 2^27
// or more slots is refused (the queue's entry count would overflow its
// field).
extern "C" int cb_sorted_seg(const int64_t* vals, int r, int64_t n,
                             const int64_t* starts, const int64_t* ends,
                             const int64_t* n_groups, int64_t cap,
                             int64_t short_rows, int64_t chunk_rows,
                             int64_t* out, u64* header, u64* spare,
                             longlong2* entries, int64_t queue_cap,
                             int chunk_blocks_per_sm, void* stream) {
  if (r < 0 || n < 0 || cap < 0 || cap >= (1ll << 27) || chunk_rows < 1 ||
      queue_cap < 0 || chunk_blocks_per_sm < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // seg_main leaves room for the seg_chunks blocks on every SM: launched
  // as a programmatic dependent, seg_chunks is resident and waiting when
  // seg_main ends, instead of paying a launch after it
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, seg_main, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int sms = cb::sm_count();
  const int room = per_sm > chunk_blocks_per_sm ? per_sm - chunk_blocks_per_sm : 1;
  int main_blocks = room * sms;
  const int wanted = cb::grid_for((int64_t)(1 + r) * cap, kThreads);
  if (main_blocks > wanted) main_blocks = wanted;
  seg_main<<<main_blocks, kThreads, 0, s>>>(vals, r, n, starts, ends,
                                            n_groups, cap, short_rows,
                                            chunk_rows, out, header, spare,
                                            entries, queue_cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunk_blocks_per_sm * sms);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, seg_chunks, vals, r, n, starts, ends, cap,
                           chunk_rows, out, header,
                           (const longlong2*)entries, queue_cap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
