// Probe join against a small unique build (every dimension join of a star
// query: TPC-H Q5's region and nation builds), the whole operator in one
// launch: from the raw key columns to the match mask, the gathered payload
// columns in their own dtypes, and the duplicate flag.
//
// Replaces: cloudberry_tpu/exec/pallas_kernels.py probe_join_pallas (kernel
// body _probe_join_kernel) together with the key packing that the
// reference's executor does around it (executor.py _probe_join_pallas:
// key_ranges, pack_with_ranges and downcast32 of exec/kernels.py, then the
// int64 limb split and recombination of the payload). On the TPU each probe
// tile compared its packed keys with the whole VMEM-resident build on the
// VPU and gathered the payload as one one-hot matmul on the f32 MXU.
//
// What bounds it on the H100: bytes. The lookup is one probe per row, so
// each probe row costs its selection (1 B) and, when selected, its key
// columns, plus the match flag (1 B) and one value per payload column in
// that column's width; the build side (B <= 2048 rows) is a few KB. Bound:
// those bytes / 3.35 TB/s, with one lookup per selected probe row as its
// operations. One launch does the whole operator, so a small join costs
// one kernel's latency rather than the dozens of small operations that
// packing in PyTorch would take.
//
// Design:
// - Packing inside the kernel, bit for bit with the reference. Every block
//   computes each key column's (lo, span) over the selected build rows with
//   a block reduction (B <= 2048, so redoing it per block costs a few KB of
//   L2 reads), then packs keys in registers exactly as pack_with_ranges +
//   downcast32 do: the reference's u64 sort key (int64 bits with the sign
//   flipped, int32 sign-extended first, bool as 0/1; float keys arrive as
//   the wrapper's sort_key_u64), the all-ones sentinel for a value outside
//   its column's range, the mixed-radix product mod 2^64, and the
//   narrowing to u32 with its own sentinel. Keys compare as those u32
//   values, sentinels included, so an edge case that the reference narrows
//   onto the sentinel gives the same answer.
// - At most kMaxKeys = 4 key columns. Every join of the 22 TPC-H queries
//   at SF0.01 that reaches the executor's gate has one key column; the
//   widest equi-join key in them has two (partsupp in Q9 and Q20, whose
//   builds are above the 2048-row cap). A join with more key columns, or
//   with more than kMaxPayload = 16 payload columns (Q10 has 7), is kept
//   off this kernel by the executor's gate.
// - A lookup independent of B, chosen by the key span, not by B. Packed
//   keys of selected build rows lie in [0, S), S the product of the
//   columns' spans. When S <= 4 T (T = 2^k slots, the smallest power of two
//   >= 2 B, at least 32, at most 4096) the table is direct: entry [key]
//   holds the build row, so a probe is one shared-memory read with no
//   compare loop. That is every TPC-H primary key (S = B for a dense key
//   column). Otherwise it is an open-addressing hash of T slots (key in the
//   high word, row in the low word) built with atomicCAS and linear
//   probing, at most half full. Both fit in the same 16 T bytes of shared
//   memory (64 KB at B = 2048). A compare-all loop would cost B compares a
//   row: 2048 near the gate's limit.
// - The contract: the lowest-index selected build row supplies the payload
//   (atomicMin on the entry); a selected probe row that hits a key held by
//   two or more selected build rows sets the caller's duplicate slot to 1
//   (never cleared here: the executor zeroes one flag buffer per statement
//   and raises DuplicateBuildKeyError from it after the statement);
//   unselected rows on either side match nothing; unmatched rows get
//   payload 0. Duplicates are marked in bit 31 of the entry by a pass after
//   the inserts (every selected row whose key's entry names another row),
//   so a probe reads one word.
// - Outputs are written in their final dtypes (bool match, each payload
//   column's own width), so there is no stack or cast around the call.
// - The probe loop keeps kRows rows a thread in flight (a step's rows are
//   kThreads apart, so a warp's loads and stores are contiguous), loads the
//   next step's selections while this step's keys are in flight, and loops
//   over key and payload columns at run time with the rows unrolled inside:
//   unrolling over the column limits and dtypes too made a loop body of
//   thousands of instructions that ran at half the speed.
// - The grid is what stays resident (every block builds its own table
//   once, then strides over the probe rows).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "grid.cuh"

namespace cb {

constexpr int kMaxKeys = 4;
constexpr int kMaxPayload = 16;

// The argument block, filled by the wrapper (cuda_kernels._PROBE_ARGS has
// the same layout) and passed to the kernel by value. It lives outside the
// anonymous namespace: the C entry point takes it, and a parameter type of
// internal linkage would give that function internal linkage too.
struct ProbeJoinArgs {
  const void* bkeys[kMaxKeys];
  const void* pkeys[kMaxKeys];
  const void* payload[kMaxPayload];  // [b] each
  void* out[kMaxPayload];            // [n] each, the payload's width
  const bool* bsel;
  const bool* psel;
  bool* matched;
  int32_t* dup;
  int64_t n;
  int32_t b;
  int32_t nkeys;
  int32_t npay;
  int8_t btype[kMaxKeys];
  int8_t ptype[kMaxKeys];
  int8_t pay_size[kMaxPayload];  // bytes: 1, 2, 4 or 8
};
static_assert(offsetof(ProbeJoinArgs, n) == 352, "layout");
static_assert(offsetof(ProbeJoinArgs, btype) == 372, "layout");
static_assert(sizeof(ProbeJoinArgs) == 400, "layout");

}  // namespace cb

namespace {

using cb::kMaxKeys;
using cb::kMaxPayload;
using cb::ProbeJoinArgs;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // probe rows a thread has in flight per step
constexpr int kTile = kThreads * kRows;
constexpr int kMaxBuild = 2048;
constexpr int kMinSlotsLog2 = 5;
constexpr int kMaxSlotsLog2 = 12;
constexpr int kTableBytesPerSlot = 16;  // T 8-byte hash slots or 4T entries
constexpr uint64_t kSign = 1ull << 63;
constexpr unsigned long long kEmpty = ~0ull;  // hash slot
constexpr uint32_t kNone = ~0u;               // direct entry
constexpr uint32_t kDupBit = 1u << 31;        // in an entry's row word

// key column types, as the wrapper codes them
constexpr int8_t kBool = 0, kInt32 = 1, kInt64 = 2;

// The reference's u64 sort key (kernels.sort_key_u64) of row i of a key
// column: int64 bits with the sign flipped, int32 sign-extended first, bool
// as 0/1.
__device__ __forceinline__ uint64_t key_u64(const void* col, int8_t type,
                                            int64_t i) {
  if (type == kInt64) {
    return (uint64_t)__ldg(reinterpret_cast<const long long*>(col) + i) ^
           kSign;
  }
  if (type == kInt32) {
    return (uint64_t)(int64_t)__ldg(reinterpret_cast<const int*>(col) + i) ^
           kSign;
  }
  return (uint64_t)__ldg(reinterpret_cast<const unsigned char*>(col) + i);
}

// One column's step of pack_with_ranges: the value's offset from lo, the
// out-of-range test, and the mixed-radix product (all mod 2^64).
__device__ __forceinline__ void pack_step(uint64_t u, uint64_t lo,
                                          uint64_t span, uint64_t& packed,
                                          bool& oob) {
  const uint64_t d = u - lo;
  oob |= (u < lo) | (d >= span);
  const uint64_t top = span - 1;
  packed = packed * span + (d < top ? d : top);
}

// pack_with_ranges' sentinel, then downcast32 (its own sentinel for the u64
// one).
__device__ __forceinline__ uint32_t narrow(uint64_t packed, bool oob) {
  if (oob) packed = ~0ull;
  return packed == ~0ull ? 0xFFFFFFFFu : (uint32_t)packed;
}

// The block's lookup table in shared memory: direct entries (the row word
// of each packed key below `direct`) or hash slots.
struct Table {
  unsigned long long* slots;  // hash: T slots
  uint32_t* entries;          // direct: `direct` entries, same memory
  uint32_t direct;            // 0 for the hash
  uint32_t mask;              // T - 1
  int slots_log2;

  __device__ __forceinline__ uint32_t home(uint32_t key) const {
    return (key * 2654435761u) >> (32 - slots_log2);
  }

  // The row word (build row | kDupBit) stored for key, or kNone.
  __device__ __forceinline__ uint32_t find(uint32_t key) const {
    if (direct) return key < direct ? entries[key] : kNone;
    for (uint32_t s = home(key);; s = (s + 1) & mask) {
      const unsigned long long v = slots[s];
      if (v == kEmpty) return kNone;
      if ((uint32_t)(v >> 32) == key) return (uint32_t)v;
    }
  }

  // Adds build row j under key; a key held already keeps the lower row.
  __device__ __forceinline__ void insert(uint32_t key, uint32_t j) const {
    if (direct) {
      atomicMin(&entries[key], j);
      return;
    }
    const unsigned long long v = ((unsigned long long)key << 32) | j;
    for (uint32_t s = home(key);; s = (s + 1) & mask) {
      const unsigned long long old = atomicCAS(&slots[s], kEmpty, v);
      if (old == kEmpty) return;
      if ((uint32_t)(old >> 32) == key) {
        atomicMin(&slots[s], v);
        return;
      }
    }
  }

  // Marks key's entry as held by two or more selected rows.
  __device__ __forceinline__ void mark_dup(uint32_t key) const {
    if (direct) {
      atomicOr(&entries[key], kDupBit);
      return;
    }
    for (uint32_t s = home(key);; s = (s + 1) & mask) {
      if ((uint32_t)(slots[s] >> 32) == key) {
        atomicOr(&slots[s], (unsigned long long)kDupBit);
        return;
      }
    }
  }
};

__device__ __forceinline__ int64_t row_of(int64_t base, int u) {
  return base + u * kThreads + threadIdx.x;
}

// The selections of one step's rows (false past the end).
__device__ __forceinline__ void load_sel(const ProbeJoinArgs& a, int64_t base,
                                         bool* sel) {
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int64_t r = row_of(base, u);
    sel[u] = r < a.n && a.psel[r];
  }
}

// One key column's sort keys for the selected rows of a step, all loads in
// flight together.
template <class T>
__device__ __forceinline__ void load_keys(const void* col, int64_t base,
                                          const bool* sel, uint64_t flip,
                                          uint64_t* u) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    u[k] = sel[k] ? (uint64_t)(int64_t)__ldg(reinterpret_cast<const T*>(col) +
                                             row_of(base, k)) ^
                        flip
                  : 0;
  }
}

// One payload column's values for one step's rows (0 where unmatched).
template <class T>
__device__ __forceinline__ void gather_rows(const void* src, void* dst,
                                            const int* idx, int64_t base,
                                            int64_t n) {
  T v[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    v[u] = idx[u] >= 0 ? __ldg(reinterpret_cast<const T*>(src) + idx[u])
                       : T(0);
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int64_t r = row_of(base, u);
    if (r < n) reinterpret_cast<T*>(dst)[r] = v[u];
  }
}

// The packed key of build row j (ranges in shared memory).
__device__ __forceinline__ uint32_t build_key(const ProbeJoinArgs& a,
                                              const uint64_t* lo,
                                              const uint64_t* span, int j) {
  uint64_t packed = 0;
  bool oob = false;
  for (int c = 0; c < a.nkeys; ++c) {
    pack_step(key_u64(a.bkeys[c], a.btype[c], j), lo[c], span[c], packed,
              oob);
  }
  return narrow(packed, oob);
}

__global__ void __launch_bounds__(kThreads)
    probe_join_kernel(const __grid_constant__ ProbeJoinArgs a,
                      int slots_log2) {
  extern __shared__ unsigned long long s_table[];  // kTableBytesPerSlot * T
  __shared__ uint64_t s_lo[kMaxKeys], s_span[kMaxKeys];
  __shared__ uint64_t w_lo[kWarps], w_hi[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the first step's probe selections load while the table is built
  bool sel[kRows];
  load_sel(a, (int64_t)blockIdx.x * kTile, sel);

  // 1. key_ranges: (lo, span) of every key column over the selected build
  // rows; an empty selection gives lo = 2^64 - 1, hi = 0, span = 2, as in
  // the reference
#pragma unroll 1
  for (int c = 0; c < a.nkeys; ++c) {
    uint64_t lo = ~0ull, hi = 0;
    for (int j = threadIdx.x; j < a.b; j += kThreads) {
      const bool bsel = a.bsel[j];
      const uint64_t u = key_u64(a.bkeys[c], a.btype[c], j);
      if (bsel) {
        lo = u < lo ? u : lo;
        hi = u > hi ? u : hi;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const uint64_t l = __shfl_xor_sync(0xffffffffu, lo, o);
      const uint64_t h = __shfl_xor_sync(0xffffffffu, hi, o);
      lo = l < lo ? l : lo;
      hi = h > hi ? h : hi;
    }
    if (lane == 0) {
      w_lo[warp] = lo;
      w_hi[warp] = hi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        lo = w_lo[w] < lo ? w_lo[w] : lo;
        hi = w_hi[w] > hi ? w_hi[w] : hi;
      }
      s_lo[c] = lo;
      s_span[c] = hi - lo + 1;  // wraps like the reference's u64 span
    }
    __syncthreads();
  }

  // 2. the table: direct when every packed key of a selected build row
  // (< the product of the spans) has an entry, else the hash
  const uint32_t n_slots = 1u << slots_log2;
  const uint32_t capacity = 4 * n_slots;
  uint64_t product = 1;
  for (int c = 0; c < a.nkeys && product <= capacity; ++c) {
    const uint64_t span = s_span[c];
    product = (span == 0 || span > capacity) ? (uint64_t)capacity + 1
                                             : product * span;
  }
  const Table table{s_table, reinterpret_cast<uint32_t*>(s_table),
                    product <= capacity ? (uint32_t)product : 0u,
                    n_slots - 1, slots_log2};
  if (table.direct) {
    for (uint32_t e = threadIdx.x; e < table.direct; e += kThreads) {
      table.entries[e] = kNone;
    }
  } else {
    for (uint32_t s = threadIdx.x; s < n_slots; s += kThreads) {
      table.slots[s] = kEmpty;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < a.b; j += kThreads) {
    if (a.bsel[j]) table.insert(build_key(a, s_lo, s_span, j), (uint32_t)j);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < a.b; j += kThreads) {
    if (!a.bsel[j]) continue;
    const uint32_t key = build_key(a, s_lo, s_span, j);
    if ((table.find(key) & ~kDupBit) != (uint32_t)j) table.mark_dup(key);
  }
  __syncthreads();

  // 3. probe rows, kRows a thread per step: pack, look up, write the match
  // and the payload; the next step's selections load while this step's
  // keys are in flight
  bool saw_dup = false;
  const int64_t step = (int64_t)gridDim.x * kTile;
  for (int64_t base = (int64_t)blockIdx.x * kTile; base < a.n; base += step) {
    uint64_t packed[kRows];
    bool oob[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      packed[u] = 0;
      oob[u] = false;
    }
#pragma unroll 1
    for (int c = 0; c < a.nkeys; ++c) {
      uint64_t u64[kRows];
      const void* col = a.pkeys[c];
      if (a.ptype[c] == kInt64) {
        load_keys<long long>(col, base, sel, kSign, u64);
      } else if (a.ptype[c] == kInt32) {
        load_keys<int>(col, base, sel, kSign, u64);
      } else {
        load_keys<unsigned char>(col, base, sel, 0, u64);
      }
      const uint64_t lo = s_lo[c], span = s_span[c];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        pack_step(u64[u], lo, span, packed[u], oob[u]);
      }
    }
    bool next[kRows];
    load_sel(a, base + step, next);
    int idx[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const uint32_t w = sel[u] ? table.find(narrow(packed[u], oob[u]))
                                : kNone;
      idx[u] = w == kNone ? -1 : (int)(w & ~kDupBit);
      saw_dup |= w != kNone && (w & kDupBit) != 0;
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int64_t r = row_of(base, u);
      if (r < a.n) a.matched[r] = idx[u] >= 0;
    }
#pragma unroll 1
    for (int q = 0; q < a.npay; ++q) {
      void* out = a.out[q];
      const void* src = a.payload[q];
      switch (a.pay_size[q]) {
        case 1: gather_rows<uint8_t>(src, out, idx, base, a.n); break;
        case 2: gather_rows<uint16_t>(src, out, idx, base, a.n); break;
        case 4: gather_rows<uint32_t>(src, out, idx, base, a.n); break;
        default: gather_rows<unsigned long long>(src, out, idx, base, a.n);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) sel[u] = next[u];
  }
  if (saw_dup) *a.dup = 1;
}

}  // namespace

// One launch of the probe-join operator on `stream`; the wrapper allocated
// the outputs. Returns cudaGetLastError(); arguments outside the kernel's
// limits are refused with cudaErrorInvalidValue.
extern "C" int cb_probe_join(const cb::ProbeJoinArgs* args, void* stream) {
  const cb::ProbeJoinArgs& a = *args;
  if (a.b < 0 || a.b > kMaxBuild || a.n < 0 || a.nkeys < 1 ||
      a.nkeys > kMaxKeys || a.npay < 0 || a.npay > kMaxPayload) {
    return (int)cudaErrorInvalidValue;
  }
  for (int c = 0; c < a.nkeys; ++c) {
    if (a.btype[c] < kBool || a.btype[c] > kInt64 || a.ptype[c] < kBool ||
        a.ptype[c] > kInt64) {
      return (int)cudaErrorInvalidValue;
    }
  }
  for (int q = 0; q < a.npay; ++q) {
    const int w = a.pay_size[q];
    if (w != 1 && w != 2 && w != 4 && w != 8) {
      return (int)cudaErrorInvalidValue;
    }
  }
  int slots_log2 = kMinSlotsLog2;
  while ((1 << slots_log2) < 2 * a.b && slots_log2 < kMaxSlotsLog2) {
    ++slots_log2;
  }
  const size_t smem = (size_t)kTableBytesPerSlot << slots_log2;
  // resident blocks per table size, found once each
  static int grid_cap[kMaxSlotsLog2 + 1] = {0};
  if (grid_cap[slots_log2] == 0) {
    cudaFuncSetAttribute(probe_join_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kTableBytesPerSlot << kMaxSlotsLog2);
    grid_cap[slots_log2] =
        cb::resident_grid(probe_join_kernel, INT64_MAX / 2, kThreads, smem);
  }
  int grid = cb::grid_for(a.n, kTile);
  if (grid > grid_cap[slots_log2]) grid = grid_cap[slots_log2];
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  probe_join_kernel<<<grid, kThreads, smem, s>>>(a, slots_log2);
  return (int)cudaGetLastError();
}
