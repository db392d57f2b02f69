// Segmented SUM over rows sorted by group (mid-cardinality GROUP BY:
// TPC-H Q3's l_orderkey x o_orderdate x o_shippriority groups).
//
// Replaces: cloudberry_tpu/exec/pallas_kernels.py sorted_seg_pallas (kernel
// body _sorted_seg_kernel). On the TPU the grid ran in order, so each tile
// ran a segmented Hillis-Steele scan and carried a (last gid, partial sum)
// pair to the next tile; int64 values rode eight 8-bit int32 limbs. Blocks
// on Hopper run in no order, so nothing is carried: the group boundaries
// (starts/ends from the shared group_layout sort) give each group its row
// range, and one warp sums a group's rows in int64 (unsigned adds, so the
// wraparound equals the reference's) with a warp-shuffle reduction.
//
// Bound on the H100: memory. The R value rows of the sorted, masked [R, N]
// matrix are read once (8 B each) plus 16 B of boundaries per group, and
// the counts and sums written once: (8 R N + 16 G + 8 (R + 1) G) bytes /
// 3.35 TB/s. Design: a warp reads its group's rows as consecutive words
// (coalesced), groups are spread over warps with a grid-stride loop, and
// slots past the true group count are written as zeros (the reference's
// padded output contract).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void sorted_seg_kernel(const int64_t* __restrict__ vals, int r,
                                  int64_t n,
                                  const int64_t* __restrict__ starts,
                                  const int64_t* __restrict__ ends,
                                  const int64_t* __restrict__ n_groups,
                                  int64_t cap, int64_t* __restrict__ counts,
                                  int64_t* __restrict__ sums) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t ng = *n_groups;
  for (int64_t g = warp; g < cap; g += n_warps) {
    const bool valid = g < ng;
    const int64_t s = valid ? starts[g] : 0;
    const int64_t e = valid ? ends[g] : -1;  // inclusive
    if (lane == 0) counts[g] = valid ? e - s + 1 : 0;
    for (int q = 0; q < r; ++q) {
      const int64_t* row = vals + (int64_t)q * n;
      unsigned long long acc = 0ull;
      for (int64_t i = s + lane; i <= e; i += 32) {
        acc += (unsigned long long)row[i];
      }
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) sums[(int64_t)q * cap + g] = (int64_t)acc;
    }
  }
}

}  // namespace

// vals: int64[r, n] in group-sorted order, zero on unselected rows;
// starts/ends: int64[cap] inclusive row ranges (valid below *n_groups);
// counts: int64[cap]; sums: int64[r, cap]. Returns cudaGetLastError().
extern "C" int cb_sorted_seg(const int64_t* vals, int r, int64_t n,
                             const int64_t* starts, const int64_t* ends,
                             const int64_t* n_groups, int64_t cap,
                             int64_t* counts, int64_t* sums, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int64_t blocks = (cap + kWarps - 1) / kWarps;
  if (blocks > 65535) blocks = 65535;
  if (blocks < 1) blocks = 1;
  sorted_seg_kernel<<<(int)blocks, kThreads, 0, s>>>(
      vals, r, n, starts, ends, n_groups, cap, counts, sums);
  return (int)cudaGetLastError();
}
