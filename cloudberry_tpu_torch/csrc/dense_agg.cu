// Grouped COUNT + SUM over a small static cell domain (dictionary-coded
// GROUP BY keys: TPC-H Q1's returnflag x linestatus, Q5's n_name).
//
// Replaces: cloudberry_tpu/exec/pallas_kernels.py dense_agg_tiles_pallas
// (kernel body _dense_agg_kernel). On the TPU the kernel built a one-hot
// (cells x tile) mask and ran vals @ onehot^T on the f32 MXU, carrying
// int64 values as five 13-bit limbs so every per-tile partial stayed
// exact. Hopper has native 64-bit integer adds, so limbs go: every row adds
// its int64 values straight into per-cell accumulators with unsigned
// 64-bit atomics (two's-complement wraparound equals the reference's
// int64 sum mod 2^64). Float values accumulate in double.
//
// Bound on the H100: memory. Each row is read once — gid (4 B), sel (1 B)
// and 8 B per value row — and the output is a few KB, so the least time is
// N x (5 + 8 K) bytes / 3.35 TB/s (Q1 at SF1: 6,001,215 rows x 61 B =
// 366 MB, about 0.11 ms). Design: one grid-stride pass with coalesced
// loads (value row k of the [K, N] matrix is contiguous); each block keeps
// its (1 + K) x cells accumulators in shared memory while they fit in
// 48 KB, so the hot atomics stay on-chip, and merges them with one global
// atomic per cell at the end. Larger domains add into global memory
// directly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemLimit = 48 * 1024;

__global__ void dense_agg_smem_kernel(const int32_t* __restrict__ gid,
                                      const int64_t* __restrict__ ivals,
                                      const double* __restrict__ fvals,
                                      const bool* __restrict__ sel,
                                      int64_t n, int ki, int kf, int cells,
                                      unsigned long long* __restrict__ out_int,
                                      double* __restrict__ out_flt) {
  extern __shared__ unsigned long long smem[];
  const int n_int = (1 + ki) * cells;  // counts row, then one row per sum
  const int n_flt = kf * cells;
  unsigned long long* s_int = smem;
  double* s_flt = reinterpret_cast<double*>(smem + n_int);
  for (int i = threadIdx.x; i < n_int; i += blockDim.x) s_int[i] = 0ull;
  for (int i = threadIdx.x; i < n_flt; i += blockDim.x) s_flt[i] = 0.0;
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int g = gid[r];
    if (!sel[r] || g < 0 || g >= cells) continue;
    atomicAdd(&s_int[g], 1ull);
    for (int k = 0; k < ki; ++k) {
      atomicAdd(&s_int[(1 + k) * cells + g],
                (unsigned long long)ivals[(int64_t)k * n + r]);
    }
    for (int k = 0; k < kf; ++k) {
      atomicAdd(&s_flt[k * cells + g], fvals[(int64_t)k * n + r]);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_int; i += blockDim.x) {
    if (s_int[i] != 0ull) atomicAdd(&out_int[i], s_int[i]);
  }
  for (int i = threadIdx.x; i < n_flt; i += blockDim.x) {
    if (s_flt[i] != 0.0) atomicAdd(&out_flt[i], s_flt[i]);
  }
}

__global__ void dense_agg_global_kernel(const int32_t* __restrict__ gid,
                                        const int64_t* __restrict__ ivals,
                                        const double* __restrict__ fvals,
                                        const bool* __restrict__ sel,
                                        int64_t n, int ki, int kf, int cells,
                                        unsigned long long* __restrict__ out_int,
                                        double* __restrict__ out_flt) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int g = gid[r];
    if (!sel[r] || g < 0 || g >= cells) continue;
    atomicAdd(&out_int[g], 1ull);
    for (int k = 0; k < ki; ++k) {
      atomicAdd(&out_int[(1 + k) * cells + g],
                (unsigned long long)ivals[(int64_t)k * n + r]);
    }
    for (int k = 0; k < kf; ++k) {
      atomicAdd(&out_flt[k * cells + g], fvals[(int64_t)k * n + r]);
    }
  }
}

}  // namespace

// out_int: zeroed uint64[(1 + ki) * cells] (counts row, then the sums);
// out_flt: zeroed double[kf * cells]. Returns cudaGetLastError().
extern "C" int cb_dense_agg(const int32_t* gid, const int64_t* ivals,
                            const double* fvals, const bool* sel, int64_t n,
                            int ki, int kf, int cells,
                            unsigned long long* out_int, double* out_flt,
                            void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = ((size_t)(1 + ki) * cells + (size_t)kf * cells) * 8;
  const int blocks = cb::grid_for(n, kThreads);
  if (smem <= kSmemLimit) {
    dense_agg_smem_kernel<<<blocks, kThreads, smem, s>>>(
        gid, ivals, fvals, sel, n, ki, kf, cells, out_int, out_flt);
  } else {
    dense_agg_global_kernel<<<blocks, kThreads, 0, s>>>(
        gid, ivals, fvals, sel, n, ki, kf, cells, out_int, out_flt);
  }
  return (int)cudaGetLastError();
}
