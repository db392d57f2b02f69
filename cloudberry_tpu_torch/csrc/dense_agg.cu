// Grouped COUNT + SUM over a small static cell domain (dictionary-coded
// GROUP BY keys: TPC-H Q1's returnflag x linestatus, Q5's n_name).
//
// Replaces: cloudberry_tpu/exec/pallas_kernels.py dense_agg_tiles_pallas
// (kernel body _dense_agg_kernel). On the TPU the kernel built a one-hot
// (cells x tile) mask and ran vals @ onehot^T on the f32 MXU, carrying
// int64 values as five 13-bit limbs so every per-tile partial stayed
// exact. Hopper has native 64-bit integer adds, so limbs go: int64 values
// add as unsigned 64-bit words (two's-complement wraparound equals the
// reference's int64 sum mod 2^64, in any order); floats add in double.
//
// Bound on the H100: memory. Each row is read once — gid (4 B), sel (1 B)
// and 8 B per value row — and the output is a few KB, so the least time is
// N x (5 + 8 K) bytes / 3.35 TB/s (Q1 at SF1: 5,997,925 rows x 61 B =
// 366 MB, 0.109 ms).
//
// Design. The few cells of a dense GROUP BY are the hazard: Q1 has 6
// cells, 4 of them occupied, so the 32 lanes of a warp that add into
// shared per-cell words collide on about 4 addresses and every add
// serialises. So no two lanes ever add to one word:
//  - private mode (dense_agg_private): every thread owns a column of
//    dynamic shared memory, one 8-byte accumulator per (value row, cell)
//    slot: slot j of thread t lives at word j * threads + t, so a warp's
//    32 lanes always hit 32 distinct words in distinct bank pairs
//    whatever their cells are, and the adds are plain loads and stores.
//    Q1 needs (1 + 7) x 6 slots x 256 threads x 8 B = 96 KB a block, Q5
//    (1 + 1) x 25 x 256 x 8 B = 100 KB; above 48 KB this is the opt-in
//    dynamic shared memory (cudaFuncSetAttribute, once). Each thread takes
//    a step of rows at a time, four (Q1) or sixteen (one or two value
//    rows: Q5), 32 rows apart, so that each load instruction of a warp
//    reads 32 consecutive words. (Per-thread 16-byte loads of consecutive
//    rows put a warp's requests 64-128 B apart and lean on L1 to merge
//    sectors, while the private columns leave L1 some 28 KB; a first
//    version that loaded so was no faster at Q1's shape and slower at
//    Q5's.) A row's
//    values are loaded only when the row is kept, and the loop is
//    software-pipelined: the next step's gid and sel loads are in flight
//    while this step's values load. After the
//    row loop every warp folds slots: its lanes sum one slot's column,
//    a shuffle reduction ends it, and one global atomic per slot per
//    block merges the blocks (int64 exact; double in another order than a
//    sequential sum).
//  - shared mode (dense_agg_shared): when a private column per thread does
//    not fit but one copy of the block's slots does, the block adds into
//    that copy with shared-memory atomics (many cells, so few collisions).
//  - global mode (dense_agg_global): larger domains add straight into the
//    output with global atomics.
// The mode, block size and shared-memory size are chosen on the host by
// cuda_kernels.dense_agg_plan, a plain function the CPU tests reach.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

typedef unsigned long long u64;
constexpr int kMaxK = 8;             // value rows loaded together per step
constexpr int kSmemMax = 232448;     // the H100's opt-in shared memory a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ const int64_t* value_row(
    const int64_t* ivals, const double* fvals, int64_t n, int ki, int k) {
  return k < ki ? ivals + (int64_t)k * n
                : reinterpret_cast<const int64_t*>(fvals) + (int64_t)(k - ki) * n;
}

// A warp's step covers STEP x 32 consecutive rows from `base`: lane l
// takes rows base + l + 32 j (j < STEP), so every load instruction of the
// warp reads 32 consecutive words.

// Loads the step's gid and sel (FULL: no row past n).
template <int STEP, bool FULL>
__device__ __forceinline__ void load_keys(const int32_t* __restrict__ gid,
                                          const bool* __restrict__ sel,
                                          int64_t n, int64_t base, int lane,
                                          int (&g)[STEP], bool (&keep)[STEP]) {
#pragma unroll
  for (int j = 0; j < STEP; ++j) {
    const int64_t row = base + lane + 32 * j;
    const bool in = FULL || row < n;
    g[j] = in ? gid[row] : -1;
    keep[j] = in ? sel[row] : false;
  }
}

template <int STEP>
__device__ __forceinline__ void in_domain(bool (&keep)[STEP],
                                          const int (&g)[STEP], int cells) {
#pragma unroll
  for (int j = 0; j < STEP; ++j) {
    keep[j] = keep[j] && (unsigned)g[j] < (unsigned)cells;
  }
}

// Adds the step's kept rows into the thread's private column. A row's
// values are loaded only when it is kept (a load whose lanes are all off
// moves nothing), and up to KU value rows' loads are issued before the
// first add.
template <int STEP, int KU>
__device__ __forceinline__ void add_values(
    u64* __restrict__ acc, int threads, const int64_t* __restrict__ ivals,
    const double* __restrict__ fvals, int64_t n, int ki, int kf, int cells,
    int64_t base, int lane, const int (&g)[STEP], const bool (&keep)[STEP]) {
  const int k_all = ki + kf;
  for (int k0 = 0; k0 < k_all; k0 += KU) {
    int64_t v[KU][STEP];
#pragma unroll
    for (int kk = 0; kk < KU; ++kk) {
      if (k0 + kk < k_all) {
        const int64_t* vrow = value_row(ivals, fvals, n, ki, k0 + kk) + base + lane;
#pragma unroll
        for (int j = 0; j < STEP; ++j) v[kk][j] = keep[j] ? vrow[32 * j] : 0;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KU; ++kk) {
      const int k = k0 + kk;
      if (k >= k_all) break;
#pragma unroll
      for (int j = 0; j < STEP; ++j) {
        if (!keep[j]) continue;
        u64* w = acc + ((int64_t)(1 + k) * cells + g[j]) * threads;
        if (k < ki) {
          *w += (u64)v[kk][j];
        } else {
          *w = (u64)__double_as_longlong(
              __longlong_as_double((long long)*w) +
              __longlong_as_double(v[kk][j]));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < STEP; ++j) {
    if (keep[j]) acc[(int64_t)g[j] * threads] += 1ull;
  }
}

// STEP rows a lane per step and KU value rows loaded together: <4, 8>
// for any number of value rows (eight at a time: Q1), <16, 1> for one or
// two (Q5: mostly unselected rows, so the gid and sel loads are most of
// the traffic and a longer step keeps more of them in flight). The loop
// is software-pipelined: the next step's gid and sel
// are in flight while this step's values load, so a step waits once.
template <int STEP, int KU>
__global__ void dense_agg_private(const int32_t* __restrict__ gid,
                                  const int64_t* __restrict__ ivals,
                                  const double* __restrict__ fvals,
                                  const bool* __restrict__ sel, int64_t n,
                                  int ki, int kf, int cells,
                                  u64* __restrict__ out_int,
                                  double* __restrict__ out_flt) {
  extern __shared__ u64 smem[];
  const int threads = blockDim.x;
  const int t = threadIdx.x;
  const int n_int = (1 + ki) * cells;  // counts row, then the int sums
  const int slots = n_int + kf * cells;
  u64* acc = smem + t;                 // this thread's column
  for (int j = 0; j < slots; ++j) acc[(int64_t)j * threads] = 0ull;

  const int lane = t & 31;
  const int64_t warp = ((int64_t)blockIdx.x * threads + t) >> 5;
  const int64_t nwarps = ((int64_t)gridDim.x * threads) >> 5;
  const int64_t span = 32 * STEP;
  const int64_t full = n / span;
  int g[STEP];
  bool keep[STEP];
  if (warp < full) load_keys<STEP, true>(gid, sel, n, warp * span, lane, g, keep);
  for (int64_t q = warp; q < full; q += nwarps) {
    int gq[STEP];
    bool kq[STEP];
#pragma unroll
    for (int j = 0; j < STEP; ++j) {
      gq[j] = g[j];
      kq[j] = keep[j];
    }
    if (q + nwarps < full) {
      load_keys<STEP, true>(gid, sel, n, (q + nwarps) * span, lane, g, keep);
    }
    in_domain<STEP>(kq, gq, cells);
    add_values<STEP, KU>(acc, threads, ivals, fvals, n, ki, kf, cells,
                         q * span, lane, gq, kq);
  }
  if (full * span < n && warp == full % nwarps) {  // the ragged last step
    load_keys<STEP, false>(gid, sel, n, full * span, lane, g, keep);
    in_domain<STEP>(keep, g, cells);
    add_values<STEP, KU>(acc, threads, ivals, fvals, n, ki, kf, cells,
                         full * span, lane, g, keep);
  }
  __syncthreads();

  // fold: warp w sums slots w, w + warps, ...; one atomic per slot
  const int warps = threads >> 5;
  for (int j = t >> 5; j < slots; j += warps) {
    const u64* col = smem + (int64_t)j * threads;
    if (j < n_int) {
      u64 s = 0;
      for (int i = lane; i < threads; i += 32) s += col[i];
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
      if (lane == 0 && s != 0ull) atomicAdd(out_int + j, s);
    } else {
      double s = 0.0;
      for (int i = lane; i < threads; i += 32) {
        s += __longlong_as_double((long long)col[i]);
      }
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
      if (lane == 0 && s != 0.0) atomicAdd(out_flt + (j - n_int), s);
    }
  }
}

__global__ void dense_agg_shared(const int32_t* __restrict__ gid,
                                 const int64_t* __restrict__ ivals,
                                 const double* __restrict__ fvals,
                                 const bool* __restrict__ sel, int64_t n,
                                 int ki, int kf, int cells,
                                 u64* __restrict__ out_int,
                                 double* __restrict__ out_flt) {
  extern __shared__ u64 smem[];
  const int n_int = (1 + ki) * cells;  // counts row, then one row per sum
  const int n_flt = kf * cells;
  u64* s_int = smem;
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
      atomicAdd(&s_int[(1 + k) * cells + g], (u64)ivals[(int64_t)k * n + r]);
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

__global__ void dense_agg_global(const int32_t* __restrict__ gid,
                                 const int64_t* __restrict__ ivals,
                                 const double* __restrict__ fvals,
                                 const bool* __restrict__ sel, int64_t n,
                                 int ki, int kf, int cells,
                                 u64* __restrict__ out_int,
                                 double* __restrict__ out_flt) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int g = gid[r];
    if (!sel[r] || g < 0 || g >= cells) continue;
    atomicAdd(&out_int[g], 1ull);
    for (int k = 0; k < ki; ++k) {
      atomicAdd(&out_int[(1 + k) * cells + g], (u64)ivals[(int64_t)k * n + r]);
    }
    for (int k = 0; k < kf; ++k) {
      atomicAdd(&out_flt[k * cells + g], fvals[(int64_t)k * n + r]);
    }
  }
}

typedef void (*Kernel)(const int32_t*, const int64_t*, const double*,
                       const bool*, int64_t, int, int, int, u64*, double*);

}  // namespace

// mode: 0 private (4-row steps), 1 private (16-row steps), 2 shared,
// 3 global (cuda_kernels.dense_agg_plan);
// out_int: zeroed uint64[(1 + ki) * cells] (counts row, then the sums);
// out_flt: zeroed double[kf * cells]. Returns cudaGetLastError().
extern "C" int cb_dense_agg(const int32_t* gid, const int64_t* ivals,
                            const double* fvals, const bool* sel, int64_t n,
                            int ki, int kf, int cells, int mode, int threads,
                            int smem, u64* out_int, double* out_flt,
                            void* stream) {
  if (mode < 0 || mode > 3 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || smem < 0 || smem > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  const Kernel kernels[] = {dense_agg_private<4, kMaxK>,
                            dense_agg_private<16, 1>, dense_agg_shared,
                            dense_agg_global};
  static bool opted_in = false;  // lift the 48 KB default once
  if (!opted_in) {
    for (int m = 0; m < 3; ++m) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernels[m], cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (err != cudaSuccess) return (int)err;
    }
    opted_in = true;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int blocks = cb::resident_grid(
      kernels[mode], mode == 0 ? n / 4 : (mode == 1 ? n / 16 : n), threads,
      smem);
  kernels[mode]<<<blocks, threads, smem, s>>>(gid, ivals, fvals, sel, n, ki,
                                               kf, cells, out_int, out_flt);
  return (int)cudaGetLastError();
}
