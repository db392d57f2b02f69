// Probe join against a small unique build (every dimension join of a star
// query: TPC-H Q5's region and nation builds).
//
// Replaces: cloudberry_tpu/exec/pallas_kernels.py probe_join_pallas (kernel
// body _probe_join_kernel). On the TPU each probe tile compared its keys
// with the whole VMEM-resident build on the VPU and gathered the payload as
// one one-hot matmul on the f32 MXU, carrying int64 payloads as 21/21/22-bit
// limbs. Here every block stages the build keys and their selection in
// shared memory, and each thread compares its probe row with all of them;
// the payload is read as int64 straight from the matching build row, so no
// limbs are needed.
//
// Bound on the H100: memory for the small builds of the main path. Each
// probe row reads its packed key (4 B) and selection (1 B) and writes the
// match flag (1 B) plus 8 B per payload column: N x (6 + 8 P) bytes /
// 3.35 TB/s. The compare-all loop costs B integer compares per probe row,
// which only matters near the 2048-row build limit. Design: build keys are
// broadcast from shared memory (every lane of a warp reads the same word,
// so there are no bank conflicts), probe loads and stores are coalesced,
// and the first matching build row (lowest index) supplies the payload. A
// selected probe row that hits two or more selected build rows sets the
// device-side duplicate flag; the executor raises DuplicateBuildKeyError
// from it after the statement, as the reference's fused path does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuild = 2048;

__global__ void probe_join_kernel(const int32_t* __restrict__ bkeys,
                                  const bool* __restrict__ bsel, int b,
                                  const int32_t* __restrict__ pkeys,
                                  const bool* __restrict__ psel, int64_t n,
                                  const int64_t* __restrict__ payload, int p,
                                  bool* __restrict__ matched,
                                  int64_t* __restrict__ out,
                                  int32_t* __restrict__ has_dup) {
  __shared__ int32_t s_keys[kMaxBuild];
  __shared__ bool s_sel[kMaxBuild];
  for (int j = threadIdx.x; j < b; j += blockDim.x) {
    s_keys[j] = bkeys[j];
    s_sel[j] = bsel[j];
  }
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    int count = 0;
    int first = 0;
    if (psel[r]) {
      const int32_t pk = pkeys[r];
      for (int j = 0; j < b; ++j) {
        const bool hit = s_sel[j] && (s_keys[j] == pk);
        if (hit && count == 0) first = j;
        count += hit ? 1 : 0;
      }
    }
    matched[r] = count > 0;
    if (count > 1) *has_dup = 1;
    for (int q = 0; q < p; ++q) {
      out[(int64_t)q * n + r] = count > 0 ? payload[(int64_t)q * b + first]
                                          : (int64_t)0;
    }
  }
}

}  // namespace

// bkeys/pkeys: packed u32 keys as int32 storage (equality only); payload:
// int64[p, b]; matched: bool[n]; out: int64[p, n]; has_dup: zeroed int32[1].
// Returns cudaGetLastError(); a build above kMaxBuild rows is refused.
extern "C" int cb_probe_join(const int32_t* bkeys, const bool* bsel, int b,
                             const int32_t* pkeys, const bool* psel,
                             int64_t n, const int64_t* payload, int p,
                             bool* matched, int64_t* out, int32_t* has_dup,
                             void* stream) {
  if (b < 0 || b > kMaxBuild) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  probe_join_kernel<<<cb::grid_for(n, kThreads), kThreads, 0, s>>>(
      bkeys, bsel, b, pkeys, psel, n, payload, p, matched, out, has_dup);
  return (int)cudaGetLastError();
}
