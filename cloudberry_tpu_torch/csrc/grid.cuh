// Grid size for the port's grid-stride kernels: enough blocks to cover n
// work items, at most eight per SM (more only queue up behind the resident
// ones), and for a kernel whose registers or shared memory allow fewer, no
// more than stay resident (a second wave would run its share of the work
// after the first, with the card part idle).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cb {

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

inline int grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = (int64_t)sm_count() * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

template <class Kernel>
inline int resident_grid(Kernel kernel, int64_t n, int threads, size_t smem) {
  const int blocks = grid_for(n, threads);
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      per_sm < 1) {
    per_sm = 1;
  }
  const int resident = per_sm * sm_count();
  return blocks < resident ? blocks : resident;
}

}  // namespace cb
