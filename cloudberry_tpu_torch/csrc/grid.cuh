// Grid size for the port's grid-stride kernels: enough blocks to cover n
// rows, at most eight per SM (more only queue up behind the resident ones).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cb {

inline int grid_for(int64_t n, int threads) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

}  // namespace cb
