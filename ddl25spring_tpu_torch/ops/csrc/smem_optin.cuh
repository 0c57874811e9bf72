// Shared by the port's CUDA sources: the opt-in to more than 48 KB of dynamic
// shared memory, made once per kernel instantiation and device rather than on
// every launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace ddl {

// `done` holds one bit per device (devices 32 and up opt in on every launch).
template <typename K>
cudaError_t allow_smem(std::atomic<uint32_t>& done, K kernel, size_t bytes, int device) {
  const uint32_t bit = device < 32 ? 1u << device : 0u;
  if (bit && (done.load() & bit)) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess)
    done.fetch_or(bit);
  else
    cudaGetLastError();  // returned here; not left for the next launch's check
  return e;
}

}  // namespace ddl
