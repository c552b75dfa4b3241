// The dynamic shared-memory limit of the kernels that ask for more than the
// default 48 KiB a CTA.
//
// cudaFuncAttributeMaxDynamicSharedMemorySize belongs to the kernel in the
// device's context, which every host thread shares. A launch that set it to
// its own need could lower it under another thread's launch of the same
// kernel with a larger need, and that launch then fails with
// cudaErrorInvalidValue: the per-key checks of independent.py launch the
// frontier kernels from a thread pool, each key at its own table size. So
// the limit is set once for each kernel and device, to all the device
// allows beside the kernel's static shared memory, and is never lowered; a
// launch only asks whether its need fits.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <mutex>

namespace {

// Raises `kernel`'s limit on the current device to the device's most (once
// for each kernel and device). Returns cudaSuccess when `need` bytes fit
// under it, cudaErrorInvalidValue when they do not, else the error of the
// runtime call that failed.
inline cudaError_t allow_smem(const void* kernel, size_t need) {
  constexpr int kSlots = 64;
  static std::mutex mu;
  static const void* kernels[kSlots] = {};
  static int devices[kSlots] = {};
  static size_t limits[kSlots] = {};
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < used && (kernels[i] != kernel || devices[i] != dev)) ++i;
  size_t limit = i < used ? limits[i] : 0;
  if (i == used) {
    int most = 0;
    cudaFuncAttributes fa;
    err = cudaDeviceGetAttribute(&most,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    limit = (size_t)most - fa.sharedSizeBytes;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)limit);
    if (err != cudaSuccess) return err;
    if (used < kSlots) {
      kernels[used] = kernel;
      devices[used] = dev;
      limits[used] = limit;
      ++used;
    }
  }
  return need <= limit ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
