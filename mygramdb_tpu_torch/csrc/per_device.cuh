// Launch state kept for each CUDA device a process launches on: the SM
// count, the shared-memory and cluster attributes a kernel raised, and
// grid memos. A function attribute and an occupancy answer belong to one
// device, so a value computed for the first card is never reused on
// another. The wrappers make their tensors' device current before they
// call a C entry point, so cudaGetDevice names the launch's device.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

constexpr int kMaxDevices = 64;

// One value of T for each device, value-initialised. with(fn) runs
// fn(device, slot) under a lock, slot being the current device's value;
// fn returns a cudaError_t, which with() passes on.
template <typename T>
class PerDevice {
 public:
  template <typename Fn>
  cudaError_t with(Fn fn) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu_);
    return fn(dev, slots_[dev]);
  }

 private:
  std::mutex mu_;
  T slots_[kMaxDevices] = {};
};

// The device's SM count and the most dynamic shared memory a block may
// opt in to.
inline cudaError_t device_limits(int dev, int* sms, int* smem_optin) {
  cudaError_t e =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e;
}

// Raises kernel's dynamic shared-memory limit on the current device to all
// that a block may opt in to (optin) beside the kernel's static shared
// memory; -> that limit in *dynamic_max.
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, int optin, int* dynamic_max) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  *dynamic_max = optin - (int)a.sharedSizeBytes;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *dynamic_max);
}
