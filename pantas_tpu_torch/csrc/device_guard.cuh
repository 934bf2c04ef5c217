// Shared by every source of the kernel library: the guard that makes a
// tensor's device current around its launches.

#pragma once

#include <cuda_runtime.h>

namespace pantas_kernels {

constexpr int kMaxDevices = 64;

// Makes `dev` current for the launches and restores the caller's device.
class DeviceGuard {
 public:
  explicit DeviceGuard(int dev) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != dev) err_ = cudaSetDevice(dev);
  }
  ~DeviceGuard() {
    int now = -1;
    if (prev_ >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t err() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace pantas_kernels
