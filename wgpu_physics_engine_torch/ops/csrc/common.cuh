// Shared by every kernel library of ops/csrc (each .cu builds into its own
// shared library, so each carries its own copy of what is defined here).
#pragma once

#include <cuda_runtime.h>

// cudaError_t -> message, for the Python wrapper's error report
// (ops/_build.py check()).
extern "C" const char* wpe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) for KERNEL on the
// current device, called again only when a launch needs more than the size
// set there before, so that a loop of short calls (a row window stepped 1
// or 2 substeps at a time) makes that driver call once, not every call.
template <auto KERNEL>
inline cudaError_t allow_smem(int bytes) {
  constexpr int kDevices = 64;
  static int allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kDevices && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev >= 0 && dev < kDevices) allowed[dev] = bytes;
  return err;
}
