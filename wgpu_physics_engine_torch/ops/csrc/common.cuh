// Shared by every kernel library of ops/csrc (each .cu builds into its own
// shared library, so each carries its own copy of what is defined here).
#pragma once

#include <cuda_runtime.h>

// cudaError_t -> message, for the Python wrapper's error report
// (ops/_build.py check()).
extern "C" const char* wpe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
