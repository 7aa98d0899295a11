// Shared helpers for the pano_tpu_torch kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// pano_tpu_torch/_build.py): raw device pointers, the CUDA stream as a
// void*, launch on that stream, allocate nothing, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PANO_API extern "C" __attribute__((visibility("default")))

static inline unsigned int pano_cdiv(int a, int b) {
  return static_cast<unsigned int>((a + b - 1) / b);
}
