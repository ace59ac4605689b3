// Shared helpers of the hand-written Hopper kernels. Each kernel source is
// built on its own into a shared library with a plain C interface (no PyTorch
// headers) and bound with ctypes from ops/kernels.py.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Threads per block of the elementwise-style kernels: one thread per output
// element, 256 threads = 8 warps, enough blocks in flight to cover the SMs.
#define TFDL_THREADS 256

// Grid for `total` elements with one thread each, capped so the grid-stride
// loop in the kernels covers any remainder (gridDim.x limit is 2^31-1).
static inline unsigned int tfdl_blocks(int64_t total) {
  int64_t blocks = (total + TFDL_THREADS - 1) / TFDL_THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 1048576) blocks = 1048576;
  return (unsigned int)blocks;
}

extern "C" const char* tfdl_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
