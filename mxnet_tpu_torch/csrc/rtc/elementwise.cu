// The reference's runtime-compiled kernels, as CUDA C++ for rtc.CudaModule.
//
// Replaces: the Pallas kernels that tests/test_library.py compiles with
// mxnet_tpu/rtc.py's PallasModule and launches through Kernel.launch
// (pl.pallas_call at mxnet_tpu/rtc.py:64): axpy (o = 2x + y), scale
// (o = 3x) and the identity k. This file is not built with the package: it
// is read as text and compiled at run time by rtc.CudaModule (NVRTC,
// sm_90a), as a user's source would be.
//
// Bound on an H100: bytes. axpy reads 8 and writes 4 bytes an element
// (12 bytes; 25.6 M elements = 307 MB = 92 us at 3.35 TB/s); scale and k
// 8 bytes an element. Design: one thread per element in a grid-stride
// loop, neighbouring threads on neighbouring addresses; 2x is exact, so
// axpy equals the plain 2 * x + y bitwise whether or not the compiler
// contracts it into an FMA.

typedef unsigned long long u64;  // NVRTC has no <stddef.h>

extern "C" __global__ void axpy(const float *x, const float *y, int n, float *o) {
  for (u64 i = blockIdx.x * (u64)blockDim.x + threadIdx.x; i < (u64)n;
       i += (u64)gridDim.x * blockDim.x)
    o[i] = 2.0f * x[i] + y[i];
}

extern "C" __global__ void scale(const float *x, int n, float *o) {
  for (u64 i = blockIdx.x * (u64)blockDim.x + threadIdx.x; i < (u64)n;
       i += (u64)gridDim.x * blockDim.x)
    o[i] = 3.0f * x[i];
}

extern "C" __global__ void k(const float *x, int n, float *o) {
  for (u64 i = blockIdx.x * (u64)blockDim.x + threadIdx.x; i < (u64)n;
       i += (u64)gridDim.x * blockDim.x)
    o[i] = x[i];
}
