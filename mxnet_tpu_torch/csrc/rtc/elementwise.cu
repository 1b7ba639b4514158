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
// 8 bytes an element. Design: a grid-stride loop, neighbouring threads on
// neighbouring addresses. axpy moves 16 bytes (4 values) a thread per load
// and store where x, y and o are 16-byte aligned, the last n % 4 values
// (or every value, unaligned) one at a time; scale and k one value a
// thread. 2x is exact, so axpy equals the plain 2 * x + y bitwise whether
// or not the compiler contracts it into an FMA.

typedef unsigned long long u64;  // NVRTC has no <stddef.h>

extern "C" __global__ void axpy(const float *x, const float *y, int n, float *o) {
  const u64 stride = (u64)gridDim.x * blockDim.x;
  const u64 tid = blockIdx.x * (u64)blockDim.x + threadIdx.x;
  u64 done = 0;
  if (((reinterpret_cast<u64>(x) | reinterpret_cast<u64>(y) |
        reinterpret_cast<u64>(o)) & 15ull) == 0) {
    const u64 n4 = (u64)n / 4;
    const float4 *x4 = reinterpret_cast<const float4 *>(x);
    const float4 *y4 = reinterpret_cast<const float4 *>(y);
    float4 *o4 = reinterpret_cast<float4 *>(o);
    for (u64 i = tid; i < n4; i += stride) {
      const float4 a = x4[i], b = y4[i];
      o4[i] = make_float4(2.0f * a.x + b.x, 2.0f * a.y + b.y,
                          2.0f * a.z + b.z, 2.0f * a.w + b.w);
    }
    done = n4 * 4;
  }
  for (u64 i = done + tid; i < (u64)n; i += stride) o[i] = 2.0f * x[i] + y[i];
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
