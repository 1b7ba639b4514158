// Tanh-approximate GELU, forward and backward, bf16 in and out with f32
// math, for rtc.CudaModule.
//
// Replaces: on this path, the GELU of BERT-base's feed-forward block
// (mxnet_tpu_torch/gluon/model_zoo/bert.py, ops.gelu_tanh; the JAX
// package's gelu_tanh, mxnet_tpu/ops/elemwise.py:82), run as a user's
// runtime-compiled kernel pair under autograd.Function, the way MXNet users
// give an rtc kernel a gradient. It is read as text and compiled at run
// time by rtc.CudaModule (NVRTC, sm_90a).
//
// Bound on an H100: bytes. Forward reads x and writes y (4 bytes an
// element), backward reads x and dy and writes dx (6 bytes); at BERT-base's
// FFN width, 64 x 128 rows of 3072 (25.2 M elements), that is 101 MB
// (30 us) and 151 MB (45 us) at 3.35 TB/s. The arithmetic (one tanhf and a
// dozen FMAs an element) is far below the card's rate. Design: each thread
// moves 16 bytes (8 values) per load and store in a grid-stride loop; a
// tail, or pointers not 16-byte aligned, take one value at a time. The
// f32 formula is PyTorch's own (gelu with approximate="tanh" and its
// backward), so the results are within one bf16 rounding of it.

#include <cuda_bf16.h>

typedef unsigned long long u64;  // NVRTC has no <stddef.h>

#define K_BETA 0.7978845608028654f   // sqrt(2 / pi)
#define K_KAPPA 0.044715f

__device__ __forceinline__ float gelu_f(float x) {
  float x_cube = x * x * x;
  float inner = K_BETA * (x + K_KAPPA * x_cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float gelu_grad_f(float x, float dy) {
  float x_sq = x * x;
  float x_cube = x_sq * x;
  float inner = K_BETA * (x + K_KAPPA * x_cube);
  float t = tanhf(inner);
  float left = 0.5f * x;
  float right = 1.0f + t;
  float left_derivative = 0.5f * right;
  float tanh_derivative = 1.0f - t * t;
  float inner_derivative = K_BETA * (1.0f + 3.0f * K_KAPPA * x_sq);
  float right_derivative = left * tanh_derivative * inner_derivative;
  return dy * (left_derivative + right_derivative);
}

__device__ __forceinline__ bool aligned16(const void *p) {
  return (reinterpret_cast<u64>(p) & 15ull) == 0;
}

extern "C" __global__ void gelu_tanh_fwd(const __nv_bfloat16 *x, int n, __nv_bfloat16 *y) {
  const u64 stride = (u64)gridDim.x * blockDim.x;
  const u64 tid = blockIdx.x * (u64)blockDim.x + threadIdx.x;
  u64 done = 0;
  if (aligned16(x) && aligned16(y)) {
    const u64 n8 = (u64)n / 8;
    for (u64 i = tid; i < n8; i += stride) {
      uint4 v = reinterpret_cast<const uint4 *>(x)[i];
      __nv_bfloat162 *h = reinterpret_cast<__nv_bfloat162 *>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(h[j]);
        h[j] = __floats2bfloat162_rn(gelu_f(f.x), gelu_f(f.y));
      }
      reinterpret_cast<uint4 *>(y)[i] = v;
    }
    done = n8 * 8;
  }
  for (u64 i = done + tid; i < (u64)n; i += stride)
    y[i] = __float2bfloat16(gelu_f(__bfloat162float(x[i])));
}

extern "C" __global__ void gelu_tanh_bwd(const __nv_bfloat16 *x, const __nv_bfloat16 *dy, int n,
                                         __nv_bfloat16 *dx) {
  const u64 stride = (u64)gridDim.x * blockDim.x;
  const u64 tid = blockIdx.x * (u64)blockDim.x + threadIdx.x;
  u64 done = 0;
  if (aligned16(x) && aligned16(dy) && aligned16(dx)) {
    const u64 n8 = (u64)n / 8;
    for (u64 i = tid; i < n8; i += stride) {
      uint4 v = reinterpret_cast<const uint4 *>(x)[i];
      uint4 g = reinterpret_cast<const uint4 *>(dy)[i];
      __nv_bfloat162 *h = reinterpret_cast<__nv_bfloat162 *>(&v);
      const __nv_bfloat162 *d = reinterpret_cast<const __nv_bfloat162 *>(&g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 f = __bfloat1622float2(h[j]);
        float2 e = __bfloat1622float2(d[j]);
        h[j] = __floats2bfloat162_rn(gelu_grad_f(f.x, e.x), gelu_grad_f(f.y, e.y));
      }
      reinterpret_cast<uint4 *>(dx)[i] = v;
    }
    done = n8 * 8;
  }
  for (u64 i = done + tid; i < (u64)n; i += stride)
    dx[i] = __float2bfloat16(gelu_grad_f(__bfloat162float(x[i]), __bfloat162float(dy[i])));
}
