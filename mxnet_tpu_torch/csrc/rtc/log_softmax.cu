// Row log-softmax, bf16 in and out with f32 math, for rtc.CudaModule.
//
// Replaces: on this path, the log-softmax of BERT-base pretraining's
// masked-LM logits (mxnet_tpu_torch/ops/nn.py log_softmax; the JAX
// package's log_softmax, mxnet_tpu/ops/nn.py:232, f32 compute for bf16
// input, the input dtype out), at (64 x 19 = 1216, 30522), run as a user's
// runtime-compiled kernel. It is read as text and compiled at run time by
// rtc.CudaModule (NVRTC, sm_90a).
//
// Bound on an H100: bytes. Each value is read once and written once (4
// bytes an element; 1216 x 30522 = 148 MB = 44 us at 3.35 TB/s). Design:
// one block per row (a grid-stride loop over rows beyond the grid). The
// row is read from device memory once, as bf16 pairs where the row allows,
// and kept as f32 in dynamic shared memory (cols * 4 bytes: 122 KB for
// BERT's vocabulary, above the 48 KB a launch gets without opting in); the
// max, the sum of exp(x - max) and the output pass then read shared memory
// only. Reductions go through warp shuffles and one 32-slot array.

#include <cuda_bf16.h>

typedef unsigned long long u64;  // NVRTC has no <stddef.h>

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's max (is_max) or sum of v, in every thread; blockDim.x is a
// multiple of 32
__device__ float block_reduce(float v, bool is_max, float *red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const float id = is_max ? __int_as_float(0xff800000) : 0.0f;
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : id;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red is reused by the next reduction
  return v;
}

extern "C" __global__ void __launch_bounds__(1024) log_softmax(const __nv_bfloat16 *x, int rows, int cols, __nv_bfloat16 *y) {
  extern __shared__ float row[];  // cols floats
  __shared__ float red[32];
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const __nv_bfloat16 *xr = x + (u64)r * cols;
    __nv_bfloat16 *yr = y + (u64)r * cols;
    const bool pairs = (cols % 2 == 0) &&
                       ((reinterpret_cast<u64>(xr) |
                         reinterpret_cast<u64>(yr)) & 3ull) == 0;
    float m = __int_as_float(0xff800000);  // -inf
    if (pairs) {
      const __nv_bfloat162 *x2 = reinterpret_cast<const __nv_bfloat162 *>(xr);
#pragma unroll 4
      for (int i = threadIdx.x; i < cols / 2; i += blockDim.x) {
        float2 f = __bfloat1622float2(x2[i]);
        reinterpret_cast<float2 *>(row)[i] = f;
        m = fmaxf(m, fmaxf(f.x, f.y));
      }
    } else {
      for (int i = threadIdx.x; i < cols; i += blockDim.x) {
        float f = __bfloat162float(xr[i]);
        row[i] = f;
        m = fmaxf(m, f);
      }
    }
    m = block_reduce(m, true, red);
    float s = 0.0f;
    for (int i = threadIdx.x; i < cols; i += blockDim.x) s += expf(row[i] - m);
    const float logsum = logf(block_reduce(s, false, red));  // y = (x - m) - logsum
    if (pairs) {
      __nv_bfloat162 *y2 = reinterpret_cast<__nv_bfloat162 *>(yr);
      for (int i = threadIdx.x; i < cols / 2; i += blockDim.x) {
        float2 f = reinterpret_cast<const float2 *>(row)[i];
        y2[i] = __floats2bfloat162_rn((f.x - m) - logsum, (f.y - m) - logsum);
      }
    } else {
      for (int i = threadIdx.x; i < cols; i += blockDim.x) yr[i] = __float2bfloat16((row[i] - m) - logsum);
    }
    __syncthreads();  // the next row overwrites row[]
  }
}
