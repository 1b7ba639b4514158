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
// one 128-thread block per row (a grid-stride loop over rows beyond the
// grid), no shared memory beyond 8 slots, so up to 16 rows are in flight
// on an SM and one row's loads overlap another's reductions. Two passes
// over the row: the first keeps, per thread, an online maximum and a sum
// of exp(x - max) rescaled when the maximum grows, and the block combines
// them; the second reads the row again (from L2: a row is 61 KB) and
// writes (x - max) - log(sum), as the plain version. Rows are read and
// written 16 bytes (8 values) a thread where x and y share their
// alignment; a row's unaligned head and its tail, or a whole row where the
// two differ, go one value at a time. The exponentials use the hardware's exp2 (__expf), within a few
// f32 ulps: far below one bf16 ulp of the output.

#include <cuda_bf16.h>

typedef unsigned long long u64;  // NVRTC has no <stddef.h>

#define NEG_INF __int_as_float(0xff800000)

// (m, s) <- the pair for the union of two sets: max m, s = sum exp(x - m)
__device__ __forceinline__ void combine(float &m, float &s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == NEG_INF) return;  // both empty
  s = s * __expf(m - mm) + s2 * __expf(m2 - mm);
  m = mm;
}

__device__ __forceinline__ void add8(float &m, float &s, const float (&v)[8]) {
  float lm = v[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) lm = fmaxf(lm, v[i]);
  float ls = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) ls += __expf(v[i] - lm);
  combine(m, s, lm, ls);
}

__device__ __forceinline__ void unpack8(float (&v)[8], uint4 u) {
  const __nv_bfloat162 *h = reinterpret_cast<const __nv_bfloat162 *>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

extern "C" __global__ void __launch_bounds__(128) log_softmax(const __nv_bfloat16 *x, int rows, int cols, __nv_bfloat16 *y) {
  __shared__ float red_m[4], red_s[4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const __nv_bfloat16 *xr = x + (u64)r * cols;
    __nv_bfloat16 *yr = y + (u64)r * cols;
    // values before the first 16-byte boundary of xr, if y shares it
    const u64 ax = reinterpret_cast<u64>(xr), ay = reinterpret_cast<u64>(yr);
    const bool vec = ((ax ^ ay) & 15ull) == 0 && (ax & 1ull) == 0;
    int head = vec ? (int)(((16ull - (ax & 15ull)) & 15ull) >> 1) : cols;
    if (head > cols) head = cols;
    const int n8 = (cols - head) >> 3;
    const int tail0 = head + 8 * n8;
    const uint4 *x8 = reinterpret_cast<const uint4 *>(xr + head);

    // pass 1: online max and sum of exp, then the block's pair
    float m = NEG_INF, s = 0.0f;
    for (int i = threadIdx.x; i < head; i += blockDim.x)
      combine(m, s, __bfloat162float(xr[i]), 1.0f);
    int i = threadIdx.x;
    for (; i + 3 * (int)blockDim.x < n8; i += 4 * blockDim.x) {
      uint4 u[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) u[j] = x8[i + j * blockDim.x];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v[8];
        unpack8(v, u[j]);
        add8(m, s, v);
      }
    }
    for (; i < n8; i += blockDim.x) {
      float v[8];
      unpack8(v, x8[i]);
      add8(m, s, v);
    }
    for (int k = tail0 + threadIdx.x; k < cols; k += blockDim.x)
      combine(m, s, __bfloat162float(xr[k]), 1.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      combine(m, s, __shfl_xor_sync(0xffffffffu, m, o),
              __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) {
      red_m[warp] = m;
      red_s[warp] = s;
    }
    __syncthreads();
    m = red_m[0];
    s = red_s[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) combine(m, s, red_m[w], red_s[w]);
    const float lsum = logf(s);  // y = (x - max) - log(sum)
    __syncthreads();             // red_* is reused by the next row

    // pass 2: the row again, out
    for (int k = threadIdx.x; k < head; k += blockDim.x)
      yr[k] = __float2bfloat16((__bfloat162float(xr[k]) - m) - lsum);
    uint4 *y8 = reinterpret_cast<uint4 *>(yr + head);
    for (int k = threadIdx.x; k < n8; k += blockDim.x) {
      float v[8];
      unpack8(v, x8[k]);
      uint4 o;
      __nv_bfloat162 *h = reinterpret_cast<__nv_bfloat162 *>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn((v[2 * j] - m) - lsum, (v[2 * j + 1] - m) - lsum);
      y8[k] = o;
    }
    for (int k = tail0 + threadIdx.x; k < cols; k += blockDim.x)
      yr[k] = __float2bfloat16((__bfloat162float(xr[k]) - m) - lsum);
  }
}
