// Fused 1x1 convolution with BatchNorm prologue and moment epilogue for
// Hopper (sm_90a): the CUDA port of the Pallas kernel `_fused_kernel`,
// launched by `conv1x1_bn_act` in mxnet_tpu/ops/pallas/fused_conv1x1.py.
//
// For x (M, K) (N*H*W rows of an NHWC activation, bf16 or f32), w (K, N)
// bf16 and the previous BatchNorm folded into scale, shift (K,) f32:
//   x_hat = relu(x * scale + shift)      f32, then rounded to bf16
//   y     = x_hat @ w                    bf16 x bf16, f32 accumulation
//   out   = bf16(y), col_sum = sum_rows y, col_sumsq = sum_rows y^2
// with the moments taken of the f32 y, as `conv1x1_bn_act_reference`.
//
// The TPU kernel keeps all of K x N resident and walks M tiles in order,
// carrying the moments in VMEM scratch across the grid. Here a 128-row x
// BN-column output tile (BN = 64 or 128) is one block's unit of work and K is
// walked in 32-wide chunks: each chunk of x is loaded, passed through the
// affine and the ReLU in f32, rounded to bf16 and stored to shared memory
// (the prologue), the w chunk beside it, and the products run on the tensor
// cores (ldmatrix, ldmatrix.trans for w, mma.sync m16n8k16). The next chunk's
// global loads are issued before the current chunk's products.
//
// Moments without float atomics, deterministic: a block owns one column strip
// and a fixed set of M tiles (blockIdx.x, + gridDim.x, ...), keeps its column
// sums in registers over its tiles and writes one partial row to a
// (grid_m, N) f32 workspace per moment. The last block of each column strip
// to finish (an integer ticket) sums the grid_m partials of its columns in a
// fixed order. Rows at or past M (the ragged last tile) contribute nothing:
// their x_hat is zero-filled and they are masked out of the moments and of
// the y store. (The Pallas kernel sums every row of its last tile, so its
// moments are wrong when block_m does not divide M; this kernel is not.)
//
// Bound. At ResNet-50's batch-128 1x1 shapes the kernel reads x and w once
// and writes y once: 103 to 257 MB at stages 2-4 (31-77 us at 3.35 TB/s,
// bound by bytes) and 13.15 GFLOP at stage 5 (13.3 us at 989 TFLOP/s, bound
// by operations). This first version uses mma.sync and a register prefetch
// of one chunk, not TMA or wgmma, and no split over K. Measured times:
// PERF.md.
//
// Plain C interface, loaded with ctypes by mxnet_tpu_torch/ops/cuda/
// fused_conv1x1.py. The launch goes to the caller's stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kBM = 128;                // rows of an output tile
constexpr int kBK = 32;                 // K chunk
constexpr int kLDA = kBK + 8;           // padded smem row (80 bytes)
constexpr int kAChunks = kBM * kBK / 8 / kThreads;  // 16-byte x chunks/thread

template <int BN>
struct Cfg {
  static constexpr int WARPS_N = BN == 128 ? 4 : 2;
  static constexpr int WARPS_M = 8 / WARPS_N;
  static constexpr int WM = kBM / WARPS_M;      // warp tile rows: 64 or 32
  static constexpr int WN = BN / WARPS_N;       // warp tile cols: 32
  static constexpr int MT = WM / 16;            // m16 tiles per warp
  static constexpr int NT = WN / 8;             // n8 tiles per warp
  static constexpr int LDB = BN + 8;            // padded smem row of w
  static constexpr int B_CHUNKS = kBK * BN / 8 / kThreads;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one 16x8x16 tile: a is 16x16 row-major, b 16x8 col-major.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 address matrix i's rows.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Eight consecutive x values as loaded from device memory (16 or 32 bytes).
template <typename XT>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Raw8<float> {
  float4 lo, hi;
};

__device__ __forceinline__ void ld8(Raw8<__nv_bfloat16>& r,
                                    const __nv_bfloat16* p) {
  r.u = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void ld8(Raw8<float>& r, const float* p) {
  r.lo = __ldg(reinterpret_cast<const float4*>(p));
  r.hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
}
__device__ __forceinline__ void to_f32(float (&v)[8],
                                       const Raw8<__nv_bfloat16>& r) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void to_f32(float (&v)[8], const Raw8<float>& r) {
  v[0] = r.lo.x; v[1] = r.lo.y; v[2] = r.lo.z; v[3] = r.lo.w;
  v[4] = r.hi.x; v[5] = r.hi.y; v[6] = r.hi.z; v[7] = r.hi.w;
}

// Global loads of the x chunk [m0, m0 + 128) x [k0, k0 + 32): thread chunk c
// is row c / 4, columns (c % 4) * 8 .. + 7. Rows >= M and columns >= K are
// flagged invalid (K is a multiple of 8, so a chunk is all in or all out).
template <typename XT>
__device__ __forceinline__ void load_a(Raw8<XT> (&ra)[kAChunks],
                                       bool (&va)[kAChunks],
                                       const XT* __restrict__ x, int m0,
                                       int k0, int M, int K) {
#pragma unroll
  for (int i = 0; i < kAChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = m0 + (c >> 2);
    const int k = k0 + (c & 3) * 8;
    va[i] = row < M && k < K;
    if (va[i]) ld8(ra[i], x + (size_t)row * K + k);
  }
}

// The prologue: x_hat = relu(x * scale + shift) in f32 (multiply and add each
// rounded, as the plain version computes them), rounded to bf16 into As.
// Invalid chunks store zeros, so padded rows and columns add nothing.
template <typename XT>
__device__ __forceinline__ void store_a(__nv_bfloat16* As,
                                        const Raw8<XT> (&ra)[kAChunks],
                                        const bool (&va)[kAChunks],
                                        const float* __restrict__ scale,
                                        const float* __restrict__ shift,
                                        int k0, int relu) {
#pragma unroll
  for (int i = 0; i < kAChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int cc = (c & 3) * 8;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (va[i]) {
      float v[8];
      to_f32(v, ra[i]);
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale + k0 + cc));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale + k0 + cc) + 1);
      const float4 t0 = __ldg(reinterpret_cast<const float4*>(shift + k0 + cc));
      const float4 t1 = __ldg(reinterpret_cast<const float4*>(shift + k0 + cc) + 1);
      const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float t[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = __fadd_rn(__fmul_rn(v[2 * j], s[2 * j]), t[2 * j]);
        float b = __fadd_rn(__fmul_rn(v[2 * j + 1], s[2 * j + 1]),
                            t[2 * j + 1]);
        if (relu) {  // NaN passes through, as max(x, 0) in the reference
          a = a < 0.f ? 0.f : a;
          b = b < 0.f ? 0.f : b;
        }
        o[j] = pack_bf16(a, b);
      }
    }
    *reinterpret_cast<uint4*>(As + (c >> 2) * kLDA + cc) = out;
  }
}

// Global loads of the w chunk [k0, k0 + 32) x [n0, n0 + BN), zero past K or N.
template <int BN>
__device__ __forceinline__ void load_b(uint4 (&rb)[Cfg<BN>::B_CHUNKS],
                                       const __nv_bfloat16* __restrict__ w,
                                       int n0, int k0, int K, int N) {
  constexpr int kPerRow = BN / 8;
#pragma unroll
  for (int i = 0; i < Cfg<BN>::B_CHUNKS; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int k = k0 + c / kPerRow;
    const int n = n0 + (c % kPerRow) * 8;
    rb[i] = make_uint4(0u, 0u, 0u, 0u);
    if (k < K && n < N)
      rb[i] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * N + n));
  }
}

template <int BN>
__device__ __forceinline__ void store_b(__nv_bfloat16* Bs,
                                        const uint4 (&rb)[Cfg<BN>::B_CHUNKS]) {
  constexpr int kPerRow = BN / 8;
#pragma unroll
  for (int i = 0; i < Cfg<BN>::B_CHUNKS; ++i) {
    const int c = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(Bs + (c / kPerRow) * Cfg<BN>::LDB +
                              (c % kPerRow) * 8) = rb[i];
  }
}

// acc += As[warp rows] @ Bs[:, warp cols] over one 32-wide K chunk.
template <int BN>
__device__ __forceinline__ void mma_chunk(
    float (&acc)[Cfg<BN>::MT][Cfg<BN>::NT][4], const __nv_bfloat16* As,
    const __nv_bfloat16* Bs, int wm, int wn, int lane) {
  using C = Cfg<BN>;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 16) {
    uint32_t a[C::MT][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
      ldmatrix_x4(a[mt], As + (wm * C::WM + mt * 16 + (lane & 15)) * kLDA +
                             ks + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < C::NT; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, Bs + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * C::LDB +
                 wn * C::WN + (nt + (lane >> 4)) * 8);
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

template <typename XT, int BN>
__global__ void __launch_bounds__(kThreads)
conv1x1_bn_act_kernel(const XT* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      __nv_bfloat16* __restrict__ y,
                      float* __restrict__ col_sum,
                      float* __restrict__ col_sumsq,
                      float* __restrict__ partial, int* __restrict__ counter,
                      int M, int K, int N, int relu) {
  using C = Cfg<BN>;
  __shared__ __align__(16) __nv_bfloat16 As[kBM * kLDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[kBK * C::LDB];
  __shared__ float red[2][C::WARPS_M][BN];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / C::WARPS_N;
  const int wn = warp % C::WARPS_N;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.y * BN;
  const int n_m_tiles = (M + kBM - 1) / kBM;

  // this thread's partial moments of columns wn*WN + nt*8 + 2t + {0, 1}
  float csum[C::NT][2], csq[C::NT][2];
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
    csum[nt][0] = csum[nt][1] = csq[nt][0] = csq[nt][1] = 0.f;

  for (int mi = blockIdx.x; mi < n_m_tiles; mi += gridDim.x) {
    const int m0 = mi * kBM;
    float acc[C::MT][C::NT][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

    Raw8<XT> ra[kAChunks];
    bool va[kAChunks];
    uint4 rb[C::B_CHUNKS];
    load_a<XT>(ra, va, x, m0, 0, M, K);
    load_b<BN>(rb, w, n0, 0, K, N);
    // the previous tile ended on a barrier after its last products
    store_a<XT>(As, ra, va, scale, shift, 0, relu);
    store_b<BN>(Bs, rb);
    __syncthreads();
    for (int k0 = 0; k0 < K; k0 += kBK) {
      const bool more = k0 + kBK < K;
      if (more) {  // in flight while this chunk's products run
        load_a<XT>(ra, va, x, m0, k0 + kBK, M, K);
        load_b<BN>(rb, w, n0, k0 + kBK, K, N);
      }
      mma_chunk<BN>(acc, As, Bs, wm, wn, lane);
      __syncthreads();
      if (more) {
        store_a<XT>(As, ra, va, scale, shift, k0 + kBK, relu);
        store_b<BN>(Bs, rb);
        __syncthreads();
      }
    }

    // epilogue: y in bf16 and the moments of the f32 y, valid rows only
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      const int r0 = m0 + wm * C::WM + mt * 16 + g;
      const int r1 = r0 + 8;
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int col = n0 + wn * C::WN + nt * 8 + 2 * t;
        if (col >= N) continue;
        const float v0 = acc[mt][nt][0], v1 = acc[mt][nt][1];
        const float v2 = acc[mt][nt][2], v3 = acc[mt][nt][3];
        if (r0 < M) {
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r0 * N + col) =
              __floats2bfloat162_rn(v0, v1);
          csum[nt][0] += v0;
          csum[nt][1] += v1;
          csq[nt][0] += v0 * v0;
          csq[nt][1] += v1 * v1;
        }
        if (r1 < M) {
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r1 * N + col) =
              __floats2bfloat162_rn(v2, v3);
          csum[nt][0] += v2;
          csum[nt][1] += v3;
          csq[nt][0] += v2 * v2;
          csq[nt][1] += v3 * v3;
        }
      }
    }
  }

  // the block's column partials: over the 8 row-groups of a warp (shuffles),
  // then over the WARPS_M warps of a column (shared memory), in fixed order
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        csum[nt][j] += __shfl_xor_sync(0xffffffffu, csum[nt][j], off);
        csq[nt][j] += __shfl_xor_sync(0xffffffffu, csq[nt][j], off);
      }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * C::WN + nt * 8 + 2 * t + j;
        red[0][wm][c] = csum[nt][j];
        red[1][wm][c] = csq[nt][j];
      }
  }
  __syncthreads();
  const int stat = tid / BN;  // 0: sum, 1: sum of squares (tid < 2 * BN)
  const int c = tid % BN;
  const int col = n0 + c;
  const int grid_m = gridDim.x;
  if (tid < 2 * BN && col < N) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < C::WARPS_M; ++i) s += red[stat][i][c];
    partial[((size_t)stat * grid_m + blockIdx.x) * N + col] = s;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(counter + blockIdx.y, 1) == grid_m - 1;
  __syncthreads();
  if (!is_last) return;

  // the last block of this column strip: sum the grid_m partials in order
  __threadfence();
  if (tid < 2 * BN && col < N) {
    const float* p = partial + (size_t)stat * grid_m * N + col;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int i = 0;
    for (; i + 4 <= grid_m; i += 4) {
      a0 += __ldcg(p + (size_t)i * N);
      a1 += __ldcg(p + (size_t)(i + 1) * N);
      a2 += __ldcg(p + (size_t)(i + 2) * N);
      a3 += __ldcg(p + (size_t)(i + 3) * N);
    }
    for (; i < grid_m; ++i) a0 += __ldcg(p + (size_t)i * N);
    (stat ? col_sumsq : col_sum)[col] = (a0 + a1) + (a2 + a3);
  }
}

template <typename XT, int BN>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* shift, void* y, float* col_sum,
                   float* col_sumsq, float* partial, int* counter, int M,
                   int K, int N, int relu, int grid_m, cudaStream_t stream) {
  const dim3 grid(grid_m, (N + BN - 1) / BN);
  conv1x1_bn_act_kernel<XT, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const __nv_bfloat16*>(w), scale,
      shift, static_cast<__nv_bfloat16*>(y), col_sum, col_sumsq, partial,
      counter, M, K, N, relu);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous (M, K), bf16 (x_is_bf16=1) or f32; w: contiguous (K, N) bf16;
// scale, shift: (K,) f32; y: (M, N) bf16; col_sum, col_sumsq: (N,) f32;
// partial: (2, grid_m, N) f32 scratch; counter: ceil(N / block_n) int32,
// zeroed. K and N multiples of 8, every pointer 16-byte aligned, block_n 64
// or 128, 1 <= grid_m <= ceil(M / 128). Returns a cudaError_t (0 on
// success).
extern "C" int mxt_conv1x1_bn_act(const void* x, const void* w,
                                  const void* scale, const void* shift,
                                  void* y, void* col_sum, void* col_sumsq,
                                  void* partial, void* counter, int M, int K,
                                  int N, int x_is_bf16, int relu, int block_n,
                                  int grid_m, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || grid_m < 1 ||
      grid_m > (M + kBM - 1) / kBM || (block_n != 64 && block_n != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(scale);
  const float* t = static_cast<const float*>(shift);
  float* cs = static_cast<float*>(col_sum);
  float* cq = static_cast<float*>(col_sumsq);
  float* p = static_cast<float*>(partial);
  int* ctr = static_cast<int*>(counter);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (x_is_bf16)
    rc = block_n == 128
             ? launch<__nv_bfloat16, 128>(x, w, s, t, y, cs, cq, p, ctr, M, K,
                                          N, relu, grid_m, st)
             : launch<__nv_bfloat16, 64>(x, w, s, t, y, cs, cq, p, ctr, M, K,
                                         N, relu, grid_m, st);
  else
    rc = block_n == 128
             ? launch<float, 128>(x, w, s, t, y, cs, cq, p, ctr, M, K, N,
                                  relu, grid_m, st)
             : launch<float, 64>(x, w, s, t, y, cs, cq, p, ctr, M, K, N, relu,
                                 grid_m, st);
  return static_cast<int>(rc);
}
