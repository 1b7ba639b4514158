// Flash-attention backward for Hopper (sm_90a): the CUDA port of the Pallas
// kernels `_bwd_dq_kernel` (K2) and `_bwd_dkv_kernel` (K3), launched by
// `_pallas_bwd` in mxnet_tpu/ops/pallas/flash_attention.py.
//
// For (B*H, S, D) tensors q, k, v, the output gradient dO, the forward's
// per-row log-sum-exp lse and delta = rowsum(dO * O) (both (B*H, S) f32):
//   P  = exp(q k^T * scale - lse)          (recomputed, never stored)
//   dP = dO v^T
//   dS = P * (dP - delta) * scale
//   K2: dq = dS k                          one block per (b*h, q-tile)
//   K3: dv = P^T dO, dk = dS^T q           one block per (b*h, k-tile)
// The TPU kernels carry their f32 accumulators in VMEM scratch across a
// sequential grid axis (k for dq, q for dk/dv). Blocks on the card run in no
// order, so each block loops over the other axis itself and keeps its
// accumulators in f32 registers; each output is written once. As in the
// reference, dq and dk/dv are two kernels, so no atomics are needed and the
// result is deterministic. Causal loops stop at (K2) or start from (K3) the
// diagonal tile; the ragged tail (S not a tile multiple) is masked here, with
// masked scores at -1e30 as `_masked_scores`, and tiles are zero-filled past
// S so masked terms are 0 * 0.
//
// Numerics (the port of `_dot_precision`). bf16: bf16 x bf16 products with
// f32 accumulation on the tensor cores (mma.sync m16n8k16); P is rounded to
// bf16 before P^T dO and dS before dS k and dS^T q, exactly where the Pallas
// kernels round (`.astype` at flash_attention.py:301-302 and :347, :355).
// f32: scalar FMA in true fp32, never TF32. Scores are taken in the base-2
// domain (scale * log2(e), lse * log2(e)) so exp is one ex2 instruction.
//
// Bound. At the BERT-base training shape (B*H = 768, S = 128, D = 64, bf16)
// K2 moves ~64 MB (q, k, v, dO read once, lse and delta, dq written once):
// ~19 us at 3.35 TB/s, against 6*B*H*S^2*D = 4.8 GFLOP (~5 us at 989 TFLOP/s).
// K3 moves ~76 MB (dk and dv written): ~23 us, against 6.4 GFLOP. Both are
// bound by bytes. This first version keeps the S x S scores out of device
// memory and reads each input once per block (the other tiles through L2);
// it does not overlap tile loads with the products (no cp.async/TMA
// pipeline) and uses mma.sync rather than wgmma. Measured times: PERF.md.
//
// Plain C interface, loaded with ctypes by mxnet_tpu_torch/ops/cuda/
// flash_attention.py. Launches go to the caller's stream, allocate nothing,
// and return cudaGetLastError(). The mma/ldmatrix helpers repeat those of
// flash_attention_fwd.cu: each library is one translation unit, built and
// cached by its own source hash.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kThreads = 128;  // 4 warps per block, every kernel
constexpr int kMmaRows = 64;   // bf16: rows a block owns, 16 per warp

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

// Four transposed 8x8 b16 matrices; lanes 8i..8i+7 address matrix i's rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Copy rows [r0, r0 + ROWS) of a (S, D) bf16 matrix into shared memory with
// row stride LD (D + 8: the 32-bit fragment loads of 8 rows x 4 lanes and
// the ldmatrix row reads then hit 32 distinct banks), zero-filling rows at
// or past S.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int r0, int S) {
  constexpr int kChunksPerRow = D / 8;  // 16-byte chunks
  for (int c = threadIdx.x; c < ROWS * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

// A fragment (16 rows x 16 k) of a row-major smem tile at local row `rl`.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4],
                                            const __nv_bfloat16* p, int LD) {
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * LD);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * LD + 8);
}

// The C accumulators of two adjacent 8-column tiles are exactly one 16x16 A
// fragment once rounded to bf16 (the rounding the Pallas kernels do).
__device__ __forceinline__ void c_pair_to_a(uint32_t (&a)[4],
                                            const float (&lo)[4],
                                            const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// acc[D/8] += a (16 x 16 over rows `r0..r0+15` of the smem tile) @ tile, with
// B fragments of the row-major (k, D) tile from ldmatrix.trans.
template <int D>
__device__ __forceinline__ void mma_a_times_rows(float (&acc)[D / 8][4],
                                                 const uint32_t (&a)[4],
                                                 const __nv_bfloat16* tile,
                                                 int LD, int r0, int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; dt += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, tile + row * LD + (dt + (lane >> 4)) * 8);
    mma_bf16(acc[dt], a, b[0], b[1]);
    mma_bf16(acc[dt + 1], a, b[2], b[3]);
  }
}

template <int D>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst,
                                                const float (&acc)[D / 8][4],
                                                int row0, int S, int t) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row0 * D + col) =
          __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row1 * D + col) =
          __floats2bfloat162_rn(acc[dt][2], acc[dt][3]);
  }
}

// ---------------------------------------------------------------------------
// K2, bf16: each warp owns 16 query rows of a 64-row q-tile, holds their Q
// and dO A fragments in registers and walks KT-key K/V tiles.
// ---------------------------------------------------------------------------
template <int D>
struct DqTiles {
  static constexpr int LD = D + 8;
  static constexpr int KT = D <= 64 ? 64 : 32;  // keys per step (registers)
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int S, float scale,
                         int causal) {
  constexpr int LD = DqTiles<D>::LD;
  constexpr int KT = DqTiles<D>::KT;
  // 64 rows each: they stage Q and dO first, then hold the K/V tiles
  __shared__ __align__(16) __nv_bfloat16 Ks[kMmaRows * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kMmaRows * LD];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kMmaRows;
  const size_t base = (size_t)bh * S * D;
  const float scale_log2 = scale * kLog2e;

  load_rows_bf16<D, LD, kMmaRows>(Ks, q + base, q0, S);
  load_rows_bf16<D, LD, kMmaRows>(Vs, dout + base, q0, S);
  __syncthreads();
  const int rl = warp * 16 + g;
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    load_a_frag(qa[ks], Ks + rl * LD + ks * 16 + 2 * t, LD);
    load_a_frag(da[ks], Vs + rl * LD + ks * 16 + 2 * t, LD);
  }

  const int row0 = q0 + rl;
  const int row1 = row0 + 8;
  // rows past S see zero Q and dO: P = 1, dP = delta = 0, so dS = 0
  const float lse0 = row0 < S ? lse[(size_t)bh * S + row0] * kLog2e : 0.f;
  const float lse1 = row1 < S ? lse[(size_t)bh * S + row1] * kLog2e : 0.f;
  const float dl0 = row0 < S ? delta[(size_t)bh * S + row0] : 0.f;
  const float dl1 = row1 < S ? delta[(size_t)bh * S + row1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int kend = causal ? min(S, q0 + kMmaRows) : S;
  for (int k0 = 0; k0 < kend; k0 += KT) {
    __syncthreads();  // previous tile (or the Q/dO stage) fully read
    load_rows_bf16<D, LD, KT>(Ks, k + base, k0, S);
    load_rows_bf16<D, LD, KT>(Vs, v + base, k0, S);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x KT keys
    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int off = (nt * 8 + g) * LD + ks * 16 + 2 * t;
        mma_bf16(s[nt], qa[ks], lds32(Ks + off), lds32(Ks + off + 8));
        mma_bf16(dp[nt], da[ks], lds32(Vs + off), lds32(Vs + off + 8));
      }
    }

    // dS = P (dP - delta) scale, P = exp(S scale - lse) with the masks
    const bool need_mask = (k0 + KT > S) || (causal && k0 + KT - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * scale_log2;
        if (need_mask) {
          const int col = k0 + nt * 8 + 2 * t + (i & 1);
          const int row = (i < 2) ? row0 : row1;
          if (col >= S || (causal && col > row)) x = kNegInf;
        }
        const float p = exp2f(x - (i < 2 ? lse0 : lse1));
        s[nt][i] = p * (dp[nt][i] - (i < 2 ? dl0 : dl1)) * scale;
      }
    }

    // dq += dS K (dS rounded to bf16)
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc) {
      uint32_t sa[4];
      c_pair_to_a(sa, s[2 * kc], s[2 * kc + 1]);
      mma_a_times_rows<D>(acc, sa, Ks, LD, kc * 16, lane);
    }
  }
  store_rows_bf16<D>(dq + base, acc, row0, S, t);
}

// ---------------------------------------------------------------------------
// K3, bf16: each warp owns 16 keys of a 64-key tile (K and V stay in shared
// memory) and walks QT-row Q/dO tiles; the scores are computed transposed
// (S^T = K Q^T, dP^T = V dO^T) so that P^T and dS^T come out as A fragments.
// ---------------------------------------------------------------------------
template <int D>
struct DkvTiles {
  static constexpr int LD = D + 8;
  // rows per step: keeps registers (dk, dv: D/2 f32 each per thread) and
  // static shared memory (< 48 KB) in bounds at D = 128
  static constexpr int QT = D <= 64 ? 64 : 16;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int S, float scale,
                          int causal) {
  constexpr int LD = DkvTiles<D>::LD;
  constexpr int QT = DkvTiles<D>::QT;
  __shared__ __align__(16) __nv_bfloat16 Ks[kMmaRows * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kMmaRows * LD];
  __shared__ __align__(16) __nv_bfloat16 Qs[QT * LD];
  __shared__ __align__(16) __nv_bfloat16 Ds[QT * LD];
  __shared__ float Ls[QT];
  __shared__ float Dl[QT];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kMmaRows;
  const size_t base = (size_t)bh * S * D;
  const float scale_log2 = scale * kLog2e;

  load_rows_bf16<D, LD, kMmaRows>(Ks, k + base, k0, S);
  load_rows_bf16<D, LD, kMmaRows>(Vs, v + base, k0, S);

  const int rl = warp * 16 + g;
  const int key0 = k0 + rl;
  const int key1 = key0 + 8;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }

  // causal: queries before k0 see none of this block's keys
  const int qstart = causal ? (k0 / QT) * QT : 0;
  for (int q0 = qstart; q0 < S; q0 += QT) {
    __syncthreads();  // previous Q/dO tile fully read
    load_rows_bf16<D, LD, QT>(Qs, q + base, q0, S);
    load_rows_bf16<D, LD, QT>(Ds, dout + base, q0, S);
    for (int i = threadIdx.x; i < QT; i += kThreads) {
      const int r = q0 + i;
      Ls[i] = r < S ? lse[(size_t)bh * S + r] * kLog2e : 0.f;
      Dl[i] = r < S ? delta[(size_t)bh * S + r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x QT queries
    float st[QT / 8][4], dpt[QT / 8][4];
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t ka[4], va[4];
      load_a_frag(ka, Ks + rl * LD + ks * 16 + 2 * t, LD);
      load_a_frag(va, Vs + rl * LD + ks * 16 + 2 * t, LD);
#pragma unroll
      for (int nt = 0; nt < QT / 8; ++nt) {
        const int off = (nt * 8 + g) * LD + ks * 16 + 2 * t;
        mma_bf16(st[nt], ka, lds32(Qs + off), lds32(Qs + off + 8));
        mma_bf16(dpt[nt], va, lds32(Ds + off), lds32(Ds + off + 8));
      }
    }

    // P^T and dS^T; a query row sees a key iff both are < S and, causal,
    // key <= query
    const bool need_mask = (q0 + QT > S) || (k0 + kMmaRows > S) ||
                           (causal && q0 < k0 + kMmaRows - 1);
#pragma unroll
    for (int nt = 0; nt < QT / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ql = nt * 8 + 2 * t + (i & 1);
        float x = st[nt][i] * scale_log2;
        if (need_mask) {
          const int qg = q0 + ql;
          const int key = (i < 2) ? key0 : key1;
          if (qg >= S || key >= S || (causal && key > qg)) x = kNegInf;
        }
        const float p = exp2f(x - Ls[ql]);
        st[nt][i] = p;
        dpt[nt][i] = p * (dpt[nt][i] - Dl[ql]) * scale;
      }
    }

    // dv += P^T dO and dk += dS^T Q (P and dS rounded to bf16)
#pragma unroll
    for (int kc = 0; kc < QT / 16; ++kc) {
      uint32_t pa[4], sa[4];
      c_pair_to_a(pa, st[2 * kc], st[2 * kc + 1]);
      c_pair_to_a(sa, dpt[2 * kc], dpt[2 * kc + 1]);
      mma_a_times_rows<D>(dva, pa, Ds, LD, kc * 16, lane);
      mma_a_times_rows<D>(dka, sa, Qs, LD, kc * 16, lane);
    }
  }
  store_rows_bf16<D>(dk + base, dka, key0, S, t);
  store_rows_bf16<D>(dv + base, dva, key0, S, t);
}

// ---------------------------------------------------------------------------
// f32: four threads per row, true fp32 FMA. A thread owns the row's float4
// chunks part, part+4, part+8, ... (interleaved, so the four threads of a row
// read 64 contiguous bytes of a shared-memory row: no bank conflicts); each
// dot product is four partial sums joined by two shuffles.
// ---------------------------------------------------------------------------
constexpr int kSplit = 4;
constexpr int kF32Rows = kThreads / kSplit;  // rows a block owns
constexpr int kF32Tile = 32;                 // rows of the other side per step

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& y, float a, float4 x) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Copy rows [r0, r0 + kF32Tile) of a (S, D) f32 matrix into shared memory,
// zero-filling rows at or past S.
template <int D>
__device__ __forceinline__ void load_rows_f32(float (*dst)[D],
                                              const float* src, int r0,
                                              int S) {
  for (int c = threadIdx.x; c < kF32Tile * D / 4; c += kThreads) {
    const int r = c / (D / 4);
    const int col = (c % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + col);
    *reinterpret_cast<float4*>(&dst[r][col]) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int S, float scale,
                        int causal) {
  constexpr int C = D / 4 / kSplit;  // float4 chunks per thread
  __shared__ __align__(16) float Ks[kF32Tile][D];
  __shared__ __align__(16) float Vs[kF32Tile][D];

  const int part = threadIdx.x % kSplit;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kF32Rows;
  const int row = q0 + threadIdx.x / kSplit;
  const bool live = row < S;
  const size_t base = (size_t)bh * S * D;
  const float scale_log2 = scale * kLog2e;

  // dead rows (past S) keep zero Q and dO and compute dS = 0; every thread
  // runs the loop because the dot products shuffle across the row's lanes
  float4 qr[C], dr[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (part + kSplit * c) * 4;
    qr[c] = dr[c] = acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      qr[c] = *reinterpret_cast<const float4*>(q + base + (size_t)row * D + col);
      dr[c] =
          *reinterpret_cast<const float4*>(dout + base + (size_t)row * D + col);
    }
  }
  const float lse_r = live ? lse[(size_t)bh * S + row] * kLog2e : 0.f;
  const float dl = live ? delta[(size_t)bh * S + row] : 0.f;

  const int kend = causal ? min(S, q0 + kF32Rows) : S;
  for (int k0 = 0; k0 < kend; k0 += kF32Tile) {
    __syncthreads();
    load_rows_f32<D>(Ks, k + base, k0, S);
    load_rows_f32<D>(Vs, v + base, k0, S);
    __syncthreads();
    for (int j = 0; j < kF32Tile; ++j) {
      float sdot = 0.f, pdot = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = (part + kSplit * c) * 4;
        sdot = dot4(qr[c], *reinterpret_cast<const float4*>(&Ks[j][col]), sdot);
        pdot = dot4(dr[c], *reinterpret_cast<const float4*>(&Vs[j][col]), pdot);
      }
      sdot = row_sum(sdot);
      pdot = row_sum(pdot);
      float x = sdot * scale_log2;
      const int col = k0 + j;
      if (col >= S || (causal && col > row)) x = kNegInf;
      const float ds = exp2f(x - lse_r) * (pdot - dl) * scale;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int cc = (part + kSplit * c) * 4;
        axpy4(acc[c], ds, *reinterpret_cast<const float4*>(&Ks[j][cc]));
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (part + kSplit * c) * 4;
    *reinterpret_cast<float4*>(dq + base + (size_t)row * D + col) = acc[c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int S,
                         float scale, int causal) {
  constexpr int C = D / 4 / kSplit;
  __shared__ __align__(16) float Qs[kF32Tile][D];
  __shared__ __align__(16) float Ds[kF32Tile][D];
  __shared__ float Ls[kF32Tile];
  __shared__ float Dl[kF32Tile];

  const int part = threadIdx.x % kSplit;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kF32Rows;
  const int key = k0 + threadIdx.x / kSplit;
  const bool live = key < S;
  const size_t base = (size_t)bh * S * D;
  const float scale_log2 = scale * kLog2e;

  float4 kr[C], vr[C], dka[C], dva[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (part + kSplit * c) * 4;
    kr[c] = vr[c] = dka[c] = dva[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      kr[c] = *reinterpret_cast<const float4*>(k + base + (size_t)key * D + col);
      vr[c] = *reinterpret_cast<const float4*>(v + base + (size_t)key * D + col);
    }
  }

  const int qstart = causal ? (k0 / kF32Tile) * kF32Tile : 0;
  for (int q0 = qstart; q0 < S; q0 += kF32Tile) {
    __syncthreads();
    load_rows_f32<D>(Qs, q + base, q0, S);
    load_rows_f32<D>(Ds, dout + base, q0, S);
    for (int i = threadIdx.x; i < kF32Tile; i += kThreads) {
      const int r = q0 + i;
      Ls[i] = r < S ? lse[(size_t)bh * S + r] * kLog2e : 0.f;
      Dl[i] = r < S ? delta[(size_t)bh * S + r] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kF32Tile; ++i) {
      float sdot = 0.f, pdot = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = (part + kSplit * c) * 4;
        sdot = dot4(kr[c], *reinterpret_cast<const float4*>(&Qs[i][col]), sdot);
        pdot = dot4(vr[c], *reinterpret_cast<const float4*>(&Ds[i][col]), pdot);
      }
      sdot = row_sum(sdot);
      pdot = row_sum(pdot);
      float x = sdot * scale_log2;
      const int qg = q0 + i;
      if (qg >= S || !live || (causal && key > qg)) x = kNegInf;
      const float p = exp2f(x - Ls[i]);
      const float ds = p * (pdot - Dl[i]) * scale;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = (part + kSplit * c) * 4;
        axpy4(dva[c], p, *reinterpret_cast<const float4*>(&Ds[i][col]));
        axpy4(dka[c], ds, *reinterpret_cast<const float4*>(&Qs[i][col]));
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (part + kSplit * c) * 4;
    *reinterpret_cast<float4*>(dk + base + (size_t)key * D + col) = dka[c];
    *reinterpret_cast<float4*>(dv + base + (size_t)key * D + col) = dva[c];
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;  // dq (K2); dk, dv (K3)
  int bh, S, is_bf16;
  float scale;
  int causal;
  cudaStream_t stream;
};

inline int blocks_along_s(int S, int rows) { return (S + rows - 1) / rows; }

template <int D>
cudaError_t launch_dq(const Args& a) {
  using bf = __nv_bfloat16;
  if (a.is_bf16) {
    const dim3 grid(a.bh, blocks_along_s(a.S, kMmaRows));
    flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
        static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
        a.delta, static_cast<bf*>(a.out0), a.S, a.scale, a.causal);
  } else {
    const dim3 grid(a.bh, blocks_along_s(a.S, kF32Rows));
    flash_bwd_dq_f32_kernel<D><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.out0), a.S, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a) {
  using bf = __nv_bfloat16;
  if (a.is_bf16) {
    const dim3 grid(a.bh, blocks_along_s(a.S, kMmaRows));
    flash_bwd_dkv_bf16_kernel<D><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
        static_cast<const bf*>(a.v), static_cast<const bf*>(a.dout), a.lse,
        a.delta, static_cast<bf*>(a.out0), static_cast<bf*>(a.out1), a.S,
        a.scale, a.causal);
  } else {
    const dim3 grid(a.bh, blocks_along_s(a.S, kF32Rows));
    flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), a.S, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <bool kDkv>
int dispatch(const Args& a, int head_dim) {
  // the smallest rows-per-block (f32) bounds gridDim.y
  if (a.bh <= 0 || a.S <= 0 || a.S > 65535 * kF32Rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc;
  switch (head_dim) {
    case 32: rc = kDkv ? launch_dkv<32>(a) : launch_dq<32>(a); break;
    case 64: rc = kDkv ? launch_dkv<64>(a) : launch_dq<64>(a); break;
    case 128: rc = kDkv ? launch_dkv<128>(a) : launch_dq<128>(a); break;
    default: rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}

}  // namespace

// q, k, v, dout, dq: contiguous (bh, seq, head_dim) in bf16 (is_bf16=1) or
// f32; lse, delta: contiguous (bh, seq) f32. Returns a cudaError_t (0 on
// success).
extern "C" int mxt_flash_attention_bwd_dq(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dq, int bh, int seq,
                                          int head_dim, int is_bf16,
                                          float sm_scale, int causal,
                                          void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, bh, seq,
               is_bf16, sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, head_dim);
}

// As above; writes dk and dv (each like k).
extern "C" int mxt_flash_attention_bwd_dkv(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dk, void* dv, int bh, int seq,
                                           int head_dim, int is_bf16,
                                           float sm_scale, int causal,
                                           void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, bh, seq, is_bf16,
               sm_scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, head_dim);
}
