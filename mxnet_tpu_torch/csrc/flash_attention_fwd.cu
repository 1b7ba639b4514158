// Flash-attention forward for Hopper (sm_90a), the CUDA port of the Pallas
// kernel `_attention_fwd_kernel` / `_flash_fwd` in
// mxnet_tpu/ops/pallas/flash_attention.py.
//
// out = softmax(q k^T * sm_scale) v over (B*H, S, D) tensors, with an online
// softmax (running max m, running sum l, f32 accumulator) so the (S x S)
// score matrix never reaches device memory; also writes the per-row
// log-sum-exp lse = m + log(l) as (B*H, S) f32 (the TPU kernel's 128-lane
// broadcast of lse is a TPU tiling rule and is dropped).
//
// Structure. One thread block per (b*h, q-tile). The TPU kernel carries
// (m, l, acc) in VMEM scratch across a sequential k grid axis; blocks on the
// card run in no order, so a loop inside the block walks the K/V tiles
// instead, with K/V staged in shared memory and (m, l, acc) in f32
// registers. Causal mode stops the loop at the diagonal tile; the ragged
// tail (S not a tile multiple) is masked here rather than padded.
//
// Numerics (the port of `_dot_precision`). bf16: bf16 x bf16 products with
// f32 accumulation on the tensor cores (mma.sync m16n8k16), P rounded to
// bf16 before P.V as the TPU kernel does. f32: scalar FMA in true fp32,
// never TF32. Masked scores take -1e30 (`_NEG_INF`) and l is clamped at
// 1e-30 before the division, as in the Pallas kernel. Scores are kept in
// the base-2 domain (scale * log2(e)) so exp is one ex2 instruction.
//
// Bound. At the BERT serving shape (B*H=384, S=512, D=64, bf16) the kernel
// moves ~101.5 MB (q, k, v, o once each plus lse) and does 4*B*H*S^2*D =
// 25.8 GFLOP: ~30 us at 3.35 TB/s against ~26 us at 989 TFLOP/s, so it is
// bound by bytes. This first version does not reach that bound: each
// q-tile re-reads K/V through L2, and tile loads are not overlapped with
// the products (no cp.async/TMA pipeline, no wgmma). Measured times are in
// PERF.md.
//
// Plain C interface, loaded with ctypes by mxnet_tpu_torch/ops/cuda/
// flash_attention.py. The launch goes to the caller's stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMinL = 1e-30f;

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel. 4 warps; each warp owns 16 query rows of a
// 64-row q-tile and walks 64-key K/V tiles.
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;
constexpr int kMmaBQ = 64;
constexpr int kMmaBK = 64;

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

// Copy rows [r0, r0 + 64) of a (S, D) bf16 matrix into shared memory with
// row stride LD, zero-filling rows at or past S (so masked P.V terms are
// 0 * 0, never 0 * garbage).
template <int D, int LD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int r0, int S) {
  constexpr int kChunksPerRow = D / 8;  // 16-byte chunks
  for (int c = threadIdx.x; c < kMmaBK * kChunksPerRow; c += kMmaThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int S, float scale_log2, int causal) {
  // +8 elements of row padding: the 32-bit fragment loads of 8 rows x 4
  // lanes and the ldmatrix row reads then hit 32 distinct banks
  constexpr int LD = D + 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[kMmaBK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kMmaBK * LD];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kMmaBQ;
  const size_t base = (size_t)bh * S * D;

  // Q tile through the K buffer into A fragments held for the whole sweep
  load_tile_bf16<D, LD>(Ks, q + base, q0, S);
  __syncthreads();
  const int rl = warp * 16 + g;  // local rows rl and rl + 8
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const __nv_bfloat16* p = Ks + rl * LD + ks * 16 + 2 * t;
    qa[ks][0] = lds32(p);
    qa[ks][1] = lds32(p + 8 * LD);
    qa[ks][2] = lds32(p + 8);
    qa[ks][3] = lds32(p + 8 * LD + 8);
  }

  const int row0 = q0 + rl;
  const int row1 = row0 + 8;
  float oacc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    oacc[dt][0] = oacc[dt][1] = oacc[dt][2] = oacc[dt][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int kend = causal ? min(S, q0 + kMmaBQ) : S;
  for (int k0 = 0; k0 < kend; k0 += kMmaBK) {
    __syncthreads();  // previous tile (or the Q stage) fully read
    load_tile_bf16<D, LD>(Ks, k + base, k0, S);
    load_tile_bf16<D, LD>(Vs, v + base, k0, S);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kMmaBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kMmaBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const __nv_bfloat16* p = Ks + (nt * 8 + g) * LD + ks * 16 + 2 * t;
        mma_bf16(s[nt], qa[ks], lds32(p), lds32(p + 8));
      }
    }

    // scale, mask (only tiles that hold the tail or cross the diagonal),
    // and the row maxima across the 4 lanes that share a row
    const bool need_mask =
        (k0 + kMmaBK > S) || (causal && k0 + kMmaBK - 1 > q0);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kMmaBK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * scale_log2;
        if (need_mask) {
          const int col = k0 + nt * 8 + 2 * t + (i & 1);
          const int row = (i < 2) ? row0 : row1;
          if (col >= S || (causal && col > row)) x = kNegInf;
        }
        s[nt][i] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0);
    const float alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kMmaBK / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    // l is this lane's partial row sum; the 4 lanes of a row share alpha,
    // so the partials are summed once at the end
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      oacc[dt][0] *= alpha0;
      oacc[dt][1] *= alpha0;
      oacc[dt][2] *= alpha1;
      oacc[dt][3] *= alpha1;
    }

    // O += P V: the score accumulators of two adjacent 8-key tiles are
    // exactly one 16x16 A fragment once rounded to bf16
#pragma unroll
    for (int kc = 0; kc < kMmaBK / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const int vrow = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vs + vrow * LD + (dt + (lane >> 4)) * 8);
        mma_bf16(oacc[dt], pa, b[0], b[1]);
        mma_bf16(oacc[dt + 1], pa, b[2], b[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ls0 = fmaxf(l0, kMinL);
  const float ls1 = fmaxf(l1, kMinL);
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row0 * D + col) =
          __floats2bfloat162_rn(oacc[dt][0] / ls0, oacc[dt][1] / ls0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row1 * D + col) =
          __floats2bfloat162_rn(oacc[dt][2] / ls1, oacc[dt][3] / ls1);
  }
  if (t == 0) {
    if (row0 < S) lse[(size_t)bh * S + row0] = m0 * kLn2 + logf(ls0);
    if (row1 < S) lse[(size_t)bh * S + row1] = m1 * kLn2 + logf(ls1);
  }
}

// ---------------------------------------------------------------------------
// f32: one thread per query row, true fp32 FMA. K/V tiles in shared memory
// are read as broadcasts (every lane reads the same key row).
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 128;  // = query rows per block
constexpr int kF32BK = 32;

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int S, float scale_log2,
                     int causal) {
  __shared__ __align__(16) float Ks[kF32BK][D];
  __shared__ __align__(16) float Vs[kF32BK][D];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kF32Threads;
  const int row = q0 + threadIdx.x;
  const bool live = row < S;
  const size_t base = (size_t)bh * S * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live)
      x = *reinterpret_cast<const float4*>(q + base + (size_t)row * D + d);
    qr[d] = x.x;
    qr[d + 1] = x.y;
    qr[d + 2] = x.z;
    qr[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int kend = causal ? min(S, q0 + kF32Threads) : S;
  for (int k0 = 0; k0 < kend; k0 += kF32BK) {
    __syncthreads();
    for (int c = threadIdx.x; c < kF32BK * D / 4; c += kF32Threads) {
      const int r = c / (D / 4);
      const int col = (c % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < S) {
        const size_t off = base + (size_t)(k0 + r) * D + col;
        kx = *reinterpret_cast<const float4*>(k + off);
        vx = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(&Ks[r][col]) = kx;
      *reinterpret_cast<float4*>(&Vs[r][col]) = vx;
    }
    __syncthreads();
    if (!live) continue;

    float s[kF32BK];
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < kF32BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      float x = dot * scale_log2;
      const int col = k0 + j;
      if (col >= S || (causal && col > row)) x = kNegInf;
      s[j] = x;
      mt = fmaxf(mt, x);
    }
    const float mn = fmaxf(m, mt);
    const float alpha = exp2f(m - mn);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32BK; ++j) {
      const float p = exp2f(s[j] - mn);
      l += p;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
  }
  if (!live) return;
  const float ls = fmaxf(l, kMinL);
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    *reinterpret_cast<float4*>(o + base + (size_t)row * D + d) = make_float4(
        acc[d] / ls, acc[d + 1] / ls, acc[d + 2] / ls, acc[d + 3] / ls);
  }
  lse[(size_t)bh * S + row] = m * kLn2 + logf(ls);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int S, int is_bf16, float scale_log2,
                   int causal, cudaStream_t stream) {
  if (is_bf16) {
    const dim3 grid(bh, (S + kMmaBQ - 1) / kMmaBQ);
    flash_fwd_bf16_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), lse, S, scale_log2, causal);
  } else {
    const dim3 grid(bh, (S + kF32Threads - 1) / kF32Threads);
    flash_fwd_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, S,
        scale_log2, causal);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous (bh, seq, head_dim) in bf16 (is_bf16=1) or f32;
// lse: contiguous (bh, seq) f32. Returns a cudaError_t (0 on success).
extern "C" int mxt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int bh, int seq, int head_dim,
                                       int is_bf16, float sm_scale,
                                       int causal, void* stream) {
  if (bh <= 0 || seq <= 0 || seq > 65535 * kMmaBQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = sm_scale * kLog2e;
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, o, lse_f, bh, seq, is_bf16, scale_log2,
                        causal, st);
    case 64:
      return launch<64>(q, k, v, o, lse_f, bh, seq, is_bf16, scale_log2,
                        causal, st);
    case 128:
      return launch<128>(q, k, v, o, lse_f, bh, seq, is_bf16, scale_log2,
                         causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
