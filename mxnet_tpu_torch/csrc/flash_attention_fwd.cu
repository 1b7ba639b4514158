// Flash-attention forward for Hopper (sm_90a), the CUDA port of the Pallas
// kernel `_attention_fwd_kernel` / `_flash_fwd` in
// mxnet_tpu/ops/pallas/flash_attention.py.
//
// out = softmax(q k^T * sm_scale) v over (B, H, S, D) tensors, with an
// online softmax (running max m, running sum l, f32 accumulator) so the
// (S x S) score matrix never reaches device memory; also writes the
// per-row log-sum-exp lse = m + log(l) as (B*H, S) f32 (the TPU kernel's
// 128-lane broadcast of lse is a TPU tiling rule and is dropped).
//
// Layout. q, k, v and o are (B, H, S, D) views with unit stride on D and
// every other stride a multiple of 16 bytes, at 16-byte-aligned addresses:
// the split views of a (B, S, 3*H*D) QKV projection are read in place,
// and o is written as (B, S, H, D) memory, so no layout copy surrounds
// the kernel. The C entry takes each tensor's address and (S, H, B) byte
// strides.
//
// bf16 (the serving and training path). A work tile is one 128-row
// q-tile of one (b, h); a persistent grid of one 384-thread block per SM
// walks them with the q-tile index fastest, so the q-tiles of one head run
// together and share its K/V tiles in L2.
// - Warpgroup 0 is the producer: one thread issues TMA loads, Q into two
//   buffers (the next work tile's Q arrives during this one) and K and V
//   tiles of 128 keys through a ring of STAGES buffers, each with full and
//   empty mbarriers. TMA reads the strided views through 4-D tensor maps
//   of dimensions (D, S, H, B) whatever the order of their strides, writes
//   the tiles swizzled as wgmma reads them, and fills rows past S with
//   zeros, so the ragged tail needs no padding code. setmaxnreg gives it 24 registers and the
//   consumers 240.
// - Warpgroups 1 and 2 each own 64 query rows. S = Q K^T is one chain of
//   wgmma.mma_async m64n128k16 with both operands in shared memory
//   (K-major), accumulated in f32 registers. The online softmax runs in
//   the accumulator layout (row maxima and sums across the 4 lanes of a
//   row by shuffles). P, rounded to bf16, is repacked in registers as the
//   A operand of O += P V (wgmma with A from registers; V from shared
//   memory, N-major, so the transpose-B immediate is set). Each tile's S
//   product is issued with the previous tile's P V, and the softmax runs
//   while that P V is on the tensor cores; the two warpgroups take turns
//   issuing (named barriers), so one's softmax overlaps the other's
//   products.
// - Epilogue: O / l rounded to bf16, written swizzled into the
//   warpgroup's staging rows and stored by TMA (rows past S are not
//   written); lse is written directly.
// Tiles: W = min(D, 64) columns per swizzle panel (128-byte rows, 128B
// swizzle; D = 32 is one 64-byte panel with 64B swizzle; D = 128 two
// panels, one descriptor each).
//
// Numerics (the port of `_dot_precision`), as the plain version: bf16 x
// bf16 products summed in f32, P rounded to bf16 before P.V as the TPU
// kernel does, scores in the base-2 domain (scale * log2 e) so exp is one
// ex2 (an eighth of them, at D <= 64, a polynomial of the same accuracy on
// the FMA pipes), masked scores at -1e30 (`_NEG_INF`), l clamped at 1e-30.
// Masks are applied only on tiles that cross the diagonal or hold the
// tail. Causal is `tril` (Lq == Lk). The result does not depend on the
// strides: the same tiles are summed in the same order.
//
// f32 (off the serving path): one thread per query row, true fp32 FMA
// (never TF32), K/V tiles staged in shared memory; the same strides.
//
// Bound. At the BERT serving shape (B*H = 384, S = 512, D = 64, bf16) the
// kernel moves ~101.5 MB (q, k, v, o once each plus lse) and does 4 B H
// S^2 D = 25.8 GFLOP: ~30 us at 3.35 TB/s against ~26 us at 989 TFLOP/s,
// with ~100 M exponentials (~25 us at 16 a clock per SM) beside them.
// Measured times, and what holds the kernel above its bound
// (tools/k1_ablation.py), are in PERF.md.
//
// Plain C interface, loaded with ctypes by mxnet_tpu_torch/ops/cuda/
// flash_attention.py. The tensor maps are encoded on the host at every
// call with cuTensorMapEncodeTiled, taken from the driver through
// cudaGetDriverEntryPoint (the library links cudart only). The launch goes
// to the caller's stream, allocates nothing, and returns
// cudaGetLastError(), or minus the encode's CUresult. The PTX wrappers and
// the encoder are shared with the backward kernels in hopper.cuh.

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMinL = 1e-30f;

// ---------------------------------------------------------------------------
// bf16: persistent, warp-specialized TMA + wgmma kernel
// ---------------------------------------------------------------------------
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kBQ = 128;       // query rows per work tile
constexpr int kWQ = 64;        // query rows per consumer warpgroup

template <int D>
struct Tile {
  static constexpr int BK = 128;              // keys per K/V tile
  static constexpr int W = D < 64 ? D : 64;   // columns per swizzle panel
  static constexpr int NP = D / W;            // panels per row
  static constexpr uint32_t ROW = W * 2;      // bytes per panel row
  static constexpr uint32_t SBO = 8 * ROW;    // stride of 8-row groups
  static constexpr uint64_t SWIZZLE = W == 64 ? 1 : 2;  // 128B : 64B
  static constexpr uint32_t SWIZZLE_MASK = W == 64 ? 7 : 3;
  static constexpr int STAGES = D == 128 ? 2 : 3;
  // every EX2_FMA_EVERY-th 8-key block's exponentials run on the FMA pipes
  // (0: none); at D = 128 the products alone outweigh the exponentials
  static constexpr int EX2_FMA_EVERY = D == 128 ? 0 : 8;
  static constexpr uint32_t Q_PANEL = kWQ * ROW;
  static constexpr uint32_t Q_HALF = kWQ * D * 2;  // one warpgroup's rows
  static constexpr uint32_t KV_PANEL = BK * ROW;
  static constexpr uint32_t KV_BYTES = BK * D * 2;  // one K or V tile
  // two Q buffers (the next work tile's Q loads during this one), the O
  // staging rows (laid out as Q), the K/V ring
  static constexpr uint32_t Q_BYTES = 2 * Q_HALF;
  static constexpr uint32_t O_OFF = 2 * Q_BYTES;
  static constexpr uint32_t K_OFF = O_OFF + Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  // mbarriers: q_full[2], q_empty[2], k_full[STAGES], v_full[STAGES],
  // kv_empty[STAGES]
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // + 1024: the dynamic shared memory is realigned to 1024 bytes
  static constexpr uint32_t SMEM = BAR_OFF + 8 * (4 + 3 * STAGES) + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 2^x for x <= 0 on the FMA pipes: x = n + f with n an integer and f in
// [-1/2, 1/2], 2^f by a degree-5 polynomial (relative error 1.1e-7, as
// ex2.approx's), 2^n added to the exponent; below 2^-126 it returns
// 2^-126, not 0 (a weight of 1e-38 beside l >= 1). At D <= 64 the
// exponentials load the multi-function unit as much as the products load
// the tensor cores, so a fraction of them runs here instead.
__device__ __forceinline__ float ex2_fma(float x) {
  x = fmaxf(x, -126.f);
  const float t = x + 12582912.f;  // 1.5 * 2^23: x rounded into the mantissa
  const float f = x - (t - 12582912.f);
  float p = fmaf(1.3218672e-3f, f, 9.6716983e-3f);
  p = fmaf(p, f, 5.5508930e-2f);
  p = fmaf(p, f, 2.4022238e-1f);
  p = fmaf(p, f, 6.9314688e-1f);
  p = fmaf(p, f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

// One consumer warpgroup's online softmax over a 64 x BK score tile in the
// accumulator layout (raw q.k, masked entries set here to -1e30): updates
// the running max m (base-2 domain, scaled) and this lane's partial row sum
// l, leaves P = exp2(s * scale_log2 - m) in s, and returns the factors
// that rescale the rows' earlier sums.
template <int BK, int FMA_EVERY>
__device__ __forceinline__ float2 online_softmax(
    float (&s)[BK / 2], float& m0, float& m1, float& l0, float& l1,
    float scale_log2, bool need_mask, int k0, int t, int row0, int row1,
    int S, int causal) {
  if (need_mask) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + j * 8 + 2 * t + (i & 1);
        const int row = (i < 2) ? row0 : row1;
        if (col >= S || (causal && col > row)) s[4 * j + i] = kNegInf;
      }
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  // the 4 lanes of a row hold its columns; scale > 0, so the maximum of
  // the scaled scores is the scaled maximum
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * scale_log2);
  const float mn1 = fmaxf(m1, mx1 * scale_log2);
  const float2 alpha = make_float2(ex2(m0 - mn0), ex2(m1 - mn1));
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    // every FMA_EVERY-th 8-key block's exponentials on the FMA pipes
    const bool on_fma =
        FMA_EVERY > 0 && j % (FMA_EVERY + !FMA_EVERY) == FMA_EVERY - 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = fmaf(s[4 * j + i], scale_log2, i < 2 ? -mn0 : -mn1);
      s[4 * j + i] = on_fma ? ex2_fma(x) : ex2(x);
    }
    ps0 += s[4 * j] + s[4 * j + 1];
    ps1 += s[4 * j + 2] + s[4 * j + 3];
  }
  // the 4 lanes of a row share alpha, so the partial sums are reduced once
  // at the end
  l0 = l0 * alpha.x + ps0;
  l1 = l1 * alpha.y + ps1;
  return alpha;
}

// P in bf16 as the register A operand of P V: the accumulators of two
// adjacent 8-key blocks are one 64 x 16 A fragment.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
    pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap omap,
                          float* __restrict__ lse, int H, int S,
                          int q_tiles, int n_work, float scale_log2,
                          int causal) {
  using T = Tile<D>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);  // generic view of `base`
  const uint32_t bars = base + T::BAR_OFF;
  auto q_full = [&](int qb) { return bars + 8u * qb; };
  auto q_empty = [&](int qb) { return bars + 8u * (2 + qb); };
  auto k_full = [&](int st) { return bars + 8u * (4 + st); };
  auto v_full = [&](int st) { return bars + 8u * (4 + T::STAGES + st); };
  auto kv_empty = [&](int st) {
    return bars + 8u * (4 + 2 * T::STAGES + st);
  };
  // work tile w: q-tile w % q_tiles of head w / q_tiles. Blocks take w =
  // blockIdx.x, + gridDim.x, ...: the q-tiles of one head run together and
  // share its K/V tiles in L2.
  auto kv_tiles = [&](int qt) {
    const int end = causal ? min(S, (qt + 1) * kBQ) : S;
    return (end + BK - 1) / BK;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), 8);  // one arrival per consumer warp
    }
#pragma unroll
    for (int st = 0; st < T::STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(kv_empty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps Q and the K/V ring loaded ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int kv_it = 0;
      for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
        const int qt = w % q_tiles, bh = w / q_tiles;
        const int b = bh / H, h = bh - b * H;
        // Q buffer i % 2, once work tile i - 2's last S product has read it
        const int qb = i & 1;
        mbar_wait(q_empty(qb), ((i >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), T::Q_BYTES);
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int p = 0; p < T::NP; ++p)
            tma_load(base + qb * T::Q_BYTES + half * T::Q_HALF +
                         p * T::Q_PANEL,
                     &qmap, q_full(qb), p * T::W, qt * kBQ + half * kWQ, h,
                     b);
        }
        const int n = kv_tiles(qt);
        for (int it = 0; it < n; ++it, ++kv_it) {
          const int st = kv_it % T::STAGES;
          // the first round finds every buffer free
          mbar_wait(kv_empty(st), ((kv_it / T::STAGES) & 1) ^ 1);
          mbar_expect_tx(k_full(st), T::KV_BYTES);
#pragma unroll
          for (int p = 0; p < T::NP; ++p)
            tma_load(base + T::K_OFF + st * T::KV_BYTES + p * T::KV_PANEL,
                     &kmap, k_full(st), p * T::W, it * BK, h, b);
          mbar_expect_tx(v_full(st), T::KV_BYTES);
#pragma unroll
          for (int p = 0; p < T::NP; ++p)
            tma_load(base + T::V_OFF + st * T::KV_BYTES + p * T::KV_PANEL,
                     &vmap, v_full(st), p * T::W, it * BK, h, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const int lr0 = warp * 16 + g;  // local rows lr0 and lr0 + 8
    const uint32_t o_smem = base + T::O_OFF + c * T::Q_HALF;
    uint8_t* const o_stage = smem + T::O_OFF + c * T::Q_HALF;

    // wgmma accumulator layout (per 8-column block j): [4j], [4j+1] are
    // row lr0, columns 8j + 2t and + 1; [4j+2], [4j+3] row lr0 + 8
    float s[BK / 2];
    float o[T::NP][T::W / 2];
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

    // S = Q K^T for one 64 x BK tile: k-steps of 16 along D, within panels
    auto issue_s = [&](float(&s)[BK / 2], uint32_t q_smem, int st) {
      const uint32_t k_smem = base + T::K_OFF + st * T::KV_BYTES;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks * 16 % T::W) * 2;  // bytes into the row
        const int p = ks * 16 / T::W;
        wgmma_ss_n128(
            s,
            smem_desc(q_smem + p * T::Q_PANEL + off, 0, T::SBO, T::SWIZZLE),
            smem_desc(k_smem + p * T::KV_PANEL + off, 0, T::SBO, T::SWIZZLE),
            ks > 0);
      }
    };
    // O += P V: V (BK x D) is N-major in shared memory, 16 keys a step
    auto issue_pv = [&](float(&o)[T::NP][T::W / 2],
                        const uint32_t(&pa)[BK / 16][4], int st) {
      const uint32_t v_smem = base + T::V_OFF + st * T::KV_BYTES;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
        for (int p = 0; p < T::NP; ++p) {
          const uint64_t db =
              smem_desc(v_smem + p * T::KV_PANEL + kc * 16 * T::ROW, T::SBO,
                        T::SBO, T::SWIZZLE);
          if constexpr (T::W == 64)
            wgmma_rs_n64(o[p], pa[kc], db);
          else
            wgmma_rs_n32(o[p], pa[kc], db);
        }
      }
    };
    // O and P are written before the fence that precedes their P V product
    // and read after its wait
    auto fence_o_p = [&] {
#pragma unroll
      for (int p = 0; p < T::NP; ++p) fence_regs(o[p]);
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) fence_regs(pa[kc]);
    };
    // this warp is done with a stage's K and V, or a tile's Q
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // The two warpgroups take turns issuing their products (named barriers
    // 3 and 4), so one's softmax runs while the other's products use the
    // tensor cores. Warpgroup 1 opens warpgroup 0's first turn and skips
    // its own last hand-over, so every barrier phase completes.
    auto turn_begin = [&] {
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory");
    };
    auto turn_end = [&](bool last) {
      if (!(last && c == 1))
        asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c) : "memory");
    };
    if (c == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");

    int kv_it = 0;
    for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
      const int qt = w % q_tiles, bh = w / q_tiles;
      const int b = bh / H, h = bh - b * H;
      const int qb = i & 1;
      const uint32_t q_smem = base + qb * T::Q_BYTES + c * T::Q_HALF;
      const int r0 = qt * kBQ + c * kWQ;  // the warpgroup's first row
      const int row0 = r0 + lr0, row1 = row0 + 8;
      const int n = kv_tiles(qt);
      const bool last_work = w + gridDim.x >= n_work;
#pragma unroll
      for (int p = 0; p < T::NP; ++p)
#pragma unroll
        for (int j = 0; j < T::W / 2; ++j) o[p][j] = 0.f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
      // masks only on tiles that hold the tail or cross the diagonal
      auto need_mask = [&](int k0) {
        return (k0 + BK > S) || (causal && k0 + BK - 1 > r0);
      };

      // tile 0: S, softmax, P
      mbar_wait(q_full(qb), (i >> 1) & 1);
      int st = kv_it % T::STAGES;
      mbar_wait(k_full(st), (kv_it / T::STAGES) & 1);
      fence_regs(s);
      turn_begin();
      wgmma_fence();
      issue_s(s, q_smem, st);
      wgmma_commit();
      turn_end(false);
      wgmma_wait<0>();
      fence_regs(s);
      if (n == 1) release(q_empty(qb));
      online_softmax<BK, T::EX2_FMA_EVERY>(s, m0, m1, l0, l1, scale_log2,
                                           need_mask(0), 0, t, row0, row1, S,
                                           causal);
      pack_p<BK>(pa, s);
      // O *= alpha, the factors of the last softmax: applied while the next
      // S product runs, just before the P V that adds to O
      float2 alpha = make_float2(1.f, 1.f);
      auto rescale = [&] {
#pragma unroll
        for (int p = 0; p < T::NP; ++p)
#pragma unroll
          for (int j = 0; j < T::W / 2; ++j)
            o[p][j] *= (j & 2) ? alpha.y : alpha.x;
      };

      // tile it: its S product is issued with the previous tile's P V, and
      // its softmax runs while that P V is still on the tensor cores
      for (int it = 1; it < n; ++it) {
        const int prev = st;
        const uint32_t prev_ph = (kv_it / T::STAGES) & 1;
        ++kv_it;
        st = kv_it % T::STAGES;
        mbar_wait(k_full(st), (kv_it / T::STAGES) & 1);
        mbar_wait(v_full(prev), prev_ph);
        fence_regs(s);
        turn_begin();
        wgmma_fence();
        issue_s(s, q_smem, st);
        wgmma_commit();
        rescale();
        fence_o_p();
        wgmma_fence();
        issue_pv(o, pa, prev);
        wgmma_commit();
        turn_end(false);
        wgmma_wait<1>();  // S done, P V may still run
        fence_regs(s);
        if (it == n - 1) release(q_empty(qb));
        alpha = online_softmax<BK, T::EX2_FMA_EVERY>(
            s, m0, m1, l0, l1, scale_log2, need_mask(it * BK), it * BK, t,
            row0, row1, S, causal);
        wgmma_wait<0>();
        fence_o_p();
        release(kv_empty(prev));
        pack_p<BK>(pa, s);
      }

      // the last tile's P V
      mbar_wait(v_full(st), (kv_it / T::STAGES) & 1);
      rescale();
      fence_o_p();
      turn_begin();
      wgmma_fence();
      issue_pv(o, pa, st);
      wgmma_commit();
      turn_end(last_work);
      wgmma_wait<0>();
      fence_o_p();
      release(kv_empty(st));
      ++kv_it;

      // ---- epilogue: O / l in bf16 through shared memory to TMA ----
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float ls0 = fmaxf(l0, kMinL);
      const float ls1 = fmaxf(l1, kMinL);
      const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
      // the previous tile's store has finished reading the staging rows
      if (tid == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
#pragma unroll
      for (int p = 0; p < T::NP; ++p) {
#pragma unroll
        for (int j = 0; j < T::W / 8; ++j) {
          // swizzled as TMA reads it: 16-byte chunk ^= row bits
          const uint32_t col = (8 * j + 2 * t) * 2;
          uint32_t a0 = lr0 * T::ROW + col, a1 = (lr0 + 8) * T::ROW + col;
          a0 ^= ((a0 >> 7) & T::SWIZZLE_MASK) << 4;
          a1 ^= ((a1 >> 7) & T::SWIZZLE_MASK) << 4;
          *reinterpret_cast<uint32_t*>(o_stage + p * T::Q_PANEL + a0) =
              pack_bf16(o[p][4 * j] * inv0, o[p][4 * j + 1] * inv0);
          *reinterpret_cast<uint32_t*>(o_stage + p * T::Q_PANEL + a1) =
              pack_bf16(o[p][4 * j + 2] * inv1, o[p][4 * j + 3] * inv1);
        }
      }
      // make the generic-proxy writes visible to TMA; one thread stores
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      if (tid == 0) {
#pragma unroll
        for (int p = 0; p < T::NP; ++p)
          tma_store(&omap, o_smem + p * T::Q_PANEL, p * T::W, r0, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      if (t == 0) {
        if (row0 < S) lse[(size_t)bh * S + row0] = m0 * kLn2 + logf(ls0);
        if (row1 < S) lse[(size_t)bh * S + row1] = m1 * kLn2 + logf(ls1);
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// f32: one thread per query row, true fp32 FMA. K/V tiles in shared memory
// are read as broadcasts (every lane reads the same key row).
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 128;  // = query rows per block
constexpr int kF32BK = 32;

// Row strides and (b, h) offsets of q, k, v and o, in elements.
struct F32Strides {
  long long s[4][3];  // [tensor][S, H, B]
};

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         F32Strides st, float* __restrict__ lse, int H,
                         int S, float scale_log2, int causal) {
  __shared__ __align__(16) float Ks[kF32BK][D];
  __shared__ __align__(16) float Vs[kF32BK][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * kF32Threads;
  const int row = q0 + threadIdx.x;
  const bool live = row < S;
  q += b * st.s[0][2] + h * st.s[0][1];
  k += b * st.s[1][2] + h * st.s[1][1];
  v += b * st.s[2][2] + h * st.s[2][1];
  o += b * st.s[3][2] + h * st.s[3][1];

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) x = *reinterpret_cast<const float4*>(q + row * st.s[0][0] + d);
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
        kx = *reinterpret_cast<const float4*>(k + (k0 + r) * st.s[1][0] + col);
        vx = *reinterpret_cast<const float4*>(v + (k0 + r) * st.s[2][0] + col);
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
    *reinterpret_cast<float4*>(o + row * st.s[3][0] + d) = make_float4(
        acc[d] / ls, acc[d + 1] / ls, acc[d + 2] / ls, acc[d + 3] / ls);
  }
  lse[(size_t)bh * S + row] = m * kLn2 + logf(ls);
}

// ---------------------------------------------------------------------------
// Host side (the tensor-map encoder is in hopper.cuh)
// ---------------------------------------------------------------------------
constexpr int kMaxDevices = 64;

template <int D>
int launch_bf16(const long long* views, float* lse, int B, int H, int S,
                float scale_log2, int causal, cudaStream_t stream) {
  using T = Tile<D>;
  if (encoder().err) return encoder().err;
  // per device: its SM count, read once the kernel's shared-memory limit
  // is raised there (0 until then)
  static int sm_count[kMaxDevices];  // read and written atomically
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = __atomic_load_n(&sm_count[dev], __ATOMIC_RELAXED);
  if (sms == 0) {
    if ((err = cudaFuncSetAttribute(
             flash_fwd_bf16_kernel<D>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    __atomic_store_n(&sm_count[dev], sms, __ATOMIC_RELAXED);
  }
  const CUtensorMapSwizzle swizzle =
      T::W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const int rows[4] = {kWQ, T::BK, T::BK, kWQ};  // q, k, v, o boxes
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const CUresult r = encode_map(&maps[i], views + 4 * i, B, H, S, D, T::W,
                                  rows[i], swizzle);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  const int q_tiles = (S + kBQ - 1) / kBQ;
  const int n_work = q_tiles * B * H;  // one block per SM walks them
  flash_fwd_bf16_kernel<D><<<min(n_work, sms), kThreads, T::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, H, S, q_tiles, n_work,
      scale_log2, causal);
  return cudaGetLastError();
}

template <int D>
int launch_f32(const long long* views, float* lse, int B, int H, int S,
               float scale_log2, int causal, cudaStream_t stream) {
  F32Strides st;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j)
      st.s[i][j] = views[4 * i + 1 + j] / (long long)sizeof(float);
  const dim3 grid(B * H, (S + kF32Threads - 1) / kF32Threads);
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(
      reinterpret_cast<const float*>(views[0]),
      reinterpret_cast<const float*>(views[4]),
      reinterpret_cast<const float*>(views[8]),
      reinterpret_cast<float*>(views[12]), st, lse, H, S, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// views: for q, k, v and o in turn {address, S stride, H stride, B stride},
// strides in bytes, of (B, H, S, D) tensors with unit stride on D, bf16
// (is_bf16 = 1) or f32; every address 16-byte aligned and every stride a
// positive multiple of 16 bytes (the wrapper checks both). lse: contiguous
// (B*H, S) f32. Returns 0, a cudaError_t, or minus the CUresult of a failed
// tensor-map encode.
extern "C" int mxt_flash_attention_fwd(const long long* views, void* lse,
                                       int batch, int heads, int seq,
                                       int head_dim, int is_bf16,
                                       float sm_scale, int causal,
                                       void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bh = static_cast<long long>(batch) * heads;
  const long long blocks =
      is_bf16 ? bh * ((seq + kBQ - 1) / kBQ) : bh;
  if (blocks > INT32_MAX ||
      (!is_bf16 && (seq + kF32Threads - 1) / kF32Threads > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = sm_scale * kLog2e;
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto launch) {
    return launch(views, lse_f, batch, heads, seq, scale_log2, causal, st);
  };
  switch (head_dim) {
    case 32:
      return is_bf16 ? run(launch_bf16<32>) : run(launch_f32<32>);
    case 64:
      return is_bf16 ? run(launch_bf16<64>) : run(launch_f32<64>);
    case 128:
      return is_bf16 ? run(launch_bf16<128>) : run(launch_f32<128>);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
