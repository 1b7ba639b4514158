// Flash-attention backward for Hopper (sm_90a): the CUDA port of the Pallas
// kernels `_bwd_dq_kernel` (K2) and `_bwd_dkv_kernel` (K3), launched by
// `_pallas_bwd` in mxnet_tpu/ops/pallas/flash_attention.py.
//
// For (B, H, S, D) tensors q, k, v, the forward's output O and per-row
// log-sum-exp lse ((B, H, S) f32), and the output gradient dO:
//   P     = exp(q k^T * scale - lse)       (recomputed, never stored)
//   dP    = dO v^T
//   delta = rowsum(dO * O)                 (K2 computes it, K3 reads it)
//   dS    = P * (dP - delta) * scale
//   K2: dq = dS k, and delta               one work unit per (b*h, q-tile)
//   K3: dv = P^T dO, dk = dS^T q           one work unit per (b*h, k-tile)
// The TPU kernels carry their f32 accumulators in VMEM scratch across a
// sequential grid axis (k for dq, q for dk/dv). Here each work unit loops
// over the other axis itself and keeps its accumulators in f32 registers;
// each output is written once. As in the reference, dq and dk/dv are two
// kernels, so no atomics are needed and the result is deterministic; K3
// runs after K2 on the caller's stream and reads the delta K2 wrote.
// Causal loops stop at (K2) or start from (K3) the diagonal tile; masked
// scores are -1e30 as `_masked_scores`.
//
// Layout. q, k, v, O, dO and the outputs dq, dk, dv are (B, H, S, D)
// views with unit stride on D and every other stride a multiple of 16
// bytes, at 16-byte-aligned addresses: the split views of a QKV
// projection, K1's (B, S, H, D) output and the transpose of the output
// gradient are read in place, and dq, dk and dv are written as (B, S, H, D)
// memory, so no layout copy surrounds the kernels. The C entries take each
// tensor's address and (S, H, B) byte strides.
//
// bf16 and fp16 (the training paths; one template on the element type E,
// the same tiles and products in either). A persistent grid of one
// 384-thread block per SM walks the work units, tile index fastest (the
// tiles of one head run together and share its other-side tiles in L2).
// - Warpgroup 0 is the producer: one thread issues TMA loads through 4-D
//   tensor maps of dimensions (D, S, H, B) (hopper.cuh), which fill rows
//   past S with zeros. A unit's own tiles (K2: Q, dO and O; K3: K and V)
//   go into one of SETS buffer sets, so the next unit's arrive while this
//   one computes (at S = 128 each unit has one tile of the other side, and
//   the overlap comes from there); the other side's tiles (K2: K and V;
//   K3: Q and dO) stream through a ring of STAGES buffers. Full and empty
//   mbarriers order both.
// - Warpgroups 1 and 2 each own 64 of the unit's 128 rows. The two score
//   products run as wgmma from shared memory (K-major), accumulated in f32
//   registers: K2 S = Q K^T and dP = dO V^T; K3 S^T = K Q^T and
//   dP^T = V dO^T, so that P^T and dS^T come out in the accumulator layout
//   of the rows this warpgroup owns. P and dS, rounded to E, are
//   repacked in registers as the A operand of the accumulating products
//   (wgmma with A from registers, B read N-major from the streamed tile):
//   K2 dq += dS K; K3 dv += P^T dO and dk += dS^T Q. In K2 a tile's dq
//   product is issued together with the next tile's score products, and
//   the two warpgroups take turns issuing (named barriers), so that one's
//   elementwise work (P, dS) runs while the other's products are on the
//   tensor cores. K3 runs each tile's products in turn: with 64-query
//   tiles, which its registers would need for the same scheme, it was
//   slower (commit a700608; times in PERF.md).
// - K2 computes delta for its rows from the O and dO tiles in shared
//   memory while the first score products run, and writes it to a (B, H,
//   S) f32 buffer; K3 stages each Q tile's lse and delta in shared memory.
// - Epilogue: the accumulators rounded to E, written swizzled into the
//   warpgroup's rows of a buffer the unit has finished with (K2: O; K3: K
//   and V) and stored by TMA (rows past S are not written).
// Tiles: W = min(D, 64) columns per swizzle panel (as K1). The streamed
// tiles hold 128 rows (64 at D = 128, for the registers).
//
// Numerics (the port of `_dot_precision`). bf16 and fp16: E x E products
// with f32 accumulation on the tensor cores; P is rounded to E before P^T dO
// and dS before dS k and dS^T q, exactly where the Pallas kernels round
// (`.astype` at flash_attention.py:301-302 and :347, :355); delta is an f32
// sum of the E products. Scores are taken in the base-2 domain
// (scale * log2(e), lse * log2(e)) so exp is one ex2 instruction. f32:
// scalar FMA in true fp32, never TF32, on the same strides.
//
// Bound. At the BERT-base training shape (B*H = 768, S = 128, D = 64, bf16)
// K2 reads q, k, v, O, dO and lse and writes dq and delta: ~76 MB, ~22.8 us
// at 3.35 TB/s, against 6*B*H*S^2*D = 4.8 GFLOP (~5 us at 989 TFLOP/s).
// K3 reads q, k, v, dO, lse and delta and writes dk and dv: ~76 MB, ~22.8
// us, against 6.4 GFLOP. Both are bound by bytes: the design keeps every
// load in flight behind the products of the unit before. Measured times:
// PERF.md.
//
// Plain C interface, loaded with ctypes by mxnet_tpu_torch/ops/cuda/
// flash_attention.py. The tensor maps are encoded on the host at every
// call (hopper.cuh). Launches go to the caller's stream, allocate nothing,
// and return cudaGetLastError(), or minus the encode's CUresult.

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// bf16 and fp16: persistent, warp-specialized TMA + wgmma kernels
// ---------------------------------------------------------------------------
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kRows = 128;     // a unit's rows: queries (K2), keys (K3)
constexpr int kWRows = 64;     // rows per consumer warpgroup

// Swizzled tile geometry shared by both kernels. A unit's own tiles are
// "split": [warpgroup half][panel][64 rows][W], loaded in boxes of W x 64
// rows, each half the A operand (or the staging rows) of one warpgroup. A
// streamed tile of N rows is [panel][N rows][W], loaded in boxes of W x N.
template <int D>
struct Geo {
  static constexpr int W = D < 64 ? D : 64;   // columns per swizzle panel
  static constexpr int NP = D / W;            // panels per row
  static constexpr uint32_t ROW = W * 2;      // bytes per panel row
  static constexpr uint32_t SBO = 8 * ROW;    // stride of 8-row groups
  static constexpr uint64_t SWIZZLE = W == 64 ? 1 : 2;  // 128B : 64B
  static constexpr uint32_t SWIZZLE_MASK = W == 64 ? 7 : 3;
  static constexpr uint32_t HALF_PANEL = kWRows * ROW;
  static constexpr uint32_t HALF = kWRows * D * 2;   // one warpgroup's rows
  static constexpr uint32_t UNIT = kRows * D * 2;    // a unit's 128 rows
};

// d (64 x N, f32) = or += A (64 x 16, K-major) B^T (N x 16, K-major), both
// of element type E
template <typename E, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 128)
    wgmma_ss_n128<E>(d, da, db, accumulate);
  else
    wgmma_ss_n64<E>(d, da, db, accumulate);
}

// d (64 x W, f32) += A (64 x 16, E in registers) B (16 x W), B N-major
template <typename E, int W>
__device__ __forceinline__ void wgmma_rs(float (&d)[W / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (W == 64)
    wgmma_rs_n64<E>(d, a, db);
  else
    wgmma_rs_n32<E>(d, a, db);
}

// acc (64 x N) = A B^T over D: A the warpgroup's 64 rows of a split tile,
// B a streamed tile of N rows, k-steps of 16 along D within the panels
template <typename E, int D, int N>
__device__ __forceinline__ void issue_scores(float (&acc)[N / 2],
                                             uint32_t a_half,
                                             uint32_t b_tile) {
  using G = Geo<D>;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks * 16 % G::W) * 2;  // bytes into the row
    const int p = ks * 16 / G::W;
    wgmma_ss<E, N>(
        acc, smem_desc(a_half + p * G::HALF_PANEL + off, 0, G::SBO, G::SWIZZLE),
        smem_desc(b_tile + p * N * G::ROW + off, 0, G::SBO, G::SWIZZLE),
        ks > 0);
  }
}

// acc (64 x D, one W-column block per panel) += A B: A (64 x N) E in
// registers, B a streamed tile of N rows read N-major, 16 rows a step
template <typename E, int D, int N>
__device__ __forceinline__ void issue_accumulate(
    float (&acc)[Geo<D>::NP][Geo<D>::W / 2], const uint32_t (&a)[N / 16][4],
    uint32_t b_tile) {
  using G = Geo<D>;
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
#pragma unroll
    for (int p = 0; p < G::NP; ++p)
      wgmma_rs<E, G::W>(acc[p], a[kc],
                     smem_desc(b_tile + p * N * G::ROW + kc * 16 * G::ROW,
                               G::SBO, G::SBO, G::SWIZZLE));
  }
}

// An accumulator (64 x N) in E as the register A operand of the next
// product: the accumulators of two adjacent 8-column blocks are one 64 x 16
// A fragment.
template <typename E, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&s)[N / 2]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    a[kc][0] = pack2<E>(s[8 * kc], s[8 * kc + 1]);
    a[kc][1] = pack2<E>(s[8 * kc + 2], s[8 * kc + 3]);
    a[kc][2] = pack2<E>(s[8 * kc + 4], s[8 * kc + 5]);
    a[kc][3] = pack2<E>(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[Geo<D>::NP][Geo<D>::W / 2]) {
#pragma unroll
  for (int p = 0; p < Geo<D>::NP; ++p)
#pragma unroll
    for (int j = 0; j < Geo<D>::W / 2; ++j) acc[p][j] = 0.f;
}

template <int D>
__device__ __forceinline__ void fence_acc(
    float (&acc)[Geo<D>::NP][Geo<D>::W / 2]) {
#pragma unroll
  for (int p = 0; p < Geo<D>::NP; ++p) fence_regs(acc[p]);
}

template <int N>
__device__ __forceinline__ void fence_a(uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) fence_regs(a[kc]);
}

// The warpgroup's 64 x D accumulator in E, written swizzled (as TMA reads
// it: 16-byte chunk ^= row bits) into its staging rows `stage` ([panel][64
// rows][W]); lr0 is the lane's first accumulator row.
template <typename E, int D>
__device__ __forceinline__ void stage_rows(
    uint8_t* stage, const float (&acc)[Geo<D>::NP][Geo<D>::W / 2], int lr0,
    int t) {
  using G = Geo<D>;
#pragma unroll
  for (int p = 0; p < G::NP; ++p) {
#pragma unroll
    for (int j = 0; j < G::W / 8; ++j) {
      const uint32_t col = (8 * j + 2 * t) * 2;
      uint32_t a0 = lr0 * G::ROW + col, a1 = (lr0 + 8) * G::ROW + col;
      a0 ^= ((a0 >> 7) & G::SWIZZLE_MASK) << 4;
      a1 ^= ((a1 >> 7) & G::SWIZZLE_MASK) << 4;
      *reinterpret_cast<uint32_t*>(stage + p * G::HALF_PANEL + a0) =
          pack2<E>(acc[p][4 * j], acc[p][4 * j + 1]);
      *reinterpret_cast<uint32_t*>(stage + p * G::HALF_PANEL + a1) =
          pack2<E>(acc[p][4 * j + 2], acc[p][4 * j + 3]);
    }
  }
}

// TMA stores of a warpgroup's staged rows, one box per panel, at rows
// r0.. of head (b, h); issued by one thread once the rows are written.
template <int D>
__device__ __forceinline__ void store_staged(const CUtensorMap* map,
                                             uint32_t stage, int r0, int h,
                                             int b) {
  using G = Geo<D>;
#pragma unroll
  for (int p = 0; p < G::NP; ++p)
    tma_store(map, stage + p * G::HALF_PANEL, p * G::W, r0, h, b);
}

// The two consumer warpgroups take turns issuing their products (named
// barriers 3 and 4), so one's elementwise work runs while the other's
// products use the tensor cores. Warpgroup 1 opens warpgroup 0's first turn
// (turns_open) and skips its own last hand-over, so every barrier phase
// completes; both take the same number of turns.
__device__ __forceinline__ void turns_open(int c) {
  if (c == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
}
__device__ __forceinline__ void turn_begin(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory");
}
__device__ __forceinline__ void turn_end(int c, bool last) {
  if (!(last && c == 1))
    asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c) : "memory");
}

// A consumer warp is done with a buffer: one arrival per warp.
__device__ __forceinline__ void warp_release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <int D>
struct DqSmem {  // K2's shared memory
  using G = Geo<D>;
  static constexpr int BK = D == 128 ? 64 : 128;  // keys per K/V tile
  static constexpr uint32_t STREAM = BK * D * 2;  // one K or V tile
  static constexpr uint32_t STREAM_PANEL = BK * G::ROW;
  static constexpr int SETS = D == 128 ? 1 : 2;  // Q, dO, O of a unit
  static constexpr int STAGES = 3;               // K and V tiles
  static constexpr uint32_t SET = 3 * G::UNIT;
  static constexpr uint32_t KV_OFF = SETS * SET;
  static constexpr uint32_t DL_OFF = KV_OFF + STAGES * 2 * STREAM;
  // mbarriers: set_full[SETS], set_empty[SETS], kv_full[STAGES],
  // kv_empty[STAGES]
  static constexpr uint32_t BAR_OFF = DL_OFF + 2 * kWRows * 4;
  // + 1024: the dynamic shared memory is realigned to 1024 bytes
  static constexpr uint32_t SMEM = BAR_OFF + 8 * (2 * SETS + 2 * STAGES) +
                                   1024;
};

// Maps: q, k, v, O, dO (loads) and dq (store).
template <int D, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap omap,
                        const __grid_constant__ CUtensorMap gmap,
                        const __grid_constant__ CUtensorMap dqmap,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, int H, int S,
                        int q_tiles, int n_work, float scale,
                        int causal) {
  using G = Geo<D>;
  using M = DqSmem<D>;
  constexpr int BK = M::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);  // generic view of `base`
  const uint32_t bars = base + M::BAR_OFF;
  auto set_full = [&](int s) { return bars + 8u * s; };
  auto set_empty = [&](int s) { return bars + 8u * (M::SETS + s); };
  auto kv_full = [&](int st) { return bars + 8u * (2 * M::SETS + st); };
  auto kv_empty = [&](int st) {
    return bars + 8u * (2 * M::SETS + M::STAGES + st);
  };
  auto set_base = [&](int s) { return base + s * M::SET; };  // Q, dO, O
  auto k_tile = [&](int st) { return base + M::KV_OFF + st * 2 * M::STREAM; };
  // work unit w: q-tile w % q_tiles of head w / q_tiles
  auto kv_tiles = [&](int qt) {
    const int end = causal ? min(S, (qt + 1) * kRows) : S;
    return (end + BK - 1) / BK;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < M::SETS; ++s) {
      mbar_init(set_full(s), 1);
      mbar_init(set_empty(s), 2);  // one arrival per consumer warpgroup
    }
#pragma unroll
    for (int st = 0; st < M::STAGES; ++st) {
      mbar_init(kv_full(st), 1);
      mbar_init(kv_empty(st), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the unit sets and the K/V ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int kv_it = 0;
      for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
        const int qt = w % q_tiles, bh = w / q_tiles;
        const int b = bh / H, h = bh - b * H;
        const int s = i % M::SETS, u = i / M::SETS;
        // set s, once unit i - SETS has stored its dq from it
        mbar_wait(set_empty(s), (u & 1) ^ 1);
        mbar_expect_tx(set_full(s), M::SET);
        const CUtensorMap* maps[3] = {&qmap, &gmap, &omap};
#pragma unroll
        for (int m = 0; m < 3; ++m)
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int p = 0; p < G::NP; ++p)
              tma_load(set_base(s) + m * G::UNIT + half * G::HALF +
                           p * G::HALF_PANEL,
                       maps[m], set_full(s), p * G::W,
                       qt * kRows + half * kWRows, h, b);
        const int n = kv_tiles(qt);
        for (int it = 0; it < n; ++it, ++kv_it) {
          const int st = kv_it % M::STAGES;
          // the first round finds every buffer free
          mbar_wait(kv_empty(st), ((kv_it / M::STAGES) & 1) ^ 1);
          mbar_expect_tx(kv_full(st), 2 * M::STREAM);
#pragma unroll
          for (int p = 0; p < G::NP; ++p) {
            tma_load(k_tile(st) + p * M::STREAM_PANEL, &kmap, kv_full(st),
                     p * G::W, it * BK, h, b);
            tma_load(k_tile(st) + M::STREAM + p * M::STREAM_PANEL, &vmap,
                     kv_full(st), p * G::W, it * BK, h, b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const int lr0 = warp * 16 + g;  // local rows lr0 and lr0 + 8
    float* const dl = reinterpret_cast<float*>(smem + M::DL_OFF) + c * kWRows;
    const float scale_log2 = scale * kLog2e;

    // wgmma accumulator layout (per 8-column block j): [4j], [4j+1] are
    // row lr0, columns 8j + 2t and + 1; [4j+2], [4j+3] row lr0 + 8
    float s[BK / 2], dp[BK / 2];
    float dq[G::NP][G::W / 2];
    uint32_t sa[BK / 16][4];
    // registers read or written by the products in flight: written before
    // the fence that precedes them, read after their wait
    auto fence_all = [&] {
      fence_regs(s);
      fence_regs(dp);
      fence_acc<D>(dq);
      fence_a<BK>(sa);
    };
    turns_open(c);

    int kv_it = 0;
    for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
      const int qt = w % q_tiles, bh = w / q_tiles;
      const int b = bh / H, h = bh - b * H;
      const int set = i % M::SETS;
      const uint32_t q_half = set_base(set) + c * G::HALF;
      const uint32_t g_half = q_half + G::UNIT;      // dO
      const uint32_t o_half = q_half + 2 * G::UNIT;  // O, then dq's staging
      const int r0 = qt * kRows + c * kWRows;  // the warpgroup's first row
      const int row0 = r0 + lr0, row1 = row0 + 8;
      const int n = kv_tiles(qt);
      const bool last_work = w + gridDim.x >= n_work;
      // rows past S see zero Q and dO: P = 1, dP = delta = 0, so dS = 0
      const float lse0 = row0 < S ? lse[(size_t)bh * S + row0] * kLog2e : 0.f;
      const float lse1 = row1 < S ? lse[(size_t)bh * S + row1] * kLog2e : 0.f;
      zero<D>(dq);
      mbar_wait(set_full(set), (i / M::SETS) & 1);

      // tile 0's score products: S = Q K^T, dP = dO V^T
      int st = kv_it % M::STAGES;
      mbar_wait(kv_full(st), (kv_it / M::STAGES) & 1);
      fence_all();
      turn_begin(c);
      wgmma_fence();
      issue_scores<E, D, BK>(s, q_half, k_tile(st));
      issue_scores<E, D, BK>(dp, g_half, k_tile(st) + M::STREAM);
      wgmma_commit();
      turn_end(c, false);

      // delta = rowsum(dO * O) for the warpgroup's 64 rows while they run:
      // two threads a row, each over half its 16-byte chunks. The swizzle
      // permutes a row's chunks within the row, alike in dO and O, so the
      // sum needs no unswizzling.
      {
        const int r = tid >> 1, part = tid & 1;
        float acc = 0.f;
#pragma unroll
        for (int j = part * (D / 16); j < (part + 1) * (D / 16); ++j) {
          const uint32_t off = (j / (G::W / 8)) * G::HALF_PANEL + r * G::ROW +
                               (j % (G::W / 8)) * 16;
          const uint4 x =
              *reinterpret_cast<const uint4*>(smem + (g_half - base) + off);
          const uint4 y =
              *reinterpret_cast<const uint4*>(smem + (o_half - base) + off);
          const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
          const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = unpack2<E>(xs[e]);
            const float2 bb = unpack2<E>(ys[e]);
            acc = fmaf(a.x, bb.x, acc);
            acc = fmaf(a.y, bb.y, acc);
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (part == 0) {
          dl[r] = acc;
          if (r0 + r < S) delta[(size_t)bh * S + r0 + r] = acc;
        }
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      }
      const float dl0 = row0 < S ? dl[lr0] : 0.f;
      const float dl1 = row1 < S ? dl[lr0 + 8] : 0.f;

      // tile it: dS from its scores; dq += dS K is issued with the next
      // tile's score products, and the elementwise work of one warpgroup
      // runs while the other's products are on the tensor cores
      for (int it = 0; it < n; ++it) {
        wgmma_wait<0>();  // tile it's scores, and tile it - 1's dq product
        fence_all();
        if (it > 0) warp_release(kv_empty((kv_it - 1) % M::STAGES), lane);

        // dS = P (dP - delta) scale, P = exp(S scale - lse) with the masks
        // (only on tiles that hold the tail or cross the diagonal)
        const int k0 = it * BK;
        const bool need_mask = (k0 + BK > S) || (causal && k0 + BK - 1 > r0);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(s[4 * j + e], scale_log2, e < 2 ? -lse0 : -lse1);
            if (need_mask) {
              const int col = k0 + j * 8 + 2 * t + (e & 1);
              const int row = e < 2 ? row0 : row1;
              if (col >= S || (causal && col > row)) x = kNegInf;
            }
            const float p = ex2(x) * scale;
            s[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? dl0 : dl1));
          }
        }
        pack_a<E, BK>(sa, s);

        const uint32_t kt = k_tile(st);
        const bool more = it + 1 < n;
        if (more) {
          ++kv_it;
          st = kv_it % M::STAGES;
          mbar_wait(kv_full(st), (kv_it / M::STAGES) & 1);
        }
        fence_all();
        turn_begin(c);
        wgmma_fence();
        issue_accumulate<E, D, BK>(dq, sa, kt);  // dq += dS K
        if (more) {
          issue_scores<E, D, BK>(s, q_half, k_tile(st));
          issue_scores<E, D, BK>(dp, g_half, k_tile(st) + M::STREAM);
        }
        wgmma_commit();
        turn_end(c, !more && last_work);
      }
      wgmma_wait<0>();
      fence_all();
      warp_release(kv_empty(st), lane);
      ++kv_it;

      // ---- epilogue: dq in E through O's rows (read by now) to TMA ----
      stage_rows<E, D>(smem + (o_half - base), dq, lr0, t);
      // make the generic-proxy writes visible to TMA; one thread stores
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      if (tid == 0) {
        store_staged<D>(&dqmap, o_half, r0, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // the set is free once the store has read the staged rows
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(set_empty(set));
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

template <int D>
struct DkvSmem {  // K3's shared memory
  using G = Geo<D>;
  static constexpr int BQ = D == 128 ? 64 : 128;  // queries per Q/dO tile
  static constexpr uint32_t STREAM = BQ * D * 2;  // one Q or dO tile
  static constexpr uint32_t STREAM_PANEL = BQ * G::ROW;
  static constexpr int SETS = D == 128 ? 1 : 2;  // K and V of a unit
  static constexpr int STAGES = 3;               // Q and dO tiles
  static constexpr uint32_t SET = 2 * G::UNIT;
  static constexpr uint32_t QD_OFF = SETS * SET;
  // per warpgroup, two slots of a Q tile's lse (base 2) and delta
  static constexpr uint32_t LD_OFF = QD_OFF + STAGES * 2 * STREAM;
  static constexpr uint32_t LD_WG = 2 * 2 * BQ * 4;
  // mbarriers: set_full[SETS], set_empty[SETS], qd_full[STAGES],
  // qd_empty[STAGES]
  static constexpr uint32_t BAR_OFF = LD_OFF + 2 * LD_WG;
  static constexpr uint32_t SMEM = BAR_OFF + 8 * (2 * SETS + 2 * STAGES) +
                                   1024;
};

// Maps: q, k, v, dO (loads), dk and dv (stores).
template <int D, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap gmap,
                         const __grid_constant__ CUtensorMap dkmap,
                         const __grid_constant__ CUtensorMap dvmap,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, int H, int S,
                         int k_tiles, int n_work, float scale,
                         int causal) {
  using G = Geo<D>;
  using M = DkvSmem<D>;
  constexpr int BQ = M::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bars = base + M::BAR_OFF;
  auto set_full = [&](int s) { return bars + 8u * s; };
  auto set_empty = [&](int s) { return bars + 8u * (M::SETS + s); };
  auto qd_full = [&](int st) { return bars + 8u * (2 * M::SETS + st); };
  auto qd_empty = [&](int st) {
    return bars + 8u * (2 * M::SETS + M::STAGES + st);
  };
  auto set_base = [&](int s) { return base + s * M::SET; };  // K, V
  auto q_tile = [&](int st) { return base + M::QD_OFF + st * 2 * M::STREAM; };
  // work unit w: k-tile w % k_tiles of head w / k_tiles; causal, queries
  // before the unit's first key see none of its keys
  const int q_count = (S + BQ - 1) / BQ;
  auto q_first = [&](int kt) { return causal ? kt * kRows / BQ : 0; };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < M::SETS; ++s) {
      mbar_init(set_full(s), 1);
      mbar_init(set_empty(s), 2);
    }
#pragma unroll
    for (int st = 0; st < M::STAGES; ++st) {
      mbar_init(qd_full(st), 1);
      mbar_init(qd_empty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int qd_it = 0;
      for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
        const int kt = w % k_tiles, bh = w / k_tiles;
        const int b = bh / H, h = bh - b * H;
        const int s = i % M::SETS, u = i / M::SETS;
        mbar_wait(set_empty(s), (u & 1) ^ 1);
        mbar_expect_tx(set_full(s), M::SET);
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int p = 0; p < G::NP; ++p) {
            const uint32_t off = half * G::HALF + p * G::HALF_PANEL;
            const int r = kt * kRows + half * kWRows;
            tma_load(set_base(s) + off, &kmap, set_full(s), p * G::W, r, h,
                     b);
            tma_load(set_base(s) + G::UNIT + off, &vmap, set_full(s),
                     p * G::W, r, h, b);
          }
        for (int qi = q_first(kt); qi < q_count; ++qi, ++qd_it) {
          const int st = qd_it % M::STAGES;
          mbar_wait(qd_empty(st), ((qd_it / M::STAGES) & 1) ^ 1);
          mbar_expect_tx(qd_full(st), 2 * M::STREAM);
#pragma unroll
          for (int p = 0; p < G::NP; ++p) {
            tma_load(q_tile(st) + p * M::STREAM_PANEL, &qmap, qd_full(st),
                     p * G::W, qi * BQ, h, b);
            tma_load(q_tile(st) + M::STREAM + p * M::STREAM_PANEL, &gmap,
                     qd_full(st), p * G::W, qi * BQ, h, b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int lr0 = warp * 16 + g;
    float* const ld = reinterpret_cast<float*>(smem + M::LD_OFF +
                                               c * M::LD_WG);
    const float scale_log2 = scale * kLog2e;

    // accumulator layout as K2's, with keys as rows and queries as columns
    float s[BQ / 2], dp[BQ / 2];
    float dk[G::NP][G::W / 2], dv[G::NP][G::W / 2];
    uint32_t pa[BQ / 16][4], sa[BQ / 16][4];

    int qd_it = 0;
    for (int w = blockIdx.x, i = 0; w < n_work; w += gridDim.x, ++i) {
      const int kt = w % k_tiles, bh = w / k_tiles;
      const int b = bh / H, h = bh - b * H;
      const int set = i % M::SETS;
      const uint32_t k_half = set_base(set) + c * G::HALF;  // then dk's
      const uint32_t v_half = k_half + G::UNIT;              // then dv's
      const int r0 = kt * kRows + c * kWRows;  // the warpgroup's first key
      const int key0 = r0 + lr0, key1 = key0 + 8;
      zero<D>(dk);
      zero<D>(dv);
      mbar_wait(set_full(set), (i / M::SETS) & 1);

      for (int qi = q_first(kt); qi < q_count; ++qi, ++qd_it) {
        const int st = qd_it % M::STAGES;
        const uint32_t qt = q_tile(st), gt = qt + M::STREAM;
        const int q0 = qi * BQ;
        // the tile's lse (base 2) and delta into this warpgroup's slot
        // qd_it & 1 (every thread of it has left the slot's last tile:
        // it passed the barrier below on the tile since)
        float* const slot = ld + (qd_it & 1) * 2 * BQ;
        for (int j = tid; j < BQ; j += 128) {
          const bool live = q0 + j < S;
          slot[j] = live ? lse[(size_t)bh * S + q0 + j] * kLog2e : 0.f;
          slot[BQ + j] = live ? delta[(size_t)bh * S + q0 + j] : 0.f;
        }
        mbar_wait(qd_full(st), (qd_it / M::STAGES) & 1);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        issue_scores<E, D, BQ>(s, k_half, qt);   // S^T = K Q^T
        issue_scores<E, D, BQ>(dp, v_half, gt);  // dP^T = V dO^T
        wgmma_commit();
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // P^T and dS^T; a query sees a key iff both are < S and, causal,
        // key <= query
        const bool need_mask = (q0 + BQ > S) || (r0 + kWRows > S) ||
                               (causal && q0 < r0 + kWRows - 1);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const int ql = j * 8 + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(slot + ql);
          const float2 d2 = *reinterpret_cast<const float2*>(slot + BQ + ql);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * j + e] * scale_log2;
            if (need_mask) {
              const int qg = q0 + ql + (e & 1);
              const int key = e < 2 ? key0 : key1;
              if (qg >= S || key >= S || (causal && key > qg)) x = kNegInf;
            }
            const float p = ex2(x - ((e & 1) ? l2.y : l2.x));
            s[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x)) *
                            scale;
          }
        }
        pack_a<E, BQ>(pa, s);
        pack_a<E, BQ>(sa, dp);

        // dv += P^T dO and dk += dS^T Q
        fence_acc<D>(dv);
        fence_acc<D>(dk);
        fence_a<BQ>(pa);
        fence_a<BQ>(sa);
        wgmma_fence();
        issue_accumulate<E, D, BQ>(dv, pa, gt);
        issue_accumulate<E, D, BQ>(dk, sa, qt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc<D>(dv);
        fence_acc<D>(dk);
        fence_a<BQ>(pa);
        fence_a<BQ>(sa);
        warp_release(qd_empty(st), lane);
      }

      // ---- epilogue: dk and dv in E through K's and V's rows to TMA ----
      stage_rows<E, D>(smem + (k_half - base), dk, lr0, t);
      stage_rows<E, D>(smem + (v_half - base), dv, lr0, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      if (tid == 0) {
        store_staged<D>(&dkmap, k_half, r0, h, b);
        store_staged<D>(&dvmap, v_half, r0, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(set_empty(set));
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// f32: four threads per row, true fp32 FMA. A thread owns the row's float4
// chunks part, part+4, part+8, ... (interleaved, so the four threads of a row
// read 64 contiguous bytes of a shared-memory row: no bank conflicts); each
// dot product is four partial sums joined by two shuffles.
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 128;
constexpr int kSplit = 4;
constexpr int kF32Rows = kF32Threads / kSplit;  // rows a block owns
constexpr int kF32Tile = 32;  // rows of the other side per step

// Six (B, H, S, D) f32 views: their addresses and (S, H, B) strides in
// elements. K2: q, k, v, O, dO, dq; K3: q, k, v, dO, dk, dv.
struct F32Views {
  float* p[6];
  long long s[6][3];
  // view i's row `row` of head (b, h)
  __device__ __forceinline__ float* row(int i, int b, int h,
                                        int row) const {
    return p[i] + b * s[i][2] + h * s[i][1] + row * s[i][0];
  }
};

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

// Copy rows [r0, r0 + kF32Tile) of view i of head (b, h) into shared
// memory, zero-filling rows at or past S.
template <int D>
__device__ __forceinline__ void load_rows_f32(float (*dst)[D],
                                              const F32Views& t, int i,
                                              int b, int h, int r0, int S) {
  for (int c = threadIdx.x; c < kF32Tile * D / 4; c += kF32Threads) {
    const int r = c / (D / 4);
    const int col = (c % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      x = *reinterpret_cast<const float4*>(t.row(i, b, h, r0 + r) + col);
    *reinterpret_cast<float4*>(&dst[r][col]) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dq_f32_kernel(F32Views t, const float* __restrict__ lse,
                            float* __restrict__ delta, int H, int S,
                            float scale, int causal) {
  constexpr int C = D / 4 / kSplit;  // float4 chunks per thread
  __shared__ __align__(16) float Ks[kF32Tile][D];
  __shared__ __align__(16) float Vs[kF32Tile][D];

  const int part = threadIdx.x % kSplit;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * kF32Rows;
  const int row = q0 + threadIdx.x / kSplit;
  const bool live = row < S;
  const float scale_log2 = scale * kLog2e;

  // dead rows (past S) keep zero Q, dO and O and compute dS = 0; every
  // thread runs the loop because the dot products shuffle across the row's
  // lanes
  float4 qr[C], dr[C], acc[C];
  float dl = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (part + kSplit * c) * 4;
    qr[c] = dr[c] = acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      qr[c] = *reinterpret_cast<const float4*>(t.row(0, b, h, row) + col);
      dr[c] = *reinterpret_cast<const float4*>(t.row(4, b, h, row) + col);
      dl = dot4(dr[c],
                *reinterpret_cast<const float4*>(t.row(3, b, h, row) + col),
                dl);
    }
  }
  dl = row_sum(dl);  // delta = rowsum(dO * O)
  if (live && part == 0) delta[(size_t)bh * S + row] = dl;
  const float lse_r = live ? lse[(size_t)bh * S + row] * kLog2e : 0.f;

  const int kend = causal ? min(S, q0 + kF32Rows) : S;
  for (int k0 = 0; k0 < kend; k0 += kF32Tile) {
    __syncthreads();
    load_rows_f32<D>(Ks, t, 1, b, h, k0, S);
    load_rows_f32<D>(Vs, t, 2, b, h, k0, S);
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
    *reinterpret_cast<float4*>(t.row(5, b, h, row) + col) = acc[c];
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dkv_f32_kernel(F32Views t, const float* __restrict__ lse,
                             const float* __restrict__ delta, int H, int S,
                             float scale, int causal) {
  constexpr int C = D / 4 / kSplit;
  __shared__ __align__(16) float Qs[kF32Tile][D];
  __shared__ __align__(16) float Ds[kF32Tile][D];
  __shared__ float Ls[kF32Tile];
  __shared__ float Dl[kF32Tile];

  const int part = threadIdx.x % kSplit;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.y * kF32Rows;
  const int key = k0 + threadIdx.x / kSplit;
  const bool live = key < S;
  const float scale_log2 = scale * kLog2e;

  float4 kr[C], vr[C], dka[C], dva[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (part + kSplit * c) * 4;
    kr[c] = vr[c] = dka[c] = dva[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) {
      kr[c] = *reinterpret_cast<const float4*>(t.row(1, b, h, key) + col);
      vr[c] = *reinterpret_cast<const float4*>(t.row(2, b, h, key) + col);
    }
  }

  const int qstart = causal ? (k0 / kF32Tile) * kF32Tile : 0;
  for (int q0 = qstart; q0 < S; q0 += kF32Tile) {
    __syncthreads();
    load_rows_f32<D>(Qs, t, 0, b, h, q0, S);
    load_rows_f32<D>(Ds, t, 3, b, h, q0, S);
    for (int i = threadIdx.x; i < kF32Tile; i += kF32Threads) {
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
    *reinterpret_cast<float4*>(t.row(4, b, h, key) + col) = dka[c];
    *reinterpret_cast<float4*>(t.row(5, b, h, key) + col) = dva[c];
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
constexpr int kMaxDevices = 64;

struct Args {
  const long long* views;  // 6 x {address, S, H, B byte strides}
  const float* lse;
  float* delta;  // K2 writes it, K3 reads it
  int B, H, S;
  float scale;
  int causal;
  cudaStream_t stream;
};

// The SM count of the current device, once `kern`'s shared-memory limit is
// raised there to `smem` bytes (both done once per device and kernel; 0
// until then). Returns a cudaError_t.
template <typename Kernel>
int sm_count_for(Kernel kern, uint32_t smem, int* cache, int* sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = __atomic_load_n(&cache[dev], __ATOMIC_RELAXED);
  if (*sms == 0) {
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    __atomic_store_n(&cache[dev], *sms, __ATOMIC_RELAXED);
  }
  return cudaSuccess;
}

// The six tensor maps of a launch: view i with boxes of W x rows[i] rows.
template <int D, typename E>
int encode_maps(CUtensorMap (&maps)[6], const Args& a, const int (&rows)[6]) {
  using G = Geo<D>;
  if (encoder().err) return encoder().err;
  const CUtensorMapSwizzle swizzle =
      G::W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  for (int i = 0; i < 6; ++i) {
    const CUresult r = encode_map(&maps[i], Elem<E>::kMap, a.views + 4 * i,
                                  a.B, a.H, a.S, D, G::W, rows[i], swizzle);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  return 0;
}

template <int D, typename E>
int launch_dq_tc(const Args& a) {
  using M = DqSmem<D>;
  static int cache[kMaxDevices];  // read and written atomically
  int sms, rc;
  if ((rc = sm_count_for(flash_bwd_dq_kernel<D, E>, M::SMEM, cache, &sms)))
    return rc;
  CUtensorMap maps[6];  // q, k, v, O, dO, dq
  const int rows[6] = {kWRows, M::BK, M::BK, kWRows, kWRows, kWRows};
  if ((rc = encode_maps<D, E>(maps, a, rows))) return rc;
  const int q_tiles = (a.S + kRows - 1) / kRows;
  const int n_work = q_tiles * a.B * a.H;
  flash_bwd_dq_kernel<D, E><<<min(n_work, sms), kThreads, M::SMEM,
                             a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a.lse, a.delta,
      a.H, a.S, q_tiles, n_work, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D, typename E>
int launch_dkv_tc(const Args& a) {
  using M = DkvSmem<D>;
  static int cache[kMaxDevices];
  int sms, rc;
  if ((rc = sm_count_for(flash_bwd_dkv_kernel<D, E>, M::SMEM, cache, &sms)))
    return rc;
  CUtensorMap maps[6];  // q, k, v, dO, dk, dv
  const int rows[6] = {M::BQ, kWRows, kWRows, M::BQ, kWRows, kWRows};
  if ((rc = encode_maps<D, E>(maps, a, rows))) return rc;
  const int k_tiles = (a.S + kRows - 1) / kRows;
  const int n_work = k_tiles * a.B * a.H;
  flash_bwd_dkv_kernel<D, E><<<min(n_work, sms), kThreads, M::SMEM,
                              a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a.lse, a.delta,
      a.H, a.S, k_tiles, n_work, a.scale, a.causal);
  return cudaGetLastError();
}

F32Views f32_views(const long long* views) {
  F32Views t;
  for (int i = 0; i < 6; ++i) {
    t.p[i] = reinterpret_cast<float*>(views[4 * i]);
    for (int j = 0; j < 3; ++j)
      t.s[i][j] = views[4 * i + 1 + j] / (long long)sizeof(float);
  }
  return t;
}

template <int D>
int launch_dq_f32(const Args& a) {
  const dim3 grid(a.B * a.H, (a.S + kF32Rows - 1) / kF32Rows);
  flash_bwd_dq_f32_kernel<D><<<grid, kF32Threads, 0, a.stream>>>(
      f32_views(a.views), a.lse, a.delta, a.H, a.S, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
int launch_dkv_f32(const Args& a) {
  const dim3 grid(a.B * a.H, (a.S + kF32Rows - 1) / kF32Rows);
  flash_bwd_dkv_f32_kernel<D><<<grid, kF32Threads, 0, a.stream>>>(
      f32_views(a.views), a.lse, a.delta, a.H, a.S, a.scale, a.causal);
  return cudaGetLastError();
}

template <bool kDkv, typename E, int D>
int launch_tc(const Args& a) {
  return kDkv ? launch_dkv_tc<D, E>(a) : launch_dq_tc<D, E>(a);
}

template <bool kDkv>
int dispatch(const Args& a, int head_dim, int dtype) {
  if (a.B <= 0 || a.H <= 0 || a.S <= 0 || dtype < kDtypeF32 ||
      dtype > kDtypeF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bh = static_cast<long long>(a.B) * a.H;
  // the f32 grid is (B*H, S / kF32Rows); the 16-bit one walks B*H*tiles
  // units
  if (bh * ((a.S + kRows - 1) / kRows) > INT32_MAX ||
      (dtype == kDtypeF32 && (a.S + kF32Rows - 1) / kF32Rows > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
#define MXT_CASE(DIM)                                                   \
  case DIM:                                                             \
    if (dtype == kDtypeBf16) return launch_tc<kDkv, __nv_bfloat16, DIM>(a); \
    if (dtype == kDtypeF16) return launch_tc<kDkv, __half, DIM>(a);     \
    return kDkv ? launch_dkv_f32<DIM>(a) : launch_dq_f32<DIM>(a);
    MXT_CASE(32)
    MXT_CASE(64)
    MXT_CASE(128)
#undef MXT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// views: for q, k, v, O, dO and dq in turn {address, S stride, H stride, B
// stride}, strides in bytes, of (B, H, S, D) tensors with unit stride on D;
// dtype: 0 = f32, 1 = bf16, 2 = fp16 (kDtypeF32, kDtypeBf16, kDtypeF16);
// every address 16-byte aligned and every stride a positive multiple of 16
// bytes (the wrapper checks both). lse: the
// forward's, contiguous (B*H, S) f32; delta: contiguous (B*H, S) f32,
// written. Returns 0, a cudaError_t, or minus the CUresult of a failed
// tensor-map encode.
extern "C" int mxt_flash_attention_bwd_dq(const long long* views,
                                          const void* lse, void* delta,
                                          int batch, int heads, int seq,
                                          int head_dim, int dtype,
                                          float sm_scale, int causal,
                                          void* stream) {
  const Args a{views, static_cast<const float*>(lse),
               static_cast<float*>(delta), batch, heads, seq, sm_scale,
               causal, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, head_dim, dtype);
}

// As above, with views q, k, v, dO, dk and dv; delta (K2's) is read.
extern "C" int mxt_flash_attention_bwd_dkv(const long long* views,
                                           const void* lse,
                                           const void* delta, int batch,
                                           int heads, int seq, int head_dim,
                                           int dtype, float sm_scale,
                                           int causal, void* stream) {
  const Args a{views, static_cast<const float*>(lse),
               const_cast<float*>(static_cast<const float*>(delta)), batch,
               heads, seq, sm_scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, head_dim, dtype);
}
