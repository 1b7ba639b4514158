// Fused 1x1 convolution with BatchNorm prologue and moment epilogue for
// Hopper (sm_90a): the CUDA port of the Pallas kernel `_fused_kernel`,
// launched by `conv1x1_bn_act` in mxnet_tpu/ops/pallas/fused_conv1x1.py.
//
// For x (M, K) (N*H*W rows of an NHWC activation, bf16 or f32), w (K, N)
// bf16 and the previous BatchNorm folded into scale, shift (K,) f32:
//   x_hat = relu(x * scale + shift)      f32 (one FMA), then rounded to bf16
//   y     = x_hat @ w                    bf16 x bf16, f32 accumulation
//   out   = bf16(y), col_sum = sum_rows y, col_sumsq = sum_rows y^2
// with the moments taken of the f32 y, as `conv1x1_bn_act_reference`.
//
// The TPU kernel keeps all of K x N resident and walks M tiles in order,
// carrying the moments in VMEM scratch across the grid. Here a persistent
// grid (at most one 384-thread block per SM) walks the 128-row x
// BN-column output tiles (BN = 64, 128 or 256), column tile fastest, so
// the tiles that read one x tile run together and find it in L2. (Split K
// for the small-M stages was built and measured slower at every shape;
// PERF.md has the times.)
// - Warpgroup 0 is the producer: one thread keeps a ring of `stages`
//   buffers full by TMA through full/empty mbarriers. A buffer holds a
//   64-wide K chunk: x as 128 rows x 64 bf16 (or two panels of 128 x 32
//   f32), 128-byte swizzled; w as BN/64 panels of 64 K-rows x 64 columns,
//   128-byte swizzled; and the chunk's 64 values of scale and of shift.
//   Boxes past M or K read zeros, so x, w, scale and shift past K are all
//   zero there and add nothing. Where one column tile covers N (ResNet-50's
//   stage 2), w is loaded once and stays resident in shared memory for the
//   kernel's life, as the Pallas kernel keeps it.
// - Warpgroups 1 and 2 each own 64 of the tile's rows. For each 16-wide
//   step of a chunk a consumer reads its x fragment from the swizzled tile
//   (ldmatrix; f32: 8-byte loads), applies the affine and the ReLU in f32
//   registers and packs the result to bf16 in the register A layout of
//   wgmma (the prologue); the products run as wgmma with A from registers
//   and B = w read N-major from shared memory (m64nNk16, N = BN), one
//   group a step, so a step's prologue overlaps the products of
//   the steps before it (three; one at BN = 256, for the registers). The
//   two consumer warpgroups interleave on the tensor cores.
// - Epilogue: y rounded to bf16, staged swizzled in shared memory and
//   stored by TMA (rows past M are not written). The moments of the f32 y
//   over the rows below M: a lane adds its two rows, the eight lanes of a
//   column group reduce-scatter by shuffles, and each warp adds its
//   columns into its own rows of running sums in shared memory, which hold
//   while the block's tiles stay in one column strip. When the strip
//   changes the eight warps' rows meet in a fixed order and are added into
//   the block's own row of a (blocks, 2, N) workspace, and the strip's
//   ticket counts the tiles; the block that completes a strip sums the
//   blocks' rows in a fixed order into col_sum / col_sumsq and zeroes the
//   rows and the ticket, so the workspace is zero again for the next call.
//   No float atomics: two calls are bitwise equal. Rows at or past M (the
//   ragged last tile, where x_hat = relu(shift) is not zero) stay out of
//   the moments. (The Pallas kernel sums every row of its last tile, so
//   its moments are wrong when block_m does not divide M; this kernel is
//   not.)
//
// Bound. At ResNet-50's batch-128 1x1 shapes the kernel must read x and w
// once and write y once: 103 to 257 MB at stages 2-4 (31-77 us at 3.35
// TB/s, bound by bytes) and 13.15 GFLOP at stage 5 (13.3 us at 989
// TFLOP/s, bound by operations). At stages 4-5 the 128 x 256 tiles read
// w again for every row tile and x for every column tile, from L2: 65-154
// MB, which bounds those shapes on the card before the products do.
// Measured times: PERF.md.
//
// Plain C interface, loaded with ctypes by mxnet_tpu_torch/ops/cuda/
// fused_conv1x1.py. The five tensor maps are encoded on the host at every
// call (hopper.cuh). The launch goes to the caller's stream, allocates
// nothing, and returns cudaGetLastError(), or minus the encode's CUresult.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;      // producer warpgroup + two consumers
constexpr int kBM = 128;           // rows of an output tile
constexpr int kKC = 64;            // K columns of a ring buffer (a chunk)
constexpr uint32_t kPanel = 8192;  // 64 rows of 128 bytes, 128B-swizzled
constexpr uint32_t kSS = 512;      // a chunk's scale and shift (2 x 64 f32)
constexpr int kMaxStages = 6;
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may use
constexpr uint32_t kResidentMax = 64 * 1024;  // resident w, at most
constexpr int kMaxDevices = 64;

template <typename XT, int BN>
struct Cfg {
  static constexpr int XP = sizeof(XT) == 2 ? 1 : 2;    // x panels a chunk
  static constexpr int XW = 128 / sizeof(XT);           // columns a panel
  static constexpr uint32_t X_STAGE = XP * kBM * 128;
  static constexpr int WP = BN / 64;                    // w panels a chunk
  static constexpr uint32_t W_STAGE = WP * kPanel;
  static constexpr uint32_t STAGING = 2 * WP * kPanel;  // y, both halves
  static constexpr uint32_t RED = 8 * 2 * BN * 4;       // warps x moments
};

// Byte offsets into the (1024-aligned) dynamic shared memory.
struct Layout {
  uint32_t stage, w_res, staging, red, ss, bars, total;
  int stages;
};

template <typename XT, int BN>
__host__ __device__ Layout layout(int stages, int resident_chunks) {
  using C = Cfg<XT, BN>;
  Layout l;
  l.stages = stages;
  l.stage = C::X_STAGE + (resident_chunks ? 0u : C::W_STAGE);
  l.w_res = stages * l.stage;
  l.staging = l.w_res + resident_chunks * C::W_STAGE;
  l.red = l.staging + C::STAGING;
  l.ss = l.red + C::RED;
  l.bars = l.ss + stages * kSS;
  // full[stages], empty[stages], w_full, the completion flag; + 1024: the
  // dynamic shared memory is realigned to 1024 bytes
  l.total = l.bars + 8 * (2 * stages + 2) + 1024;
  return l;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void consumers_sync() {  // both consumer groups
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}
__device__ __forceinline__ void group_sync(int c) {  // one consumer group
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

// The accumulator slot of entry i of a lane's columns: entry i is column
// 8 (i / 2) + 2t + i % 2, and its row-g value sits at 4 (i / 2) + i % 2.
__host__ __device__ constexpr int sum_at(int i) { return 4 * (i >> 1) + (i & 1); }

// One halving of a reduce-scatter across the lanes `mask` apart: entries
// [0, HALF) and [HALF, 2 HALF) (sums and, two slots on, sums of squares)
// are split, the lane with `mask` set keeping the upper half, added to its
// partner's, in entries [0, HALF).
template <int N2, int HALF, int MASK>
__device__ __forceinline__ void halve(float (&acc)[N2], int lane) {
  const bool hi = lane & MASK;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
#pragma unroll
    for (int k = 0; k < 3; k += 2) {  // the sum, then the sum of squares
      const float lo_v = acc[sum_at(i) + k], hi_v = acc[sum_at(i + HALF) + k];
      const float got =
          __shfl_xor_sync(0xffffffffu, hi ? lo_v : hi_v, MASK);
      acc[sum_at(i) + k] = (hi ? hi_v : lo_v) + got;
    }
  }
}

// The place of column c in a warp's row of running moments: the lane that
// holds c after the reduce-scatter is 4 g + t, g = the entry's index / (CN
// / 8), and keeps its entry i at i * 32 + lane.
template <int BN>
__device__ __forceinline__ int red_slot(int c) {
  constexpr int CN8 = BN / 32;  // entries a lane keeps
  const int idx = 2 * (c >> 3) + (c & 1);  // c's entry among the CN
  return (idx % CN8) * 32 + (idx / CN8) * 4 + ((c >> 1) & 3);
}

__device__ __forceinline__ void warp_release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// d (64 x BN) += A (64 x 16, registers) B (16 x BN, N-major in shared
// memory)
template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (BN == 256)
    wgmma_rs_n256(d, a, db);
  else if constexpr (BN == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

// x*scale + shift and the ReLU for the two values of one register,
// columns col, col + 1 of the chunk; packed to bf16
__device__ __forceinline__ uint32_t affine2(float2 v, const float* ss,
                                            int col, int relu) {
  const float2 s = *reinterpret_cast<const float2*>(ss + col);
  const float2 t = *reinterpret_cast<const float2*>(ss + kKC + col);
  float a = fmaf(v.x, s.x, t.x), b = fmaf(v.y, s.y, t.y);
  if (relu) {  // NaN passes through, as max(x, 0) in the reference
    a = a < 0.f ? 0.f : a;
    b = b < 0.f ? 0.f : b;
  }
  return pack_bf16(a, b);
}

// The prologue of one 16-wide step `ks` of a chunk: the consumer's 64
// rows of x, through the affine and the ReLU, as the A fragment of the
// step. `xs` is the chunk's x tile (shared address), `xg` the same as a
// generic pointer, `r0` the warp's first row in the tile.
template <typename XT>
__device__ __forceinline__ void prologue(uint32_t (&fr)[4], int ks,
                                         uint32_t xs, const uint8_t* xg,
                                         const float* ss, int r0, int lane,
                                         int relu) {
  const int t = lane & 3;
  if constexpr (sizeof(XT) == 2) {
    const int r = r0 + (lane & 15);
    const int chunk = ks * 2 + (lane >> 4);
    uint32_t raw[4];
    ldmatrix_x4(raw, xs + r * 128 + ((chunk ^ (r & 7)) << 4));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&raw[q]));
      fr[q] = affine2(v, ss, ks * 16 + (q >> 1) * 8 + 2 * t, relu);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + (lane >> 2) + (q & 1) * 8;
      const int col = ks * 16 + (q >> 1) * 8 + 2 * t;
      const int kk = col & 31;
      const uint32_t off = (col >> 5) * (kBM * 128) + r * 128 +
                           (((kk >> 2) ^ (r & 7)) << 4) + (kk & 3) * 4;
      const float2 v = *reinterpret_cast<const float2*>(xg + off);
      fr[q] = affine2(v, ss, col, relu);
    }
  }
}

template <typename XT, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv1x1_bn_act_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ CUtensorMap smap,
                          const __grid_constant__ CUtensorMap tmap,
                          const __grid_constant__ CUtensorMap ymap,
                          float* __restrict__ col_sum,
                          float* __restrict__ col_sumsq,
                          float* __restrict__ slots,
                          int* __restrict__ tickets, int M, int K, int N,
                          int relu, int stages, int resident) {
  using C = Cfg<XT, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const int kchunks = (K + kKC - 1) / kKC;
  const Layout L = layout<XT, BN>(stages, resident ? kchunks : 0);
  const uint32_t bars = base + L.bars;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (stages + st); };
  const uint32_t w_full = bars + 16u * stages;
  int* const last_flag = reinterpret_cast<int*>(smem + L.bars +
                                                16 * stages + 8);
  const int n_tiles = (N + BN - 1) / BN;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int units = m_tiles * n_tiles;

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);
    }
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      if (resident) {
        mbar_expect_tx(w_full, kchunks * C::W_STAGE);
        for (int kc = 0; kc < kchunks; ++kc)
#pragma unroll
          for (int p = 0; p < C::WP; ++p)
            tma_load_2d(base + L.w_res + kc * C::W_STAGE + p * kPanel,
                        &wmap, w_full, p * 64, kc * kKC);
      }
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int n0 = (u % n_tiles) * BN, m0 = (u / n_tiles) * kBM;
        for (int kc = 0; kc < kchunks; ++kc, ++it) {
          const int st = it % stages;
          mbar_wait(empty(st), ((it / stages) & 1) ^ 1);
          mbar_expect_tx(full(st), L.stage + kSS);
          const uint32_t buf = base + st * L.stage;
#pragma unroll
          for (int p = 0; p < C::XP; ++p)
            tma_load_2d(buf + p * kBM * 128, &xmap, full(st),
                        kc * kKC + p * C::XW, m0);
          if (!resident)
#pragma unroll
            for (int p = 0; p < C::WP; ++p)
              tma_load_2d(buf + C::X_STAGE + p * kPanel, &wmap, full(st),
                          n0 + p * 64, kc * kKC);
          const uint32_t ss = base + L.ss + st * kSS;
          tma_load_1d(ss, &smap, full(st), kc * kKC);
          tma_load_1d(ss + kSS / 2, &tmap, full(st), kc * kKC);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 rows per warpgroup ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1;
  const int tid = threadIdx.x - wg * 128;
  const int ctid = threadIdx.x - 128;  // 0..255 over both groups
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* const red = reinterpret_cast<float*>(smem + L.red);
  float* const slot = slots + (size_t)blockIdx.x * 2 * N;
  const uint32_t staging = base + L.staging + c * C::WP * kPanel;

  if (resident) mbar_wait(w_full, 0);

  // The running moments over the tiles of the current strip, one row of
  // sums and one of squares a warp, in shared memory (`red`): after the
  // reduce-scatter below, each lane holds CN / 8 of the warp's columns and
  // adds them into its own places, place i * 32 + lane for its entry i (no
  // bank conflicts); red_slot() finds a column's place.
  constexpr int CN = BN / 4;
  float* const rw = red + (c * 4 + warp) * 2 * BN;
#pragma unroll
  for (int i = 0; i < CN / 8; ++i) rw[i * 32 + lane] = rw[BN + i * 32 + lane] = 0.f;
  int pending = 0, strip = -1;  // tiles in the running sums, their strip

  // the eight warps' running sums meet in a fixed order and are added into
  // the block's row; the block that completes the strip's tiles reduces
  // every block's row into the outputs
  auto flush = [&]() {
    const int n0 = strip * BN;
    consumers_sync();
    if (ctid < BN && n0 + ctid < N) {
      float ts = 0.f, tq = 0.f;
#pragma unroll
      for (int w8 = 0; w8 < 8; ++w8) {
        ts += red[w8 * 2 * BN + red_slot<BN>(ctid)];
        tq += red[w8 * 2 * BN + BN + red_slot<BN>(ctid)];
      }
      slot[n0 + ctid] = __ldcg(slot + n0 + ctid) + ts;
      slot[N + n0 + ctid] = __ldcg(slot + N + n0 + ctid) + tq;
    }
    __threadfence();
    consumers_sync();
#pragma unroll
    for (int i = 0; i < CN / 8; ++i) rw[i * 32 + lane] = rw[BN + i * 32 + lane] = 0.f;
    if (ctid == 0)
      *last_flag = atomicAdd(tickets + strip, pending) + pending == m_tiles;
    pending = 0;
    consumers_sync();
    if (!*last_flag) return;
    __threadfence();
    // BN / 2 float4 columns (sums, then squares), R threads each, the
    // blocks' rows split among them in a fixed order
    constexpr int V = BN / 2, R = 256 / V;
    const int v = ctid % V, r = ctid / V;
    const int stat = v / (BN / 4), col = n0 + (v % (BN / 4)) * 4;
    // Block b's tiles are b, b + G, ... (G blocks), so only blocks b = strip
    // (mod gcd(G, n_tiles)) can have a row for this strip: the others'
    // rows are zero and are not read.
    int d = gridDim.x, e = n_tiles;
    while (e) {
      const int q = d % e;
      d = e;
      e = q;
    }
    const int rows = ((int)gridDim.x - strip % d + d - 1) / d;
    constexpr int U = 8;  // rows in flight a thread
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col < N) {  // each row read, then zeroed for the next call
      float* const p = slots + (size_t)stat * N + col + (size_t)(strip % d) * 2 * N;
      const size_t step = (size_t)d * 2 * N;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k0 = r; k0 < rows; k0 += U * R) {
        float4 x[U];
#pragma unroll
        for (int j = 0; j < U; ++j)
          if (k0 + j * R < rows)
            x[j] = __ldcg(reinterpret_cast<const float4*>(p + (k0 + j * R) * step));
#pragma unroll
        for (int j = 0; j < U; ++j)
          if (k0 + j * R < rows) {  // rows in order
            a.x += x[j].x; a.y += x[j].y; a.z += x[j].z; a.w += x[j].w;
            __stcg(reinterpret_cast<float4*>(p + (k0 + j * R) * step), z);
          }
      }
    }
    // the parts meet in the first group's y staging buffer, once its last
    // store has read it
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    consumers_sync();
    float4* const part = reinterpret_cast<float4*>(smem + L.staging);
    part[r * V + v] = a;
    consumers_sync();
    if (ctid < V && col < N) {
      float4 sum = part[v];
      for (int i = 1; i < R; ++i) {
        const float4 x = part[i * V + v];
        sum.x += x.x; sum.y += x.y; sum.z += x.z; sum.w += x.w;
      }
      *reinterpret_cast<float4*>((stat ? col_sumsq : col_sum) + col) = sum;
    }
    if (ctid == 0) tickets[strip] = 0;
    consumers_sync();
  };

  // the warp's 16 rows x BN: acc[4j + e] is row g, column 8j + 2t + e;
  // acc[4j + 2 + e] row g + 8
  float acc[BN / 2];
  // A fragments of the last FR 16-wide steps (FR groups in flight; two at
  // BN = 256, whose 128 accumulators leave fewer registers)
  constexpr int FR = BN == 256 ? 2 : 4;
  uint32_t fr[FR][4];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int nt = u % n_tiles;
    const int n0 = nt * BN, m0 = (u / n_tiles) * kBM;
    if (strip != nt && pending > 0) flush();
    strip = nt;
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;

    // Each 16-wide step is one wgmma group: its fragment is rebuilt once
    // the group FR steps back is complete, so a step's prologue overlaps
    // the FR - 1 groups before it. The chunk before's buffer goes back to
    // the producer once its last step is complete.
    int prev = -1;
    for (int kc = 0; kc < kchunks; ++kc, ++it) {
      const int st = it % stages;
      mbar_wait(full(st), (it / stages) & 1);
      const uint32_t xs = base + st * L.stage;
      const uint32_t wb =
          resident ? base + L.w_res + kc * C::W_STAGE : xs + C::X_STAGE;
      const float* ss = reinterpret_cast<const float*>(smem + L.ss + st * kSS);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t(&f)[4] = fr[ks % FR];
        wgmma_wait<FR - 1>();
        fence_regs(f);
        // the chunk before's last group is complete once FR - 1 of this
        // chunk's are pending
        if (ks == FR - 1 && prev >= 0) warp_release(empty(prev), lane);
        prologue<XT>(f, ks, xs, smem + st * L.stage, ss, c * 64 + warp * 16,
                     lane, relu);
        fence_regs(f);
        fence_regs(acc);
        wgmma_fence();
        wgmma_rs<BN>(acc, f, smem_desc(wb + ks * 16 * 128, kPanel, 1024, 1));
        wgmma_commit();
      }
      prev = st;
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < FR; ++i) fence_regs(fr[i]);
    warp_release(empty(prev), lane);

    // ---- y: bf16, staged swizzled, stored by TMA ----
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    group_sync(c);
    {
      const int lr = warp * 16 + g;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const uint32_t pb = (col >> 6) * kPanel + (col & 63) * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t off = pb + (lr + 8 * h) * 128;
          off ^= ((off >> 7) & 7) << 4;
          *reinterpret_cast<uint32_t*>(smem + (staging - base) + off) =
              pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    group_sync(c);
    if (tid == 0 && m0 + c * 64 < M) {
#pragma unroll
      for (int p = 0; p < C::WP; ++p)
        if (n0 + p * 64 < N)
          tma_store_2d(&ymap, staging + p * kPanel, n0 + p * 64,
                       m0 + c * 64);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }

    // ---- moments of the f32 y over rows below M ----
    // entry i of the lane's CN columns: its sum in acc[sum_at(i)], its sum
    // of squares two places on
    const int row = m0 + c * 64 + warp * 16 + g;
    if (row + 8 >= M) {  // the ragged tile: rows at or past M add nothing
      const bool v0 = row < M;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        acc[4 * j + 2] = acc[4 * j + 3] = 0.f;  // row + 8
        if (!v0) acc[4 * j] = acc[4 * j + 1] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < CN; ++i) {
      const float a = acc[sum_at(i)], b = acc[sum_at(i) + 2];
      acc[sum_at(i)] = a + b;
      acc[sum_at(i) + 2] = fmaf(a, a, b * b);
    }
    // reduce-scatter over the eight lanes of a column group (g): lane g
    // keeps entries g * CN / 8 .. + CN / 8 (g's bits from the first halving
    // down), in entries 0 .. CN / 8
    halve<BN / 2, CN / 2, 16>(acc, lane);
    halve<BN / 2, CN / 4, 8>(acc, lane);
    halve<BN / 2, CN / 8, 4>(acc, lane);
#pragma unroll
    for (int i = 0; i < CN / 8; ++i) {
      rw[i * 32 + lane] += acc[sum_at(i)];
      rw[BN + i * 32 + lane] += acc[sum_at(i) + 2];
    }
    ++pending;
    const int next = u + gridDim.x;
    if (next >= units || next % n_tiles != nt) flush();
  }
  if (pending > 0) flush();
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename XT, int BN>
int launch(const void* x, const void* w, const void* scale,
           const void* shift, void* y, float* col_sum, float* col_sumsq,
           float* slots, int* tickets, int M, int K, int N, int relu,
           int blocks, cudaStream_t stream) {
  using C = Cfg<XT, BN>;
  const int kchunks = (K + kKC - 1) / kKC;
  const bool resident =
      (N + BN - 1) / BN == 1 && kchunks * C::W_STAGE <= kResidentMax;
  const uint32_t fixed = layout<XT, BN>(0, resident ? kchunks : 0).total;
  const uint32_t per_stage = C::X_STAGE + (resident ? 0 : C::W_STAGE) + kSS +
                             16;
  const long long fit = ((long long)kSmemMax - fixed) / per_stage;
  const int stages = fit < kMaxStages ? (int)fit : kMaxStages;
  if (stages < 2) return cudaErrorInvalidValue;
  const Layout l = layout<XT, BN>(stages, resident ? kchunks : 0);

  static int ready[kMaxDevices];  // shared-memory limit raised, per device
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!__atomic_load_n(&ready[dev], __ATOMIC_RELAXED)) {
    if ((err = cudaFuncSetAttribute(
             conv1x1_bn_act_kernel<XT, BN>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax)) !=
        cudaSuccess)
      return err;
    __atomic_store_n(&ready[dev], 1, __ATOMIC_RELAXED);
  }

  if (encoder().err) return encoder().err;
  CUtensorMap maps[5];  // x, w, scale, shift, y
  const CUtensorMapDataType xt = sizeof(XT) == 2
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUresult r;
  if ((r = encode_matrix(&maps[0], xt, const_cast<void*>(x), K, M,
                         (long long)K * sizeof(XT), C::XW, kBM,
                         CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (r = encode_matrix(&maps[1], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         const_cast<void*>(w), N, K, (long long)N * 2, 64,
                         kKC, CU_TENSOR_MAP_SWIZZLE_128B)) ||
      (r = encode_vector(&maps[2], const_cast<void*>(scale), K, kKC)) ||
      (r = encode_vector(&maps[3], const_cast<void*>(shift), K, kKC)) ||
      (r = encode_matrix(&maps[4], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, y, N, M,
                         (long long)N * 2, 64, 64,
                         CU_TENSOR_MAP_SWIZZLE_128B)))
    return -static_cast<int>(r);
  conv1x1_bn_act_kernel<XT, BN><<<blocks, kThreads, l.total, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], col_sum, col_sumsq, slots,
      tickets, M, K, N, relu, stages, resident);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous (M, K), bf16 (x_is_bf16 = 1) or f32; w: contiguous (K, N)
// bf16; scale, shift: (K,) f32; y: (M, N) bf16; col_sum, col_sumsq: (N,)
// f32. Workspaces, zero (the kernel leaves them zero): slots (blocks, 2, N)
// f32 and tickets ceil(N / block_n) int32. K and N multiples of 8, every
// pointer 16-byte aligned, block_n 64, 128 or 256, 1 <= blocks <= the
// number of tiles (ceil(M / 128) * ceil(N / block_n)). Returns 0, a
// cudaError_t, or minus the CUresult of a failed tensor-map encode.
extern "C" int mxt_conv1x1_bn_act(const void* x, const void* w,
                                  const void* scale, const void* shift,
                                  void* y, void* col_sum, void* col_sumsq,
                                  void* slots, void* tickets, int M, int K,
                                  int N, int x_is_bf16, int relu, int block_n,
                                  int blocks, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 ||
      (block_n != 64 && block_n != 128 && block_n != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * ((N + block_n - 1) / block_n);
  if (blocks < 1 || blocks > tiles || tiles > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  float* cs = static_cast<float*>(col_sum);
  float* cq = static_cast<float*>(col_sumsq);
  float* sl = static_cast<float*>(slots);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXT_ARGS \
  x, w, scale, shift, y, cs, cq, sl, tk, M, K, N, relu, blocks, st
  if (x_is_bf16) {
    if (block_n == 256) return launch<__nv_bfloat16, 256>(MXT_ARGS);
    if (block_n == 128) return launch<__nv_bfloat16, 128>(MXT_ARGS);
    return launch<__nv_bfloat16, 64>(MXT_ARGS);
  }
  if (block_n == 256) return launch<float, 256>(MXT_ARGS);
  if (block_n == 128) return launch<float, 128>(MXT_ARGS);
  return launch<float, 64>(MXT_ARGS);
#undef MXT_ARGS
}
