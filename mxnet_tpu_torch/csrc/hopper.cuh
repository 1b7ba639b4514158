// Hopper building blocks shared by the hand-written kernels: the
// flash-attention kernels (flash_attention_fwd.cu, K1; flash_attention_bwd.cu,
// K2 and K3) and the fused 1x1 convolution (fused_conv1x1.cu, K4). PTX
// wrappers for shared-memory addresses, mbarriers, TMA loads and stores (1-,
// 2- and 4-D) and wgmma (descriptors, fences, products with A from shared
// memory or from registers, in bf16 or fp16), and the host's tensor-map
// encoders: 4-D (B, H, S, D) bf16 or fp16 views for K1-K3, plain 2-D
// matrices and 1-D vectors for K4. Everything is inline in an anonymous namespace: each library is one
// translation unit, and ops/_build.py hashes this header with the sources
// that include it, so a change here rebuilds them all.
#pragma once

#include <cuda.h>  // CUtensorMap and the encode's signature; no libcuda link
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
// The 16-bit element types of the tensor-core paths: bf16 and fp16 take the
// same tiles, swizzles and wgmma shapes; only the PTX type and the tensor
// map's data type differ.
template <typename E>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kHalf = false;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Elem<__half> {
  static constexpr bool kHalf = true;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// ---------------------------------------------------------------------------
// PTX wrappers: shared-memory addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory; completion (its bytes)
// is reported to the mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 2-D tensor map (c0 the inner, contiguous coordinate) or of
// a 1-D one into shared memory, completion reported to `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins register operands of an async wgmma in program order: values are
// written before the fence that precedes it, and read after its wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode in bits 62-63 (1 = 128B,
// 2 = 64B). Every tile starts 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

// Two floats rounded to the 16-bit element type E (bf16 or fp16), packed
// in one register: the A fragments of wgmma and the staged outputs.
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (Elem<E>::kHalf) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// K4's bf16 pack.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack2<__nv_bfloat16>(lo, hi);
}

// The two E values of one register as floats.
template <typename E>
__device__ __forceinline__ float2 unpack2(uint32_t x) {
  if constexpr (Elem<E>::kHalf)
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// The products below take E = __nv_bfloat16 (the default: K4 is bf16 only)
// or __half: one PTX text each (a macro of the type's name), instantiated
// as .f32.bf16.bf16 or .f32.f16.f16 by `if constexpr`.

// d (64 x 128, f32) = or += A (64 x 16, K-major) B^T (128 x 16, K-major),
// both read from shared memory through descriptors
#define MXT_WGMMA_SS_N128(TY)                                        \
  asm volatile(                                                      \
        "{\n.reg .pred p;\n"                                         \
        "setp.ne.b32 p, %66, 0;\n"                                   \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
        "{%0, %1, %2, %3, %4, %5, %6, %7, "                          \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                     \
        "%16, %17, %18, %19, %20, %21, %22, %23, "                   \
        "%24, %25, %26, %27, %28, %29, %30, %31, "                   \
        "%32, %33, %34, %35, %36, %37, %38, %39, "                   \
        "%40, %41, %42, %43, %44, %45, %46, %47, "                   \
        "%48, %49, %50, %51, %52, %53, %54, %55, "                   \
        "%56, %57, %58, %59, %60, %61, %62, %63}, "                  \
        "%64, %65, p, 1, 1, 0, 0;\n}\n"                              \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),            \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),            \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),          \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),        \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),        \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),        \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),        \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),        \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),        \
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),        \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),        \
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),        \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),        \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])         \
        : "l"(da), "l"(db), "r"(accumulate))
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  if constexpr (Elem<E>::kHalf)
    MXT_WGMMA_SS_N128("f16");
  else
    MXT_WGMMA_SS_N128("bf16");
}

// d (64 x 32, f32) += A (64 x 16, E in registers) B (16 x 32),
// B read from shared memory N-major (transposed) through a descriptor
#define MXT_WGMMA_RS_N32(TY)                                            \
  asm volatile(                                                         \
        "{\n.reg .pred p;\n"                                            \
        "setp.ne.b32 p, %21, 0;\n"                                      \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "     \
        "{%0, %1, %2, %3, %4, %5, %6, %7, "                             \
        "%8, %9, %10, %11, %12, %13, %14, %15}, "                       \
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                   \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),               \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),               \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),             \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])            \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  if constexpr (Elem<E>::kHalf)
    MXT_WGMMA_RS_N32("f16");
  else
    MXT_WGMMA_RS_N32("bf16");
}

// d (64 x 64, f32) += A (64 x 16, E in registers) B (16 x 64),
// B read from shared memory N-major (transposed) through a descriptor
#define MXT_WGMMA_RS_N64(TY)                                            \
  asm volatile(                                                         \
        "{\n.reg .pred p;\n"                                            \
        "setp.ne.b32 p, %37, 0;\n"                                      \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "     \
        "{%0, %1, %2, %3, %4, %5, %6, %7, "                             \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                        \
        "%16, %17, %18, %19, %20, %21, %22, %23, "                      \
        "%24, %25, %26, %27, %28, %29, %30, %31}, "                     \
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                   \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),               \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),               \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),             \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),           \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),           \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),           \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])            \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  if constexpr (Elem<E>::kHalf)
    MXT_WGMMA_RS_N64("f16");
  else
    MXT_WGMMA_RS_N64("bf16");
}

// d (64 x 128, f32) += A (64 x 16, E in registers) B (16 x 128),
// B read from shared memory N-major (transposed) through a descriptor
#define MXT_WGMMA_RS_N128(TY)                                           \
  asm volatile(                                                         \
        "{\n.reg .pred p;\n"                                            \
        "setp.ne.b32 p, %69, 0;\n"                                      \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "    \
        "{%0, %1, %2, %3, %4, %5, %6, %7, "                             \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                        \
        "%16, %17, %18, %19, %20, %21, %22, %23, "                      \
        "%24, %25, %26, %27, %28, %29, %30, %31, "                      \
        "%32, %33, %34, %35, %36, %37, %38, %39, "                      \
        "%40, %41, %42, %43, %44, %45, %46, %47, "                      \
        "%48, %49, %50, %51, %52, %53, %54, %55, "                      \
        "%56, %57, %58, %59, %60, %61, %62, %63}, "                     \
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                   \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),               \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),               \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),             \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),           \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),           \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),           \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),           \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),           \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),           \
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),           \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),           \
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),           \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])            \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (Elem<E>::kHalf)
    MXT_WGMMA_RS_N128("f16");
  else
    MXT_WGMMA_RS_N128("bf16");
}

// d (64 x 256, f32) += A (64 x 16, E in registers) B (16 x 256),
// B read from shared memory N-major (transposed) through a descriptor
#define MXT_WGMMA_RS_N256(TY)                                           \
  asm volatile(                                                         \
        "{\n.reg .pred p;\n"                                            \
        "setp.ne.b32 p, %133, 0;\n"                                     \
        "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "    \
        "{%0, %1, %2, %3, %4, %5, %6, %7, "                             \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                        \
        "%16, %17, %18, %19, %20, %21, %22, %23, "                      \
        "%24, %25, %26, %27, %28, %29, %30, %31, "                      \
        "%32, %33, %34, %35, %36, %37, %38, %39, "                      \
        "%40, %41, %42, %43, %44, %45, %46, %47, "                      \
        "%48, %49, %50, %51, %52, %53, %54, %55, "                      \
        "%56, %57, %58, %59, %60, %61, %62, %63, "                      \
        "%64, %65, %66, %67, %68, %69, %70, %71, "                      \
        "%72, %73, %74, %75, %76, %77, %78, %79, "                      \
        "%80, %81, %82, %83, %84, %85, %86, %87, "                      \
        "%88, %89, %90, %91, %92, %93, %94, %95, "                      \
        "%96, %97, %98, %99, %100, %101, %102, %103, "                  \
        "%104, %105, %106, %107, %108, %109, %110, %111, "              \
        "%112, %113, %114, %115, %116, %117, %118, %119, "              \
        "%120, %121, %122, %123, %124, %125, %126, %127}, "             \
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"              \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),               \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),               \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),             \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),           \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),           \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),           \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),           \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),           \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),           \
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),           \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),           \
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),           \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),           \
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),           \
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),           \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),           \
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),           \
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),           \
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),           \
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),           \
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),           \
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),           \
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),       \
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),       \
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),       \
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),       \
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),       \
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),       \
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])        \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (Elem<E>::kHalf)
    MXT_WGMMA_RS_N256("f16");
  else
    MXT_WGMMA_RS_N256("bf16");
}

// d (64 x 64, f32) = or += A (64 x 16, K-major) B^T (64 x 16, K-major),
// both read from shared memory through descriptors
#define MXT_WGMMA_SS_N64(TY)                                        \
  asm volatile(                                                     \
        "{\n.reg .pred p;\n"                                        \
        "setp.ne.b32 p, %34, 0;\n"                                  \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
        "{%0, %1, %2, %3, %4, %5, %6, %7, "                         \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                    \
        "%16, %17, %18, %19, %20, %21, %22, %23, "                  \
        "%24, %25, %26, %27, %28, %29, %30, %31}, "                 \
        "%32, %33, p, 1, 1, 0, 0;\n}\n"                             \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),           \
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),           \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),         \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),       \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),       \
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])        \
        : "l"(da), "l"(db), "r"(accumulate))
template <typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (Elem<E>::kHalf)
    MXT_WGMMA_SS_N64("f16");
  else
    MXT_WGMMA_SS_N64("bf16");
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
// The element type code of the flash-attention C entries (`dtype`), as the
// wrapper's _DTYPES in ops/cuda/flash_attention.py gives it.
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBf16 = 1;
constexpr int kDtypeF16 = 2;

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, looked up once; `err` is the
// lookup's cudaError_t.
struct Encoder {
  EncodeTiled fn;
  int err;
};

const Encoder& encoder() {
  static const Encoder e = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err == cudaSuccess &&
        (found != cudaDriverEntryPointSuccess || fn == nullptr))
      err = cudaErrorSymbolNotFound;
    return Encoder{reinterpret_cast<EncodeTiled>(fn), static_cast<int>(err)};
  }();
  return e;
}

// The 4-D tensor map of one (B, H, S, D) view `t` of 16-bit elements (`type`
// bf16 or fp16) = {address, S, H and B strides in bytes}: dimensions (D, S,
// H, B), box `cols` x `rows` rows of S. The strides need not increase with
// the dimension (a split QKV view's S stride is larger than its H stride).
CUresult encode_map(CUtensorMap* map, CUtensorMapDataType type,
                    const long long* t, int B, int H, int S, int D, int cols,
                    int rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t gdim[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t gstride[3] = {(cuuint64_t)t[1], (cuuint64_t)t[2],
                                 (cuuint64_t)t[3]};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return encoder().fn(map, type, 4,
                      reinterpret_cast<void*>(t[0]), gdim, gstride, box,
                      estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The 2-D tensor map of a row-major matrix at `ptr`: `rows` rows of `cols`
// elements of `type` (bf16 or f32), `row_bytes` apart (a multiple of 16);
// boxes of `box_cols` x `box_rows`. Boxes past the edge read zeros and
// store nothing there.
inline CUresult encode_matrix(CUtensorMap* map, CUtensorMapDataType type,
                              void* ptr, long long cols, long long rows,
                              long long row_bytes, int box_cols,
                              int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t gdim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t gstride[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  return encoder().fn(map, type, 2, ptr, gdim, gstride, box, estride,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The 1-D tensor map of `n` f32 values at `ptr`, boxes of `box`; past `n` a
// box reads zeros.
inline CUresult encode_vector(CUtensorMap* map, void* ptr, long long n,
                              int box) {
  const cuuint64_t gdim[1] = {(cuuint64_t)n};
  const cuuint64_t gstride[1] = {(cuuint64_t)n * 4};  // rank 1: unread
  const cuuint32_t boxd[1] = {(cuuint32_t)box};
  const cuuint32_t estride[1] = {1};
  return encoder().fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, ptr, gdim,
                      gstride, boxd, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_NONE,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
