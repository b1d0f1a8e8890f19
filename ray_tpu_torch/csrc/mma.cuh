// Tensor-core helpers for the port's CUDA kernels on Hopper (sm_90a):
// warpgroup products (wgmma) with bf16 / f16 inputs and f32 accumulators,
// the shared-memory tile layout wgmma reads, cp.async copies that fill it,
// and the register repacking that turns an f32 accumulator into the A
// operand of the next product.
//
// A warpgroup is four consecutive warps (128 threads); one wgmma m64nNk16
// computes a 64 x N tile. Warp w of the warpgroup holds rows 16w .. 16w+15
// of the accumulator; with lane = 4 * g + t (g = lane / 4 in 0..7, t =
// lane % 4 in 0..3), each 8-column block j of them sits in d[j][0..3]:
//   d[j][0], d[j][1]: row 16w + g,     columns 8j + 2t, 8j + 2t + 1;
//   d[j][2], d[j][3]: row 16w + g + 8, the same columns.
// An A operand from registers (64 x 16) has the warp's 16 rows in four
// 32-bit registers of two 16-bit values each, the lower column in the low
// half:
//   a[0] (row g, cols 2t, 2t+1)    a[1] (row g+8, cols 2t, 2t+1)
//   a[2] (row g, cols 2t+8, 2t+9)  a[3] (row g+8, cols 2t+8, 2t+9).
// So the accumulators of two adjacent 8-column blocks, rounded and packed,
// are exactly the A operand of the next product over those 16 columns
// (acc_to_a): FlashAttention-2's way of keeping P in registers.
#pragma once

#include "common.cuh"

namespace mma {

// wgmma's K-major swizzled layout of a tile of 64 rows of D 16-bit values:
// panels of P = min(D, 64) columns, each 64 rows of P * 2 bytes, with
// 16-byte chunks XOR-swizzled as wgmma's 128-byte (P = 64) or 64-byte
// (P = 32) swizzle reads them, so that its reads are free of bank
// conflicts. A tile must start at a multiple of 1024 bytes. The same bytes
// serve as an MN-major operand (rows along k): the transposed B of a
// product with the tile itself.
template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "rows of 32, 64 or 128 16-bit values");
  static constexpr int P = D < 64 ? D : 64;
  static constexpr int PANEL = 64 * P * 2;
  static constexpr int BYTES = 64 * D * 2;
  static constexpr uint64_t SWIZZLE = P == 64 ? 1 : 2;  // 128-byte : 64-byte

  // byte offset of chunk c (8 values) of row r
  __device__ __forceinline__ static uint32_t off(int r, int c) {
    constexpr int CPP = P / 8;  // chunks per panel row
    const int x = P == 64 ? (r & 7) : ((r >> 1) & 3);
    return (uint32_t)((c / CPP) * PANEL + r * P * 2 + (((c % CPP) ^ x) * 16));
  }

  // wgmma's matrix descriptor: start address, leading and stride byte
  // offsets (each in 16-byte units) and the swizzle mode
  __device__ __forceinline__ static uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32) | (SWIZZLE << 62);
  }
  // columns k0 .. k0+15 of all 64 rows, K-major: 8-row groups 8 P 2 bytes
  // apart (the leading offset is unused by swizzled K-major layouts)
  __device__ __forceinline__ static uint64_t k_major(uint32_t tile, int k0) {
    return desc(tile + (k0 / P) * PANEL + (k0 % P) * 2, 16, 8 * P * 2);
  }
  // rows k0 .. k0+15, all D columns, MN-major: P-column groups a panel
  // apart, 8-row groups 8 P 2 bytes apart
  __device__ __forceinline__ static uint64_t mn_major(uint32_t tile, int k0) {
    return desc(tile + k0 * P * 2, PANEL, 8 * P * 2);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, or 4 zero bytes when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two f32 values rounded to T (to nearest even), lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A operand (16 rows x 16 k per warp) made of the f32 accumulators of
// 8-column blocks 2j and 2j+1, rounded to T.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
}

// Before the first wgmma that reads registers written by other instructions.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of wgmma are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Make shared-memory writes of the generic proxy (cp.async, stores) visible
// to wgmma's reads; each writer fences before the barrier that publishes.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// an asynchronous product (before its issue and after its wait).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// The products, one k16 step each, accumulating (scale-d is 1):
//   ss_n64: d[8][4] += A B, A (64 x 16) and B (16 x 64) both K-major in
//           shared memory;
//   rs:     d[N/8][4] += A B, A (64 x 16) in registers, B (16 x N, N = 32,
//           64 or 128) MN-major (transposed) in shared memory.
template <typename T>
struct Wgmma;

#define RT_D8(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define RT_D16 RT_D8(0), RT_D8(1), RT_D8(2), RT_D8(3)
#define RT_D32 RT_D16, RT_D8(4), RT_D8(5), RT_D8(6), RT_D8(7)
#define RT_D64 \
  RT_D32, RT_D8(8), RT_D8(9), RT_D8(10), RT_D8(11), RT_D8(12), RT_D8(13), RT_D8(14), RT_D8(15)
#define RT_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define RT_R32 \
  RT_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define RT_R64                                                                               \
  RT_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
         "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
// scale-d is a predicate operand: set from an input register that is 1
#define RT_SCALE_D(n) "{\n.reg .pred p;\nsetp.ne.b32 p, %" #n ", 0;\n"

#define RT_WGMMA_TYPE(CT, PT)                                                                 \
  template <>                                                                                 \
  struct Wgmma<CT> {                                                                          \
    __device__ __forceinline__ static void ss_n64(float (&d)[8][4], uint64_t da,              \
                                                  uint64_t db) {                              \
      asm volatile(RT_SCALE_D(34) "wgmma.mma_async.sync.aligned.m64n64k16.f32." PT "." PT    \
                                  " {" RT_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"             \
                   : RT_D32                                                                   \
                   : "l"(da), "l"(db), "r"(1));                                               \
    }                                                                                         \
    __device__ __forceinline__ static void rs(float (&d)[4][4], const uint32_t (&a)[4],      \
                                              uint64_t db) {                                  \
      asm volatile(RT_SCALE_D(21) "wgmma.mma_async.sync.aligned.m64n32k16.f32." PT "." PT    \
                                  " {" RT_R16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
                   : RT_D16                                                                   \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));            \
    }                                                                                         \
    __device__ __forceinline__ static void rs(float (&d)[8][4], const uint32_t (&a)[4],      \
                                              uint64_t db) {                                  \
      asm volatile(RT_SCALE_D(37) "wgmma.mma_async.sync.aligned.m64n64k16.f32." PT "." PT    \
                                  " {" RT_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
                   : RT_D32                                                                   \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));            \
    }                                                                                         \
    __device__ __forceinline__ static void rs(float (&d)[16][4], const uint32_t (&a)[4],     \
                                              uint64_t db) {                                  \
      asm volatile(RT_SCALE_D(69) "wgmma.mma_async.sync.aligned.m64n128k16.f32." PT "." PT   \
                                  " {" RT_R64 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
                   : RT_D64                                                                   \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));            \
    }                                                                                         \
  };

RT_WGMMA_TYPE(__nv_bfloat16, "bf16")
RT_WGMMA_TYPE(__half, "f16")

#undef RT_WGMMA_TYPE
#undef RT_SCALE_D
#undef RT_R64
#undef RT_R32
#undef RT_R16
#undef RT_D64
#undef RT_D32
#undef RT_D16
#undef RT_D8

}  // namespace mma
