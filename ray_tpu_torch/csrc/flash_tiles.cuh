// The tile schedule that the tensor-core flash-attention kernels share
// (the forward in flash_attention.cu, dQ and dK/dV in flash_attention_bwd.cu):
// one warpgroup (128 threads) per block over 64-row tiles of 16-bit values
// in wgmma's swizzled layout (mma::Tile), filled with cp.async, multiplied
// with wgmma, and the f32 accumulators rounded back through a tile to
// device memory in 16-byte rows.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace flash {

constexpr int ROWS = 64;          // rows of every tile (q rows or keys)
constexpr int TC_THREADS = 128;   // one warpgroup: 4 warps x 16 rows of a tile
constexpr float NEG = -1e30f;     // masked score: finite, as the TPU kernels use
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
using Tile = mma::Tile<D>;

// Start copying rows r0 .. r0+63 of a (n, D) tensor into a tile; rows at or
// past n are zero-filled and not read.
template <typename T, int D>
__device__ __forceinline__ void stage_async(uint32_t tile, const T* src, int r0, int n, int tid) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int j = 0; j < ROWS * CPR / TC_THREADS; ++j) {
    const int i = tid + j * TC_THREADS;
    const int r = i / CPR, c = i % CPR;
    const bool in = r0 + r < n;
    mma::cp_async16(tile + Tile<D>::off(r, c), src + (in ? (int64_t)(r0 + r) * D + c * 8 : 0),
                    in);
  }
}

// Wait for this thread's copies, make them visible to wgmma, and publish
// them to the block; also the barrier after which every warp is done with
// the tiles it read before.
__device__ __forceinline__ void tiles_ready() {
  mma::cp_async_wait<0>();
  mma::fence_async_shared();
  __syncthreads();
}

// Round a warp's 16 x D f32 accumulator to T into its 16 rows of a tile
// (the caller synchronises before the tile is read back).
template <typename T, int D>
__device__ __forceinline__ void acc_to_tile(unsigned char* tile, const float (&acc)[D / 8][4],
                                            int lane) {
  const int row = (threadIdx.x >> 5) * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + Tile<D>::off(row + 8 * h, j) + 4 * t) =
          mma::pack2<T>(acc[j][2 * h], acc[j][2 * h + 1]);
}

// Store rows r < 64 with r0 + r < n of a tile to a (n, D) tensor.
template <int D>
__device__ __forceinline__ void tile_to_global(void* dst, const unsigned char* tile, int r0, int n,
                                               int tid) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int j = 0; j < ROWS * CPR / TC_THREADS; ++j) {
    const int i = tid + j * TC_THREADS;
    const int r = i / CPR, c = i % CPR;
    if (r0 + r < n)
      reinterpret_cast<uint4*>(dst)[(int64_t)(r0 + r) * CPR + c] =
          *reinterpret_cast<const uint4*>(tile + Tile<D>::off(r, c));
  }
}

// Issue s = X Y^T over D for the 64-row tiles X and Y (a 64 x 64 score
// tile) as wgmma; the caller commits and waits.
template <typename T, int D>
__device__ __forceinline__ void issue_scores(float (&s)[8][4], uint32_t xs, uint32_t ys) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  mma::fence_acc(s);
  mma::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma::Wgmma<T>::ss_n64(s, Tile<D>::k_major(xs, kk * 16), Tile<D>::k_major(ys, kk * 16));
}

// Issue acc += W Z over the tile's 64 rows as wgmma, for W a 64 x 64 f32
// score tile in registers (rounded to T into a, which must stay untouched
// until the wait) and Z a 64 x D tile read transposed; the caller commits
// and waits.
template <typename T, int D>
__device__ __forceinline__ void issue_accumulate(float (&acc)[D / 8][4], uint32_t (&a)[4][4],
                                                 const float (&w)[8][4], uint32_t zs) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma::acc_to_a<T>(a[kk], w[2 * kk], w[2 * kk + 1]);
  mma::fence_acc(acc);
  mma::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma::Wgmma<T>::rs(acc, a[kk], Tile<D>::mn_major(zs, kk * 16));
}

// Commit the issued products and wait for them, after which acc may be read.
template <int N>
__device__ __forceinline__ void finish(float (&acc)[N][4]) {
  mma::wgmma_commit();
  mma::wgmma_wait<0>();
  mma::fence_acc(acc);
}

// Raise the kernel's dynamic shared-memory limit to `smem` and ask for the
// largest carveout, so that two tensor-core blocks fit on an SM.
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

}  // namespace flash
