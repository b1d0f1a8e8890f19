// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV.
//
// Replaces the two Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   * `_bwd_dq_kernel` (launched by `flash_bwd_dq`) -> flash_bwd_dq_kernel:
//     dQ = sum_k dS K, one block per (bh, 64-row q tile);
//   * `_bwd_dkv_kernel` (launched by `flash_bwd_dkv`) -> flash_bwd_dkv_kernel:
//     dV = sum_q P^T dO and dK = sum_q dS^T Q, one block per (bh, 64-key tile).
// Both recompute P = exp(S - lse) from the forward's saved log-sum-exp, with
// S = Q K^T * scale, dP = dO V^T and dS = P (dP - delta) * scale, where
// delta = rowsum(dO * O). As in the reference, the work is split into two
// kernels so that every output row is owned by exactly one block: no atomics,
// and the result is the same from run to run.
//
// Semantics held to the TPU kernels':
//   * causal masking is top-left aligned, q_pos >= k_pos, for any sq and sk;
//   * masked scores are set to the finite -1e30 before exp(s - lse) (-inf would
//     give NaN where lse is itself -1e30);
//   * K/V rows past sk are zero and masked; Q, dO, lse and delta rows past sq
//     are treated as zero and never read out of bounds;
//   * all products and sums in f32; each output is rounded once to its dtype.
//   * causal tile skipping: dQ stops at the diagonal k tile (the reference's
//     pl.when), dK/dV starts at the first q tile on or below the diagonal (its
//     pl.when together with the q_index clamp).
//
// Bound on the H100: operations. At the Llama-2-7B training call
// (bh = 64, s = 2048, d = 128, causal, bf16) the reference's count is 6d
// FLOPs per visible (q, k) pair for dQ and 8d for dK/dV: 1.03e11 and 1.38e11
// FLOPs, 0.104 ms and 0.139 ms on the tensor cores' 989 TFLOP/s, against
// 169 MB and 202 MB of bytes (0.050 ms and 0.060 ms at 3.35 TB/s).
//
// Two designs, picked by dtype behind the same C entries:
//
// bf16 and f16: the tensor-core kernels (flash_bwd_dq_tc_kernel,
// flash_bwd_dkv_tc_kernel). One warpgroup (four warps) per block and
// 64-row tile (q rows for dQ, keys for dK/dV); warp w holds rows 16w ..
// 16w+15 of every accumulator. Every product is a warpgroup MMA (wgmma
// m64nNk16, 16-bit inputs, f32 accumulators; mma.cuh), which reads its
// shared-memory operands once for the four warps:
//   dQ:     S = Q K^T, dP = dO V^T (both operands in shared memory),
//           dQ += dS K (dS from registers, K read transposed);
//   dK/dV:  S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q.
// P and dS are computed in f32 from the S and dP accumulators and rounded to
// the input dtype as the register A operand of the next product: they never
// leave the registers (FlashAttention-2's scheme). That rounding is the one
// numerical difference from the f32 plain version; the plain version with
// round_ps=True repeats it. Tiles are staged in the input dtype, in wgmma's
// swizzled layout (free of bank conflicts; the same bytes serve K-major and
// transposed reads): the block's resident tiles (Q and dO for dQ, K and V
// for dK/dV) once, the streamed tiles double-buffered with cp.async so that
// the next tile loads while this one computes; dQ issues S and dP as one
// group of products. lse and delta are per q row: dQ keeps its
// rows' values in registers, dK/dV streams them beside Q and dO and reads
// the values of the accumulator columns each thread holds. Under causal
// masking the blocks with the most tiles get the lowest blockIdx: dQ walks
// its q tiles in reverse, dK/dV's key tile 0 already has the most q tiles.
// The accumulators stay in registers (d/8 column blocks x 4 f32 per thread
// each). A first design on mma.sync m16n8k16 fed by ldmatrix, with the same
// tiling, ran 1.6x (dQ) and 1.7x (dK/dV) slower at the training call: each
// warp read the whole streamed tile through ldmatrix, four times per block.
//
// f32: the first version's CUDA-core kernels (flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel), which keep every product in f32 FMAs: the block's
// resident tiles and the streamed tiles are staged in shared memory as f32
// (rows padded by one word
// so the access patterns below hit distinct banks), S and dP live in
// registers, P and dS pass through one shared tile each to be re-read along
// the other axis, and the f32 accumulators live in registers.
//
// Shared memory at d = 32 / 64 / 128:
//   tensor cores, 64 x d tiles of 16-bit values (4 / 8 / 16 KB):
//     dQ:     Q, dO + two buffers of K, V = 6 tiles: 24 / 48 / 96 KB;
//     dK/dV:  K, V + two buffers of Q, dO = 6 tiles, + two buffers of lse,
//             delta (1 KB): 25 / 49 / 97 KB;
//     two blocks of either fit on an SM (228 KB);
//   f32, 64 x 64 tiles:
//     dQ:     Q, dO, K, V (64 x (d+1) each) + dS (64 x 65) + lse, delta (64 each)
//             = 4 * (4 * 64 * (d+1) + 64 * 65 + 128) bytes: 51 / 84 / 149 KB;
//     dK/dV:  K, V, Q, dO (64 x (d+1) each) + P, dS (64 x 65 each) + lse, delta
//             = 4 * (4 * 64 * (d+1) + 2 * 64 * 65 + 128) bytes: 68 / 100 / 166 KB.
// All above 48 KB go through cudaFuncAttributeMaxDynamicSharedMemorySize and
// stay under the 227 KB a block may use. The f32 accumulators are registers:
// 4 rows x d/8 columns per thread for dQ (128 threads), 2 rows x d/8 columns
// each of dK and dV per thread for dK/dV (256 threads).

#include <type_traits>

#include "common.cuh"
#include "flash_tiles.cuh"

namespace {

using namespace flash;  // NEG, LOG2E, TC_THREADS, Tile and the tile helpers

constexpr int BQ = ROWS;  // q rows per tile
constexpr int BK = ROWS;  // keys per tile
constexpr int LDS = 65;  // padded row of a 64-wide score tile

constexpr int DQ_THREADS = 128;   // 16 row groups of 4 q rows x 8 column lanes
constexpr int DKV_THREADS = 256;  // 32 row groups of 2 keys x 8 column lanes

__host__ __device__ constexpr size_t dq_smem_bytes(int d) {
  return sizeof(float) * (size_t)(2 * BQ * (d + 1) + 2 * BK * (d + 1) + BQ * LDS + 2 * BQ);
}

__host__ __device__ constexpr size_t dkv_smem_bytes(int d) {
  return sizeof(float) * (size_t)(2 * BK * (d + 1) + 2 * BQ * (d + 1) + 2 * BK * LDS + 2 * BQ);
}

// Stage `rows` rows of a (n, D) tensor starting at row r0 into an f32 tile
// with row stride D + 1; rows at or past n are zero.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0, int n, int rows,
                                           int tid, int nthreads) {
  constexpr int N = Pack<T>::N;
  constexpr int VPR = D / N;
  for (int i = tid; i < rows * VPR; i += nthreads) {
    const int r = i / VPR, c = (i % VPR) * N;
    float f[N];
    if (r0 + r < n) {
      load16(src + (int64_t)(r0 + r) * D + c, f);
    } else {
#pragma unroll
      for (int m = 0; m < N; ++m) f[m] = 0.f;
    }
#pragma unroll
    for (int m = 0; m < N; ++m) dst[r * (D + 1) + c + m] = f[m];
  }
}

// Store rows r < rows with r0 + r < n of an f32 tile (row stride D + 1) to a
// (n, D) tensor, rounded once.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, const float* src, int r0, int n, int rows,
                                           int tid, int nthreads) {
  constexpr int N = Pack<T>::N;
  constexpr int VPR = D / N;
  for (int i = tid; i < rows * VPR; i += nthreads) {
    const int r = i / VPR, c = (i % VPR) * N;
    if (r0 + r >= n) continue;
    float f[N];
#pragma unroll
    for (int m = 0; m < N; ++m) f[m] = src[r * (D + 1) + c + m];
    store16(dst + (int64_t)(r0 + r) * D + c, f);
  }
}

// K3. Thread (tr, tc) = (tid / 8, tid % 8) owns q rows tr*4 .. tr*4+3 of the
// tile, score columns tc + 8*j (j < 8) and dQ columns tc + 8*j (j < D/8).
template <typename T, int D>
__global__ void __launch_bounds__(DQ_THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int sq, int sk, float sm_scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x LD, later the dQ staging tile
  float* Os = Qs + BQ * LD;    // BQ x LD: dO
  float* Ks = Os + BQ * LD;    // BK x LD
  float* Vs = Ks + BK * LD;    // BK x LD
  float* Ds = Vs + BK * LD;    // BQ x LDS: dS
  float* Ls = Ds + BQ * LDS;   // BQ: lse
  float* Dl = Ls + BQ;         // BQ: delta

  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;

  stage_rows<T, D>(Qs, q + bh * sq * D, q0, sq, BQ, tid, DQ_THREADS);
  stage_rows<T, D>(Os, dout + bh * sq * D, q0, sq, BQ, tid, DQ_THREADS);
  for (int r = tid; r < BQ; r += DQ_THREADS) {
    const bool in = q0 + r < sq;
    Ls[r] = in ? lse[bh * sq + q0 + r] : 0.f;
    Dl[r] = in ? delta[bh * sq + q0 + r] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int n_tiles = (sk + BK - 1) / BK;
  if (causal) {
    // stop at the diagonal: a tile runs iff its first key is at or before
    // the q tile's last row
    const int last = (q0 + BQ - 1) / BK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ds are done
    stage_rows<T, D>(Ks, k + bh * sk * D, k0, sk, BK, tid, DQ_THREADS);
    stage_rows<T, D>(Vs, v + bh * sk * D, k0, sk, BK, tid, DQ_THREADS);
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 1  // 64 FMAs a step already; unrolling would cost registers
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], ov[4], kv[8], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(tr * 4 + i) * LD + dd];
        ov[i] = Os[(tr * 4 + i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kv[j] = Ks[(tc + 8 * j) * LD + dd];
        vv[j] = Vs[(tc + 8 * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const int qp = q0 + r;
      const float l = Ls[r], dl = Dl[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tc + 8 * j;
        const bool valid = kp < sk && qp < sq && (!causal || qp >= kp);
        const float p = expf((valid ? s[i][j] * sm_scale : NEG) - l);
        Ds[r * LDS + tc + 8 * j] = p * (dp[i][j] - dl) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = Ds[(tr * 4 + i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = Ks[c * LD + tc + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }

  __syncthreads();  // every reader of Qs is done: reuse it to stage dQ
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) Qs[(tr * 4 + i) * LD + tc + 8 * j] = acc[i][j];
  __syncthreads();
  store_rows<T, D>(dq + bh * sq * D, Qs, q0, sq, BQ, tid, DQ_THREADS);
}

// K4. Thread (tr, tc) = (tid / 8, tid % 8) owns keys tr*2, tr*2+1 of the
// tile, score columns (q rows) tc + 8*j (j < 8) and dK/dV columns tc + 8*j
// (j < D/8).
template <typename T, int D>
__global__ void __launch_bounds__(DKV_THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
                         float sm_scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* Ks = smem;            // BK x LD, later the dK staging tile
  float* Vs = Ks + BK * LD;    // BK x LD, later the dV staging tile
  float* Qs = Vs + BK * LD;    // BQ x LD
  float* Os = Qs + BQ * LD;    // BQ x LD: dO
  float* Ps = Os + BQ * LD;    // BK x LDS: P^T
  float* Ds = Ps + BK * LDS;   // BK x LDS: dS^T
  float* Ls = Ds + BK * LDS;   // BQ: lse
  float* Dl = Ls + BQ;         // BQ: delta

  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;

  stage_rows<T, D>(Ks, k + bh * sk * D, k0, sk, BK, tid, DKV_THREADS);
  stage_rows<T, D>(Vs, v + bh * sk * D, k0, sk, BK, tid, DKV_THREADS);

  float dka[2][DJ], dva[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  const int n_q = (sq + BQ - 1) / BQ;
  // start at the first q tile whose last row is on or below the tile's first
  // key; with no such tile (keys past every query) dK = dV = 0
  const int first = causal ? k0 / BQ : 0;

  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers of Qs, Os, Ps, Ds are done
    stage_rows<T, D>(Qs, q + bh * sq * D, q0, sq, BQ, tid, DKV_THREADS);
    stage_rows<T, D>(Os, dout + bh * sq * D, q0, sq, BQ, tid, DKV_THREADS);
    for (int r = tid; r < BQ; r += DKV_THREADS) {
      const bool in = q0 + r < sq;
      Ls[r] = in ? lse[bh * sq + q0 + r] : 0.f;
      Dl[r] = in ? delta[bh * sq + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[2][8], dp[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < D; ++dd) {
      float kv[2], vv[2], qv[8], ov[8];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        kv[i] = Ks[(tr * 2 + i) * LD + dd];
        vv[i] = Vs[(tr * 2 + i) * LD + dd];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qv[j] = Qs[(tc + 8 * j) * LD + dd];
        ov[j] = Os[(tc + 8 * j) * LD + dd];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = tr * 2 + i;
      const int kp = k0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tc + 8 * j;
        const int qp = q0 + c;
        const bool valid = kp < sk && qp < sq && (!causal || qp >= kp);
        const float p = expf((valid ? s[i][j] * sm_scale : NEG) - Ls[c]);
        Ps[r * LDS + c] = p;
        Ds[r * LDS + c] = p * (dp[i][j] - Dl[c]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float pv[2], dsv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pv[i] = Ps[(tr * 2 + i) * LDS + c];
        dsv[i] = Ds[(tr * 2 + i) * LDS + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float o = Os[c * LD + tc + 8 * j];
        const float qq = Qs[c * LD + tc + 8 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dva[i][j] = fmaf(pv[i], o, dva[i][j]);
          dka[i][j] = fmaf(dsv[i], qq, dka[i][j]);
        }
      }
    }
  }

  __syncthreads();  // every reader of Ks, Vs (and their loads) is done
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      Ks[(tr * 2 + i) * LD + tc + 8 * j] = dka[i][j];
      Vs[(tr * 2 + i) * LD + tc + 8 * j] = dva[i][j];
    }
  __syncthreads();
  store_rows<T, D>(dk + bh * sk * D, Ks, k0, sk, BK, tid, DKV_THREADS);
  store_rows<T, D>(dv + bh * sk * D, Vs, k0, sk, BK, tid, DKV_THREADS);
}

// ---------------------------------------------------------------------------
// The tensor-core kernels (bf16, f16)
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_tc_smem_bytes() {
  return 6 * (size_t)Tile<D>::BYTES;
}

template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  return 6 * (size_t)Tile<D>::BYTES + 4 * BQ * sizeof(float);
}

// K3 on the tensor cores. Block (bh, 64-row q tile); warp w owns q rows
// w*16 .. w*16+15 of the tile. Thread (g, t) = (lane / 4, lane % 4) holds,
// in each 16 x 8 accumulator block, rows g and g+8 and columns 2t, 2t+1.
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
    flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dq, int sq, int sk, float sm_scale, int causal) {
  constexpr int TILE = Tile<D>::BYTES;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t Qs = mma::smem_addr(tc_smem);
  const uint32_t Os = Qs + TILE;
  const uint32_t KV0 = Qs + 2 * TILE;  // buffer b: K at KV0 + 2b TILE, V one TILE on

  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest q tiles first
  const int tid = threadIdx.x, lane = tid & 31, row0 = (tid >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;

  int n_tiles = (sk + BK - 1) / BK;
  if (causal) {
    // stop at the diagonal: a tile runs iff its first key is at or before
    // the q tile's last row
    const int last = (q0 + BQ - 1) / BK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  stage_async<T, D>(Qs, q + bh * sq * D, q0, sq, tid);
  stage_async<T, D>(Os, dout + bh * sq * D, q0, sq, tid);
  stage_async<T, D>(KV0, kb, 0, sk, tid);
  stage_async<T, D>(KV0 + TILE, vb, 0, sk, tid);
  mma::cp_async_commit();

  // lse (times log2 e) and delta of this thread's rows g and g+8; rows past
  // sq are never read
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + row0 + g + 8 * h;
    lse2[h] = r < sq ? lse[bh * sq + r] * LOG2E : 0.f;
    dl[h] = r < sq ? delta[bh * sq + r] : 0.f;
  }
  const float scale2 = sm_scale * LOG2E;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    tiles_ready();  // tile kt is in; every warp is done with tile kt-1's buffer
    if (kt + 1 < n_tiles) {
      const uint32_t nxt = KV0 + ((kt + 1) & 1) * 2 * TILE;
      stage_async<T, D>(nxt, kb, k0 + BK, sk, tid);
      stage_async<T, D>(nxt + TILE, vb, k0 + BK, sk, tid);
    }
    mma::cp_async_commit();
    const uint32_t Ks = KV0 + (kt & 1) * 2 * TILE, Vs = Ks + TILE;

    // S = Q K^T and dP = dO V^T, as one group
    float s[8][4], dp[8][4];
    issue_scores<T, D>(s, Qs, Ks);
    issue_scores<T, D>(dp, Os, Vs);
    finish(s);
    mma::fence_acc(dp);

    // P = exp(S scale - lse) and dS = P (dP - delta) scale, in f32, masked
    // (finite -1e30) where the tile crosses the diagonal or a ragged edge
    const bool edge = k0 + BK > sk || q0 + BQ > sq || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qp = q0 + row0 + g + 8 * h, kp = k0 + j * 8 + 2 * t + (e & 1);
        const bool valid = !edge || (kp < sk && qp < sq && (!causal || qp >= kp));
        const float p = exp2f(valid ? fmaf(s[j][e], scale2, -lse2[h]) : NEG * LOG2E - lse2[h]);
        dp[j][e] = p * (dp[j][e] - dl[h]) * sm_scale;
      }
    uint32_t a[4][4];
    issue_accumulate<T, D>(acc, a, dp, Ks);  // dQ += dS K
    finish(acc);
  }

  mma::cp_async_wait<0>();
  __syncthreads();  // every warp is done with Q, K, V: stage dQ in the Q tile
  acc_to_tile<T, D>(tc_smem, acc, lane);
  __syncthreads();
  tile_to_global<D>(dq + bh * sq * D, tc_smem, q0, sq, tid);
}

// K4 on the tensor cores. Block (bh, 64-key tile); warp w owns keys
// w*16 .. w*16+15 of the tile, so the score tiles are transposed: rows are
// keys and columns q rows, and lse, delta are read per column.
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
    flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
                            float sm_scale, int causal) {
  constexpr int TILE = Tile<D>::BYTES;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t Ks = mma::smem_addr(tc_smem);
  const uint32_t Vs = Ks + TILE;
  const uint32_t QO0 = Ks + 2 * TILE;  // buffer b: Q at QO0 + 2b TILE, dO one TILE on
  // buffer b: 64 floats of lse at LD0 + 2b * 64, then 64 of delta
  float* const LD0 = reinterpret_cast<float*>(tc_smem + 6 * TILE);

  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // under causal masking key tile 0 has the most q tiles
  const int tid = threadIdx.x, lane = tid & 31, row0 = (tid >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const T* qb = q + bh * sq * D;
  const T* ob = dout + bh * sq * D;
  const float* lb = lse + bh * sq;
  const float* db = delta + bh * sq;

  const int n_q = (sq + BQ - 1) / BQ;
  // start at the first q tile whose last row is on or below the tile's first
  // key; with no such tile (keys past every query) dK = dV = 0
  const int first = causal ? k0 / BQ : 0;

  // rows of lse and delta past sq are zero-filled, never read
  auto stage_q = [&](int q0, int buf) {
    const uint32_t qs = QO0 + buf * 2 * TILE;
    stage_async<T, D>(qs, qb, q0, sq, tid);
    stage_async<T, D>(qs + TILE, ob, q0, sq, tid);
    const int r = tid & (BQ - 1);
    const float* src = tid < BQ ? lb : db;
    const bool in = q0 + r < sq;
    mma::cp_async4(mma::smem_addr(LD0 + (2 * buf + (tid >= BQ)) * BQ + r), src + (in ? q0 + r : 0),
                   in);
  };

  stage_async<T, D>(Ks, k + bh * sk * D, k0, sk, tid);
  stage_async<T, D>(Vs, v + bh * sk * D, k0, sk, tid);
  if (first < n_q) stage_q(first * BQ, 0);
  mma::cp_async_commit();

  const float scale2 = sm_scale * LOG2E;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * BQ, buf = (qt - first) & 1;
    tiles_ready();  // tile qt is in; every warp is done with tile qt-1's buffer
    if (qt + 1 < n_q) stage_q(q0 + BQ, buf ^ 1);
    mma::cp_async_commit();
    const uint32_t Qs = QO0 + buf * 2 * TILE, Os = Qs + TILE;
    const float* Ls = LD0 + 2 * buf * BQ;
    const float* Dl = Ls + BQ;

    // P^T = exp(S^T scale - lse), masked as in K3 with (row, col) = (key, q)
    float s[8][4];
    issue_scores<T, D>(s, Ks, Qs);  // S^T = K Q^T
    finish(s);
    const bool edge = k0 + BK > sk || q0 + BQ > sq || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(Ls + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + row0 + g + 8 * (e >> 1), qp = q0 + j * 8 + 2 * t + (e & 1);
        const bool valid = !edge || (kp < sk && qp < sq && (!causal || qp >= kp));
        const float l2 = ((e & 1) ? l.y : l.x) * LOG2E;
        s[j][e] = exp2f(valid ? fmaf(s[j][e], scale2, -l2) : NEG * LOG2E - l2);
      }
    }
    uint32_t a[4][4];
    issue_accumulate<T, D>(dva, a, s, Os);  // dV += P^T dO
    finish(dva);

    // dS^T = P^T (dP^T - delta) scale; dP^T = V dO^T is computed only now
    // (not in one group with S^T, as dQ does): live through the dV product,
    // it made the accumulators spill at d = 128
    float dp[8][4];
    issue_scores<T, D>(dp, Vs, Os);
    finish(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(Dl + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - ((e & 1) ? dl.y : dl.x)) * sm_scale;
    }
    issue_accumulate<T, D>(dka, a, dp, Qs);  // dK += dS^T Q
    finish(dka);
  }

  mma::cp_async_wait<0>();
  __syncthreads();  // every warp is done with K and V: stage dK, dV there
  acc_to_tile<T, D>(tc_smem, dka, lane);
  acc_to_tile<T, D>(tc_smem + TILE, dva, lane);
  __syncthreads();
  tile_to_global<D>(dk + bh * sk * D, tc_smem, k0, sk, tid);
  tile_to_global<D>(dv + bh * sk * D, tc_smem + TILE, k0, sk, tid);
}

// bf16 and f16 run the tensor-core kernels, f32 the CUDA-core ones.
template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
                      float sm_scale, int causal, cudaStream_t stream) {
  constexpr bool tc = !std::is_same<T, float>::value;
  void (*kernel)(const T*, const T*, const T*, const T*, const float*, const float*, T*, int,
                 int, float, int);
  size_t smem;
  if constexpr (tc) {
    kernel = flash_bwd_dq_tc_kernel<T, D>;
    smem = dq_tc_smem_bytes<D>();
  } else {
    kernel = flash_bwd_dq_kernel<T, D>;
    smem = dq_smem_bytes(D);
  }
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  kernel<<<grid, tc ? TC_THREADS : DQ_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), sq, sk, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                       int sk, float sm_scale, int causal, cudaStream_t stream) {
  constexpr bool tc = !std::is_same<T, float>::value;
  void (*kernel)(const T*, const T*, const T*, const T*, const float*, const float*, T*, T*, int,
                 int, float, int);
  size_t smem;
  if constexpr (tc) {
    kernel = flash_bwd_dkv_tc_kernel<T, D>;
    smem = dkv_tc_smem_bytes<D>();
  } else {
    kernel = flash_bwd_dkv_kernel<T, D>;
    smem = dkv_smem_bytes(D);
  }
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sk + BK - 1) / BK);
  kernel<<<grid, tc ? TC_THREADS : DKV_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
      sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
                        int d, float sm_scale, int causal, cudaStream_t s) {
  switch (d) {
    case 32: return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, bh, sq, sk, sm_scale, causal, s);
    case 64: return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, bh, sq, sk, sm_scale, causal, s);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, bh, sq, sk, sm_scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                         int sk, int d, float sm_scale, int causal, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, sm_scale, causal, s);
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, sm_scale, causal, s);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, sm_scale, causal,
                                s);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int bh, int sq, int sk, int tiles) {
  return bh <= 0 || sq <= 0 || sk <= 0 || tiles > 65535;
}

}  // namespace

// q, dout, dq: (bh, sq, d); k, v: (bh, sk, d); all contiguous, 16-byte
// aligned and of one dtype; lse, delta: (bh, sq) f32. d in {32, 64, 128}.
// Returns the launch's cudaError_t.
extern "C" int rt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int bh, int sq,
                               int sk, int d, float sm_scale, int causal, int dtype,
                               void* stream) {
  if (bad_shape(bh, sq, sk, (sq + BQ - 1) / BQ)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case RT_F32:
      return dispatch_dq<float>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, sm_scale, causal, s);
    case RT_BF16:
      return dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, sm_scale,
                                        causal, s);
    case RT_F16:
      return dispatch_dq<__half>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, sm_scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

// As rt_flash_bwd_dq, with dk, dv: (bh, sk, d) in the dtype of k and v.
extern "C" int rt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int bh,
                                int sq, int sk, int d, float sm_scale, int causal, int dtype,
                                void* stream) {
  if (bad_shape(bh, sq, sk, (sk + BK - 1) / BK)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case RT_F32:
      return dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, sm_scale,
                                 causal, s);
    case RT_BF16:
      return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                                         sm_scale, causal, s);
    case RT_F16:
      return dispatch_dkv<__half>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, sm_scale,
                                  causal, s);
    default: return cudaErrorInvalidValue;
  }
}
