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
// 169 MB and 202 MB of bytes (0.050 ms and 0.060 ms at 3.35 TB/s). This first
// version runs every product on the CUDA cores in f32 FMAs, not on the tensor
// cores, so it stays far from that bound (mma.sync, wgmma and TMA are later
// work). The design keeps everything between the loads and the stores on
// chip: the block's resident tiles and the streamed tiles are staged in
// shared memory as f32 (rows padded by one word so the access patterns below
// hit distinct banks), S and dP live in registers, P and dS pass through one
// shared tile each to be re-read along the other axis, and the f32
// accumulators live in registers.
//
// Shared memory (f32 staging, 64 x 64 tiles), at d = 32 / 64 / 128:
//   dQ:     Q, dO, K, V (64 x (d+1) each) + dS (64 x 65) + lse, delta (64 each)
//           = 4 * (4 * 64 * (d+1) + 64 * 65 + 128) bytes: 51 / 84 / 149 KB;
//   dK/dV:  K, V, Q, dO (64 x (d+1) each) + P, dS (64 x 65 each) + lse, delta
//           = 4 * (4 * 64 * (d+1) + 2 * 64 * 65 + 128) bytes: 68 / 100 / 166 KB.
// All above 48 KB go through cudaFuncAttributeMaxDynamicSharedMemorySize and
// stay under the 227 KB a block may use. The accumulators are registers:
// 4 rows x d/8 columns per thread for dQ (128 threads), 2 rows x d/8 columns
// each of dK and dV per thread for dK/dV (256 threads).

#include "common.cuh"

namespace {

constexpr int BQ = 64;  // q rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int LDS = 65;  // padded row of a 64-wide score tile
constexpr float NEG = -1e30f;

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

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
                      float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, D><<<grid, DQ_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), sq, sk, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
                       int sk, float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sk + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, D><<<grid, DKV_THREADS, smem, stream>>>(
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
