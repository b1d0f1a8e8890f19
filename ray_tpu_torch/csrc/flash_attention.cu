// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py `_fwd_kernel`
// (launched by `_flash_forward`): the FlashAttention-2 forward over
// q (bh, sq, d), k and v (bh, sk, d), returning o (bh, sq, d) in the input
// dtype and the per-row log-sum-exp (bh, sq) in f32. Semantics held to the
// TPU kernel's:
//   * causal masking is top-left aligned, q_pos >= k_pos;
//   * key rows past sk are zero and masked;
//   * scores are masked to -1e30, the running max starts at -1e30, and a row
//     with no visible key gives o = 0 and lse = -1e30 + log(1);
//   * the online softmax and both products are in f32.
//
// Bound on the H100: at the serving shapes (d = 128, a few hundred keys) the
// bytes of q, k, v and o bound it; at long sequences the operations do. This
// first version computes both products with f32 FMAs on the CUDA cores, not
// the tensor cores, so it stays far from the operation bound at long
// sequences (wgmma and TMA are later work). The design keeps everything
// between the loads of q/k/v and the store of o on chip: one block of 128
// threads per (bh, 64-row q tile) loops over 64-row k/v tiles staged in
// shared memory (f32, rows padded by one word so that the access patterns
// below hit distinct banks), keeps the running max, sum and the 64 x d output
// accumulator in registers, and skips whole tiles above the causal diagonal.

#include "common.cuh"

namespace {

constexpr int BQ = 64;  // q rows per block
constexpr int BK = 64;  // keys per tile
constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

__host__ __device__ constexpr size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(BQ * (d + 1) + 2 * BK * (d + 1) + BQ * (BK + 1));
}

// Thread (tr, tc) = (tid / 8, tid % 8) owns q rows tr*4 .. tr*4+3 of the
// tile, score columns tc + 8*j (j < 8) and output columns tc + 8*j (j < D/8).
// The 8 threads that share a row group are 8 neighbouring lanes, so row
// reductions are three xor-shuffles.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     int sq, int sk, float sm_scale, int causal) {
  constexpr int N = Pack<T>::N;
  constexpr int VPR = D / N;  // 16-byte vectors per row
  constexpr int LD = D + 1;
  constexpr int LDS = BK + 1;
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* Qs = smem;           // BQ x LD, later the output staging tile
  float* Ks = Qs + BQ * LD;   // BK x LD
  float* Vs = Ks + BK * LD;   // BK x LD
  float* Ps = Vs + BK * LD;   // BQ x LDS

  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const T* qb = q + bh * sq * D;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;

  for (int i = tid; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * N;
    float f[N];
    if (q0 + r < sq) {
      load16(qb + (int64_t)(q0 + r) * D + c, f);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) f[n] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < N; ++n) Qs[r * LD + c + n] = f[n];
  }

  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (sk + BK - 1) / BK;
  if (causal) {
    // the TPU kernel's skip rule: a tile runs iff its first key is at or
    // before the q tile's last row
    const int last = (q0 + BQ - 1) / BK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
    for (int i = tid; i < BK * VPR; i += THREADS) {
      const int r = i / VPR, c = (i % VPR) * N;
      float fk[N], fv[N];
      if (k0 + r < sk) {
        load16(kb + (int64_t)(k0 + r) * D + c, fk);
        load16(vb + (int64_t)(k0 + r) * D + c, fv);
      } else {
#pragma unroll
        for (int n = 0; n < N; ++n) fk[n] = fv[n] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < N; ++n) {
        Ks[r * LD + c + n] = fk[n];
        Vs[r * LD + c + n] = fv[n];
      }
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr * 4 + i) * LD + dd];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tc + 8 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + tr * 4 + i;
      unsigned ok = 0;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tc + 8 * j;
        const bool valid = kp < sk && (!causal || qp >= kp);
        ok |= (unsigned)valid << j;
        s[i][j] = valid ? s[i][j] * sm_scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = (ok >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        Ps[(tr * 4 + i) * LDS + tc + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr * 4 + i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * LD + tc + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  // Qs was last read before the final __syncthreads of the loop: reuse it to
  // stage the output so that the store is in 16-byte vectors.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) Qs[r * LD + tc + 8 * j] = acc[i][j] / l_safe;
    if (tc == 0 && q0 + r < sq) lse[bh * sq + q0 + r] = m[i] + logf(l_safe);
  }
  __syncthreads();
  for (int i = tid; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * N;
    if (q0 + r >= sq) continue;
    float f[N];
#pragma unroll
    for (int n = 0; n < N; ++n) f[n] = Qs[r * LD + c + n];
    store16(o + (bh * sq + q0 + r) * D + c, f);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int sq, int sk, float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), sq, sk, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int sq, int sk, int d, float sm_scale, int causal, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, sq, sk, sm_scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, sq, sk, sm_scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, sq, sk, sm_scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bh, sq, d); k, v: (bh, sk, d); o: (bh, sq, d), all contiguous,
// 16-byte aligned and of one dtype; lse: (bh, sq) f32. d in {32, 64, 128}.
// Returns the launch's cudaError_t.
extern "C" int rt_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int bh, int sq, int sk, int d,
                                      float sm_scale, int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || (sq + BQ - 1) / BQ > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case RT_F32: return dispatch_d<float>(q, k, v, o, lse, bh, sq, sk, d, sm_scale, causal, s);
    case RT_BF16:
      return dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, sq, sk, d, sm_scale, causal, s);
    case RT_F16: return dispatch_d<__half>(q, k, v, o, lse, bh, sq, sk, d, sm_scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
