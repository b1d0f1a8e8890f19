// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py `_fwd_kernel`
// (launched by `_flash_forward`): the FlashAttention-2 forward over
// q (bh, sq, d), k and v (bh, sk, d), returning o (bh, sq, d) in the input
// dtype and the per-row log-sum-exp (bh, sq) in f32. Semantics held to the
// TPU kernel's:
//   * causal masking is top-left aligned, q_pos >= k_pos;
//   * key rows past sk are zero and masked; q rows past sq are never stored;
//   * causal tile skipping: a key tile runs iff its first key is at or before
//     the q tile's last row (the reference's pl.when);
//   * the running max starts at -1e30, a masked score gives p = 0, and a row
//     with no visible key gives o = 0 and lse = -1e30 + log(1);
//   * the online softmax (max, sum, rescale) and both products' sums in f32.
//
// Bound on the H100: at the Llama-2-7B training call (bh = 64, s = 2048,
// d = 128, causal, bf16) operations bound it: the reference's count of 4d
// FLOPs per visible (q, k) pair is 68.75 GFLOP, 0.0695 ms at the tensor
// cores' 989 TFLOP/s, against 135 MB of bytes (0.040 ms at 3.35 TB/s). At the
// serving call (bh = 128, s = 128) the bytes bound it, 0.005 ms, and a launch
// of 256 blocks that each run one or two key tiles is bound by latency.
//
// Two designs, picked by dtype behind the same C entry:
//
// bf16 and f16: flash_fwd_tc_kernel, on the tensor cores. One warpgroup (four
// warps) per block and 64-row q tile; warp w holds q rows 16w .. 16w+15 of
// every accumulator. Per 64-key tile, S = Q K^T is a warpgroup MMA (wgmma
// m64n64k16, both operands in shared memory); the online softmax runs in f32
// on S's accumulator fragments, where each row's 64 scores are spread over
// the four threads of a quad (row max by two xor-shuffles, the row sum kept
// per thread and summed over the quad once at the end), with log2 e folded
// into the scale and exp2 on the special-function unit; only tiles that cross
// the diagonal or the ragged end of the keys evaluate the mask. acc is
// rescaled by alpha = exp(m_old - m_new); P is rounded to the input dtype and
// repacked in registers as the A operand of O += P V (wgmma with A from
// registers, V read transposed from the same tile), so P never leaves the
// registers. That rounding is the one numerical difference from the f32
// plain version: the plain version with round_p=True repeats it, and
// flash_fwd_rounding_bound bounds it. Q is staged once, K and V
// double-buffered with cp.async in wgmma's swizzled layout (tiles and helpers
// in flash_tiles.cuh, shared with the backward), so the next tile loads while
// this one computes. Under causal masking the q tiles with the most key
// tiles get the lowest blockIdx. The epilogue stages o through the Q tile and
// stores 16-byte rows. Each block waits for S before its softmax and for
// P V before the next tile: the tensor cores overlap only across the two
// blocks of an SM. Three changes were tried on the card and dropped, being
// no faster: FlashAttention-3's overlap of tile t's softmax with tile t-1's
// P V inside the warpgroup; a grid that runs the q tiles of one bh in
// consecutive blocks (to share K and V in L2); and blocks of two warpgroups
// over two q tiles that share each K and V tile (half the L2 traffic, one
// block an SM, slower).
//
// f32: flash_fwd_kernel, the first version, with both products in f32 FMAs on
// the CUDA cores: one block of 128 threads per (bh, 64-row q tile) loops over
// 64-row k/v tiles staged in shared memory (f32, rows padded by one word so
// that the access patterns below hit distinct banks), keeps the running max,
// sum and the 64 x d output accumulator in registers, and passes P through
// shared memory to be re-read along the other axis.
//
// Shared memory at d = 32 / 64 / 128:
//   tensor cores: Q + two buffers of K, V = 5 tiles of 64 x d 16-bit values:
//     20 / 40 / 80 KB, two blocks an SM;
//   f32: Q, K, V (64 x (d+1) each) + P (64 x 65): 42 / 67 / 116 KB.

#include <type_traits>

#include "common.cuh"
#include "flash_tiles.cuh"

namespace {

using namespace flash;  // NEG, LOG2E, TC_THREADS, Tile and the tile helpers

constexpr int BQ = ROWS;  // q rows per block
constexpr int BK = ROWS;  // keys per tile
constexpr int THREADS = 128;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(BQ * (d + 1) + 2 * BK * (d + 1) + BQ * (BK + 1));
}

template <int D>
constexpr size_t tc_smem_bytes() {
  return 5 * (size_t)Tile<D>::BYTES;
}

// The f32 kernel. Thread (tr, tc) = (tid / 8, tid % 8) owns q rows
// tr*4 .. tr*4+3 of the tile, score columns tc + 8*j (j < 8) and output
// columns tc + 8*j (j < D/8). The 8 threads that share a row group are 8
// neighbouring lanes, so row reductions are three xor-shuffles.
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

// 2^x by the special-function unit, subnormals flushed to zero (what
// exp2f compiles to under --use_fast_math)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One key tile's online softmax on the S fragments that a thread holds:
// rows qp and qp + 8 (h = 0, 1), columns kp + 8j and kp + 8j + 1. s comes in
// as raw scores and leaves as P = exp(s scale - m_new) in f32; m2 is the
// running max in log2 units (scores times scale2), l this thread's part of
// the row sums (its 16 of the tile's 64 columns), alpha = exp(m_old - m_new)
// per row. With MASK (the tile crosses the diagonal or the ragged end of
// the keys) a masked entry stays out of the max and gets p = 0 explicitly:
// exp(-1e30 - m_new) would be 1 in a row with no visible key yet.
template <bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&m2)[2], float (&l)[2],
                                               float (&alpha)[2], float scale2, int qp, int kp,
                                               int sk, int causal) {
  uint32_t ok = 0xffffffffu;  // bit 4j + e: s[j][e] is a visible key
  if constexpr (MASK) {
    ok = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = qp + 8 * (e >> 1), c = kp + 8 * j + (e & 1);
        ok |= (uint32_t)(c < sk && (!causal || r >= c)) << (4 * j + e);
      }
  }
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] *= scale2;
      if ((ok >> (4 * j + e)) & 1u) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m2[h], mx[h]);
    alpha[h] = ex2(m2[h] - m_new);  // 1 while the row has seen no visible key
    m2[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      s[j][e] = (ok >> (4 * j + e)) & 1u ? ex2(s[j][e] - m2[h]) : 0.f;
      l[h] += s[j][e];
    }
}

// The tensor-core kernel. Block (bh, 64-row q tile); warp w owns q rows
// w*16 .. w*16+15 of the tile. Thread (g, t) = (lane / 4, lane % 4) holds, in
// each 16 x 8 accumulator block, rows g and g+8 and columns 2t, 2t+1, so a
// row's scores of a tile lie with the four threads of a quad.
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
    flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                        int sq, int sk, float sm_scale, int causal) {
  constexpr int TILE = Tile<D>::BYTES;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  const uint32_t Qs = mma::smem_addr(tc_smem);  // later the output staging tile
  const uint32_t KV0 = Qs + TILE;  // buffer b: K at KV0 + 2b TILE, V one TILE on

  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest q tiles first
  const int tid = threadIdx.x, lane = tid & 31, row0 = (tid >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  const T* kb = k + bh * sk * D;
  const T* vb = v + bh * sk * D;

  int n_tiles = (sk + BK - 1) / BK;
  if (causal) {
    // the TPU kernel's skip rule: a tile runs iff its first key is at or
    // before the q tile's last row
    const int last = (q0 + BQ - 1) / BK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  stage_async<T, D>(Qs, q + bh * sq * D, q0, sq, tid);
  stage_async<T, D>(KV0, kb, 0, sk, tid);
  stage_async<T, D>(KV0 + TILE, vb, 0, sk, tid);
  mma::cp_async_commit();

  // rows g and g+8 of this warp (h = 0, 1): the running max in log2 units
  // (scores times scale2), and this thread's part of the row sum, over its
  // 16 of each tile's 64 columns (summed over the quad at the end)
  const float scale2 = sm_scale * LOG2E;
  float m2[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
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

    float s[8][4];
    issue_scores<T, D>(s, Qs, Ks);  // S = Q K^T
    finish(s);

    // only tiles that cross the diagonal or the ragged end of the keys mask
    float alpha[2];
    if (k0 + BK > sk || (causal && k0 + BK - 1 > q0))
      online_softmax<true>(s, m2, l, alpha, scale2, q0 + row0 + g, k0 + 2 * t, sk, causal);
    else
      online_softmax<false>(s, m2, l, alpha, scale2, 0, 0, sk, causal);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    uint32_t a[4][4];
    issue_accumulate<T, D>(acc, a, s, Vs);  // O += P V, P rounded to T
    finish(acc);
  }

  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l_safe[h] = l[h] == 0.f ? 1.f : l[h];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] /= l_safe[e >> 1];
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + row0 + g + 8 * h;
      // m + log(l_safe), with m back in natural units; -1e30 + log(1) for a
      // row with no visible key
      if (r < sq) lse[bh * sq + r] = l[h] == 0.f ? NEG : m2[h] * LN2 + logf(l[h]);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // every warp is done with Q: stage o in the Q tile
  acc_to_tile<T, D>(tc_smem, acc, lane);
  __syncthreads();
  tile_to_global<D>(o + bh * sq * D, tc_smem, q0, sq, tid);
}

// bf16 and f16 run the tensor-core kernel, f32 the CUDA-core one.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int sq, int sk, float sm_scale, int causal, cudaStream_t stream) {
  constexpr bool tc = !std::is_same<T, float>::value;
  void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, float, int);
  size_t smem;
  if constexpr (tc) {
    kernel = flash_fwd_tc_kernel<T, D>;
    smem = tc_smem_bytes<D>();
  } else {
    kernel = flash_fwd_kernel<T, D>;
    smem = smem_bytes(D);
  }
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  kernel<<<grid, tc ? TC_THREADS : THREADS, smem, stream>>>(
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
