// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_tpu/ops/rmsnorm.py `_fwd_kernel`
// (launched by `_rmsnorm_fwd_impl`): per row, out = x * rsqrt(mean(x^2) + eps)
// * w, with the statistics in f32 and the result in x's dtype.
//
// Bound on the H100: bytes. It does about 4 operations per element and must
// read x and w once and write out once, so at any width the memory rate sets
// the floor. The design spends nothing on arithmetic and keeps loads wide:
// one block per row, 16-byte vector loads and stores, the sum of squares in
// f32 registers reduced by warp shuffles and one shared-memory step. The
// second pass re-reads the row, which the first pass left in L1/L2.

#include "common.cuh"

namespace {

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  return partial[0];
}

template <typename T>
__global__ void rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                   T* __restrict__ out, int d, float eps) {
  constexpr int N = Pack<T>::N;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int nvec = d / N;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float f[N];
    load16(xr + i * N, f);
#pragma unroll
    for (int n = 0; n < N; ++n) ss += f[n] * f[n];
  }
  const float inv = rsqrtf(block_sum(ss) / d + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float f[N], g[N];
    load16(xr + i * N, f);
    load16(w + i * N, g);
#pragma unroll
    for (int n = 0; n < N; ++n) f[n] = f[n] * inv * g[n];
    store16(orow + i * N, f);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, long long rows, int d,
                   float eps, cudaStream_t stream) {
  const int nvec = d / Pack<T>::N;
  int threads = ((nvec + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  rmsnorm_fwd_kernel<T><<<(unsigned)rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, d) contiguous, 16-byte aligned; w: (d,) of the same dtype;
// d % 8 == 0. Returns the launch's cudaError_t.
extern "C" int rt_rmsnorm_fwd(const void* x, const void* w, void* out, long long rows, int d,
                              float eps, int dtype, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0 || d % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case RT_F32: return launch<float>(x, w, out, rows, d, eps, s);
    case RT_BF16: return launch<__nv_bfloat16>(x, w, out, rows, d, eps, s);
    case RT_F16: return launch<__half>(x, w, out, rows, d, eps, s);
    default: return cudaErrorInvalidValue;
  }
}
