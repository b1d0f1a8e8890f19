// Shared helpers for the port's CUDA kernels: dtype codes, 16-byte vector
// loads and stores that widen to / narrow from f32, and the error string
// every library exports for its Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Must match _DTYPE_CODES in ray_tpu_torch/_internal/kernels.py.
enum RtDtype { RT_F32 = 0, RT_BF16 = 1, RT_F16 = 2 };

// Elements of T in one 16-byte vector.
template <typename T>
struct Pack {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* f);

template <>
__device__ __forceinline__ void load16<float>(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <>
__device__ __forceinline__ void load16<__half>(const __half* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Round to nearest even, as a cast in PyTorch or XLA does.
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* f);

template <>
__device__ __forceinline__ void store16<float>(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

template <>
__device__ __forceinline__ void store16<__nv_bfloat16>(__nv_bfloat16* p, const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

template <>
__device__ __forceinline__ void store16<__half>(__half* p, const float* f) {
  uint4 v;
  __half2* h = reinterpret_cast<__half2*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// Each .cu file is its own shared library, so each defines this once.
extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
