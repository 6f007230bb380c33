// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel is exported through a plain C entry (extern "C") taking raw
// device pointers, sizes and the caller's CUDA stream; the entry returns
// cudaGetLastError() right after the launch and the Python wrapper raises
// when that is not 0.  Kernels allocate nothing and never synchronise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes shared with repro_torch/kernels/build.py (DTYPE_CODES)
enum LeoamDType { LEOAM_F32 = 0, LEOAM_F16 = 1, LEOAM_BF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float through storage type T (identity for float): the cast
// points of the plain PyTorch versions, reproduced value for value.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
