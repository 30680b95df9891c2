// Shared helpers for the hand-written Hopper kernels of storm_tpu_torch.
//
// Every kernel is templated on its element type T (float or __nv_bfloat16),
// loads T and converts to f32 for the arithmetic, and stores T. The C entry
// points take a dtype code (DTYPE_F32 / DTYPE_BF16, mirrored in
// storm_tpu_torch/ops/_build.py) and return cudaGetLastError() after the
// launch, so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define DTYPE_F32 0
#define DTYPE_BF16 1

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round an f32 value through T and back (identity for float): where the TPU
// kernel casts an intermediate to the input dtype, this reproduces it.
template <typename T>
__device__ __forceinline__ float round_through(float v) {
  return to_f32(from_f32<T>(v));
}
