// Shared helpers of the hand-written kernels: dtype codes and casts.
//
// Dtype codes match repro_torch/kernels/_build.py:DTYPE_CODES.
// Every cast to bf16 rounds through f32 (__float2bfloat16_rn((float)x)):
// that is what PyTorch's and JAX's own f64 -> bf16 casts do, so the
// kernels agree bit for bit with the plain versions.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum DType : int { DT_BF16 = 0, DT_F32 = 1, DT_F64 = 2 };

// Accumulator of a plane type: f64 stays f64, bf16 and f32 sum in f32.
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

// Widen a stored element to the arithmetic type A (float or double); exact.
template <typename A> __device__ __forceinline__ A widen(__nv_bfloat16 v) {
  return (A)__bfloat162float(v);
}
template <typename A> __device__ __forceinline__ A widen(float v) { return (A)v; }
template <typename A> __device__ __forceinline__ A widen(double v) { return (A)v; }

// Narrow (or widen) a float or double to the stored type O, rounding to
// nearest even; double -> bf16 rounds through float.
template <typename O> struct Store;
template <> struct Store<float> {
  __device__ __forceinline__ static float from(float v) { return v; }
  __device__ __forceinline__ static float from(double v) { return (float)v; }
};
template <> struct Store<double> {
  __device__ __forceinline__ static double from(float v) { return (double)v; }
  __device__ __forceinline__ static double from(double v) { return v; }
};
template <> struct Store<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 from(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ __forceinline__ static __nv_bfloat16 from(double v) {
    return __float2bfloat16_rn((float)v);
  }
};

// Cast one stored element of type I to type O.  Goes through the wider of
// the two arithmetic types, so every widening is exact and every
// narrowing rounds once (twice for f64 -> bf16, as above).
template <typename O, typename I> __device__ __forceinline__ O convert(I v) {
  using W = typename AccOf<I>::type;      // float for bf16/f32, double for f64
  return Store<O>::from(widen<W>(v));
}

// Run the statements in __VA_ARGS__ with T bound to the C++ type of a
// dtype code; an unknown code returns cudaErrorInvalidValue.  Nests.
#define DISPATCH_DTYPE(code, T, ...)                                \
  switch (code) {                                                   \
    case DT_BF16: { using T = __nv_bfloat16; __VA_ARGS__ } break;   \
    case DT_F32: { using T = float; __VA_ARGS__ } break;            \
    case DT_F64: { using T = double; __VA_ARGS__ } break;           \
    default: return (int)cudaErrorInvalidValue;                     \
  }
