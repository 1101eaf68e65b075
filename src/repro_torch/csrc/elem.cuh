// Element types of the data matrix A: float32, bfloat16 and float16, read
// from memory as raw bits and widened to f32 exactly (every bf16 and fp16
// value is an f32 value), so the kernels compute in f32 whatever A holds.
//
// Elem<T>: S, the raw scalar (float, or the 16-bit pattern); V4, four
// neighbouring elements in one load (float4: 16 bytes; uint2: 8 bytes);
// V16, one 16-byte load and kPer16 elements in it. elem<T>(v, i) is element
// i of a raw load, widened.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <typename T>
struct Elem {
  using S = unsigned short;
  using V4 = uint2;
  using V16 = uint4;
  static constexpr int kPer16 = 8;
};
template <>
struct Elem<float> {
  using S = float;
  using V4 = float4;
  using V16 = float4;
  static constexpr int kPer16 = 4;
};

// a 16-bit pattern of T as f32
template <typename T>
__device__ __forceinline__ float from_bits(unsigned b);
template <>
__device__ __forceinline__ float from_bits<__nv_bfloat16>(unsigned b) {
  return widen(__ushort_as_bfloat16(static_cast<unsigned short>(b)));
}
template <>
__device__ __forceinline__ float from_bits<__half>(unsigned b) {
  return widen(__ushort_as_half(static_cast<unsigned short>(b)));
}

// element i of a raw load (i a compile-time constant once unrolled); the
// lower half of a 32-bit word is the element at the lower address
template <typename T>
__device__ __forceinline__ float elem(float v, int) { return v; }
template <typename T>
__device__ __forceinline__ float elem(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
template <typename T>
__device__ __forceinline__ float elem(unsigned short v, int) {
  return from_bits<T>(v);
}
__device__ __forceinline__ unsigned half_of(unsigned w, int i) {
  return (i & 1) ? w >> 16 : w & 0xffffu;
}
template <typename T>
__device__ __forceinline__ float elem(const uint2& v, int i) {
  return from_bits<T>(half_of(i < 2 ? v.x : v.y, i));
}
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int i) {
  const unsigned w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
  return from_bits<T>(half_of(w, i));
}
