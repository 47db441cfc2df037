// Device helpers shared by the kernels of csrc/ (included by segment.cu,
// pixel_loss.cu and prereduce.cu; ops/_build.py keys every library's
// build cache on the headers of this directory as well as its source).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Round to nearest even bf16, kept in float32: one cvt.rn.bf16.f32. On
// finite values it gives the bits of the integer trick (u + 0x7fff +
// ((u >> 16) & 1), low half cleared) that it replaced, and was 7% faster
// in K7 (PERF.md).
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A row-major kernel's memory unit: a float4 (kWide: C % 4 == 0 and the
// rows 16-byte aligned) or a float. K7 and K10 read rows as units; K10
// stores its dl as units as well.
template <bool kWide>
struct Unit {
  typedef float T;
  static constexpr int kFloats = 1;
  __device__ __forceinline__ static void get(float u, float* f) { f[0] = u; }
  __device__ __forceinline__ static float put(const float* f) { return f[0]; }
};
template <>
struct Unit<true> {
  typedef float4 T;
  static constexpr int kFloats = 4;
  __device__ __forceinline__ static void get(float4 u, float* f) {
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
  __device__ __forceinline__ static float4 put(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
