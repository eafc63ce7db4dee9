// Shared pieces of the DecAvg mixing kernels: the fp32 / bf16 conversions
// (mix.cu, quant_mix.cu) and the row loads and stores of the block-sparse
// walk and the quantised rounds (bsr_walk.cuh, quant_mix.cu).
//
// A load or store moves VEC consecutive elements of one row as one 4/8/16-
// byte access; the caller picked VEC so that every row stays aligned for it.
// Every kernel accumulates in fp32 on the CUDA cores: Hopper's tensor cores
// take fp32 only as TF32 (10-bit mantissa), which would truncate the
// post-diffusion parameter scale that mixing must preserve.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mixk {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// VEC consecutive elements of W row `row` from column c0, widened to fp32.
// Rows outside [0, row_end) and columns at or past d read as zero, so a
// caller never reads outside W whatever block indices it was handed.
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ w, long long row, long long row_end,
                                         long long d, long long c0, float (&out)[VEC]) {
  if (row < 0 || row >= row_end) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = 0.f;
    return;
  }
  const T* p = w + row * d + c0;
  if (c0 + VEC <= d) {
    const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = to_f32(pk.v[v]);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = (c0 + v < d) ? to_f32(p[v]) : 0.f;
  }
}

// y row `row`, columns c0 .. c0+VEC (masked at d), narrowed to T.
template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* __restrict__ y, long long row, long long d, long long c0,
                                          const float (&val)[VEC]) {
  T* p = y + row * d + c0;
  if (c0 + VEC <= d) {
    Pack<T, VEC> pk;
#pragma unroll
    for (int v = 0; v < VEC; ++v) pk.v[v] = from_f32<T>(val[v]);
    *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      if (c0 + v < d) p[v] = from_f32<T>(val[v]);
  }
}

}  // namespace mixk
