// Shared pieces of the DecAvg mixing kernels: the row loads and stores of
// every walk (mix.cu, bsr_walk.cuh, quant_mix.cu) and the dense walk's
// accumulation (mix.cu, and quant_mix.cu's with a dequantising load).
//
// The dense walk computes output rows  y[r, :] = sum_k M[r, k] * W[k, :]
// for a small group of RG rows at a time, over a strip of W's columns.  A
// thread owns VEC consecutive columns (one 4/8/16-byte load per W row) and
// keeps RG x VEC fp32 accumulators in registers; the block's slice of M
// sits in shared memory and is read four k at a time as one broadcast
// float4, which feeds 4 * VEC fused multiply-adds.  Every output is a
// sequential fp32 FMA chain over k in ascending order: no atomics, so a run
// is bitwise reproducible.  fp32 stays on the CUDA cores: Hopper's tensor
// cores take fp32 only as TF32 (10-bit mantissa), which would truncate the
// post-diffusion parameter scale that mixing must preserve.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mixk {

constexpr int kThreads = 128;

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

// acc[r][:] += sum_{k < kc} m_s[r * ldm + k] * W[row0 + k, c0 : c0 + VEC].
// m_s is RG x ldm fp32 in shared memory, 16-byte aligned, ldm a multiple of
// 4, zero-filled at k >= kc up to the next multiple of 4.
template <typename T, int VEC, int RG>
__device__ __forceinline__ void accumulate(float (&acc)[RG][VEC], const float* __restrict__ m_s,
                                           int ldm, int kc, const T* __restrict__ w, long long row0,
                                           long long row_end, long long d, long long c0) {
  for (int k = 0; k < kc; k += 4) {
    float wv[4][VEC];
#pragma unroll
    for (int j = 0; j < 4; ++j) load_row<T, VEC>(w, row0 + k + j, row_end, d, c0, wv[j]);
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      const float4 mv = *reinterpret_cast<const float4*>(m_s + r * ldm + k);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float a = acc[r][v];
        a = fmaf(mv.x, wv[0][v], a);
        a = fmaf(mv.y, wv[1][v], a);
        a = fmaf(mv.z, wv[2][v], a);
        a = fmaf(mv.w, wv[3][v], a);
        acc[r][v] = a;
      }
    }
  }
}

}  // namespace mixk

// Instantiate KERNEL_CALL(T, VEC, RG) for the (dtype, vector width, row
// group) the host picked; evaluates to cudaErrorInvalidValue otherwise.
#define MIXK_DISPATCH(dtype, vec, rg, KERNEL_CALL)                              \
  [&]() -> cudaError_t {                                                        \
    switch ((dtype) * 100 + (vec) * 10 + ((rg) == 8 ? 0 : (rg) == 16 ? 1 : 2)) { \
      case 10: KERNEL_CALL(float, 1, 8); break;                                 \
      case 11: KERNEL_CALL(float, 1, 16); break;                                \
      case 12: KERNEL_CALL(float, 1, 32); break;                                \
      case 20: KERNEL_CALL(float, 2, 8); break;                                 \
      case 21: KERNEL_CALL(float, 2, 16); break;                                \
      case 22: KERNEL_CALL(float, 2, 32); break;                                \
      case 40: KERNEL_CALL(float, 4, 8); break;                                 \
      case 41: KERNEL_CALL(float, 4, 16); break;                                \
      case 42: KERNEL_CALL(float, 4, 32); break;                                \
      case 110: KERNEL_CALL(__nv_bfloat16, 1, 8); break;                        \
      case 111: KERNEL_CALL(__nv_bfloat16, 1, 16); break;                       \
      case 112: KERNEL_CALL(__nv_bfloat16, 1, 32); break;                       \
      case 120: KERNEL_CALL(__nv_bfloat16, 2, 8); break;                        \
      case 121: KERNEL_CALL(__nv_bfloat16, 2, 16); break;                       \
      case 122: KERNEL_CALL(__nv_bfloat16, 2, 32); break;                       \
      case 140: KERNEL_CALL(__nv_bfloat16, 4, 8); break;                        \
      case 141: KERNEL_CALL(__nv_bfloat16, 4, 16); break;                       \
      case 142: KERNEL_CALL(__nv_bfloat16, 4, 32); break;                       \
      default: return cudaErrorInvalidValue;                                    \
    }                                                                           \
    return cudaGetLastError();                                                  \
  }()
