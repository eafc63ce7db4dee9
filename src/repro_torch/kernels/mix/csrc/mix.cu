// Dense DecAvg mixing  Y = M . W  for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mix/mix.py::mix_matmul (Pallas body _mix_kernel),
// the TPU kernel of the dense mixing backend.  M is the (n, n) fp32
// row-stochastic receive operator, W the (n, d) node-major flattened
// parameters (fp32 on the training path, or bf16), Y has W's dtype and is
// accumulated in fp32.
//
// What bounds it on an H100: per column of W the product reads 4n bytes,
// writes 4n bytes and does 2n^2 flops — n/4 flop per byte.  fp32 must stay
// off the tensor cores (TF32 would truncate the post-diffusion signal), and
// against ~67 TFLOP/s of fp32 FMA and 3.35 TB/s the ridge sits near n = 80.
// Over the dense backend's range (n <= 64) the kernel is memory-bound: the
// least time is 8 n d bytes over the memory rate.
//
// What the design does about it: W and Y each cross DRAM once.  One block
// per (column strip, row group): 128 threads, each owning VEC columns
// (16/8/4-byte coalesced loads, VEC picked by the host to divide d), and
// RG <= 32 output rows in fp32 registers.  M's rows for the group are
// staged in shared memory 64 columns at a time.  When n > 32 the row
// groups of one strip are adjacent in launch order, so the second group
// re-reads the strip from L2, not DRAM.  The ragged edge of d is masked in
// the kernel; nothing is padded or copied.  No atomics: bitwise
// deterministic.
#include "mix_common.cuh"

namespace {

constexpr int kChunk = 64;  // M columns staged per pass

template <typename T, int VEC, int RG>
__global__ void __launch_bounds__(mixk::kThreads)
    mix_dense_kernel(const float* __restrict__ m, const T* __restrict__ w, T* __restrict__ y, int n,
                     long long d, int n_rg) {
  __shared__ __align__(16) float m_s[RG * kChunk];
  const long long strip = blockIdx.x / n_rg;
  const int r0 = (blockIdx.x % n_rg) * RG;
  const long long c0 = (strip * mixk::kThreads + threadIdx.x) * VEC;
  float acc[RG][VEC];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kChunk) {
    const int kc = min(kChunk, n - k0);
    for (int i = threadIdx.x; i < RG * kChunk; i += mixk::kThreads) {
      const int r = i / kChunk, k = i % kChunk;
      m_s[i] = (r0 + r < n && k < kc) ? m[(long long)(r0 + r) * n + k0 + k] : 0.f;
    }
    __syncthreads();
    if (c0 < d) mixk::accumulate<T, VEC, RG>(acc, m_s, kChunk, kc, w, k0, k0 + kc, d, c0);
    __syncthreads();
  }
  if (c0 >= d) return;
#pragma unroll
  for (int r = 0; r < RG; ++r)
    if (r0 + r < n) mixk::store_row<T, VEC>(y, r0 + r, d, c0, acc[r]);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (W and Y).  vec in {1, 2, 4} divides d and the
// host checked both pointers' alignment for it.  Returns a cudaError_t.
extern "C" int mix_dense(int dtype, const float* m, const void* w, void* y, int n, long long d,
                         int vec, void* stream) {
  if (n <= 0 || d <= 0) return cudaErrorInvalidValue;
  const int rg = n <= 8 ? 8 : n <= 16 ? 16 : 32;
  const int n_rg = (n + rg - 1) / rg;
  const long long strip_cols = (long long)mixk::kThreads * vec;
  const long long blocks = ((d + strip_cols - 1) / strip_cols) * n_rg;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MIX_DENSE_CALL(T, VEC, RG)                                                       \
  mix_dense_kernel<T, VEC, RG><<<(unsigned)blocks, mixk::kThreads, 0, s>>>(              \
      m, static_cast<const T*>(w), static_cast<T*>(y), n, d, n_rg)
  return (int)MIXK_DISPATCH(dtype, vec, rg, MIX_DENSE_CALL);
#undef MIX_DENSE_CALL
}
