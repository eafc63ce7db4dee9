// Block-sparse DecAvg mixing  Y = M . W  for Hopper (sm_90a), M in BSR form.
//
// Replaces: src/repro/kernels/mix/sparse.py::mix_bsr (Pallas body
// _mix_bsr_kernel), the TPU kernel of the sparse mixing backend.  M is
// lowered to (bn x bn) fp32 tiles: block_cols (nrb, max_nnz) int32 names the
// column block of each kept tile, tiles (nrb, max_nnz, bn, bn) holds them,
// counts (nrb,) int32 says how many of a row block's tiles are real.  W is
// (n, d) fp32 or bf16; Y has W's dtype, accumulated in fp32.
//
// What bounds it on an H100: the least traffic is reading W once and writing
// Y once, 8 n d bytes; the flops are 2 bn^2 d per kept tile, which for the
// paper's sparse families (a few tiles per row block) is far below the fp32
// rate, so the kernel is memory-bound.  What it cannot avoid is that a W row
// block is needed by every row block whose tile list names it: on a ring
// that is 3 row blocks, on a randomly numbered graph nearly all of them.
//
// What the design does about it: one block per (column strip, row block,
// row group of <= 32 rows); it walks its row block's tile list in the fixed
// stored order up to counts[i] — the loop that replaces the TPU grid's
// sequential K axis, and the padded tiles of short row blocks are skipped,
// not multiplied.  The row group's slice of each tile sits in shared memory,
// the W strip of the named column block is read with coalesced 16/8/4-byte
// loads, and the accumulators are fp32 registers.  Row blocks are the
// fastest-varying launch index, so the blocks that share a W strip run
// together and re-read it from L2.  Rows past n (the last row block's
// padding) are neither read nor written.  No atomics: bitwise deterministic.
#include "mix_common.cuh"

namespace {

template <typename T, int VEC, int RG>
__global__ void __launch_bounds__(mixk::kThreads)
    mix_bsr_kernel(const int* __restrict__ block_cols, const float* __restrict__ tiles,
                   const int* __restrict__ counts, const T* __restrict__ w, T* __restrict__ y,
                   int n, long long d, int nrb, int max_nnz, int bn, int ldt, int n_rg) {
  extern __shared__ __align__(16) float t_s[];  // RG x ldt slice of one tile
  unsigned long long b = blockIdx.x;
  const int g = (int)(b % n_rg);
  b /= n_rg;
  const int i = (int)(b % nrb);
  const long long strip = (long long)(b / nrb);
  const long long c0 = (strip * mixk::kThreads + threadIdx.x) * VEC;
  const int rr0 = g * RG;  // first tile row of this row group
  const int nt = min(counts[i], max_nnz);
  float acc[RG][VEC];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;

  for (int t = 0; t < nt; ++t) {
    const long long slot = (long long)i * max_nnz + t;
    const float* tile = tiles + slot * bn * bn;
    for (int e = threadIdx.x; e < RG * ldt; e += mixk::kThreads) {
      const int r = e / ldt, c = e % ldt;
      t_s[e] = (rr0 + r < bn && c < bn) ? tile[(rr0 + r) * bn + c] : 0.f;
    }
    __syncthreads();
    if (c0 < d) {
      const long long row0 = (long long)block_cols[slot] * bn;
      const long long row_end = min((long long)n, row0 + bn);
      mixk::accumulate<T, VEC, RG>(acc, t_s, ldt, bn, w, row0, row_end, d, c0);
    }
    __syncthreads();
  }
  if (c0 >= d) return;
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    const long long row = (long long)i * bn + rr0 + r;
    if (rr0 + r < bn && row < n) mixk::store_row<T, VEC>(y, row, d, c0, acc[r]);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (W and Y).  vec in {1, 2, 4} divides d and the
// host checked both pointers' alignment for it.  1 <= bn <= 256 and
// nrb * bn >= n.  Returns a cudaError_t.
extern "C" int mix_bsr(int dtype, const int* block_cols, const float* tiles, const int* counts,
                       const void* w, void* y, int n, long long d, int nrb, int max_nnz, int bn,
                       int vec, void* stream) {
  if (n <= 0 || d <= 0 || bn <= 0 || bn > 256 || (long long)nrb * bn < n || max_nnz <= 0)
    return cudaErrorInvalidValue;
  const int rg = bn <= 8 ? 8 : bn <= 16 ? 16 : 32;
  const int n_rg = (bn + rg - 1) / rg;
  const int ldt = (bn + 3) / 4 * 4;
  const size_t smem = (size_t)rg * ldt * sizeof(float);
  const long long strip_cols = (long long)mixk::kThreads * vec;
  const long long blocks = ((d + strip_cols - 1) / strip_cols) * nrb * n_rg;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MIX_BSR_CALL(T, VEC, RG)                                                             \
  mix_bsr_kernel<T, VEC, RG><<<(unsigned)blocks, mixk::kThreads, smem, s>>>(                \
      block_cols, tiles, counts, static_cast<const T*>(w), static_cast<T*>(y), n, d, nrb,    \
      max_nnz, bn, ldt, n_rg)
  return (int)MIXK_DISPATCH(dtype, vec, rg, MIX_BSR_CALL);
#undef MIX_BSR_CALL
}
