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
// Y once, 8 n d bytes; the flops are 2 d per nonzero of M, which for the
// paper's sparse families (deg + 1 nonzeros a row) is far below the fp32
// rate, so the function is memory-bound.  What a walk over whole tiles
// cannot avoid is bn FMAs a tile row where M has a few nonzeros: on a ring
// at bn 32 that is 96 FMAs an output element for 3 nonzeros, more than the
// byte bound in fp32 operations alone, and on a randomly numbered graph,
// where nearly every tile of a row block is kept, some 1,000 for 5.
//
// What the design does about it: the walk of bsr_walk.cuh.  It multiplies
// only the nonzeros of M, compacted once per block into shared memory in
// the fixed order (tile order up to counts[i], ascending column inside a
// tile), so a row costs deg + 1 FMAs a column, whatever the tiles hold and
// however the graph is numbered.  The blocks of all row groups walk the same
// column strips together, so a W row referenced by deg + 1 output rows is
// read from device memory about once.  Four blocks an SM, each with 48 KB of
// stages: a block whose lists fit two strips (a ring's 3 nonzeros a row)
// keeps the next strip's W rows in flight by cp.async; one whose lists need
// more (a 4-regular graph's 5) walks from registers, four blocks an SM
// keeping the loads in flight.  Rows past n (the last row block's padding)
// are neither read nor written.  No atomics: bitwise deterministic.
#include "bsr_walk.cuh"

namespace {

constexpr int kStageBytes = 48 * 1024;  // dynamic shared memory a block stages in

template <typename T, int VEC>
__global__ void __launch_bounds__(bsrw::kThreads, VEC == 4 ? 3 : 4)
    mix_bsr_kernel(const int* __restrict__ block_cols, const float* __restrict__ tiles,
                   const int* __restrict__ counts, const T* __restrict__ w, T* __restrict__ y, int n,
                   long long d, int max_nnz, int bn, int groups_per_rb, int slices) {
  bsrw::RowsOf<T, VEC> src{w, d};
  bsrw::rows_walk<VEC, kStageBytes>(block_cols, tiles, counts, n, d, max_nnz, bn, groups_per_rb, slices, src,
                                    bsrw::StoreRows<T, VEC>{y, d});
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
  const int groups_per_rb = (bn + bsrw::kRows - 1) / bsrw::kRows;
  const long long slices = bsrw::slices_of(d, vec);
  const long long blocks = (long long)nrb * groups_per_rb * slices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MIX_BSR_CALL(T, VEC)                                                                          \
  {                                                                                                   \
    const auto kernel = mix_bsr_kernel<T, VEC>;                                                       \
    const int smem = bsrw::RowsOf<T, VEC>::kStaged ? kStageBytes : 0;                                 \
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                  \
    kernel<<<(unsigned)blocks, bsrw::kThreads, smem, s>>>(block_cols, tiles, counts,                   \
                                                          static_cast<const T*>(w), static_cast<T*>(y), \
                                                          n, d, max_nnz, bn, groups_per_rb, (int)slices); \
  }
  return (int)BSRW_DISPATCH(dtype, vec, MIX_BSR_CALL);
#undef MIX_BSR_CALL
}
