// Row-list (HYB) DecAvg mixing  Y = M . W  for Hopper (sm_90a): the sparse
// backend's static-topology round.
//
// Replaces: no pallas_call.  The JAX package renders this round in XLA,
// src/repro/core/decavg.py::mix_pytree_hyb (an ELL slot chain of fused
// full-length gathers, then a dense (H, n) product for the hub rows); the
// port gives it a kernel of its own.  M comes as its HYB layout
// (core/commplan.py::_hyb_layout): every row that is not a hub has n_slots
// ELL slots, slot s of row i reading source row slot_idx[s, i] with weight
// slot_w[s, i] (weight 0: padding), plus its self weight self_w[i]; a hub
// row holds its receive row as a compacted list of nonzeros, hub_ptr /
// hub_col / hub_val, ascending column.  hub_of[i] is the hub index of row i,
// or -1.
//
// Outputs are rows i < n_rows.  The ELL terms read W (n_src rows) and the
// hub lists read W_hub (n_hub_src rows): the unsharded call passes W twice;
// the node-sharded round (core/shardplan.py) passes the rank's [local | halo]
// buffer as W, its own rows first, and the all-gathered payload as W_hub.
//
// Numerics, in the JAX order: an ELL row is self_w[i] * w[i], rounded, then
// for each slot in slot order + slot_w * w[src], the product and the sum
// each rounded (no contraction into an FMA, so the plain version's separate
// torch multiply and add give the same bits); a slot of weight exactly 0 is
// skipped.  A hub row is one fp32 FMA chain from 0 over its nonzeros.
// fp32 accumulation whatever W's dtype; no atomics, each output row written
// once by one block: two launches are bitwise equal, and equal to
// hyb.py::mix_hyb_ref.  Whatever the tables hold, nothing outside them or
// the buffers is read: source rows outside [0, n_src) / [0, n_hub_src) add
// nothing, a hub index outside [0, H) makes an ELL row, and a hub's list
// is clipped to [0, nnz).
//
// Work.  A block of kThreads threads owns kRows consecutive output rows and
// one strip of kThreads * VEC columns; it walks its rows one after another,
// every thread on its own VEC columns, so the row's kind, slots and weights
// are the same for the whole block (no divergence).  The row blocks are the
// fastest launch index: the blocks resident at one time walk a few
// neighbouring strips of every row, so a source row that deg + 1 outputs
// read comes from device memory about once and then from L2.  Up to kBatch
// source vectors are loaded before their adds.
//
// What bounds it on an H100: reading W once and writing Y once, 8 n d bytes
// in fp32, against 2 d flops a nonzero: memory-bound for every sparse family.
#include "mix_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;   // output rows a block walks
constexpr int kBatch = 4;  // source vectors a thread loads before it adds them

template <typename T, int VEC>
__device__ __forceinline__ void ell_row(const int* __restrict__ slot_idx, const float* __restrict__ slot_w,
                                        float self_w, const T* __restrict__ w, int row, int n_src, int n_rows,
                                        int n_slots, long long d, long long c0, float (&acc)[VEC]) {
  float v[VEC];
  mixk::load_row<T, VEC>(w, row, n_src, d, c0, v);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = __fmul_rn(self_w, v[j]);
  for (int s0 = 0; s0 < n_slots; s0 += kBatch) {
    int src[kBatch];
    float wt[kBatch];
    float x[kBatch][VEC];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int s = s0 + b;
      src[b] = s < n_slots ? slot_idx[(long long)s * n_rows + row] : -1;
      wt[b] = s < n_slots ? slot_w[(long long)s * n_rows + row] : 0.f;
      if (wt[b] != 0.f && src[b] >= 0 && src[b] < n_src) mixk::load_row<T, VEC>(w, src[b], n_src, d, c0, x[b]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (wt[b] != 0.f && src[b] >= 0 && src[b] < n_src) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(wt[b], x[b][j]));
      }
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void hub_row(const int* __restrict__ hub_col, const float* __restrict__ hub_val, int e0,
                                        int e1, const T* __restrict__ w_hub, int n_hub_src, long long d, long long c0,
                                        float (&acc)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int b0 = e0; b0 < e1; b0 += kBatch) {
    int src[kBatch];
    float wt[kBatch];
    float x[kBatch][VEC];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = b0 + b;
      src[b] = e < e1 ? hub_col[e] : -1;
      wt[b] = e < e1 ? hub_val[e] : 0.f;
      if (src[b] >= 0 && src[b] < n_hub_src) mixk::load_row<T, VEC>(w_hub, src[b], n_hub_src, d, c0, x[b]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (src[b] >= 0 && src[b] < n_hub_src) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = fmaf(wt[b], x[b][j], acc[j]);
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    mix_hyb_kernel(const int* __restrict__ slot_idx, const float* __restrict__ slot_w,
                   const float* __restrict__ self_w, const int* __restrict__ hub_of, const int* __restrict__ hub_ptr,
                   const int* __restrict__ hub_col, const float* __restrict__ hub_val, const T* __restrict__ w,
                   const T* __restrict__ w_hub, T* __restrict__ y, int n_src, int n_hub_src, int n_rows,
                   long long d, int n_slots, int n_hubs, int nnz, int n_row_blocks) {
  const long long rb = blockIdx.x % n_row_blocks;
  const long long strip = blockIdx.x / n_row_blocks;
  const long long c0 = (strip * kThreads + threadIdx.x) * VEC;
  if (c0 >= d) return;  // the block shares no memory and waits at no barrier
  const int row_end = (int)min((long long)n_rows, (rb + 1) * kRows);
  for (int row = (int)(rb * kRows); row < row_end; ++row) {
    float acc[VEC];
    const int h = hub_of[row];
    if (h < 0 || h >= n_hubs) {
      ell_row<T, VEC>(slot_idx, slot_w, self_w[row], w, row, n_src, n_rows, n_slots, d, c0, acc);
    } else {
      hub_row<T, VEC>(hub_col, hub_val, max(0, hub_ptr[h]), min(nnz, hub_ptr[h + 1]), w_hub, n_hub_src, d, c0,
                      acc);
    }
    mixk::store_row<T, VEC>(y, row, d, c0, acc);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (W, W_hub and Y).  vec in {1, 2, 4} divides d
// and the host checked the three pointers' alignment for it.  W is
// (n_src, d), W_hub (n_hub_src, d), Y (n_rows, d) with n_rows <= n_src;
// slot_idx / slot_w are (n_slots, n_rows), self_w / hub_of (n_rows,),
// hub_ptr (n_hubs + 1,), hub_col / hub_val (nnz,).  Returns a cudaError_t.
extern "C" int mix_hyb(int dtype, const int* slot_idx, const float* slot_w, const float* self_w, const int* hub_of,
                       const int* hub_ptr, const int* hub_col, const float* hub_val, const void* w,
                       const void* w_hub, void* y, int n_src, int n_hub_src, int n_rows, long long d, int n_slots,
                       int n_hubs, int nnz, int vec, void* stream) {
  if (n_rows <= 0 || n_rows > n_src || n_hub_src < 0 || d <= 0 || n_slots < 0 || n_hubs < 0 || nnz < 0)
    return cudaErrorInvalidValue;
  const int n_row_blocks = (n_rows + kRows - 1) / kRows;
  const long long strip_cols = (long long)kThreads * vec;
  const long long strips = (d + strip_cols - 1) / strip_cols;
  const long long blocks = strips * n_row_blocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MIX_HYB_CALL(TT, VV)                                                                                    \
  mix_hyb_kernel<TT, VV><<<(unsigned)blocks, kThreads, 0, s>>>(                                                  \
      slot_idx, slot_w, self_w, hub_of, hub_ptr, hub_col, hub_val, static_cast<const TT*>(w),                    \
      static_cast<const TT*>(w_hub), static_cast<TT*>(y), n_src, n_hub_src, n_rows, d, n_slots, n_hubs, nnz,    \
      n_row_blocks);                                                                                            \
  break;
  switch (dtype * 10 + vec) {
    case 1: MIX_HYB_CALL(float, 1)
    case 2: MIX_HYB_CALL(float, 2)
    case 4: MIX_HYB_CALL(float, 4)
    case 11: MIX_HYB_CALL(__nv_bfloat16, 1)
    case 12: MIX_HYB_CALL(__nv_bfloat16, 2)
    case 14: MIX_HYB_CALL(__nv_bfloat16, 4)
    default: return cudaErrorInvalidValue;
  }
#undef MIX_HYB_CALL
  return (int)cudaGetLastError();
}
