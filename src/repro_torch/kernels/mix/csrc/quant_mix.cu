// Quantised DecAvg mixing for Hopper (sm_90a): Y = M . (H + Q(X - H)), one
// fp32 absmax scale per (source row, chunk), int8 or fp8 e4m3 codes.
//
// Replaces: src/repro/kernels/mix/quant.py::quantised_mix_bsr (Pallas body
// _quant_mix_kernel), which computes Y = M . Q(W) with M in BSR form and
// quantises each source tile as the walk loads it.  This library computes
// that function (raw mode: no H, the Pallas chunking and scale floor) and
// the compressed gossip round of src/repro/core/compress.py, where a node
// transmits Q(x - h) against its mirror h and every peer decodes
// h' = h + Q(x - h) (round mode).  The round's epilogue also writes
// H' = h' and X' = X + gamma (M h' - h') for the rows a block owns.
//
// Arithmetic, to the bit of the JAX package as XLA compiles it (jit):
//   scale  fmaxf(amax, 1e-30f) * fl(1/qmax)      the codec's floor, or
//          fmaxf(amax * fl(1/qmax), 1e-30f)      the Pallas kernel's;
//   code   int8: rintf(t / scale) (half to even, a true IEEE division:
//          this library is built without fast math), clipped to +-127;
//          fp8: __nv_cvt_float_to_fp8(t / scale, SATFINITE, E4M3) and back;
//   h'     __fmaf_rn(q, scale, h) (XLA contracts h + q * scale into one
//          FMA), or __fmul_rn(q, scale) without a mirror.
//
// The kernels.  quant_scales: one block per (row, chunk) reduces the
// chunk's absmax of X - H (a chunk is up to 65,536 columns and need not
// align with any column strip, so the reduction is a pass of its own;
// n * C floats out).  quant_mix_dense: mix.cu's walk with each source
// element dequantised in registers from X, H and its (row, chunk) scale
// before the fp32 FMA; a thread finds the chunk of each of its VEC columns
// once, by binary search of the chunk table (C + 1 boundaries), and reads
// the scale from the n x C table through L1 (the threads of a warp mostly
// share a chunk, so those loads are broadcasts).  quant_mix_bsr, the walk
// of bsr_walk.cuh over the nonzeros of M: in raw mode over the rows peers
// decode, dequantised in registers per reference; in round mode in two
// passes, dequant_rows_kernel writing H' (each element decoded once) and
// then the walk over H' with the X' epilogue.
//
// What bounds it on an H100: bytes.  A round reads X and H and writes X'
// and H' (16 bytes per fp32 element) plus the operator; the flops are the
// mix's (2 n d per dense row, 2 d per nonzero of a BSR operator) and a
// handful per source element to dequantise, below the fp32 rate at the
// main path's sizes.  The BSR round moves 24 bytes an element instead (X
// and H in and H' out, then H', X in and X' out): on the card the one-pass
// form, which decodes a source row once per row that references it (a
// true division, a rint, clips and an FMA), ran slower than that (PERF.md).
// H' is what every neighbour mixed, bit for bit: the walk reads the H' the
// first pass wrote, and the dense walk's owning block recomputes h'_i in
// its epilogue from the same inputs.  Each element of Y, X' and H' is
// written by exactly one block; no atomics: bitwise deterministic.
#include <cuda_fp8.h>

#include "bsr_walk.cuh"

namespace {

using mixk::kThreads;

constexpr int kChunk = 64;           // dense: M columns staged per pass
constexpr int kScaleThreads = 256;   // quant_scales block

struct QArgs {
  const long long* bounds;  // (n_chunks + 1,) column boundaries
  const float* scales;      // (n, n_chunks)
  const float* h;           // (n, d) fp32 mirror, or null
  const unsigned char* keep;  // (n,) rows whose mirror updates, or null (all)
  int n_chunks;
  int codec;  // 0 int8, 1 fp8 e4m3
  int ef;     // 1: quantise X - H and add H back (needs h)
};

__device__ __forceinline__ int find_chunk(const long long* __restrict__ bounds, int n_chunks, long long c) {
  int lo = 0, hi = n_chunks - 1;  // the largest j with bounds[j] <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bounds[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float quantise(float t, float s, int codec) {
  const float v = t / s;
  if (codec == 0) return fminf(fmaxf(rintf(v), -127.f), 127.f);
  __nv_fp8_e4m3 q;
  q.__x = __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  return static_cast<float>(q);
}

// What peers decode from x (and its mirror h) under scale s.
__device__ __forceinline__ float dequantise(float xv, float hv, float s, const QArgs& qa) {
  const float t = qa.ef ? xv - hv : xv;
  const float q = quantise(t, s, qa.codec);
  return qa.ef ? __fmaf_rn(q, s, hv) : __fmul_rn(q, s);
}

// Row `row` of X (and H) at columns c0 .. c0+VEC, and what its peers decode
// there.  Rows outside [0, row_end) read as zero and decode to zero.
template <typename T, int VEC>
__device__ __forceinline__ void load_deq(const T* __restrict__ x, const QArgs& qa, long long row,
                                         long long row_end, long long d, long long c0,
                                         const int (&ch)[VEC], float (&xv)[VEC], float (&out)[VEC]) {
  mixk::load_row<T, VEC>(x, row, row_end, d, c0, xv);
  float hv[VEC];
  if (qa.h != nullptr) {
    mixk::load_row<float, VEC>(qa.h, row, row_end, d, c0, hv);
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) hv[v] = 0.f;
  }
  if (row < 0 || row >= row_end || (qa.keep != nullptr && !qa.keep[row])) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) out[v] = hv[v];
    return;
  }
  const float* srow = qa.scales + row * qa.n_chunks;
#pragma unroll
  for (int v = 0; v < VEC; ++v) out[v] = dequantise(xv[v], hv[v], srow[ch[v]], qa);
}

// acc[r][:] += sum_{k < kc} m_s[r * ldm + k] * deq(row0 + k)[c0 : c0 + VEC]
// (mix_common.cuh's accumulate, with the source rows dequantised).
template <typename T, int VEC, int RG>
__device__ __forceinline__ void accumulate_q(float (&acc)[RG][VEC], const float* __restrict__ m_s, int ldm,
                                             int kc, const T* __restrict__ x, const QArgs& qa,
                                             long long row0, long long row_end, long long d, long long c0,
                                             const int (&ch)[VEC]) {
  for (int k = 0; k < kc; k += 4) {
    float wv[4][VEC], xv[VEC];
#pragma unroll
    for (int j = 0; j < 4; ++j) load_deq<T, VEC>(x, qa, row0 + k + j, row_end, d, c0, ch, xv, wv[j]);
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

template <int VEC>
__device__ __forceinline__ void chunks_of(const QArgs& qa, long long d, long long c0, int (&ch)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) ch[v] = c0 + v < d ? find_chunk(qa.bounds, qa.n_chunks, c0 + v) : 0;
}

// Output row `row`: Y (raw mode), or h'_row and X' = X + gamma (acc - h') (round mode).
template <typename T, int VEC>
__device__ __forceinline__ void epilogue(const T* __restrict__ x, const QArgs& qa, long long row, int n,
                                         long long d, long long c0, const int (&ch)[VEC],
                                         const float (&acc)[VEC], T* __restrict__ y, T* __restrict__ x_out,
                                         float* __restrict__ h_out, float gamma) {
  if (y != nullptr) {
    mixk::store_row<T, VEC>(y, row, d, c0, acc);
    return;
  }
  float xv[VEC], hq[VEC], xo[VEC];
  load_deq<T, VEC>(x, qa, row, n, d, c0, ch, xv, hq);
#pragma unroll
  for (int v = 0; v < VEC; ++v) xo[v] = xv[v] + gamma * (acc[v] - hq[v]);
  mixk::store_row<T, VEC>(x_out, row, d, c0, xo);
  mixk::store_row<float, VEC>(h_out, row, d, c0, hq);
}

template <typename T>
__global__ void __launch_bounds__(kScaleThreads)
    quant_scales_kernel(const T* __restrict__ x, QArgs qa, float* __restrict__ scales, long long d,
                        int floor_pallas) {
  __shared__ float red[kScaleThreads / 32];
  const long long b = blockIdx.x;
  const int j = (int)(b % qa.n_chunks);
  const long long row = b / qa.n_chunks;
  const long long lo = qa.bounds[j], hi = qa.bounds[j + 1];
  const T* xr = x + row * d;
  const float* hr = qa.ef ? qa.h + row * d : nullptr;
  float amax = 0.f;
  for (long long c = lo + threadIdx.x; c < hi; c += kScaleThreads) {
    float t = mixk::to_f32(xr[c]);
    if (hr != nullptr) t = t - hr[c];
    amax = fmaxf(amax, fabsf(t));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kScaleThreads / 32; ++w) amax = fmaxf(amax, red[w]);
    const float inv = qa.codec == 0 ? 1.0f / 127.0f : 1.0f / 448.0f;
    scales[b] = floor_pallas ? fmaxf(__fmul_rn(amax, inv), 1e-30f) : __fmul_rn(fmaxf(amax, 1e-30f), inv);
  }
}

template <typename T, int VEC, int RG>
__device__ __forceinline__ void dense_walk(const float* __restrict__ m, const T* __restrict__ x, QArgs qa,
                                           T* __restrict__ y, T* __restrict__ x_out, float* __restrict__ h_out,
                                           int n, long long d, int n_rg, float gamma) {
  __shared__ __align__(16) float m_s[RG * kChunk];
  const long long strip = blockIdx.x / n_rg;
  const int r0 = (blockIdx.x % n_rg) * RG;
  const long long c0 = (strip * kThreads + threadIdx.x) * VEC;
  int ch[VEC];
  chunks_of<VEC>(qa, d, c0, ch);
  float acc[RG][VEC];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kChunk) {
    const int kc = min(kChunk, n - k0);
    for (int i = threadIdx.x; i < RG * kChunk; i += kThreads) {
      const int r = i / kChunk, k = i % kChunk;
      m_s[i] = (r0 + r < n && k < kc) ? m[(long long)(r0 + r) * n + k0 + k] : 0.f;
    }
    __syncthreads();
    if (c0 < d) accumulate_q<T, VEC, RG>(acc, m_s, kChunk, kc, x, qa, k0, k0 + kc, d, c0, ch);
    __syncthreads();
  }
  if (c0 >= d) return;
#pragma unroll
  for (int r = 0; r < RG; ++r)
    if (r0 + r < n) epilogue<T, VEC>(x, qa, r0 + r, n, d, c0, ch, acc[r], y, x_out, h_out, gamma);
}

template <typename T, int VEC, int RG>
__global__ void __launch_bounds__(kThreads)
    quant_mix_dense_kernel(const float* __restrict__ m, const T* __restrict__ x, QArgs qa, T* __restrict__ y,
                           T* __restrict__ x_out, float* __restrict__ h_out, int n, long long d, int n_rg,
                           float gamma) {
  dense_walk<T, VEC, RG>(m, x, qa, y, x_out, h_out, n, d, n_rg, gamma);
}

// VEC 1, RG 32, on its own: under ptxas's own register choice it spills;
// told of four blocks an SM (128 registers) it does not.  The hint stays off
// the other instantiations, whose register choice it would change.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    quant_mix_dense_v1_kernel(const float* __restrict__ m, const T* __restrict__ x, QArgs qa, T* __restrict__ y,
                              T* __restrict__ x_out, float* __restrict__ h_out, int n, long long d, int n_rg,
                              float gamma) {
  dense_walk<T, 1, 32>(m, x, qa, y, x_out, h_out, n, d, n_rg, gamma);
}

template <typename T, int VEC, int RG>
void launch_dense(unsigned blocks, cudaStream_t s, const float* m, const T* x, const QArgs& qa, T* y, T* x_out,
                  float* h_out, int n, long long d, int n_rg, float gamma) {
  if constexpr (VEC == 1 && RG == 32) {
    quant_mix_dense_v1_kernel<T><<<blocks, kThreads, 0, s>>>(m, x, qa, y, x_out, h_out, n, d, n_rg, gamma);
  } else {
    quant_mix_dense_kernel<T, VEC, RG><<<blocks, kThreads, 0, s>>>(m, x, qa, y, x_out, h_out, n, d, n_rg, gamma);
  }
}

// Raw mode's source rows for the BSR walk (bsr_walk.cuh): what peers decode
// from rows of X.  A thread's chunk of each of its VEC columns advances
// with its column strip.
template <typename T, int VEC>
struct DecodedRows {
  static constexpr int kBatch = 1;  // kRows sources in flight: their X, H and scales
  static constexpr bool kStaged = false;
  const T* __restrict__ x;
  QArgs qa;
  long long d;
  int ch[VEC];

  struct Raw {
    mixk::Pack<T, VEC> x;
    mixk::Pack<float, VEC> h;
    float s[VEC];
    bool update;
  };

  __device__ __forceinline__ void begin_strip(long long c0) {
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      while (ch[v] + 1 < qa.n_chunks && qa.bounds[ch[v] + 1] <= c0 + v) ++ch[v];
  }

  template <bool EDGE>
  __device__ __forceinline__ void fetch(int row, long long c0, Raw& raw) const {
    const long long off = row * d + c0;
    if (!EDGE) {
      raw.x = *reinterpret_cast<const mixk::Pack<T, VEC>*>(x + off);
      if (qa.h != nullptr) raw.h = *reinterpret_cast<const mixk::Pack<float, VEC>*>(qa.h + off);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        raw.x.v[v] = c0 + v < d ? x[off + v] : mixk::from_f32<T>(0.f);
        if (qa.h != nullptr) raw.h.v[v] = c0 + v < d ? qa.h[off + v] : 0.f;
      }
    }
    if (qa.h == nullptr) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) raw.h.v[v] = 0.f;
    }
    const float* srow = qa.scales + (long long)row * qa.n_chunks;
#pragma unroll
    for (int v = 0; v < VEC; ++v) raw.s[v] = srow[ch[v]];
    raw.update = qa.keep == nullptr || qa.keep[row];
  }

  __device__ __forceinline__ void decode(const Raw& raw, float (&out)[VEC]) const {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float hv = raw.h.v[v];
      out[v] = raw.update ? dequantise(mixk::to_f32(raw.x.v[v]), hv, raw.s[v], qa) : hv;
    }
  }
};

// Raw mode, Y = M . Q(X): the walk over the rows peers decode.
template <typename T, int VEC>
__global__ void __launch_bounds__(bsrw::kThreads, 2)
    quant_bsr_raw_kernel(const int* __restrict__ block_cols, const float* __restrict__ tiles,
                         const int* __restrict__ counts, const T* __restrict__ x, QArgs qa, T* __restrict__ y,
                         int n, long long d, int max_nnz, int bn, int groups_per_rb, int slices) {
  DecodedRows<T, VEC> src{x, qa, d, {}};
  bsrw::rows_walk<VEC, 0>(block_cols, tiles, counts, n, d, max_nnz, bn, groups_per_rb, slices, src,
                          bsrw::StoreRows<T, VEC>{y, d});
}

// Round mode, first pass: H' = the rows peers decode, each element once.  A
// block covers kDeqStrips strips of one row; a thread's chunk advances with
// its columns.
constexpr int kDeqThreads = 256;
// The second pass: two blocks an SM, 96 KB of stages each (two strips of a
// ring's or a 4-regular graph's lists and the owned rows' X and h').
constexpr int kStageBytes = 96 * 1024;
constexpr int kDeqStrips = 8;

template <typename T, int VEC>
__global__ void __launch_bounds__(kDeqThreads)
    dequant_rows_kernel(const T* __restrict__ x, QArgs qa, float* __restrict__ h_out, int n, long long d,
                        long long blocks_per_row) {
  const long long row = blockIdx.x / blocks_per_row;
  long long c0 = ((blockIdx.x % blocks_per_row) * kDeqStrips * kDeqThreads + threadIdx.x) * VEC;
  if (c0 >= d) return;
  int ch[VEC];
  chunks_of<VEC>(qa, d, c0, ch);
#pragma unroll
  for (int k = 0; k < kDeqStrips; ++k, c0 += kDeqThreads * VEC) {
    if (c0 < d) {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        while (ch[v] + 1 < qa.n_chunks && qa.bounds[ch[v] + 1] <= c0 + v) ++ch[v];
      float xv[VEC], hq[VEC];
      load_deq<T, VEC>(x, qa, row, n, d, c0, ch, xv, hq);
      mixk::store_row<float, VEC>(h_out, row, d, c0, hq);
    }
  }
}

// Round mode, second pass: X' = X + gamma (M h' - h') for an owned row,
// from its X and h' (staged beside the sources, or loaded before the walk).
template <typename T, int VEC>
struct StoreRound {
  static constexpr int kOwn = 2;
  struct Own {
    float x[VEC], h[VEC];
  };
  const T* __restrict__ x;
  const float* __restrict__ hq;
  T* __restrict__ x_out;
  long long d;
  float gamma;

  __device__ __forceinline__ void stage_own(int a, int row, long long c0, mixk::Pack<float, VEC>* dst) const {
    if (a == 0) {
      bsrw::stage_vec<T, VEC>(x + row * d + c0, c0, d, reinterpret_cast<mixk::Pack<T, VEC>*>(dst));
    } else {
      bsrw::stage_vec<float, VEC>(hq + row * d + c0, c0, d, dst);
    }
  }

  __device__ __forceinline__ Own own_staged(const void* slot) const {
    const auto* o = static_cast<const mixk::Pack<float, VEC>*>(slot);
    const mixk::Pack<T, VEC> xp = *reinterpret_cast<const mixk::Pack<T, VEC>*>(o);
    const mixk::Pack<float, VEC> hp = o[bsrw::kRows * bsrw::kThreads];
    Own own;
#pragma unroll
    for (int v = 0; v < VEC; ++v) own.x[v] = mixk::to_f32(xp.v[v]), own.h[v] = hp.v[v];
    return own;
  }

  __device__ __forceinline__ Own own_load(int row, long long c0) const {
    Own own;
    mixk::load_row<T, VEC>(x, row, row + 1, d, c0, own.x);
    mixk::load_row<float, VEC>(hq, row, row + 1, d, c0, own.h);
    return own;
  }

  __device__ __forceinline__ void operator()(int row, long long c0, const float (&acc)[VEC], const Own& own) const {
    float xo[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) xo[v] = own.x[v] + gamma * (acc[v] - own.h[v]);
    mixk::store_row<T, VEC>(x_out, row, d, c0, xo);
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(bsrw::kThreads, 2)
    quant_bsr_round_kernel(const int* __restrict__ block_cols, const float* __restrict__ tiles,
                           const int* __restrict__ counts, const T* __restrict__ x, const float* __restrict__ hq,
                           T* __restrict__ x_out, int n, long long d, int max_nnz, int bn, int groups_per_rb,
                           int slices, float gamma) {
  bsrw::RowsOf<float, VEC> src{hq, d};
  bsrw::rows_walk<VEC, kStageBytes>(block_cols, tiles, counts, n, d, max_nnz, bn, groups_per_rb, slices, src,
                                    StoreRound<T, VEC>{x, hq, x_out, d, gamma});
}

// Raw mode writes y and leaves x_out / h_out null; round mode the reverse.
bool bad_outputs(const void* y, const void* x_out, const float* h_out) {
  return y != nullptr ? (x_out != nullptr || h_out != nullptr) : (x_out == nullptr || h_out == nullptr);
}

QArgs make_args(const long long* bounds, const float* scales, const float* h, const unsigned char* keep,
                int n_chunks, int codec, int ef) {
  QArgs qa;
  qa.bounds = bounds;
  qa.scales = scales;
  qa.h = h;
  qa.keep = keep;
  qa.n_chunks = n_chunks;
  qa.codec = codec;
  qa.ef = ef;
  return qa;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (X).  codec: 0 = int8, 1 = fp8 e4m3.  ef = 1
// reduces |X - H| (h required), else |X|.  floor_pallas picks the Pallas
// kernel's scale floor.  scales is (n, n_chunks) fp32.  Returns a cudaError_t.
extern "C" int quant_scales(int dtype, const void* x, const float* h, const long long* bounds, float* scales,
                            int n, long long d, int n_chunks, int codec, int ef, int floor_pallas,
                            void* stream) {
  if (n <= 0 || d <= 0 || n_chunks <= 0 || (ef && h == nullptr) || codec < 0 || codec > 1)
    return cudaErrorInvalidValue;
  const long long blocks = (long long)n * n_chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const QArgs qa = make_args(bounds, nullptr, h, nullptr, n_chunks, codec, ef);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    quant_scales_kernel<float><<<(unsigned)blocks, kScaleThreads, 0, s>>>(
        static_cast<const float*>(x), qa, scales, d, floor_pallas);
  } else if (dtype == 1) {
    quant_scales_kernel<__nv_bfloat16><<<(unsigned)blocks, kScaleThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), qa, scales, d, floor_pallas);
  } else {
    return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Dense M (n, n) fp32.  Raw mode: y (n, d) in X's dtype, h and keep null.
// Round mode: x_out (X's dtype) and h_out (fp32), gamma the consensus step.
// vec in {1, 2, 4} divides d and the host checked every pointer's alignment.
extern "C" int quant_mix_dense(int dtype, const float* m, const void* x, const float* h,
                               const unsigned char* keep, const long long* bounds, const float* scales,
                               void* y, void* x_out, float* h_out, int n, long long d, int n_chunks,
                               int codec, int ef, float gamma, int vec, void* stream) {
  if (n <= 0 || d <= 0 || n_chunks <= 0 || (ef && h == nullptr) || (keep != nullptr && h == nullptr) ||
      codec < 0 || codec > 1 || bad_outputs(y, x_out, h_out) || (y != nullptr && (h || keep)))
    return cudaErrorInvalidValue;
  const int rg = n <= 8 ? 8 : n <= 16 ? 16 : 32;
  const int n_rg = (n + rg - 1) / rg;
  const long long strip_cols = (long long)kThreads * vec;
  const long long blocks = ((d + strip_cols - 1) / strip_cols) * n_rg;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const QArgs qa = make_args(bounds, scales, h, keep, n_chunks, codec, ef);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QMIX_DENSE_CALL(T, VEC, RG)                                                                 \
  launch_dense<T, VEC, RG>((unsigned)blocks, s, m, static_cast<const T*>(x), qa, static_cast<T*>(y), \
                           static_cast<T*>(x_out), h_out, n, d, n_rg, gamma)
  return (int)MIXK_DISPATCH(dtype, vec, rg, QMIX_DENSE_CALL);
#undef QMIX_DENSE_CALL
}

// M in BSR form, as mix_bsr.  Outputs and the rest as quant_mix_dense.
extern "C" int quant_mix_bsr(int dtype, const int* block_cols, const float* tiles, const int* counts,
                             const void* x, const float* h, const unsigned char* keep,
                             const long long* bounds, const float* scales, void* y, void* x_out,
                             float* h_out, int n, long long d, int n_chunks, int nrb, int max_nnz, int bn,
                             int codec, int ef, float gamma, int vec, void* stream) {
  if (n <= 0 || d <= 0 || n_chunks <= 0 || bn <= 0 || bn > 256 || (long long)nrb * bn < n ||
      max_nnz <= 0 || (ef && h == nullptr) || (keep != nullptr && h == nullptr) || codec < 0 ||
      codec > 1 || bad_outputs(y, x_out, h_out) || (y != nullptr && (h || keep)))
    return cudaErrorInvalidValue;
  const int groups_per_rb = (bn + bsrw::kRows - 1) / bsrw::kRows;
  const long long slices = bsrw::slices_of(d, vec);
  const long long blocks = (long long)nrb * groups_per_rb * slices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const QArgs qa = make_args(bounds, scales, h, keep, n_chunks, codec, ef);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QMIX_BSR_CALL(T, VEC)                                                                          \
  {                                                                                                    \
    if (y != nullptr) {                                                                                \
      quant_bsr_raw_kernel<T, VEC><<<(unsigned)blocks, bsrw::kThreads, 0, s>>>(                        \
          block_cols, tiles, counts, static_cast<const T*>(x), qa, static_cast<T*>(y), n, d, max_nnz,  \
          bn, groups_per_rb, (int)slices);                                                             \
    } else {                                                                                           \
      const long long per_row = (d + (long long)kDeqStrips * kDeqThreads * VEC - 1) /                 \
                                ((long long)kDeqStrips * kDeqThreads * VEC);                           \
      if (n * per_row > 0x7fffffffLL) return cudaErrorInvalidConfiguration;                            \
      dequant_rows_kernel<T, VEC><<<(unsigned)(n * per_row), kDeqThreads, 0, s>>>(                     \
          static_cast<const T*>(x), qa, h_out, n, d, per_row);                                         \
      const auto kernel = quant_bsr_round_kernel<T, VEC>;                                              \
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);          \
      kernel<<<(unsigned)blocks, bsrw::kThreads, kStageBytes, s>>>(                                    \
          block_cols, tiles, counts, static_cast<const T*>(x), h_out, static_cast<T*>(x_out), n, d,    \
          max_nnz, bn, groups_per_rb, (int)slices, gamma);                                             \
    }                                                                                                  \
  }
  return (int)BSRW_DISPATCH(dtype, vec, QMIX_BSR_CALL);
#undef QMIX_BSR_CALL
}
