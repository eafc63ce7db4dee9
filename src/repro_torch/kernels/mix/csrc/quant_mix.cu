// Quantised DecAvg mixing for Hopper (sm_90a): Y = M . (H + Q(X - H)), one
// fp32 absmax scale per (source row, chunk), int8 or fp8 e4m3 codes.
//
// Replaces: src/repro/kernels/mix/quant.py::quantised_mix_bsr (Pallas body
// _quant_mix_kernel), which computes Y = M . Q(W) with M in BSR form and
// quantises each source tile as the walk loads it.  This library computes
// that function (raw mode: no H, the Pallas chunking and scale floor) and
// the compressed gossip round of src/repro/core/compress.py, where a node
// transmits Q(x - h) against its mirror h and every peer decodes
// h' = h + Q(x - h) (round mode), then writes H' = h' and
// X' = X + gamma (M h' - h').
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
// The kernels.  quant_mix_dense, M dense: one launch a round,
// quant_round_kernel (its own section below), which reduces the scales,
// decodes, mixes and writes in one pass over X and H.  quant_scales: one
// block per (row, chunk) reduces the chunk's absmax of X - H (n * C floats
// out), for the block-sparse round.  quant_mix_bsr, the walk of
// bsr_walk.cuh over the nonzeros of M, with the scales quant_scales gave:
// in raw mode over the rows peers decode, dequantised in registers per
// reference; in round mode in two passes, dequant_rows_kernel writing H'
// (each element decoded once) and then the walk over H' with the X'
// epilogue.
//
// What bounds it on an H100: bytes.  A round reads X and H and writes X'
// and H' (16 bytes per fp32 element) plus the operator; the flops are the
// mix's (2 n d per dense row, 2 d per nonzero of a BSR operator) and a
// handful per source element to dequantise, below the fp32 rate at the
// main path's sizes.  The dense round moves those 16 bytes.  The BSR round
// moves 24 bytes an element, besides the scales pass's 8 (X and H in and H'
// out, then H', X in and X' out): on the card the one-pass form, which
// decodes a source row once per row that references it (a true division,
// a rint, clips and an FMA), ran slower than that (PERF.md).  H' is what
// every neighbour mixed, bit for bit.  Each element of Y, X' and H' is
// written by exactly one block; no atomics: bitwise deterministic.
#include <cooperative_groups.h>
#include <cuda_fp8.h>

#include <cstdint>

#include "bsr_walk.cuh"

namespace {


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

// What peers decode from x (and its mirror h) under scale s; ef: x - h was
// quantised and h is added back.
__device__ __forceinline__ float decode(float xv, float hv, float s, int codec, int ef) {
  const float t = ef ? xv - hv : xv;
  const float q = quantise(t, s, codec);
  return ef ? __fmaf_rn(q, s, hv) : __fmul_rn(q, s);
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
  for (int v = 0; v < VEC; ++v) out[v] = decode(xv[v], hv[v], srow[ch[v]], qa.codec, qa.ef);
}

template <int VEC>
__device__ __forceinline__ void chunks_of(const QArgs& qa, long long d, long long c0, int (&ch)[VEC]) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) ch[v] = c0 + v < d ? find_chunk(qa.bounds, qa.n_chunks, c0 + v) : 0;
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

// ------------------------------------------------------------ the dense round
// One launch a round: quant_round_kernel computes the scales, decodes each
// element once, mixes and writes X' and H' (or Y) in one pass over X and H.
//
// Tiles.  The host (quant.py::plan_tiles) cuts the chunk table into column
// tiles on chunk boundaries: whole chunks, at most tile_chunks of them and
// at most cluster x cols columns, or one chunk wider than that.  The grid is
// persistent: as many thread-block clusters as fit on the card at once,
// each walking the tiles t = c, c + clusters, ...; CTA `rank` of a cluster
// takes each tile's rank-th slice of ceil(width / cluster) columns, all n
// rows.
//
// Staged route (a tile of at most cluster x cols columns).  A CTA copies its
// slice of X and H, n rows, into shared memory with 16-byte cp.async (a
// row's unaligned head and tail element by element: rows are as little as
// one element aligned).  It reduces each (row, chunk) partial absmax of
// X - H from the stage and stores it into every peer's shared memory
// (distributed shared memory: stores, which do not wait, rather than loads,
// which do); after the cluster's barrier each CTA takes the max of the
// partials it holds, and rank 0 writes the scale table.  (One cluster
// barrier at the start, its wait after M^T is filled, makes sure every
// peer is running before the first such store.)  Each staged
// element is then decoded once, h' overwrites h in shared memory and goes
// out as H', and the CTA forms M h' for its columns from shared memory (M
// there too) and writes X' = X + gamma (M h' - h') from the staged X.  HBM
// traffic: X and H in, X' and H' out, 16 bytes an fp32 element.  While it
// works on a tile, the CTA has L2 fetch its slice of the next one.
//
// Wide route (one chunk wider than cluster x cols; Compression.chunk allows
// 65,536 columns).  The CTA reduces its slice's partial absmax straight from
// device memory, the cluster combines them, then the CTA walks its slice in
// passes of cols columns, each staged, decoded, mixed and written as above:
// the chunk is read twice, 24 bytes an element.
//
// The mix: a warp owns RG output rows and VEC columns a lane (lanes on
// neighbouring columns, a lane's columns 32 apart, so the reads of h' are
// free of bank conflicts); every output is one fp32 FMA chain over k = 0 ..
// n-1, M^T read as RG / 4 broadcast float4s a k.  Past kMResidentMax
// rows M does not fit beside the stages and is read from device memory
// through L1 (MG).  No atomics: two launches are bitwise equal, and the
// scales and H' are bitwise quant_scales_ref and ref.py's decode (the
// absmax is a max, exact in any order).
//
// What holds it: latency more than bytes.  A tile is a chain of barriers
// (the stage, the cluster's partials, the decode, the mix), so an SM needs
// several CTAs at once: each n's (RG, VEC) comes with a thread count and a
// register cap that keep it free of spills (dispatch_round), chosen in
// A/Bs on the card (PERF.md): n <= 32 runs 256 threads at 64 registers,
// four CTAs an SM; up to 128 rows 512 threads at 128.  Two stage buffers
// (the next tile's copies in flight during this one) halved the CTAs an SM
// and lost at every shape tried.
namespace cg = cooperative_groups;

constexpr int kMResidentMax = 128;        // M sits in shared memory up to this n
constexpr int kMaxCluster = 8;            // CTAs of a tile (the portable cluster size)
constexpr long long kSmemLimit = 232448;  // dynamic shared memory a block may use on sm_90

struct RoundArgs {
  const float* m;             // (n, n)
  const void* x;              // (n, d) fp32 or bf16
  const float* h;             // (n, d) fp32 mirror, or null
  const unsigned char* keep;  // (n,) or null
  const long long* bounds;    // (n_chunks + 1,) the chunk table
  const long long* tiles;     // (n_tiles, 4): first column, end column, first chunk, end chunk
  float* scales;              // (n, n_chunks) out
  void* y;                    // raw mode out, X's dtype
  void* x_out;                // round mode out, X's dtype
  float* h_out;               // round mode out
  long long d;
  int n, n_chunks, n_tiles, cols, tile_chunks, codec, ef, floor_pallas;
  float gamma;
};

__host__ __device__ constexpr long long align16(long long b) { return (b + 15) & ~15LL; }

// Byte offsets of the round kernel's dynamic shared memory, for n rows,
// `cols` staged columns, tables of `tc` chunks and X elements of `xsize`
// bytes.  Tile i's partials are at part + (i & 1) * part_buf, one (n, tc)
// table for each CTA of the cluster (each CTA stores its own into every
// peer's); two, so that a CTA's next tile never overwrites what a peer
// still reads.
// quant.py::round_smem_bytes computes `total` on the host, and a card
// test holds it equal to quant_round_smem_bytes.
struct RoundSmem {
  int m_rows, sx, sh, n4;
  int m, part, part_buf, sc, cb, cc, xb, hb, keep, xs, hs;  // byte offsets: int, as the block's memory is < 227 KB
  long long total;
  __host__ __device__ RoundSmem(int n, int cols, int tc, int rg, int xsize, bool m_resident) {
    const int e = 16 / xsize;
    n4 = (n + 3) & ~3;
    m_rows = (n + rg - 1) / rg * rg;
    sx = (cols + e - 1) / e * e + e;  // room for a row's shift of up to e - 1 elements
    sh = (cols + 3) / 4 * 4 + 4;
    long long off = 0;
    m = (int)off, off += align16(m_resident ? 4LL * m_rows * n : 0);  // M^T, k-major
    part = (int)off, off += 2 * align16(4LL * kMaxCluster * n * tc);
    sc = (int)off, off += align16(4LL * n * tc);
    cb = (int)off, off += align16(8LL * (tc + 1));
    cc = (int)off, off += align16(cols);
    xb = (int)off, off += align16(4LL * n4);
    hb = (int)off, off += align16(4LL * n4);
    keep = (int)off, off += align16(n);
    xs = (int)off, off += align16((long long)xsize * n * sx);
    hs = (int)off, off += align16(4LL * n * sh);
    part_buf = (int)align16(4LL * kMaxCluster * n * tc);
    total = off;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One warp copies `count` elements of a row into shared memory: element e
// lands at dst[shift + e], shift being src's element offset in its 16-byte
// word, so the middle of the row goes over as 16-byte cp.async copies and
// only the head and tail element by element.  dst is 16-byte aligned.
template <typename T>
__device__ __forceinline__ int stage_row(T* dst, const T* src, int count, int lane) {
  constexpr int kE = 16 / sizeof(T);
  const int shift = (int)((reinterpret_cast<uintptr_t>(src) / sizeof(T)) % kE);
  const int head = min(count, (kE - shift) % kE);
  const int nv = (count - head) / kE;
  const int tail = head + nv * kE;
  for (int j = lane; j < nv; j += 32) cp_async16(dst + shift + head + j * kE, src + head + j * kE);
  if (lane < head) dst[shift + lane] = src[lane];
  if (tail + lane < count) dst[shift + tail + lane] = src[tail + lane];
  return shift;
}

// Stage columns [p0, p0 + pw) of every row of X (and H) and record where
// each row starts in shared memory.  Ends with the block's barrier.
template <typename T, int WARPS>
__device__ __forceinline__ void stage(const RoundArgs& a, const RoundSmem& L, char* smem, long long p0, int pw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  int* xb = reinterpret_cast<int*>(smem + L.xb);
  int* hb = reinterpret_cast<int*>(smem + L.hb);
  const T* x = static_cast<const T*>(a.x);
  for (int r = warp; r < a.n; r += WARPS) {
    const long long off = r * a.d + p0;
    const int sx = stage_row<T>(xs + (long long)r * L.sx, x + off, pw, lane);
    const int sh = a.h != nullptr ? stage_row<float>(hs + (long long)r * L.sh, a.h + off, pw, lane) : 0;
    if (lane == 0) xb[r] = r * L.sx + sx, hb[r] = r * L.sh + sh;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Ask L2 for columns [p0, p0 + pw) of every row of X (and H): one
// prefetch a 128-byte line, and the row's last element.
template <typename T, int WARPS>
__device__ __forceinline__ void prefetch_l2(const RoundArgs& a, long long p0, int pw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (pw <= 0) return;
  for (int r = warp; r < a.n; r += WARPS) {
    const T* xr = static_cast<const T*>(a.x) + r * a.d + p0;
    const float* hr = a.h != nullptr ? a.h + r * a.d + p0 : nullptr;
    for (int c = lane * (128 / (int)sizeof(T)); c < pw + 128 / (int)sizeof(T); c += 32 * (128 / (int)sizeof(T)))
      asm volatile("prefetch.global.L2 [%0];" ::"l"(xr + min(c, pw - 1)));
    if (hr != nullptr)
      for (int c = lane * 32; c < pw + 32; c += 32 * 32) asm volatile("prefetch.global.L2 [%0];" ::"l"(hr + min(c, pw - 1)));
  }
}

// M[r0 .. r0+RG, k], zero past n: from M^T in shared memory (k-major, rows
// padded to m_rows), RG / 4 broadcast float4 loads; or from device memory.
template <int RG, bool MG>
__device__ __forceinline__ void m_column(const RoundArgs& a, const float* m_s, int m_rows, int r0, int k,
                                         float (&mk)[RG]) {
  if constexpr (!MG) {
#pragma unroll
    for (int q = 0; q < RG / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(m_s + k * m_rows + r0 + 4 * q);
      mk[4 * q] = v.x, mk[4 * q + 1] = v.y, mk[4 * q + 2] = v.z, mk[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < RG; ++r) mk[r] = r0 + r < a.n ? __ldg(a.m + (long long)(r0 + r) * a.n + k) : 0.f;
  }
}

// Tile t as this CTA sees it: its slice [s_lo, s_hi) of the tile's columns.
struct TileSlice {
  long long s_lo, s_hi;
  int j_lo, nch;
  bool wide;
};

__device__ __forceinline__ TileSlice slice_of(const RoundArgs& a, long long t, int G, int rank) {
  const long long* tile = a.tiles + 4 * t;
  const long long c_lo = tile[0], c_hi = tile[1], width = c_hi - c_lo;
  const long long sw = (width + G - 1) / G;
  TileSlice s;
  s.s_lo = min(c_hi, c_lo + rank * sw);
  s.s_hi = min(c_hi, s.s_lo + sw);
  s.j_lo = (int)tile[2];
  s.nch = (int)(tile[3] - tile[2]);
  s.wide = width > (long long)G * a.cols;
  return s;
}

template <typename T, int RG, int VEC, bool MG, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) quant_round_kernel(RoundArgs a) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long n_clusters = gridDim.x / G;
  const int n = a.n, tc = a.tile_chunks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const RoundSmem L(n, a.cols, tc, RG, (int)sizeof(T), !MG);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  long long* cb = reinterpret_cast<long long*>(smem + L.cb);
  unsigned char* cc = reinterpret_cast<unsigned char*>(smem + L.cc);
  unsigned char* keep_s = reinterpret_cast<unsigned char*>(smem + L.keep);
  const T* xs = reinterpret_cast<const T*>(smem + L.xs);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  const int* xb = reinterpret_cast<const int*>(smem + L.xb);
  const int* hb = reinterpret_cast<const int*>(smem + L.hb);

  // Every CTA of the cluster is running before any stores into a peer's
  // shared memory: arrive here, wait once M^T and keep are filled.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if constexpr (!MG) {  // M^T: m_s[k * m_rows + r] = M[r, k]
    for (int i = tid; i < L.m_rows * n; i += THREADS) {
      const int k = i / L.m_rows, r = i - k * L.m_rows;
      m_s[i] = r < n ? a.m[(long long)r * n + k] : 0.f;
    }
  }
  for (int r = tid; r < n; r += THREADS) keep_s[r] = a.keep == nullptr || a.keep[r];
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  const float inv = a.codec == 0 ? 1.0f / 127.0f : 1.0f / 448.0f;
  const int n_rg = (n + RG - 1) / RG;
  int it = 0;
  for (long long t = blockIdx.x / G; t < a.n_tiles; t += n_clusters, ++it) {
    const TileSlice s = slice_of(a, t, G, rank);
    float* part = reinterpret_cast<float*>(smem + L.part + (it & 1) * L.part_buf);
    for (int i = tid; i <= s.nch; i += THREADS) cb[i] = a.bounds[s.j_lo + i];

    // each (row, chunk) partial absmax of X - H over this CTA's slice
    if (!s.wide) {
      stage<T, kWarps>(a, L, smem, s.s_lo, (int)(s.s_hi - s.s_lo));
      if (t + n_clusters < a.n_tiles) {  // the next tile's slice into L2 while this one is worked on
        const TileSlice s_next = slice_of(a, t + n_clusters, G, rank);
        if (!s_next.wide) prefetch_l2<T, kWarps>(a, s_next.s_lo, (int)(s_next.s_hi - s_next.s_lo));
      }
      for (int r = warp; r < n; r += kWarps) {
        const T* xr = xs + xb[r];
        const float* hr = hs + hb[r];
        for (int jj = 0; jj < s.nch; ++jj) {
          const int lo = (int)(max(cb[jj], s.s_lo) - s.s_lo), hi = (int)(min(cb[jj + 1], s.s_hi) - s.s_lo);
          float amax = 0.f;
#pragma unroll 4
          for (int c = lo + lane; c < hi; c += 32) {
            float v = mixk::to_f32(xr[c]);
            if (a.ef) v = v - hr[c];
            amax = fmaxf(amax, fabsf(v));
          }
          amax = warp_max(amax);
          if (lane < G) cluster.map_shared_rank(part, lane)[(rank * n + r) * tc + jj] = amax;
        }
      }
    } else {  // one chunk: reduce straight from device memory
      const T* x = static_cast<const T*>(a.x);
      for (int r = warp; r < n; r += kWarps) {
        const T* xr = x + r * a.d;
        const float* hr = a.ef ? a.h + r * a.d : nullptr;
        float amax = 0.f;
#pragma unroll 4
        for (long long c = s.s_lo + lane; c < s.s_hi; c += 32) {
          float v = mixk::to_f32(xr[c]);
          if (hr != nullptr) v = v - hr[c];
          amax = fmaxf(amax, fabsf(v));
        }
        amax = warp_max(amax);
        if (lane < G) cluster.map_shared_rank(part, lane)[(rank * n + r) * tc] = amax;
      }
    }
    cluster.sync();

    // the max of the cluster's partials, which every CTA stored here: the scales
    for (int i = tid; i < n * s.nch; i += THREADS) {
      const int r = i / s.nch, jj = i - r * s.nch;
      float amax = 0.f;
      for (int q = 0; q < G; ++q) amax = fmaxf(amax, part[(q * n + r) * tc + jj]);
      const float sv = a.floor_pallas ? fmaxf(__fmul_rn(amax, inv), 1e-30f) : __fmul_rn(fmaxf(amax, 1e-30f), inv);
      sc[r * tc + jj] = sv;
      if (rank == 0) a.scales[(long long)r * a.n_chunks + s.j_lo + jj] = sv;
    }

    for (long long p0 = s.s_lo; p0 < s.s_hi; p0 += a.cols) {
      const int pw = (int)min((long long)a.cols, s.s_hi - p0);
      if (s.wide) {
        __syncthreads();  // the previous pass is done with the stage
        stage<T, kWarps>(a, L, smem, p0, pw);
      }
      for (int c = tid; c < pw; c += THREADS) {
        int jj = 0;
        while (jj + 1 < s.nch && cb[jj + 1] <= p0 + c) ++jj;
        cc[c] = (unsigned char)jj;
      }
      __syncthreads();

      // decode each staged element once: h' over h, and out as H'
      for (int r = warp; r < n; r += kWarps) {
        const T* xr = xs + xb[r];
        float* hr = hs + hb[r];
        const float* sr = sc + r * tc;
        const bool upd = keep_s[r];
        float* ho = a.h_out != nullptr ? a.h_out + r * a.d + p0 : nullptr;
#pragma unroll 4
        for (int c = lane; c < pw; c += 32) {
          const float hv = a.h != nullptr ? hr[c] : 0.f;
          const float hq = upd ? decode(mixk::to_f32(xr[c]), hv, sr[cc[c]], a.codec, a.ef) : hv;
          hr[c] = hq;
          if (ho != nullptr) ho[c] = hq;
        }
      }
      __syncthreads();

      // M h' for the slice's columns; the epilogue writes Y or X'
      const int nb = (pw + 32 * VEC - 1) / (32 * VEC);
      for (int item = warp; item < n_rg * nb; item += kWarps) {
        const int g = item / nb, c0 = (item - g * nb) * 32 * VEC + lane;
        const int r0 = g * RG;
        int ci[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) ci[v] = min(c0 + 32 * v, pw - 1);
        float acc[RG][VEC];
#pragma unroll
        for (int r = 0; r < RG; ++r)
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;
#pragma unroll 2
        for (int k = 0; k < n; ++k) {
          const float* hr = hs + hb[k];
          float hv[VEC], mk[RG];
#pragma unroll
          for (int v = 0; v < VEC; ++v) hv[v] = hr[ci[v]];
          m_column<RG, MG>(a, m_s, L.m_rows, r0, k, mk);
#pragma unroll
          for (int r = 0; r < RG; ++r)
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(mk[r], hv[v], acc[r][v]);
        }
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const int row = r0 + r;
          if (row >= n) break;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const int c = c0 + 32 * v;
            if (c >= pw) continue;
            const long long o = row * a.d + p0 + c;
            if (a.y != nullptr) {
              static_cast<T*>(a.y)[o] = mixk::from_f32<T>(acc[r][v]);
            } else {
              const float xv = mixk::to_f32(xs[xb[row] + c]), hq = hs[hb[row] + c];
              static_cast<T*>(a.x_out)[o] = mixk::from_f32<T>(xv + a.gamma * (acc[r][v] - hq));
            }
          }
        }
      }
      if (!s.wide) break;
    }
    __syncthreads();  // the stage, the scales and the chunk map are free for the next tile
  }
  cluster.sync();  // no CTA leaves while a peer may still store into its partials
}

template <typename T, int RG, int VEC, bool MG, int THREADS, int MIN_BLOCKS>
cudaError_t launch_round(const RoundArgs& a, int cluster, cudaStream_t s) {
  const RoundSmem L(a.n, a.cols, a.tile_chunks, RG, (int)sizeof(T), !MG);
  if (L.total > kSmemLimit) return cudaErrorInvalidValue;
  const auto kernel = quant_round_kernel<T, RG, VEC, MG, THREADS, MIN_BLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)a.n_tiles * cluster));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)L.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // persistent: as many clusters as the card holds at once, each walking tiles
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((unsigned)((long long)(resident < a.n_tiles ? resident : a.n_tiles) * cluster));
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// A warp's output rows in the round's mix for n rows.
__host__ __device__ constexpr int round_rg(int n) { return n <= 8 ? 8 : 16; }

// The round's shape for n rows: a warp's output rows RG (round_rg) and a
// lane's columns VEC, M from device memory (MG) past kMResidentMax rows,
// the threads of a CTA and the CTAs an SM the registers are capped for.
template <typename T>
cudaError_t dispatch_round(const RoundArgs& a, int cluster, cudaStream_t s) {
  constexpr int kMore = kMResidentMax + 1;
  if (a.n <= 8) return launch_round<T, round_rg(8), 2, false, 256, 3>(a, cluster, s);
  if (a.n <= 32) return launch_round<T, round_rg(32), 1, false, 256, 4>(a, cluster, s);
  if (a.n <= kMResidentMax) return launch_round<T, round_rg(kMResidentMax), 4, false, 512, 1>(a, cluster, s);
  return launch_round<T, round_rg(kMore), 1, true, 256, 1>(a, cluster, s);
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
      out[v] = raw.update ? ::decode(mixk::to_f32(raw.x.v[v]), hv, raw.s[v], qa.codec, qa.ef) : hv;
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
  bsrw::rows_walk<VEC, 0>(block_cols, tiles, counts, n, n, d, max_nnz, bn, groups_per_rb, slices, src,
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
  bsrw::rows_walk<VEC, kStageBytes>(block_cols, tiles, counts, n, n, d, max_nnz, bn, groups_per_rb, slices, src,
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

// Dense M (n, n) fp32: one round, its scales included.  Raw mode: y (n, d)
// in X's dtype, h and keep null.  Round mode: x_out (X's dtype) and h_out
// (fp32), gamma the consensus step.  scales (n, n_chunks) fp32 out, floored
// as quant_scales.  tiles (n_tiles, 4) int64 and cluster, cols and
// tile_chunks are the host's plan (quant.py::plan_tiles).
extern "C" int quant_mix_dense(int dtype, const float* m, const void* x, const float* h,
                               const unsigned char* keep, const long long* bounds, const long long* tiles,
                               float* scales, void* y, void* x_out, float* h_out, int n, long long d,
                               int n_chunks, int n_tiles, int cluster, int cols, int tile_chunks, int codec,
                               int ef, int floor_pallas, float gamma, void* stream) {
  if (n <= 0 || d <= 0 || n_chunks <= 0 || n_tiles <= 0 || cols <= 0 || tile_chunks <= 0 || tile_chunks > 255 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) || (ef && h == nullptr) ||
      (keep != nullptr && h == nullptr) || codec < 0 || codec > 1 || bad_outputs(y, x_out, h_out) ||
      (y != nullptr && (h || keep)))
    return cudaErrorInvalidValue;
  if ((long long)n_tiles * cluster > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  RoundArgs a;
  a.m = m, a.x = x, a.h = h, a.keep = keep, a.bounds = bounds, a.tiles = tiles, a.scales = scales;
  a.y = y, a.x_out = x_out, a.h_out = h_out, a.d = d;
  a.n = n, a.n_chunks = n_chunks, a.n_tiles = n_tiles, a.cols = cols, a.tile_chunks = tile_chunks;
  a.codec = codec, a.ef = ef;
  a.floor_pallas = floor_pallas, a.gamma = gamma;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_round<float>(a, cluster, s);
  if (dtype == 1) return (int)dispatch_round<__nv_bfloat16>(a, cluster, s);
  return cudaErrorInvalidValue;
}

// The dynamic shared memory of quant_mix_dense's kernel for n rows, `cols`
// staged columns, tables of `tile_chunks` chunks and X elements of `xsize`
// bytes (quant.py::round_smem_bytes computes the same on the host).
extern "C" long long quant_round_smem_bytes(int n, int cols, int tile_chunks, int xsize) {
  return RoundSmem(n, cols, tile_chunks, round_rg(n), xsize, n <= kMResidentMax).total;
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
