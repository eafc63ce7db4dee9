// Dense DecAvg mixing  Y = M . W  for Hopper (sm_90a): two routes.
//
// Replaces: src/repro/kernels/mix/mix.py::mix_matmul (Pallas body _mix_kernel),
// the TPU kernel of the dense mixing backend.  M is the (n, n) fp32
// row-stochastic operator, W the (n, d) node-major flattened parameters (fp32
// on the training path, or bf16), Y has W's dtype and is accumulated in fp32
// on the CUDA cores (mix_common.cuh says why never TF32).  The host picks the
// route from (n, d, dtype) alone (kernels/mix/mix.py::dense_route), never
// from a pointer, so a chunked or resumed run sums in the same order.
//
// What bounds it on an H100.  At the gossip payloads (CommPlan.spread: Mᵀ
// with d = 1-4 columns, n up to 256 and beyond) the work is a few KB and
// the floor is the launch itself, ~4.8 us for an empty kernel; what counts
// is how few dependent memory round trips the one launch takes.  At the
// training widths (d ~ 10^4-10^8, n <= 64) the product reads 4n bytes and
// writes 4n bytes per column for 2n^2 flops (n/4 flop per byte, against a
// ridge near n = 80 for 67 TFLOP/s of fp32 FMA and 3.35 TB/s): the least
// time is 8 n d bytes over the memory rate.
//
// Thin route (mix_thin_kernel, d <= D_THIN): one warp, alone in its block,
// per output row and tile of CT <= 32 columns.  Lanes stride over k, each
// keeping CT fp32 partial sums (M's row read coalesced, W[k, tile] a few
// bytes a lane, 8 k of loads in flight at CT <= 4), then a fixed xor-shuffle
// tree adds the 32 partials and lane 0 writes: one memory round trip at
// n <= 256.  One warp a block spreads kreg4-256's rows over 256 blocks; two
// or more warps a block ran slower there.
//
// Wide route (mix_wide_kernel): one block of 128 threads per (strip of 128
// x 8 bytes of columns, group of RG output rows: 8 at <= 8 rows, else 16; the row
// groups of a strip adjacent in launch order, so the second reads W from
// L2).  A thread issues its loads of the first KB W rows (all of them at
// n <= 16, 8 at a time beyond) before the block stages its RG x n slice of M in
// shared memory and syncs, so the staging hides behind them; then KB
// broadcast float4 reads of M feed RG x 8 bytes of fused multiply-adds.
// A thread reads 8 bytes of every W row at once and stores its Y values
// whole when all rows are 8-byte aligned (d even and both pointers 8-byte
// aligned: every training width), else element by element: a uniform
// choice inside the kernel that changes the accesses, not the sums.  Each output is one fp32 FMA
// chain over k in ascending order, bitwise the kernel it replaced.  Tried
// and measured slower at the MLP and VGG16 widths, so not kept: a
// persistent grid (one wave from the occupancy API) streaming W through a
// cp.async ring in shared memory, the same grid pipelining W in registers,
// and 16-byte loads (the realigning shuffles or twice the registers per row
// in flight left fewer warps to hide DRAM latency).
//
// Both routes: the ragged edge of d is masked in the kernel, nothing is
// padded or copied, indices are 64-bit (n d > 2^31 at VGG16's n = 64), no
// atomics: two launches agree bit for bit.
//
// What replaced what: the port's first dense kernel ran every shape as the
// wide route does, with the vector width (16, 8 or 4 bytes) picked on the
// host from d and the pointers, M's rows staged 64 columns at a time
// (zero-filled past n) before the first W load, and 4 W rows in flight a
// thread.  At the
// gossip payloads that left one strip, 8 blocks at kreg4-256 with d of 128
// threads busy, each alone over 32 rows x 256 k (0.037-0.061 ms against
// torch.matmul's 0.007-0.011).
#include <cstdint>

#include "mix_common.cuh"

namespace {

// ------------------------------------------------------------------ thin
template <typename T, int CT>
__global__ void __launch_bounds__(32)
    mix_thin_kernel(const float* __restrict__ m, const T* __restrict__ w, T* __restrict__ y, int n, long long d,
                    long long n_tiles) {
  const int lane = threadIdx.x;
  const long long r = blockIdx.x / n_tiles;
  const long long c0 = (blockIdx.x - r * n_tiles) * CT;
  float acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) acc[c] = 0.f;
  const float* mr = m + r * n;  // M's leading dimension is n, also for a row block
  constexpr int kUnroll = CT <= 4 ? 8 : 32 / CT;  // up to 32 W values of loads in flight a lane
#pragma unroll kUnroll
  for (int k = lane; k < n; k += 32) {
    const float mk = mr[k];
    const T* wk = w + static_cast<long long>(k) * d + c0;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      if (c0 + c < d) acc[c] = fmaf(mk, mixk::to_f32(wk[c]), acc[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
  if (lane == 0) {
    T* yr = y + r * d + c0;
#pragma unroll
    for (int c = 0; c < CT; ++c)
      if (c0 + c < d) yr[c] = mixk::from_f32<T>(acc[c]);
  }
}

// ------------------------------------------------------------------ wide
constexpr int kWideThreads = 128;

template <typename T, int RG, int KB>
__global__ void __launch_bounds__(kWideThreads)
    mix_wide_kernel(const float* __restrict__ m, const T* __restrict__ w, T* __restrict__ y, int rows, int n,
                    long long d, int n_rg) {
  constexpr int V = 8 / sizeof(T);              // columns a thread: 8 bytes of each row
  extern __shared__ __align__(16) float m_s[];  // M[r0 + r, k] at k * RG + r
  const int t = threadIdx.x;
  const int r0 = (blockIdx.x % n_rg) * RG;
  const long long c = (static_cast<long long>(blockIdx.x / n_rg) * kWideThreads + t) * V;
  const long long valid = d - c;
  const bool whole = valid >= V && d % V == 0 &&
                     ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(y)) & 7) == 0;
  float acc[RG][V];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
  for (int k0 = 0; k0 < n; k0 += KB) {
    uint2 raw[KB];  // 8 bytes of W rows k0 .. k0 + KB
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const T* p = w + static_cast<long long>(k0 + j) * d + c;
      raw[j] = make_uint2(0u, 0u);
      if (k0 + j < n) {
        if (whole) {
          raw[j] = *reinterpret_cast<const uint2*>(p);
        } else {
          for (int e = 0; e < V && e < valid; ++e) {
            if constexpr (sizeof(T) == 4) {
              (e ? raw[j].y : raw[j].x) = reinterpret_cast<const uint32_t*>(p)[e];
            } else {
              const uint32_t h = reinterpret_cast<const unsigned short*>(p)[e];
              (e < 2 ? raw[j].x : raw[j].y) |= h << (16 * (e & 1));
            }
          }
        }
      }
    }
    if (k0 == 0) {  // M's slice, while the first loads are in flight
      for (int i = t; i < RG * n; i += kWideThreads) {
        const int k = i / RG, r = i - k * RG;
        m_s[i] = r0 + r < rows ? m[static_cast<long long>(r0 + r) * n + k] : 0.f;
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      if (k0 + j >= n) break;  // the same for the whole block
      float wv[V];
      if constexpr (sizeof(T) == 4) {
        wv[0] = __uint_as_float(raw[j].x), wv[1] = __uint_as_float(raw[j].y);
      } else {  // bf16: element 2i in the low half word
        wv[0] = __uint_as_float(raw[j].x << 16), wv[1] = __uint_as_float(raw[j].x & 0xffff0000u);
        wv[2] = __uint_as_float(raw[j].y << 16), wv[3] = __uint_as_float(raw[j].y & 0xffff0000u);
      }
      const float* mk = m_s + (k0 + j) * RG;
#pragma unroll
      for (int r = 0; r < RG; r += 4) {
        const float4 mv = *reinterpret_cast<const float4*>(mk + r);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[r][e] = fmaf(mv.x, wv[e], acc[r][e]);
          acc[r + 1][e] = fmaf(mv.y, wv[e], acc[r + 1][e]);
          acc[r + 2][e] = fmaf(mv.z, wv[e], acc[r + 2][e]);
          acc[r + 3][e] = fmaf(mv.w, wv[e], acc[r + 3][e]);
        }
      }
    }
  }
  if (valid <= 0) return;
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    if (r0 + r >= rows) break;
    T* p = y + static_cast<long long>(r0 + r) * d + c;
    if (whole) {
      uint2 o;
      if constexpr (sizeof(T) == 4) {
        o = make_uint2(__float_as_uint(acc[r][0]), __float_as_uint(acc[r][1]));
      } else {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[r][0], acc[r][1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[r][2], acc[r][3]);
        o = make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
      }
      *reinterpret_cast<uint2*>(p) = o;
    } else {
      for (int e = 0; e < V && e < valid; ++e) p[e] = mixk::from_f32<T>(acc[r][e]);
    }
  }
}

template <typename T, int RG, int KB>
cudaError_t launch_wide(const float* m, const T* w, T* y, int rows, int n, long long d, cudaStream_t s) {
  constexpr int V = 8 / sizeof(T);
  const int n_rg = (rows + RG - 1) / RG;
  const long long blocks = ((d + V - 1) / V + kWideThreads - 1) / kWideThreads * n_rg;
  const long long smem = static_cast<long long>(n) * RG * sizeof(float);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const auto kernel = mix_wide_kernel<T, RG, KB>;
  if (smem > 48 * 1024) {  // n > 768: M's slice past the default limit
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(unsigned)blocks, kWideThreads, (size_t)smem, s>>>(m, w, y, rows, n, d, n_rg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_thin(const float* m, const T* w, T* y, int rows, int n, long long d, int tile,
                        cudaStream_t s) {
  const long long n_tiles = (d + tile - 1) / tile;
  const long long blocks = rows * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
#define MIX_THIN_CASE(CT)                                                             \
  case CT:                                                                            \
    mix_thin_kernel<T, CT><<<(unsigned)blocks, 32, 0, s>>>(m, w, y, n, d, n_tiles); \
    break;
  switch (tile) {
    MIX_THIN_CASE(1)
    MIX_THIN_CASE(2)
    MIX_THIN_CASE(4)
    MIX_THIN_CASE(8)
    MIX_THIN_CASE(16)
    MIX_THIN_CASE(32)
    default: return cudaErrorInvalidValue;
  }
#undef MIX_THIN_CASE
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int route, int tile, const float* m, const void* w, void* y, int rows, int n, long long d,
                   cudaStream_t s) {
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (route == 0) return launch_thin<T>(m, wt, yt, rows, n, d, tile, s);
  if (route != 1) return cudaErrorInvalidValue;
  // RG from the rows, KB from n; a square M takes the instances it always
  // took (8, 8), (16, 16), (16, 8).  Neither changes a sum: each output is
  // one FMA chain over k in ascending order
  if (rows <= 8) {
    if (n > 8 && n <= 16) return launch_wide<T, 8, 16>(m, wt, yt, rows, n, d, s);
    return launch_wide<T, 8, 8>(m, wt, yt, rows, n, d, s);
  }
  if (n <= 16) return launch_wide<T, 16, 16>(m, wt, yt, rows, n, d, s);
  return launch_wide<T, 16, 8>(m, wt, yt, rows, n, d, s);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (W and Y).  route: 0 = thin (tile columns a
// warp, tile in {1, 2, 4, 8, 16, 32}), 1 = wide (tile unused).  M is
// (rows, n) with rows <= n, row-major with leading dimension n: the square
// operator, or a row block of it (a rank's rows in the node-sharded round of
// core/shardplan.py); W (n, d), Y (rows, d).  Any pointer alignment.
// Returns a cudaError_t: the launch's, or cudaErrorInvalidValue for
// arguments no instance takes.
extern "C" int mix_dense(int dtype, int route, int tile, const float* m, const void* w, void* y, int rows, int n,
                         long long d, void* stream) {
  if (rows <= 0 || rows > n || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(route, tile, m, w, y, rows, n, d, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(route, tile, m, w, y, rows, n, d, s);
  return cudaErrorInvalidValue;
}
