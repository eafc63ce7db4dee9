// Flash attention forward (online softmax) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash/flash.py::flash_mha (Pallas body
// _flash_kernel), the TPU kernel of full-sequence attention.  q (B, H, S, hd),
// k/v (B, KVH, S, hd), each addressed through its own (b, head, s) strides
// with hd contiguous, so the model's (B, S, H, hd) activations go in without a
// transposing copy.  GQA: q head h reads kv head h / group.  Masks: key
// position < S, causal (kpos <= qpos), sliding window (kpos > qpos - window).
// fp32 running max, denominator and accumulator; out = acc / max(l, 1e-30)
// in the input dtype (fp32 or bf16).
//
// What bounds it on an H100: per (q, k) pair kept by the mask the product
// does 4 hd flops (QK^T and PV) on 2 hd bytes of q/o per row and 4 hd bytes
// of k/v per key, so at the serving shapes (S = 2048, hd 128 or 256) it is
// bound by arithmetic, not memory: the least time is the kept pairs' flops
// over the bf16 tensor-core peak.
//
// What this design does about it: it is the simple, right version first.
// The products run as fp32 FMA chains on the CUDA cores (no wgmma, no TMA),
// so it cannot approach that bound; it keeps the work to the mask instead.
// One block of 128 threads per (b, h, tile of BQ = 16 TM query rows); it
// walks only the kv tiles (BK = 64 keys) that intersect the causal / window
// band of its rows, so a windowed layer costs O(S window), not O(S^2).  Q
// stays in shared memory for the whole walk; K and V of one tile share one
// shared buffer in turn.  Thread (ty, tx) owns TM query rows and the keys
// tx + 8j of a tile (the row max / sum are 8-lane shuffles, whose butterfly
// gives every lane the same bits) and, for PV, the output dims
// tx*4 + 32jj .. +3.  The heaviest (last) causal tiles are launched first.
// Rows past S are computed but never stored; keys past S are masked and their
// V rows zero-filled.  Every sum is one fixed-order chain and there are no
// atomics: two launches give bitwise-equal results.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 16 row groups (ty) x 8 lanes (tx)
constexpr int kBK = 64;        // keys per kv tile
constexpr int kLDP = kBK + 4;  // padded row of the P tile (floats)
constexpr float kNeg = -1e30f;

struct Strides {
  long long b, h, s;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int H, group, S, causal, window;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Rows [0, n_rows) of one (b, head) slice: row r at base + r * row_stride,
// HD contiguous elements, into dst[r * LD + d] as fp32.  Rows at or past
// `valid` are zero-filled and never read from memory.  One 16-byte load per
// thread, neighbouring threads on neighbouring chunks of a row.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ base,
                                          long long row_stride, int n_rows, int valid) {
  constexpr int VN = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int CHUNKS = HD / VN;
  for (int i = threadIdx.x; i < n_rows * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * VN;
    float vals[VN];
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + (long long)r * row_stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VN; ++j) vals[j] = to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; j += 4)
      *reinterpret_cast<float4*>(dst + r * LD + c + j) =
          make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
  }
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

// max / sum over the 8 lanes (tx) that share a row group; every lane ends
// with the same value (each butterfly step adds the same two operands)
__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD, int TM>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(16 * TM * (HD + 4) + kBK * (HD + 4) + 16 * TM * kLDP);
}

template <typename T, int HD, int TM>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  constexpr int BQ = 16 * TM;  // query rows per block
  constexpr int LD = HD + 4;   // padded smem row: conflict-free float4 reads across 8 rows
  constexpr int DV = HD / 32;  // float4 groups of output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;              // BQ x LD
  float* kv_s = q_s + BQ * LD;    // kBK x LD: K, then V of the same tile
  float* p_s = kv_s + kBK * LD;   // BQ x kLDP

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int kvh = h / a.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int S = a.S;

  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h + q0 * a.sq.s;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;

  const int q_valid = min(BQ, S - q0);
  load_tile<T, HD, LD>(q_s, qb, a.sq.s, BQ, q_valid);

  // kv tiles that intersect the mask of rows [q0, q0 + q_valid)
  const int k_end = a.causal ? q0 + q_valid : S;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_lo = k_begin / kBK, kt_hi = (k_end + kBK - 1) / kBK;

  float m[TM], l[TM], acc[TM][4 * DV];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * DV; ++e) acc[i][e] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    const int kc = min(kBK, S - k0);
    __syncthreads();  // Q loaded; the previous tile's V reads are done
    load_tile<T, HD, LD>(kv_s, kb + k0 * a.sk.s, a.sk.s, kBK, kc);
    __syncthreads();

    // scores for rows ty*TM + i, keys tx + 8j: one fp32 FMA chain over d
    float s[TM][8];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = *reinterpret_cast<const float4*>(q_s + (ty * TM + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(kv_s + (tx + 8 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv.x, t);
          t = fmaf(qv[i].y, kv.y, t);
          t = fmaf(qv[i].z, kv.z, t);
          t = fmaf(qv[i].w, kv.w, t);
          s[i][j] = t;
        }
      }
    }

    // mask, online softmax update, P to shared memory
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty * TM + i;
      bool keep[8];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        keep[j] = kpos < S && (!a.causal || kpos <= qpos) && (a.window <= 0 || kpos > qpos - a.window);
        s[i][j] = keep[j] ? s[i][j] * a.scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group8_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + group8_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 4 * DV; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) p_s[(ty * TM + i) * kLDP + tx + 8 * j] = s[i][j];
    }
    __syncthreads();  // K reads done, P written
    load_tile<T, HD, LD>(kv_s, vb + k0 * a.sv.s, a.sv.s, kBK, kc);
    __syncthreads();

    // acc += P V over the tile's real keys, in key order
    for (int c = 0; c < kc; ++c) {
      float p[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) p[i] = p_s[(ty * TM + i) * kLDP + c];
#pragma unroll
      for (int jj = 0; jj < DV; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(kv_s + c * LD + tx * 4 + 32 * jj);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][4 * jj + 0] = fmaf(p[i], vv.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(p[i], vv.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(p[i], vv.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(p[i], vv.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }

  T* ob = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DV; ++jj) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[i][4 * jj + e] / denom;
      store4(ob + row * a.so.s + tx * 4 + 32 * jj, out);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int TM = HD >= 256 ? 2 : 4;  // 64 fp32 accumulators per thread at hd 128 and 256
  constexpr int BQ = 16 * TM;
  constexpr size_t smem = smem_bytes<HD, TM>();
  auto kernel = flash_fwd_kernel<T, HD, TM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_qt = (a.S + BQ - 1) / BQ;
  const long long bh = (long long)batch * a.H;
  if (n_qt > 65535 || bh > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<dim3((unsigned)bh, (unsigned)n_qt), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, int batch, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, batch, stream);
    case 64: return launch<T, 64>(a, batch, stream);
    case 128: return launch<T, 128>(a, batch, stream);
    case 256: return launch<T, 256>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v and o alike).  Strides are in elements,
// hd is contiguous; the host checked that every row starts 16-byte aligned.
// Returns a cudaError_t.
extern "C" int flash_fwd(int dtype, int hd, const void* q, const void* k, const void* v, void* o,
                         int batch, int heads, int kv_heads, int seq,
                         long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         long long o_sb, long long o_sh, long long o_ss,
                         int causal, int window, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || seq <= 0 || heads % kv_heads != 0 || window < 0)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.sq = {q_sb, q_sh, q_ss};
  a.sk = {k_sb, k_sh, k_ss};
  a.sv = {v_sb, v_sh, v_ss};
  a.so = {o_sb, o_sh, o_ss};
  a.H = heads;
  a.group = heads / kv_heads;
  a.S = seq;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_hd<float>(hd, a, batch, s);
  if (dtype == 1) return (int)dispatch_hd<__nv_bfloat16>(hd, a, batch, s);
  return (int)cudaErrorInvalidValue;
}
