// Flash attention forward for Hopper (sm_90a): bf16 q/k/v, wgmma + TMA.
//
// Replaces: src/repro/kernels/flash/flash.py::flash_mha (Pallas body
// _flash_kernel), the TPU kernel of full-sequence attention, for bf16 inputs
// at head dims 64, 128 and 256 (flash.cu keeps fp32 and hd 32).  q (B, H, S,
// hd), k/v (B, KVH, S, hd), each addressed through its own (b, head, s)
// strides with hd contiguous, so the model's (B, S, H, hd) activations go in
// as views.  GQA: q head h reads kv head h / group.  Masks: key position < S,
// causal (kpos <= qpos), sliding window (kpos > qpos - window).  fp32 running
// max, denominator and accumulator; out = acc / max(l, 1e-30) in bf16.
//
// What bounds it on an H100: the function does 4 hd flops per (q, k) pair
// the mask keeps (2 hd for Q K^T, 2 hd for P V) on 2 hd bytes of q and o per
// row and 4 hd bytes of k and v per key; at the serving shapes (S = 2048,
// hd 128 or 256) that is far above the card's ~295 flops a byte, so it is
// bound by operations: the kept pairs' flops over the 989 TFLOP/s bf16
// tensor-core peak.  This kernel does 6 hd flops a pair (P V twice, see
// below), so its own floor is 1.5x the function's.
//
// What this design does about it:
// - Both products run on the tensor cores as wgmma.mma_async (m64nNk16,
//   fp32 accumulation).  Q K^T takes Q and K from shared memory (K-major);
//   P V takes P from registers (the S accumulator's layout is the A
//   fragment's) and V from shared memory, MN-major (the transpose bit).
//   A product of two bf16 values is exact in fp32, so S is the Pallas
//   kernel's up to summation order.
// - P's precision.  The Pallas kernel keeps P in fp32; one bf16 rounding of
//   P would err by ~2^-9 |v| / sqrt(n), above the fp32 atol on rows with
//   few keys.  P is split into hi = bf16(p) and lo = bf16(p - hi) and both
//   go through the same fp32 accumulator, which leaves ~2^-17 of p.
// - Loads: one producer warp issues TMA loads (Q once, then K and V into a
//   ring of STAGES tiles, completing on mbarriers), 128-byte swizzled boxes
//   of 64 hd columns that match the wgmma descriptors.  The tensor maps
//   are rank 4 over (hd, S, heads, B) with the tensors' own byte strides,
//   so strided views need no copy; TMA zero-fills rows past S.
// - One CTA per (b, h, tile of 64 W query rows): W consumer warpgroups of
//   64 rows each (W = 2; W = 1 at hd 256, whose fp32 O accumulator alone is
//   128 registers a thread), so one warpgroup's softmax overlaps the
//   other's products.  The CTA walks only the kv tiles (64 keys) that meet
//   its rows' causal / window band; a warpgroup skips a tile wholly masked
//   for its rows and masks per element only on edge tiles.  The heaviest
//   (last) causal tiles launch first.
// - Softmax in registers in the accumulator layout: row max and sum over
//   the 4 lanes of a quad by xor shuffles; p = ex2.approx(s c - m), one FMA
//   with c = log2(e) / sqrt(hd); O is rescaled only when a row's max moved.
//   The softmax sits between the two products of a warpgroup, so its
//   instruction count is on the critical path.  Every sum has one fixed
//   order and there are no atomics: two launches give bitwise-equal
//   results.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace sm90;

constexpr int kBK = 64;     // keys per kv tile
constexpr int kBM = 64;     // query rows per consumer warpgroup
constexpr int kChunk = 64;  // hd columns per 128-byte swizzled box
constexpr float kNeg = -1e30f;

template <int HD>
struct Cfg {
  static constexpr int W = HD >= 256 ? 1 : 2;  // consumer warpgroups
  static constexpr int STAGES = HD >= 256 ? 2 : 3;
  static constexpr int BQ = kBM * W;  // query rows per CTA
  static constexpr int THREADS = 128 * W + 32;  // + one producer warp
  static constexpr int CHUNKS = HD / kChunk;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = kBK * HD * 2;  // one K or V tile
  // 1024 bytes of slack to align the swizzled tiles, then the barriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

struct Params {
  void* o;
  long long o_sb, o_sh, o_ss;
  int H, group, S, causal, window;
  float scale_log2;  // log2(e) / sqrt(hd)
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d, int s, int head,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(s), "r"(head), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (the tile 1024-aligned):
// start address, leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// 2^x, flushing a result below 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__device__ __forceinline__ void pv_mma(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t desc_v) {
  if constexpr (HD == 64) wgmma_m64n64k16_rs(o, a, desc_v);
  else if constexpr (HD == 128) wgmma_m64n128k16_rs(o, a, desc_v);
  else wgmma_m64n256k16_rs(o, a, desc_v);
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const Params p) {
  using C = Cfg<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;  // CHUNKS blocks of BQ rows x 128 bytes
  const uint32_t k_s = q_s + C::Q_BYTES;       // STAGES tiles of CHUNKS blocks of kBK rows x 128 bytes
  const uint32_t v_s = k_s + C::STAGES * C::KV_BYTES;
  const uint32_t q_bar = v_s + C::STAGES * C::KV_BYTES;
  auto full = [&](int st) { return q_bar + 8 * (1 + st); };
  auto empty = [&](int st) { return q_bar + 8 * (1 + C::STAGES + st); };

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kvh = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const int S = p.S;
  // kv tiles that meet the mask of rows [q0, min(q0 + BQ, S))
  const int k_end = p.causal ? min(q0 + C::BQ, S) : S;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt_lo = k_begin / kBK, kt_hi = (k_end + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * C::W);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C::W) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
      for (int c = 0; c < C::CHUNKS; ++c) tma_load(q_s + c * C::BQ * 128, &q_map, q_bar, c * kChunk, q0, h, b);
      int stage = 0, phase = 0;
      for (int kt = kt_lo; kt < kt_hi; ++kt) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), 2 * C::KV_BYTES);
        const uint32_t ks = k_s + stage * C::KV_BYTES, vs = v_s + stage * C::KV_BYTES;
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load(ks + c * kBK * 128, &k_map, full(stage), c * kChunk, kt * kBK, kvh, b);
          tma_load(vs + c * kBK * 128, &v_map, full(stage), c * kChunk, kt * kBK, kvh, b);
        }
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows [wq0, wq0 + 64); this thread holds rows
  // row_in and row_in + 8 of them, columns col_in, col_in + 1 of every 8
  const int wg = warp / 4;
  const int wq0 = q0 + wg * kBM;
  const int row_in = (warp % 4) * 16 + lane / 4;
  const int col_in = (lane % 4) * 2;
  const bool live = wq0 < S;
  const int wk_end = p.causal ? min(wq0 + kBM, S) : S;
  const int wk_begin = p.window > 0 ? max(0, wq0 - p.window + 1) : 0;
  const uint32_t q_wg = q_s + wg * kBM * 128;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  mbar_wait(q_bar, 0);
  int stage = 0, phase = 0;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    mbar_wait(full(stage), phase);
    if (live && k0 < wk_end && k0 + kBK > wk_begin) {
      // S = Q K^T over hd in steps of 16 (32 bytes inside a swizzled row)
      float s[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
      const uint32_t ks = k_s + stage * C::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t da = desc_sw128(q_wg + (kk / 4) * C::BQ * 128 + (kk % 4) * 32, 16, 1024);
        const uint64_t db = desc_sw128(ks + (kk / 4) * kBK * 128 + (kk % 4) * 32, 16, 1024);
        wgmma_m64n64k16_ss(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_operands(s);

      // mask (edge tiles only), row max; p = 2^(s scale log2(e) - m) with m
      // in those units (rounding is monotonic, so scaling the raw max gives
      // the max of the scaled scores)
      const bool edge = k0 + kBK > S || (p.causal && k0 + kBK - 1 > wq0) ||
                        (p.window > 0 && k0 <= wq0 + kBM - 1 - p.window);
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        if (edge) {
          const int qpos = wq0 + row_in + 8 * r, kpos = k0 + (i >> 2) * 8 + col_in + (i & 1);
          const bool keep =
              kpos < S && (!p.causal || kpos <= qpos) && (p.window <= 0 || kpos > qpos - p.window);
          s[i] = keep ? s[i] : kNeg;
        }
        mx[r] = fmaxf(mx[r], s[i]);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * p.scale_log2);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
      // split p into bf16 hi + lo, packed as the A fragments of P V: a[j]
      // of slice kk holds accumulator elements 8 kk + 2 j, + 1
      uint32_t phi[kBK / 16][4], plo[kBK / 16][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kBK / 2; i += 2) {
        const int r = (i >> 1) & 1;
        float p0 = ex2(fmaf(s[i], p.scale_log2, -m[r])), p1 = ex2(fmaf(s[i + 1], p.scale_log2, -m[r]));
        if (edge) {  // a row whose keys are all masked so far has m = kNeg
          p0 = s[i] == kNeg ? 0.f : p0;
          p1 = s[i + 1] == kNeg ? 0.f : p1;
        }
        rs[r] += p0;
        rs[r] += p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - __low2float(hi), p1 - __high2float(hi));
        phi[i / 8][(i % 8) / 2] = pack_bf16(hi);
        plo[i / 8][(i % 8) / 2] = pack_bf16(lo);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
      // rescale O unless no row of the warp's moved its max (x 1 is exact)
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }

      // O += P V over the tile's 64 keys in steps of 16 rows of V (2048
      // bytes); N = hd walks the 64-column blocks kBK rows apart
      const uint32_t vs = v_s + stage * C::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = desc_sw128(vs + kk * 16 * 128, kBK * 128, 1024);
        pv_mma<HD>(o, phi[kk], dv);
        pv_mma<HD>(o, plo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_operands(o);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        fence_operands(phi[kk]);
        fence_operands(plo[kk]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage));
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (!live) return;

  // the 4 lanes of a quad hold partial row sums: add them (every lane gets
  // the same bits), then out = acc / l in bf16, rows past S not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + row_in + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ob + row * p.o_ss + j * 8 + col_in) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// rank-4 map over (hd, S, heads, B), strides in elements; boxes of 64 hd
// columns x `rows` rows, 128-byte swizzle, zero fill out of bounds
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int hd, int seq, int heads, int batch,
                  long long sb, long long sh, long long ss, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)seq, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kChunk, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kEncodeError = 10000;  // + the CUresult of a failed encode

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads, int kv_heads, int seq,
           const long long* st, int causal, int window, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  CUresult r = make_map(encode, &qm, q, HD, seq, heads, batch, st[0], st[1], st[2], C::BQ);
  if (r == CUDA_SUCCESS) r = make_map(encode, &km, k, HD, seq, kv_heads, batch, st[3], st[4], st[5], kBK);
  if (r == CUDA_SUCCESS) r = make_map(encode, &vm, v, HD, seq, kv_heads, batch, st[6], st[7], st[8], kBK);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  Params p;
  p.o = o;
  p.o_sb = st[9];
  p.o_sh = st[10];
  p.o_ss = st[11];
  p.H = heads;
  p.group = heads / kv_heads;
  p.S = seq;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * 1.4426950408889634f;
  auto kernel = flash_sm90_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long n_qt = (seq + C::BQ - 1) / C::BQ;
  const long long bh = (long long)batch * heads;
  if (n_qt > 65535 || bh > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<dim3((unsigned)bh, (unsigned)n_qt), C::THREADS, C::SMEM, stream>>>(qm, km, vm, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 = bf16 (q, k, v and o alike; flash.cu's codes, which also take
// 0 = fp32); hd 64, 128 or 256.  Strides are in elements, hd is contiguous;
// the host checked that every row starts 16-byte aligned.  Returns a
// cudaError_t, or 10000 + the CUresult of a failed tensor-map encode.
extern "C" int flash_sm90_fwd(int dtype, int hd, const void* q, const void* k, const void* v, void* o, int batch, int heads,
                              int kv_heads, int seq, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                              long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                              long long o_sb, long long o_sh, long long o_ss, int causal, int window, float scale,
                              void* stream) {
  if (dtype != 1 || batch <= 0 || heads <= 0 || kv_heads <= 0 || seq <= 0 || heads % kv_heads != 0 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch<64>(q, k, v, o, batch, heads, kv_heads, seq, st, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, o, batch, heads, kv_heads, seq, st, causal, window, scale, s);
    case 256: return launch<256>(q, k, v, o, batch, heads, kv_heads, seq, st, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
