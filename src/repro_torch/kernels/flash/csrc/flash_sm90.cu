// Flash attention forward for Hopper (sm_90a): wgmma + TMA, bf16 or fp32
// q/k/v at head dims 32, 64, 128, 160 and 256.
//
// Replaces: src/repro/kernels/flash/flash.py::flash_mha (Pallas body
// _flash_kernel), the TPU kernel of full-sequence attention.  q (B, H, S,
// hd), k/v (B, KVH, S, hd), each addressed through its own (b, head, s)
// strides with hd contiguous, so the model's (B, S, H, hd) activations go in
// as views.  GQA: q head h reads kv head h / group.  Masks: key position < S,
// causal (kpos <= qpos), sliding window (kpos > qpos - window).  fp32 running
// max, denominator and accumulator; out = acc / max(l, 1e-30) in the input
// dtype.
//
// What bounds it on an H100: the function does 4 hd flops per (q, k) pair
// the mask keeps (2 hd for Q K^T, 2 hd for P V) on 2 hd elements of q and o
// per row and 2 hd of k and v per key; at the serving shapes (S = 2048, hd
// 128 or 256) that is far above the card's flops a byte, so it is bound by
// operations: the kept pairs' flops over the tensor-core peak (989 TFLOP/s
// bf16, 495 TF32).  The bf16 route does 6 hd flops a pair (P V twice, see
// below), so its own floor is 1.5x the function's; the fp32 route does
// 12 hd TF32 flops a pair (every product three times), 3x the function's
// at the TF32 peak.
//
// Two kernels, one per input type, on one frame:
// - Loads: one producer warp issues TMA loads (Q once, then K and V into a
//   ring of STAGES tiles, completing on mbarriers), 128-byte swizzled boxes
//   (64-byte at bf16 hd 32 and 160) that match the wgmma descriptors.  The tensor
//   maps are rank 4 over (hd, S, heads, B) with the tensors' own byte
//   strides, so strided views need no copy; TMA zero-fills rows past S.
// - One CTA per (b, h, tile of 64 W query rows): W consumer warpgroups of
//   64 rows each.  The CTA walks only the kv tiles that meet its rows'
//   causal / window band; a warpgroup skips a tile wholly masked for its
//   rows and masks per element only on edge tiles.  The heaviest (last)
//   causal tiles launch first.
// - Softmax in registers in the accumulator layout: row max and sum over
//   the 4 lanes of a quad by xor shuffles; p = ex2.approx(s c - m), one FMA
//   with c = log2(e) / sqrt(hd); O is rescaled only when a row's max moved.
//   Every sum has one fixed order and there are no atomics: two launches
//   give bitwise-equal results.
//
// bf16 (flash_sm90_kernel, route "wgmma"): both products are bf16 wgmma
// (m64nNk16).  Q K^T takes Q and K from shared memory (K-major); P V takes
// P from registers (the S accumulator's layout is the A fragment's) and V
// MN-major (the transpose bit).  A product of two bf16 values is exact in
// fp32, so S is the Pallas kernel's up to summation order.  One bf16
// rounding of P would err by ~2^-9 |v| / sqrt(n), above the fp32 atol on
// rows with few keys, so P is split into hi = bf16(p) and lo = bf16(p - hi)
// and both go through the same accumulator (~2^-17 of p left).  W = 2
// (1 at hd 256, whose O accumulator alone is 128 registers a thread).
//
// hd 160 (stablelm-12b) is its own instance, not a zero-padded hd-256 call:
// 160 is a multiple of 16 (QK^T's k16 steps) and of 8 (P V's n), so both
// products run at the true width, m64n64k16 over 10 k-steps and m64n160k16.
// 160 columns are not a whole number of the 64-column boxes a 128-byte
// swizzle takes, so the bf16 tiles use the 64-byte swizzle of hd 32: boxes
// of 32 columns, 5 to a row, the descriptors of hd 32 with 5 column blocks
// (K-major Q and K: 2 k16 steps a block; MN-major V: N = 160 across 5
// swizzle atoms, the leading byte offset between them).  A 128-byte swizzle
// over 3 boxes would load, hold and multiply 192 columns, 20% more than
// needed.  Shared memory at W = 2: Q 40 KB, 3 stages of K and V 120 KB.
//
// fp32 (flash_tf32_kernel, route "wgmma_tf32x3"): the products run on the
// tensor cores in TF32 on split operands: x = hi + lo, hi = tf32(x), lo =
// tf32(x - hi) (rounding to nearest, ties away), and x y as hi.hi + hi.lo +
// lo.hi (~2^-21 of each term left: the fp32 bound needs it; a bf16 split
// leaves ~2^-17 on S, which exp turns into misses, see
// ref.py::attention_split_ref).  TF32 wgmma takes both operands K-major
// only, so after each tile lands the consumers split it in shared memory:
// Q and K elementwise into hi and lo tiles of the TMA layout, V transposed
// into hi and lo tiles of V^T (keys contiguous).  Within every 8 keys, V^T
// stores key 2t at position t and key 2t + 1 at t + 4: the TF32 A fragment
// holds k-columns t and t + 4 where the S accumulator holds keys 2t and
// 2t + 1, so P goes from the accumulator into the P V product as it is.
// The raw tile is released once split, so one raw stage already overlaps
// the next tile's load with this tile's products.  Tiles (W, keys a tile,
// raw stages) per hd in Cfg32: fp32 Q hi + lo alone is 128 KB at 128 rows
// of hd 128 or 64 rows of hd 256.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 64;  // query rows per consumer warpgroup
constexpr float kNeg = -1e30f;

// the bf16 route: kv tiles of kBK keys, boxes of SW-byte swizzled rows
constexpr int kBK = 64;
template <int HD>
struct Cfg {
  static constexpr int W = HD >= 256 ? 1 : 2;  // consumer warpgroups
  static constexpr int STAGES = HD >= 256 ? 2 : 3;
  static constexpr int BQ = kBM * W;  // query rows per CTA
  static constexpr int THREADS = 128 * W + 32;  // + one producer warp
  static constexpr int SW = HD % 64 == 0 ? 128 : 64;  // bytes of a swizzled row (its box's hd columns)
  static constexpr int CCOLS = SW / 2;
  static constexpr int CHUNKS = HD / CCOLS;
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = kBK * HD * 2;  // one K or V tile
  // 1024 bytes of slack to align the swizzled tiles, then the barriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

// the fp32 route: boxes of 32 fp32 (128 bytes); V^T rows of VT_RB bytes.
// hd 160 takes W = 1 as hd 256 does: at W = 2 Q hi + lo alone would be
// 160 KB, and with the raw and split K / V tiles ~280 KB; at W = 1 ~201 KB.
template <int HD>
struct Cfg32 {
  static constexpr int W = HD > 128 ? 1 : 2;
  static constexpr int BK = HD >= 256 ? 16 : (HD >= 128 ? 32 : 64);  // keys a kv tile
  static constexpr int STAGES = HD >= 128 ? 1 : 2;  // raw K / V tiles in flight
  static constexpr int BQ = kBM * W;
  static constexpr int THREADS = 128 * W + 32;
  static constexpr int CHUNKS = HD / 32;
  static constexpr int VT_RB = BK >= 32 ? 128 : 4 * BK;  // 128- or 64-byte swizzle
  static constexpr int KPR = VT_RB / 4;  // keys a V^T row
  static constexpr int Q_BYTES = BQ * HD * 4;  // one of Q hi, Q lo
  static constexpr int KV_BYTES = BK * HD * 4;  // one raw K or V tile, or one split part
  // Q hi (loaded raw, split in place), Q lo, the raw ring, K hi / lo, V^T hi / lo
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 4 * KV_BYTES + 8 * (1 + 2 * STAGES);
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

// wgmma shared-memory descriptor of a swizzled tile (1024-aligned) with
// rows of `rb` bytes (128- or 64-byte swizzle): start address, leading and
// stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t lbo, uint32_t sbo, int rb) {
  const uint64_t layout = rb == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// the 16-byte unit a row's unit u lands on under that swizzle
__device__ __forceinline__ int swizzled(int u, int row, int rb) { return u ^ (rb == 128 ? row & 7 : (row >> 1) & 3); }

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// 2^x, flushing a result below 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// fp32 -> the nearest TF32 value (ties away from zero), low 13 bits zero
__device__ __forceinline__ float tf32(float x) { return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u); }

// the consumer warpgroups' barrier (the producer warp is not in it)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// generic-proxy stores to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// --------------------------------------------------------------- bf16 route
template <int HD>
__device__ __forceinline__ void pv_mma(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t desc_v) {
  if constexpr (HD == 32) wgmma_m64n32k16_rs_bf16(o, a, desc_v);
  else if constexpr (HD == 64) wgmma_m64n64k16_rs_bf16(o, a, desc_v);
  else if constexpr (HD == 128) wgmma_m64n128k16_rs_bf16(o, a, desc_v);
  else if constexpr (HD == 160) wgmma_m64n160k16_rs_bf16(o, a, desc_v);
  else wgmma_m64n256k16_rs_bf16(o, a, desc_v);
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const Params p) {
  using C = Cfg<HD>;
  constexpr int SW = C::SW, K16_ROW = SW / 32;  // k16 steps in a swizzled row
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;  // CHUNKS blocks of BQ rows x SW bytes
  const uint32_t k_s = q_s + C::Q_BYTES;       // STAGES tiles of CHUNKS blocks of kBK rows x SW bytes
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
      for (int c = 0; c < C::CHUNKS; ++c) tma_load(q_s + c * C::BQ * SW, &q_map, q_bar, c * C::CCOLS, q0, h, b);
      int stage = 0, phase = 0;
      for (int kt = kt_lo; kt < kt_hi; ++kt) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), 2 * C::KV_BYTES);
        const uint32_t ks = k_s + stage * C::KV_BYTES, vs = v_s + stage * C::KV_BYTES;
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load(ks + c * kBK * SW, &k_map, full(stage), c * C::CCOLS, kt * kBK, kvh, b);
          tma_load(vs + c * kBK * SW, &v_map, full(stage), c * C::CCOLS, kt * kBK, kvh, b);
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
  const uint32_t q_wg = q_s + wg * kBM * SW;

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
        const uint32_t kc = kk / K16_ROW, ko = (kk % K16_ROW) * 32;  // column block, offset in its rows
        const uint64_t da = desc_sw(q_wg + kc * C::BQ * SW + ko, 16, 8 * SW, SW);
        const uint64_t db = desc_sw(ks + kc * kBK * SW + ko, 16, 8 * SW, SW);
        wgmma_m64n64k16_ss_bf16(s, da, db, kk > 0);
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

      // O += P V over the tile's 64 keys in steps of 16 rows of V (16 SW
      // bytes); N = hd walks the column blocks kBK rows apart
      const uint32_t vs = v_s + stage * C::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = desc_sw(vs + kk * 16 * SW, kBK * SW, 8 * SW, SW);
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

// --------------------------------------------------------------- fp32 route
template <int BK>
__device__ __forceinline__ void s_mma_tf32(float (&s)[BK / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BK == 16) wgmma_m64n16k8_ss_tf32(s, da, db, scale_d);
  else if constexpr (BK == 32) wgmma_m64n32k8_ss_tf32(s, da, db, scale_d);
  else wgmma_m64n64k8_ss_tf32(s, da, db, scale_d);
}

template <int HD>
__device__ __forceinline__ void pv_mma_tf32(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t desc_v) {
  if constexpr (HD == 32) wgmma_m64n32k8_rs_tf32(o, a, desc_v);
  else if constexpr (HD == 64) wgmma_m64n64k8_rs_tf32(o, a, desc_v);
  else if constexpr (HD == 128) wgmma_m64n128k8_rs_tf32(o, a, desc_v);
  else if constexpr (HD == 160) wgmma_m64n160k8_rs_tf32(o, a, desc_v);
  else wgmma_m64n256k8_rs_tf32(o, a, desc_v);
}

// n4 float4s of src into their TF32 parts hi (may be src itself) and lo
__device__ __forceinline__ void split4(const float4* src, float4* hi, float4* lo, int n4, int tid, int threads) {
  for (int i = tid; i < n4; i += threads) {
    const float4 x = src[i];
    const float4 h = make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
    hi[i] = h;
    lo[i] = make_float4(tf32(x.x - h.x), tf32(x.y - h.y), tf32(x.z - h.z), tf32(x.w - h.w));
  }
}

template <int HD>
__global__ void __launch_bounds__(Cfg32<HD>::THREADS, 1)
    flash_tf32_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const Params p) {
  using C = Cfg32<HD>;
  constexpr int BK = C::BK, RB = C::VT_RB, NC = 128 * C::W;  // NC: consumer threads
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t q_hi = (raw + 1023) & ~1023u;  // CHUNKS blocks of BQ rows x 128 bytes
  const uint32_t q_lo = q_hi + C::Q_BYTES;
  const uint32_t k_raw = q_lo + C::Q_BYTES;  // STAGES tiles of CHUNKS blocks of BK rows x 128 bytes
  const uint32_t v_raw = k_raw + C::STAGES * C::KV_BYTES;
  const uint32_t k_hi = v_raw + C::STAGES * C::KV_BYTES;  // K's layout
  const uint32_t k_lo = k_hi + C::KV_BYTES;
  const uint32_t vt_hi = k_lo + C::KV_BYTES;  // BK / KPR blocks of HD rows x RB bytes
  const uint32_t vt_lo = vt_hi + C::KV_BYTES;
  const uint32_t q_bar = vt_lo + C::KV_BYTES;
  auto full = [&](int st) { return q_bar + 8 * (1 + st); };
  auto empty = [&](int st) { return q_bar + 8 * (1 + C::STAGES + st); };
  auto at = [&](uint32_t addr) { return smem_raw + (addr - raw); };  // the generic pointer

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kvh = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;
  const int S = p.S;
  const int k_end = p.causal ? min(q0 + C::BQ, S) : S;
  const int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt_lo = k_begin / BK, kt_hi = (k_end + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * C::W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C::W) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
      for (int c = 0; c < C::CHUNKS; ++c) tma_load(q_hi + c * C::BQ * 128, &q_map, q_bar, c * 32, q0, h, b);
      int stage = 0, phase = 0;
      for (int kt = kt_lo; kt < kt_hi; ++kt) {
        mbar_wait(empty(stage), phase ^ 1);
        mbar_expect_tx(full(stage), 2 * C::KV_BYTES);
        const uint32_t ks = k_raw + stage * C::KV_BYTES, vs = v_raw + stage * C::KV_BYTES;
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load(ks + c * BK * 128, &k_map, full(stage), c * 32, kt * BK, kvh, b);
          tma_load(vs + c * BK * 128, &v_map, full(stage), c * 32, kt * BK, kvh, b);
        }
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int wq0 = q0 + wg * kBM;
  const int row_in = (warp % 4) * 16 + lane / 4;
  const int col_in = (lane % 4) * 2;
  const bool live = wq0 < S;
  const int wk_end = p.causal ? min(wq0 + kBM, S) : S;
  const int wk_begin = p.window > 0 ? max(0, wq0 - p.window + 1) : 0;
  const uint32_t wg_rows = wg * kBM * 128;  // the warpgroup's rows inside every Q block

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  // Q's TF32 parts: hi over the raw tile, lo beside it
  mbar_wait(q_bar, 0);
  split4(reinterpret_cast<const float4*>(at(q_hi)), reinterpret_cast<float4*>(at(q_hi)),
         reinterpret_cast<float4*>(at(q_lo)), C::Q_BYTES / 16, threadIdx.x, NC);
  fence_async_smem();

  int stage = 0, phase = 0;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    mbar_wait(full(stage), phase);
    consumers_sync(NC);  // every warpgroup is done with the last tile's split parts
    // K's parts in K's layout; V's transposed: thread item (n, 8 keys g8)
    // reads V[8 g8 + w][n] from the raw tile (128-byte swizzle, key row
    // w mod 8) and writes the even keys' parts to one 16-byte unit of V^T
    // row n and the odd keys' to the next
    split4(reinterpret_cast<const float4*>(at(k_raw + stage * C::KV_BYTES)), reinterpret_cast<float4*>(at(k_hi)),
           reinterpret_cast<float4*>(at(k_lo)), C::KV_BYTES / 16, threadIdx.x, NC);
    {
      const float* vr = reinterpret_cast<const float*>(at(v_raw + stage * C::KV_BYTES));
      for (int it = threadIdx.x; it < HD * (BK / 8); it += NC) {
        const int n = it % HD, g8 = it / HD;
        float hi[8], lo[8];
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const float x = vr[((n >> 5) * BK + g8 * 8 + w) * 32 + ((((n & 31) >> 2) ^ w) << 2) + (n & 3)];
          hi[w] = tf32(x);
          lo[w] = tf32(x - hi[w]);
        }
        const int kl = (g8 * 8) % C::KPR;
        const uint32_t row = (g8 * 8) / C::KPR * HD * RB + n * RB;
        const int u0 = swizzled(kl / 4, n, RB), u1 = swizzled(kl / 4 + 1, n, RB);
        *reinterpret_cast<float4*>(at(vt_hi + row + u0 * 16)) = make_float4(hi[0], hi[2], hi[4], hi[6]);
        *reinterpret_cast<float4*>(at(vt_hi + row + u1 * 16)) = make_float4(hi[1], hi[3], hi[5], hi[7]);
        *reinterpret_cast<float4*>(at(vt_lo + row + u0 * 16)) = make_float4(lo[0], lo[2], lo[4], lo[6]);
        *reinterpret_cast<float4*>(at(vt_lo + row + u1 * 16)) = make_float4(lo[1], lo[3], lo[5], lo[7]);
      }
    }
    fence_async_smem();
    consumers_sync(NC);  // the parts are written; the raw stage is read
    if (lane == 0) mbar_arrive(empty(stage));

    if (live && k0 < wk_end && k0 + BK > wk_begin) {
      // S = Q K^T over hd in steps of 8 (32 bytes inside a 128-byte row):
      // lo.hi and hi.lo first, then hi.hi
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const uint32_t qa = (kk >> 2) * C::BQ * 128 + wg_rows + (kk & 3) * 32;
        const uint32_t kb = (kk >> 2) * BK * 128 + (kk & 3) * 32;
        s_mma_tf32<BK>(s, desc_sw(q_hi + qa, 16, 1024, 128), desc_sw(k_lo + kb, 16, 1024, 128), kk > 0);
        s_mma_tf32<BK>(s, desc_sw(q_lo + qa, 16, 1024, 128), desc_sw(k_hi + kb, 16, 1024, 128), 1);
        s_mma_tf32<BK>(s, desc_sw(q_hi + qa, 16, 1024, 128), desc_sw(k_hi + kb, 16, 1024, 128), 1);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_operands(s);

      const bool edge = k0 + BK > S || (p.causal && k0 + BK - 1 > wq0) ||
                        (p.window > 0 && k0 <= wq0 + kBM - 1 - p.window);
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
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
      // p and its TF32 parts as the A fragments of P V: slice kk's a[0..3]
      // are (row, k-column) (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4),
      // i.e. keys 2t, 2t, 2t + 1, 2t + 1 in V^T's order: accumulator
      // elements 4 kk + 0, 2, 1, 3
      uint32_t phi[BK / 8][4], plo[BK / 8][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        float pe = ex2(fmaf(s[i], p.scale_log2, -m[r]));
        if (edge) pe = s[i] == kNeg ? 0.f : pe;  // a row whose keys are all masked so far has m = kNeg
        rs[r] += pe;
        const float hi = tf32(pe);
        const int j = ((i & 1) << 1) | r;
        phi[i >> 2][j] = __float_as_uint(hi);
        plo[i >> 2][j] = __float_as_uint(tf32(pe - hi));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }

      // O += P V over the tile's keys in steps of 8 (32 bytes inside a V^T
      // row); N = hd walks V^T's rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint32_t vo = (kk * 8) / C::KPR * HD * RB + ((kk * 8) % C::KPR) * 4;
        pv_mma_tf32<HD>(o, phi[kk], desc_sw(vt_lo + vo, 16, 8 * RB, RB));
        pv_mma_tf32<HD>(o, plo[kk], desc_sw(vt_hi + vo, 16, 8 * RB, RB));
        pv_mma_tf32<HD>(o, phi[kk], desc_sw(vt_hi + vo, 16, 8 * RB, RB));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_operands(o);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        fence_operands(phi[kk]);
        fence_operands(plo[kk]);
      }
    }
    if (++stage == C::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (!live) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + row_in + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<float2*>(ob + row * p.o_ss + j * 8 + col_in) =
          make_float2(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
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

// rank-4 map over (hd, S, heads, B), strides in elements of `esize` bytes;
// boxes of `cols` hd columns (one swizzled row of cols * esize bytes: 128
// or 64) x `rows` rows, zero fill out of bounds
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int esize, int hd, int seq, int heads,
                  int batch, long long sb, long long sh, long long ss, int cols, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)seq, (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(ss * esize), (cuuint64_t)(sh * esize), (cuuint64_t)(sb * esize)};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols * esize == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kEncodeError = 10000;  // + the CUresult of a failed encode

// one launch of `kernel`: maps with boxes of `cols` columns, Q boxes of
// BQ rows, K and V boxes of BK rows; CTAs of THREADS over (b h, q tiles)
template <typename Kernel>
int launch(Kernel kernel, int esize, int hd, int cols, int bq, int bk, int threads, int smem, const void* q,
           const void* k, const void* v, void* o, int batch, int heads, int kv_heads, int seq, const long long* st,
           int causal, int window, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  CUresult r = make_map(encode, &qm, q, esize, hd, seq, heads, batch, st[0], st[1], st[2], cols, bq);
  if (r == CUDA_SUCCESS) r = make_map(encode, &km, k, esize, hd, seq, kv_heads, batch, st[3], st[4], st[5], cols, bk);
  if (r == CUDA_SUCCESS) r = make_map(encode, &vm, v, esize, hd, seq, kv_heads, batch, st[6], st[7], st[8], cols, bk);
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
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_qt = (seq + bq - 1) / bq;
  const long long bh = (long long)batch * heads;
  if (n_qt > 65535 || bh > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<dim3((unsigned)bh, (unsigned)n_qt), threads, smem, stream>>>(qm, km, vm, p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* k, const void* v, void* o, int batch, int heads, int kv_heads,
              int seq, const long long* st, int causal, int window, float scale, cudaStream_t s) {
  if (dtype == 1) {
    using C = Cfg<HD>;
    return launch(flash_sm90_kernel<HD>, 2, HD, C::CCOLS, C::BQ, kBK, C::THREADS, C::SMEM, q, k, v, o, batch,
                  heads, kv_heads, seq, st, causal, window, scale, s);
  }
  using C = Cfg32<HD>;
  return launch(flash_tf32_kernel<HD>, 4, HD, 32, C::BQ, C::BK, C::THREADS, C::SMEM, q, k, v, o, batch, heads,
                kv_heads, seq, st, causal, window, scale, s);
}

}  // namespace

// dtype: 0 = fp32 (route wgmma_tf32x3), 1 = bf16 (route wgmma); q, k, v
// and o alike; hd 32, 64, 128, 160 or 256.  Strides are in elements, hd is
// contiguous; the host checked that every row starts 16-byte aligned.
// Returns a cudaError_t, or 10000 + the CUresult of a failed tensor-map
// encode.
extern "C" int flash_sm90_fwd(int dtype, int hd, const void* q, const void* k, const void* v, void* o, int batch, int heads,
                              int kv_heads, int seq, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                              long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                              long long o_sb, long long o_sh, long long o_ss, int causal, int window, float scale,
                              void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || heads <= 0 || kv_heads <= 0 || seq <= 0 ||
      heads % kv_heads != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_hd<32>(dtype, q, k, v, o, batch, heads, kv_heads, seq, st, causal, window, scale, s);
    case 64: return launch_hd<64>(dtype, q, k, v, o, batch, heads, kv_heads, seq, st, causal, window, scale, s);
    case 128: return launch_hd<128>(dtype, q, k, v, o, batch, heads, kv_heads, seq, st, causal, window, scale, s);
    case 160: return launch_hd<160>(dtype, q, k, v, o, batch, heads, kv_heads, seq, st, causal, window, scale, s);
    case 256: return launch_hd<256>(dtype, q, k, v, o, batch, heads, kv_heads, seq, st, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
