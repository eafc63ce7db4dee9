// RWKV-6 chunked time-mix for Hopper (sm_90a): bf16 r/k/v at head dim 64,
// chunk-parallel state passing, every product on the tensor cores.
//
// Replaces: src/repro/kernels/rwkv/rwkv.py::rwkv6_chunked (Pallas body
// _rwkv_kernel), the TPU kernel of the full-sequence RWKV-6 recurrence
//
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t,   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),
//
// for the route that takes bf16 r, k, v at M = 64 (every full-width launch
// of rwkv6-3b); rwkv.cu keeps fp32 and the other head dims.  The function
// is rwkv.cu's: w (B, L, H, M) and u (H, M) fp32, an optional fp32 initial
// state (B, H, M, M), out (B, L, H, M) and the final state in fp32, r, k, v,
// w and out read and written through their (b, l, h) strides with M
// contiguous (rows 16-byte aligned), tokens past L acting as w = 1,
// k = v = 0.  The arithmetic is the model's _wkv_chunked
// (src/repro/models/rwkv.py): 32-token sub-chunks, the log-decay scan cum
// within each, the mid-chunk-referenced pair factors, so every exponent is
// the model's.
//
// What bounds it on an H100: per (b, h, 32 tokens) the function needs
// 4CM^2 + 2C^2M flops (0.1002 ms in fp32 on the CUDA cores at the
// 4 x 2048-token, 40-head prefill) on 296 MB (0.088 ms at 3.35 TB/s).  On
// the tensor cores, with fp32 operands split into bf16 hi + lo parts (three
// products for fp32 x fp32, two for fp32 x bf16), the arithmetic is far
// below the bytes: the design is held to bytes, and to latency at 1 x 512.
//
// The design: the state recurrence is elementwise once each span's own
// contribution is known, so the products leave the sequential loop.  The
// sequence is cut into spans of kSpan = 128 tokens, four sub-chunks (128
// against 64 by an A/B on the card, PERF.md); three launches, in order, no
// atomics, each CTA of 8 warps:
//   A. rwkv_span_delta, one CTA per (span, b h), all in parallel: the state
//      the span adds from a zero state, by the recurrence itself over its
//      sub-chunks (dS = e^{last_j} dS + kf_j^T V_j, kf_s = k_s e^{last_j - cum_s}),
//      and its decay W = prod_j e^{last_j}, into the scratch.
//   B. rwkv_span_scan, one thread per 4 state elements of a (b, h): the
//      only sequential loop, one FMA a span: S_in[span] = S (in place over
//      dS), S = W S + dS; then the final state.  Loads are fetched 8 spans
//      ahead: they do not depend on the chain.
//   C. rwkv_span_out, one CTA per (span, b h), all in parallel: for each
//      sub-chunk in turn, the scores rq2 . kd2^T (the bonus on the diagonal),
//      out = rq . S + P . V written once, and S = e^{last} S + kf^T V in
//      registers for the next sub-chunk.
// A and C stage r, k, v, w by cp.async, two sub-chunks ahead; four threads
// scan a channel's log decays (quarters of 8 tokens, joined through shared
// memory).  Products are mma.sync m16n8k16 bf16 with fp32 accumulation: an
// fp32 operand x goes in as hi = bf16(x), lo = bf16(x - hi) (rounding to
// nearest), x . y as hi.hi + hi.lo + lo.hi (~2^-16 of each term left), and
// a bf16 operand (v) as it is.  Operands are stored in shared memory as bf16
// pairs along the product's depth (rows padded to 4 words mod 32: the
// fragment loads hit 32 banks).  Every sum has one fixed order: two
// launches give bitwise-equal results.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int M = 64;         // head dim
constexpr int C = 32;         // sub-chunk: the model's chunk
constexpr int kSub = 4;       // sub-chunks a span
constexpr int kSpan = kSub * C;  // tokens a state step of phase B
constexpr int kThreads = 256;   // 8 warps
constexpr int kQuarters = kThreads / M;  // threads scanning one channel of a sub-chunk
constexpr int kQT = C / kQuarters;       // tokens each of them scans
constexpr int RW_M = M / 2 + 4;  // words of a padded row of M bf16 (depth = channel)
constexpr int RW_C = C / 2 + 4;  // words of a padded row of C bf16 (depth = token)
constexpr int kScanThreads = 256;
constexpr int kPrefetch = 8;  // spans the scan fetches ahead
static_assert(kQuarters == 4 && kQT == 8, "the scan maps four threads (token quarters) to each channel");

struct Strides {
  long long b, l, h;
};

struct Args {
  const __nv_bfloat16* r;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* w;
  const float* u;
  const float* s_in;  // nullptr: zero initial state
  float* o;
  float* s_out;
  float* dstate;  // (B H, NS, M, M): dS after A, the state entering each span after B
  float* wspan;   // (B H, NS, M): e^{cum} over the span
  Strides sr, sk, sv, sw, so;
  int L, H, NS;
};

// ------------------------------------------------------------ primitives
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a . b, a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments from bf16 pairs stored along the depth, rows `rw` words apart:
// A rows row0.., B columns n0.. (stored as rows), depth step ks (16 values).
struct Lane {
  int g, t;  // lane / 4, lane % 4
};
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint32_t* s, int rw, int row0, int ks, Lane l) {
  const uint32_t* p = s + (row0 + l.g) * rw + ks * 8 + l.t;
  a[0] = p[0];
  a[1] = p[8 * rw];
  a[2] = p[4];
  a[3] = p[8 * rw + 4];
}
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const uint32_t* s, int rw, int n0, int ks, Lane l) {
  const uint32_t* p = s + (n0 + l.g) * rw + ks * 8 + l.t;
  b0 = p[0];
  b1 = p[4];
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }

// (x0, x1) -> bf16 pairs hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}
__device__ __forceinline__ void split_one(float x, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// d += a . b over one depth step, a as hi + lo: mma3 with b as hi + lo
// (hi.hi + hi.lo + lo.hi), mma2 with b exact in bf16 (hi.b + lo.b)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(d, ah, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, al, bh0, bh1);
}
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t b0,
                                     uint32_t b1) {
  mma(d, ah, b0, b1);
  mma(d, al, b0, b1);
}

// One sub-chunk staged from device memory (tokens past L zero-filled).
struct Stage {
  __nv_bfloat16 r[C * M], k[C * M], v[C * M];
  float w[C * M];
};
struct StageKVW {  // phase A reads no r
  __nv_bfloat16 k[C * M], v[C * M];
  float w[C * M];
};

// Rows t0 .. t0 + C of r (unless r_dst is null), k, v, w by cp.async.
__device__ __forceinline__ void stage_sub_chunk(__nv_bfloat16* r_dst, __nv_bfloat16* k_dst, __nv_bfloat16* v_dst,
                                                float* w_dst, const Args& a, int b, int h, int t0, int tid) {
  const int valid = min(C, a.L - t0);
  for (int c = tid; c < C * (M / 8); c += kThreads) {  // 8 bf16 a copy
    const int t = c / (M / 8), q = (c % (M / 8)) * 8;
    const bool ok = t < valid;
    const long long tt = ok ? t0 + t : t0;  // t0 < L: a valid address either way
    if (r_dst != nullptr) cp_async16(r_dst + t * M + q, a.r + b * a.sr.b + h * a.sr.h + tt * a.sr.l + q, ok);
    cp_async16(k_dst + t * M + q, a.k + b * a.sk.b + h * a.sk.h + tt * a.sk.l + q, ok);
    cp_async16(v_dst + t * M + q, a.v + b * a.sv.b + h * a.sv.h + tt * a.sv.l + q, ok);
  }
  for (int c = tid; c < C * (M / 4); c += kThreads) {  // 4 fp32 a copy
    const int t = c / (M / 4), q = (c % (M / 4)) * 4;
    const bool ok = t < valid;
    const long long tt = ok ? t0 + t : t0;
    cp_async16(w_dst + t * M + q, a.w + b * a.sw.b + h * a.sw.h + tt * a.sw.l + q, ok);
  }
}

// The log decays of tokens [8 q, 8 q + 8) of channel m (w tile [t][m]),
// scanned: lw[i] and the inclusive sum loc[i] from the quarter's first
// token.  Returns the quarter's total.  Tokens past `valid` act as w = 1.
__device__ __forceinline__ float scan_quarter(const float* w, int m, int q, int valid, float (&lw)[kQT],
                                              float (&loc)[kQT]) {
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < kQT; ++i) {
    const int t = q * kQT + i;
    lw[i] = t < valid ? logf(fmaxf(w[t * M + m], 1e-20f)) : 0.f;
    run += lw[i];
    loc[i] = run;
  }
  return run;
}

// The quarters' totals part[0..q) of channel m summed in order: the scan's
// offset for quarter q; prefix(4) is cum at the sub-chunk's last token.
__device__ __forceinline__ float prefix(const float (&part)[kQuarters][M], int m, int q) {
  float off = 0.f;
  for (int i = 0; i < q; ++i) off += part[i][m];
  return off;
}

// v of a sub-chunk transposed to bf16 pairs along the token: vt[n][t]
__device__ __forceinline__ void transpose_v(uint32_t* vt, const __nv_bfloat16* v, int n, int q) {
#pragma unroll
  for (int i = 0; i < kQT; i += 2) {
    const int t = q * kQT + i;
    __nv_bfloat162 p;
    p.x = v[t * M + n];
    p.y = v[(t + 1) * M + n];
    vt[n * RW_C + t / 2] = bits(p);
  }
}

// ------------------------------------------------------ A: span deltas
struct DeltaSmem {
  StageKVW st[2];  // sub-chunks j, j + 1 in flight
  uint32_t kf_hi[M * RW_C], kf_lo[M * RW_C], vt[M * RW_C];
  float part[kQuarters][M];  // quarter totals of the log-decay scan
  float wl[M];               // e^{last} of the sub-chunk
};

__global__ void __launch_bounds__(kThreads) rwkv_span_delta(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& s = *reinterpret_cast<DeltaSmem*>(smem_raw);
  const int sp = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, warp = tid / 32, m = tid % M, q = tid / M;
  const Lane ln{(tid % 32) / 4, tid % 4};
  const int span0 = sp * kSpan;
  const int n_sub = min(kSub, (a.L - span0 + C - 1) / C);  // sub-chunks holding a token

  auto stage = [&](int j) {  // sub-chunk j into buffer j % 2
    StageKVW& st = s.st[j % 2];
    stage_sub_chunk(nullptr, st.k, st.v, st.w, a, b, h, span0 + j * C, tid);
    cp_async_commit();
  };
  stage(0);
  if (n_sub > 1) stage(1);

  // dS by Horner's rule over the sub-chunks, like the state itself:
  // dS = e^{last_j} dS + kf_j^T V_j; warp = (16 rows m, 32 columns n)
  const int row0 = 16 * (warp % 4), col0 = 32 * (warp / 4);
  float acc[4][4] = {};
  float decay = 1.f;  // W of channel tid (tid < M)
  for (int j = 0; j < n_sub; ++j) {
    if (j + 1 < n_sub) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // stage j landed; last sub-chunk's readers done
    const StageKVW& st = s.st[j % 2];
    float lw[kQT], loc[kQT];
    s.part[q][m] = scan_quarter(st.w, m, q, a.L - span0 - j * C, lw, loc);
    __syncthreads();
    const float off = prefix(s.part, m, q), last = prefix(s.part, m, kQuarters);
    if (q == 0) {
      s.wl[m] = expf(last);
      decay *= s.wl[m];
    }
#pragma unroll
    for (int i = 0; i < kQT; i += 2) {
      const int t = q * kQT + i;
      const float k0 = __bfloat162float(st.k[t * M + m]), k1 = __bfloat162float(st.k[(t + 1) * M + m]);
      split_pair(k0 * expf(last - (loc[i] + off)), k1 * expf(last - (loc[i + 1] + off)),
                 s.kf_hi[m * RW_C + t / 2], s.kf_lo[m * RW_C + t / 2]);
    }
    transpose_v(s.vt, st.v, m, q);
    __syncthreads();
    if (j + 2 < n_sub) stage(j + 2);  // buffer j % 2 is read: sub-chunk j + 2 into it
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= s.wl[row0 + ln.g + 8 * (e / 2)];
    }
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks) {
      uint32_t ah[4], al[4];
      load_a(ah, s.kf_hi, RW_C, row0, ks, ln);
      load_a(al, s.kf_lo, RW_C, row0, ks, ln);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, s.vt, RW_C, col0 + 8 * nt, ks, ln);
        mma2(acc[nt], ah, al, b0, b1);
      }
    }
  }

  if (tid < M) a.wspan[((long long)bh * a.NS + sp) * M + tid] = decay;
  float* ds = a.dstate + ((long long)bh * a.NS + sp) * M * M;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int row = row0 + ln.g, col = col0 + 8 * nt + 2 * ln.t;
    *reinterpret_cast<float2*>(ds + row * M + col) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(ds + (row + 8) * M + col) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ------------------------------------------------------- B: state scan
__global__ void __launch_bounds__(kScanThreads) rwkv_span_scan(const Args a) {
  constexpr int kVec = M * M / 4;  // float4s of one state
  const long long idx = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  const long long bh = idx / kVec;
  const int e = (int)(idx % kVec), m = e / (M / 4);
  float4* ds = reinterpret_cast<float4*>(a.dstate) + bh * a.NS * kVec + e;
  const float* ws = a.wspan + bh * a.NS * M + m;
  float4 s = a.s_in != nullptr ? reinterpret_cast<const float4*>(a.s_in)[bh * kVec + e] : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 d[kPrefetch] = {}, dn[kPrefetch] = {};
  float w[kPrefetch] = {}, wn[kPrefetch] = {};
  auto fetch = [&](int i0, float4(&dd)[kPrefetch], float(&ww)[kPrefetch]) {
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      if (i0 + q < a.NS) {
        dd[q] = ds[(long long)(i0 + q) * kVec];
        ww[q] = ws[(long long)(i0 + q) * M];
      }
    }
  };
  fetch(0, d, w);
  for (int i0 = 0; i0 < a.NS; i0 += kPrefetch) {
    fetch(i0 + kPrefetch, dn, wn);
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      if (i0 + q < a.NS) {
        ds[(long long)(i0 + q) * kVec] = s;
        s = make_float4(fmaf(w[q], s.x, d[q].x), fmaf(w[q], s.y, d[q].y), fmaf(w[q], s.z, d[q].z),
                        fmaf(w[q], s.w, d[q].w));
      }
    }
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      d[q] = dn[q];
      w[q] = wn[q];
    }
  }
  reinterpret_cast<float4*>(a.s_out)[bh * kVec + e] = s;
}

// ------------------------------------------------------ C: span outputs
struct OutSmem {
  Stage st[2];                                             // sub-chunks j, j + 1 in flight
  uint32_t rq_hi[C * RW_M], rq_lo[C * RW_M];                // r_t e^{cum_{t-1}}        [t][m]
  uint32_t rq2_hi[C * RW_M], rq2_lo[C * RW_M];              // r_t e^{cum_{t-1} - mid}  [t][m]
  uint32_t kd2_hi[C * RW_M], kd2_lo[C * RW_M];              // k_s e^{mid - cum_s}      [s][m]
  uint32_t kf_hi[M * RW_C], kf_lo[M * RW_C], vt[M * RW_C];  // k_s e^{last - cum_s}, v  [m|n][s]
  uint32_t p_hi[C * RW_C], p_lo[C * RW_C];                  // scores, bonus on the diagonal [t][s]
  uint32_t st_hi[M * RW_M], st_lo[M * RW_M];                // the state entering the sub-chunk [n][m]
  float part[kQuarters][M], first[kQuarters][M];           // quarter totals; each quarter's first log decay
  float wl[M], bonus[C], u[M];
};

// The state is held in the accumulators as warp = (16 rows m, 32 columns
// n): rows row0 + g (+8), columns col0 + 8 nt + 2 t (+1).  Into st_hi /
// st_lo, transposed: [n][m].
__device__ __forceinline__ void store_state(OutSmem& s, const float (&acc)[4][4], int row0, int col0, Lane ln) {
  auto* hi = reinterpret_cast<__nv_bfloat16*>(s.st_hi);
  auto* lo = reinterpret_cast<__nv_bfloat16*>(s.st_lo);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + ln.g + 8 * (e / 2), col = col0 + 8 * nt + 2 * ln.t + e % 2;
      split_one(acc[nt][e], hi[col * 2 * RW_M + row], lo[col * 2 * RW_M + row]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) rwkv_span_out(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& s = *reinterpret_cast<OutSmem*>(smem_raw);
  const int sp = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, warp = tid / 32, m = tid % M, q = tid / M;
  const Lane ln{(tid % 32) / 4, tid % 4};
  const int span0 = sp * kSpan;
  const int n_sub = min(kSub, (a.L - span0 + C - 1) / C);
  float* ob = a.o + b * a.so.b + h * a.so.h;

  auto stage = [&](int j) {  // sub-chunk j into buffer j % 2
    Stage& st = s.st[j % 2];
    stage_sub_chunk(st.r, st.k, st.v, st.w, a, b, h, span0 + j * C, tid);
    cp_async_commit();
  };
  stage(0);
  if (n_sub > 1) stage(1);
  if (tid < M) s.u[tid] = a.u[h * M + tid];

  // the state entering the span, from phase B
  const int s_row0 = 16 * (warp % 4), s_col0 = 32 * (warp / 4);
  float sacc[4][4];
  {
    const float* sin = a.dstate + ((long long)bh * a.NS + sp) * M * M;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = s_row0 + ln.g, col = s_col0 + 8 * nt + 2 * ln.t;
      const float2 x = *reinterpret_cast<const float2*>(sin + row * M + col);
      const float2 y = *reinterpret_cast<const float2*>(sin + (row + 8) * M + col);
      sacc[nt][0] = x.x;
      sacc[nt][1] = x.y;
      sacc[nt][2] = y.x;
      sacc[nt][3] = y.y;
    }
    store_state(s, sacc, s_row0, s_col0, ln);
  }

  for (int j = 0; j < n_sub; ++j) {
    if (j + 1 < n_sub) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // stage j landed; the state written; last sub-chunk's readers done
    const Stage& st = s.st[j % 2];
    const int t0 = span0 + j * C, valid = min(C, a.L - t0);

    // 1. the scan and the factor rows
    float lw[kQT], loc[kQT];
    s.part[q][m] = scan_quarter(st.w, m, q, valid, lw, loc);
    s.first[q][m] = lw[0];
    {  // bonus r_t . u . k_t: 8 threads a token, 8 channels each (rotated
       // by the token: no bank conflicts), then summed across the eight
      const int t = tid / 8, c8 = tid % 8;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < M / 8; ++i) {
        const int mm = 8 * c8 + (i + 2 * t) % 8;
        acc += __bfloat162float(st.r[t * M + mm]) * s.u[mm] * __bfloat162float(st.k[t * M + mm]);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      if (c8 == 0) s.bonus[t] = acc;
    }
    __syncthreads();
    {
      const float off = prefix(s.part, m, q);
      const float mid = prefix(s.part, m, 2) + s.first[2][m];  // cum at token 16
      const float last = prefix(s.part, m, kQuarters);
      if (q == 0) s.wl[m] = expf(last);
      auto* rqh = reinterpret_cast<__nv_bfloat16*>(s.rq_hi);
      auto* rql = reinterpret_cast<__nv_bfloat16*>(s.rq_lo);
      auto* rq2h = reinterpret_cast<__nv_bfloat16*>(s.rq2_hi);
      auto* rq2l = reinterpret_cast<__nv_bfloat16*>(s.rq2_lo);
      auto* kd2h = reinterpret_cast<__nv_bfloat16*>(s.kd2_hi);
      auto* kd2l = reinterpret_cast<__nv_bfloat16*>(s.kd2_lo);
      // two exponentials a token: e^{-mid} and e^{last - mid} are the
      // channel's (|exponent| <= 16 steps of log-decay, as the pair factors')
      const float e_nmid = expf(-mid), e_tail = expf(last - mid);
      float kf_prev = 0.f;
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        const int t = q * kQT + i, at = t * 2 * RW_M + m;
        const float cum = loc[i] + off, prev = cum - lw[i];
        const float r = __bfloat162float(st.r[t * M + m]), k = __bfloat162float(st.k[t * M + m]);
        const float rq = r * expf(prev), kd2 = k * expf(mid - cum);
        split_one(rq, rqh[at], rql[at]);
        split_one(rq * e_nmid, rq2h[at], rq2l[at]);
        split_one(kd2, kd2h[at], kd2l[at]);
        const float kf = kd2 * e_tail;
        if (i % 2) split_pair(kf_prev, kf, s.kf_hi[m * RW_C + t / 2], s.kf_lo[m * RW_C + t / 2]);
        kf_prev = kf;
      }
      transpose_v(s.vt, st.v, m, q);
    }
    __syncthreads();
    if (j + 2 < n_sub) stage(j + 2);  // buffer j % 2 is read: sub-chunk j + 2 into it

    // 2. scores, one 16 x 8 tile a warp: rows 16..31 with s 0..31 in warps
    //    0..3, rows 0..15 with s 0..15 in warps 4, 5 (s > t is zero); s < t
    //    kept, the bonus at s = t
    if (warp < 6) {
      const int rt = warp < 4 ? 1 : 0, s0 = 8 * (warp % 4);
      float acc[4] = {};
#pragma unroll
      for (int ks = 0; ks < M / 16; ++ks) {
        uint32_t ah[4], al[4], bh0, bh1, bl0, bl1;
        load_a(ah, s.rq2_hi, RW_M, 16 * rt, ks, ln);
        load_a(al, s.rq2_lo, RW_M, 16 * rt, ks, ln);
        load_b(bh0, bh1, s.kd2_hi, RW_M, s0, ks, ln);
        load_b(bl0, bl1, s.kd2_lo, RW_M, s0, ks, ln);
        mma3(acc, ah, al, bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int t = 16 * rt + ln.g + 8 * e2, sc = s0 + 2 * ln.t;
        float x[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) x[c] = sc + c < t ? acc[2 * e2 + c] : (sc + c == t ? s.bonus[t] : 0.f);
        split_pair(x[0], x[1], s.p_hi[t * RW_C + sc / 2], s.p_lo[t * RW_C + sc / 2]);
      }
    }
    __syncthreads();

    // 3. out = rq . S + P . V: warp = (16 rows t, 16 columns n)
    {
      const int rt = warp % 2, n0 = 16 * (warp / 2);
      float o[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < M / 16; ++ks) {
        uint32_t ah[4], al[4];
        load_a(ah, s.rq_hi, RW_M, 16 * rt, ks, ln);
        load_a(al, s.rq_lo, RW_M, 16 * rt, ks, ln);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t bh0, bh1, bl0, bl1;
          load_b(bh0, bh1, s.st_hi, RW_M, n0 + 8 * nt, ks, ln);
          load_b(bl0, bl1, s.st_lo, RW_M, n0 + 8 * nt, ks, ln);
          mma3(o[nt], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      for (int ks = 0; ks <= rt; ++ks) {  // s <= t: rows 0..15 need s 0..15 only
        uint32_t ah[4], al[4];
        load_a(ah, s.p_hi, RW_C, 16 * rt, ks, ln);
        load_a(al, s.p_lo, RW_C, 16 * rt, ks, ln);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t b0, b1;
          load_b(b0, b1, s.vt, RW_C, n0 + 8 * nt, ks, ln);
          mma2(o[nt], ah, al, b0, b1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = n0 + 8 * nt + 2 * ln.t;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int t = 16 * rt + ln.g + 8 * e2;
          if (t < valid)
            *reinterpret_cast<float2*>(ob + (long long)(t0 + t) * a.so.l + col) =
                make_float2(o[nt][2 * e2], o[nt][2 * e2 + 1]);
        }
      }
    }

    // 4. the state entering the next sub-chunk: S = e^{last} S + kf^T V
    if (j + 1 < n_sub) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nt][e] *= s.wl[s_row0 + ln.g + 8 * (e / 2)];
      }
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks) {
        uint32_t ah[4], al[4];
        load_a(ah, s.kf_hi, RW_C, s_row0, ks, ln);
        load_a(al, s.kf_lo, RW_C, s_row0, ks, ln);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t b0, b1;
          load_b(b0, b1, s.vt, RW_C, s_col0 + 8 * nt, ks, ln);
          mma2(sacc[nt], ah, al, b0, b1);
        }
      }
      __syncthreads();  // every warp has read st_hi / st_lo
      store_state(s, sacc, s_row0, s_col0, ln);
    }
  }
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream, const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const long long bh = (long long)batch * a.H;
  if (bh > 65535 || bh * (M * M / 4) / kScanThreads > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 spans((unsigned)a.NS, (unsigned)bh);
  cudaError_t err = cudaSuccess;
  if (a.NS > 0) err = launch_one(rwkv_span_delta, spans, kThreads, sizeof(DeltaSmem), stream, a);
  if (err == cudaSuccess)
    err = launch_one(rwkv_span_scan, dim3((unsigned)(bh * (M * M / 4) / kScanThreads)), kScanThreads, 0, stream, a);
  if (err == cudaSuccess && a.NS > 0)
    err = launch_one(rwkv_span_out, spans, kThreads, sizeof(OutSmem), stream, a);
  return err;
}

}  // namespace

// dtype must be 1 (bf16 r, k, v) and m 64.  w, u, the states, out and the
// scratch are fp32.  Strides are in elements, M is contiguous, and every
// (b, l, h) row of r, k, v, w starts on a 16-byte boundary; u (H, M), the
// states (B, H, M, M) and the scratch are contiguous and 16-byte aligned.
// The scratch holds B H NS (M M + M) floats, NS = ceil(L / 128): dS, then
// W.  s_in may be null (zero initial state).  Returns a cudaError_t.
extern "C" int rwkv6_sm90_fwd(int dtype, int m, const void* r, const void* k, const void* v, const float* w,
                              const float* u, const float* s_in, float* o, float* s_out, float* scratch, int batch,
                              int seq, int heads, long long r_sb, long long r_sl, long long r_sh, long long k_sb,
                              long long k_sl, long long k_sh, long long v_sb, long long v_sl, long long v_sh,
                              long long w_sb, long long w_sl, long long w_sh, long long o_sb, long long o_sl,
                              long long o_sh, void* stream) {
  if (dtype != 1 || m != M || batch <= 0 || seq < 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.r = static_cast<const __nv_bfloat16*>(r);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.w = w;
  a.u = u;
  a.s_in = s_in;
  a.o = o;
  a.s_out = s_out;
  a.sr = {r_sb, r_sl, r_sh};
  a.sk = {k_sb, k_sl, k_sh};
  a.sv = {v_sb, v_sl, v_sh};
  a.sw = {w_sb, w_sl, w_sh};
  a.so = {o_sb, o_sl, o_sh};
  a.L = seq;
  a.H = heads;
  a.NS = (seq + kSpan - 1) / kSpan;
  a.dstate = scratch;
  a.wspan = scratch + (long long)batch * heads * a.NS * M * M;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch(a, batch, s);
}
