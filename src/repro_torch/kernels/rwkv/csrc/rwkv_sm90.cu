// RWKV-6 chunked time-mix for Hopper (sm_90a): bf16 or fp32 r/k/v at head
// dims 32, 64 and 128, chunk-parallel state passing, every product on the
// tensor cores.
//
// Replaces: src/repro/kernels/rwkv/rwkv.py::rwkv6_chunked (Pallas body
// _rwkv_kernel), the TPU kernel of the full-sequence RWKV-6 recurrence
//
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t,   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t).
//
// w (B, L, H, M) and u (H, M) fp32, r, k, v bf16 or fp32, an optional fp32
// initial state (B, H, M, M), out (B, L, H, M) and the final state in fp32,
// r, k, v, w and out read and written through their (b, l, h) strides with
// M contiguous (rows 16-byte aligned), tokens past L acting as w = 1,
// k = v = 0.  The arithmetic is the model's _wkv_chunked
// (src/repro/models/rwkv.py): 32-token sub-chunks, the log-decay scan cum
// within each, the mid-chunk-referenced pair factors, so every exponent is
// the model's.
//
// What bounds it on an H100: per (b, h, 32 tokens) the function needs
// 4CM^2 + 2C^2M flops (0.1002 ms in fp32 on the CUDA cores at the
// 4 x 2048-token, 40-head prefill) on 296 MB in bf16 (0.088 ms at 3.35
// TB/s; 422 MB in fp32, 0.126 ms).  On the tensor cores, with fp32 operands
// split into hi + lo parts (three products for fp32 x fp32, two for fp32 x
// bf16), the arithmetic is far below the bytes: the design is held to
// bytes, and to latency at short L.
//
// The design: the state recurrence is elementwise once each span's own
// contribution is known, so the products leave the sequential loop.  The
// sequence is cut into spans of kSpan = 128 tokens, four sub-chunks (128
// against 64 by an A/B on the card, PERF.md); three launches, in order, no
// atomics, each CTA of 8 warps:
//   A. rwkv_span_delta, one CTA per (span, b h, value block), all in
//      parallel: the state the span adds from a zero state, by the
//      recurrence itself over its sub-chunks (dS = e^{last_j} dS + kf_j^T V_j,
//      kf_s = k_s e^{last_j - cum_s}), and its decay W = prod_j e^{last_j},
//      into the scratch.
//   B. rwkv_span_scan, one thread per 4 state elements of a (b, h): the
//      only sequential loop, one FMA a span: S_in[span] = S (in place over
//      dS), S = W S + dS; then the final state.  Loads are fetched 8 spans
//      ahead: they do not depend on the chain.
//   C. rwkv_span_out, one CTA per (span, b h, value block), all in
//      parallel: for each sub-chunk in turn, the scores rq2 . kd2^T (the
//      bonus on the diagonal), out = rq . S + P . V written once, and
//      S = e^{last} S + kf^T V in registers for the next sub-chunk.
// When L <= kSpan (one span, and no scratch given) C runs alone: the span's
// input state is the given one (or zero), and after its last sub-chunk it
// stores the final state from its registers.  Its out is the three
// launches' bit for bit; its state sums in another order.
// The value columns n of the state, of v and of out are independent, so at
// M = 128 each (span, b h) takes MK / MV CTAs of MV value columns (64, or
// 32 for fp32 r, k, v), each with the head's 128 key channels (MK): the
// state a CTA holds is MK x MV.
// A and C stage r, k, v, w by cp.async (two sub-chunks ahead where two
// stages keep two CTAs an SM, else one: the next sub-chunk loads while
// this one's products run); QS = 256 / MK threads scan a channel's log
// decays (pieces of 32 / QS tokens, joined through shared memory).
// Products run on the tensor cores with fp32 accumulation, an fp32
// operand x as hi + lo parts and x . y as hi.hi + hi.lo + lo.hi.  bf16 r,
// k, v (route tc): mma.sync m16n8k16 bf16, hi = bf16(x), lo = bf16(x - hi)
// (rounding to nearest; ~2^-16 of each term left, in the kernel's 5e-5
// bound), a bf16 v as it is; operands stored as bf16 pairs along the
// product's depth.  fp32 r, k, v (route tc_fp32): mma.sync m16n8k8 TF32,
// hi = tf32(x), lo = tf32(x - hi) (ties away; ~2^-21 left: the bf16 split
// meets the kernel's bound but not the fp32 decoders' logits, see
// ref.py::rwkv6_spans_ref), v split too; operands stored one a word.
// Rows are padded to 4 words mod 32: the fragment loads hit 32 banks.
// At M 128 fp32, rq and rq2 share one buffer (rq is written after the
// scores have read rq2) to fit shared memory.  Every sum has one fixed
// order: two launches give bitwise-equal results.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;            // sub-chunk: the model's chunk
constexpr int kSub = 4;          // sub-chunks a span
constexpr int kSpan = kSub * C;  // tokens a state step of phase B
constexpr int kThreads = 256;    // 8 warps
constexpr int kScanThreads = 256;
constexpr int kPrefetch = 8;  // spans the scan fetches ahead

// MK key channels (the head dim of r, k, w, u), MV value columns a CTA
// (of v, out and the state), T the type of r, k, v: bf16 operands as bf16
// pairs, fp32 ones as TF32 words (TF)
template <int MK, int MV, typename T>
struct Cfg {
  static constexpr bool TF = sizeof(T) == 4;
  static constexpr int VPW = TF ? 1 : 2;    // operand values a 32-bit word
  static constexpr int KS = 8 * VPW;        // depth of one mma (k16 bf16, k8 TF32)
  static constexpr int QS = kThreads / MK;  // threads scanning one channel of a sub-chunk
  static constexpr int QT = C / QS;         // tokens each of them scans
  static constexpr int RW_M = MK / VPW + 4;  // words of a padded row of depth MK (channel)
  static constexpr int RW_C = C / VPW + 4;   // words of a padded row of depth C (token)
  static constexpr int RT = MK / 16;        // row tiles of the state (16 channels each)
  static constexpr int CG = 8 / RT;         // column groups: warp = (row tile, column group)
  static constexpr int NT = MV / (8 * CG);  // 8-column tiles of the state a warp holds
  static constexpr int VQ = kThreads / MV;  // v transposed: token groups
  static constexpr int VT = C / VQ;         // tokens a thread transposes
  static constexpr int ONT = MV / 32;       // 8-column tiles of out a warp holds (warp = (16 t, MV / 4 n))
  static constexpr int VS = MK / MV;       // CTAs (value blocks) a head
  static_assert(QS >= 2 && QS % 2 == 0 && QT % 2 == 0 && CG >= 1 && NT >= 1 && VT % 2 == 0 && ONT >= 1,
                "thread mapping");
};

struct Strides {
  long long b, l, h;
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s_in;  // nullptr: zero initial state
  float* o;
  float* s_out;
  float* dstate;  // (B H VS, NS, MK, MV): dS after A, the state entering each span after B; nullptr: C alone
  float* wspan;   // (B H, NS, MK): e^{cum} over the span
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

// d += a . b, fp32 accumulate: a 16 x 16 (row), b 16 x 8 (col) bf16, or
// (TF) a 16 x 8, b 8 x 8 TF32
template <bool TF>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (TF) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Fragments from words stored along the depth (bf16 pairs or TF32 values),
// rows `rw` words apart: A rows row0.., B columns n0.. (stored as rows),
// depth step ks (8 words: one mma's depth).
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
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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
// x -> TF32 words hi = tf32(x), lo = tf32(x - hi): ties away from zero,
// low 13 bits zero (ref.py's split_parts)
__device__ __forceinline__ uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// Operand element e of row `row` of a buffer of `rw`-word rows (depth
// index e): x's hi and lo parts, bf16 halves or TF32 words
template <bool TF>
__device__ __forceinline__ void put(uint32_t* hi, uint32_t* lo, int rw, int row, int e, float x) {
  if constexpr (TF) {
    split_tf32(x, hi[row * rw + e], lo[row * rw + e]);
  } else {
    split_one(x, reinterpret_cast<__nv_bfloat16*>(hi)[row * 2 * rw + e],
              reinterpret_cast<__nv_bfloat16*>(lo)[row * 2 * rw + e]);
  }
}
// elements e, e + 1 (e even) of a row at once: one bf16 pair word, or two TF32 words
template <bool TF>
__device__ __forceinline__ void put2(uint32_t* hi, uint32_t* lo, int rw, int row, int e, float x0, float x1) {
  if constexpr (TF) {
    split_tf32(x0, hi[row * rw + e], lo[row * rw + e]);
    split_tf32(x1, hi[row * rw + e + 1], lo[row * rw + e + 1]);
  } else {
    split_pair(x0, x1, hi[row * rw + e / 2], lo[row * rw + e / 2]);
  }
}

// d += a . b over one depth step, a as hi + lo: mma3 with b as hi + lo
// (hi.hi + hi.lo + lo.hi), mma2 with b exact (hi.b + lo.b)
template <bool TF>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma<TF>(d, ah, bh0, bh1);
  mma<TF>(d, ah, bl0, bl1);
  mma<TF>(d, al, bh0, bh1);
}
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t b0,
                                     uint32_t b1) {
  mma<false>(d, ah, b0, b1);
  mma<false>(d, al, b0, b1);
}

// d += a . v^T over one depth step (tokens): a bf16 v^T as it is, or an
// fp32 v's TF32 hi + lo parts (vt_lo)
template <bool TF>
__device__ __forceinline__ void mma_v(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                      const uint32_t* vt, const uint32_t* vt_lo, int rw, int n0, int ks, Lane l) {
  uint32_t b0, b1;
  load_b(b0, b1, vt, rw, n0, ks, l);
  if constexpr (TF) {
    uint32_t c0, c1;
    load_b(c0, c1, vt_lo, rw, n0, ks, l);
    mma3<true>(d, ah, al, b0, b1, c0, c1);
  } else {
    mma2(d, ah, al, b0, b1);
  }
}

// One sub-chunk staged from device memory (tokens past L zero-filled).
template <int MK, int MV, typename T>
struct Stage {
  T r[C * MK], k[C * MK], v[C * MV];
  float w[C * MK];
};
template <int MK, int MV, typename T>
struct StageKVW {  // phase A reads no r
  T k[C * MK], v[C * MV];
  float w[C * MK];
};

// Rows t0 .. t0 + C of r (unless r_dst is null), k, w (MK channels) and v
// (MV columns from n0) by cp.async.
template <int MK, int MV, typename T>
__device__ __forceinline__ void stage_sub_chunk(T* r_dst, T* k_dst, T* v_dst, float* w_dst, const Args& a, int b,
                                                int h, int n0, int t0, int tid) {
  constexpr int E = 16 / sizeof(T);  // elements a copy
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int valid = min(C, a.L - t0);
  for (int c = tid; c < C * (MK / E); c += kThreads) {
    const int t = c / (MK / E), q = (c % (MK / E)) * E;
    const bool ok = t < valid;
    const long long tt = ok ? t0 + t : t0;  // t0 < L: a valid address either way
    if (r_dst != nullptr) cp_async16(r_dst + t * MK + q, r + b * a.sr.b + h * a.sr.h + tt * a.sr.l + q, ok);
    cp_async16(k_dst + t * MK + q, k + b * a.sk.b + h * a.sk.h + tt * a.sk.l + q, ok);
    if constexpr (MK == MV) cp_async16(v_dst + t * MV + q, v + b * a.sv.b + h * a.sv.h + tt * a.sv.l + q, ok);
  }
  if constexpr (MK != MV) {  // v's columns n0 .. n0 + MV
    for (int c = tid; c < C * (MV / E); c += kThreads) {
      const int t = c / (MV / E), q = (c % (MV / E)) * E;
      const bool ok = t < valid;
      const long long tt = ok ? t0 + t : t0;
      cp_async16(v_dst + t * MV + q, v + b * a.sv.b + h * a.sv.h + tt * a.sv.l + n0 + q, ok);
    }
  }
  for (int c = tid; c < C * (MK / 4); c += kThreads) {  // 4 fp32 a copy
    const int t = c / (MK / 4), q = (c % (MK / 4)) * 4;
    const bool ok = t < valid;
    const long long tt = ok ? t0 + t : t0;
    cp_async16(w_dst + t * MK + q, a.w + b * a.sw.b + h * a.sw.h + tt * a.sw.l + q, ok);
  }
}

// The log decays of tokens [QT q, QT q + QT) of channel m (w tile [t][m]),
// scanned: lw[i] and the inclusive sum loc[i] from the piece's first token.
// Returns the piece's total.  Tokens past `valid` act as w = 1.
template <int MK, int QT>
__device__ __forceinline__ float scan_piece(const float* w, int m, int q, int valid, float (&lw)[QT],
                                            float (&loc)[QT]) {
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const int t = q * QT + i;
    lw[i] = t < valid ? logf(fmaxf(w[t * MK + m], 1e-20f)) : 0.f;
    run += lw[i];
    loc[i] = run;
  }
  return run;
}

// The pieces' totals part[0..q) of channel m summed in order: the scan's
// offset for piece q; prefix(QS) is cum at the sub-chunk's last token.
template <int QS, int MK>
__device__ __forceinline__ float prefix(const float (&part)[QS][MK], int m, int q) {
  float off = 0.f;
  for (int i = 0; i < q; ++i) off += part[i][m];
  return off;
}

// v of a sub-chunk transposed along the token: vt[n][t], bf16 pairs as
// they are, or an fp32 v's TF32 parts (the lo into vt_lo); thread (n,
// token group vq)
template <int MV, int VT, int RW_C, typename T>
__device__ __forceinline__ void transpose_v(uint32_t* vt, uint32_t* vt_lo, const T* v, int n, int vq) {
#pragma unroll
  for (int i = 0; i < VT; i += 2) {
    const int t = vq * VT + i;
    if constexpr (sizeof(T) == 4) {
      put2<true>(vt, vt_lo, RW_C, n, t, v[t * MV + n], v[(t + 1) * MV + n]);
    } else {
      __nv_bfloat162 p;
      p.x = v[t * MV + n];
      p.y = v[(t + 1) * MV + n];
      vt[n * RW_C + t / 2] = bits(p);
    }
  }
}

// ------------------------------------------------------ A: span deltas
template <int MK, int MV, typename T>
struct DeltaSmem {
  static constexpr int RW_C = Cfg<MK, MV, T>::RW_C;
  StageKVW<MK, MV, T> st[2];  // sub-chunks j, j + 1 in flight
  uint32_t kf_hi[MK * RW_C], kf_lo[MK * RW_C], vt[MV * RW_C];
  float part[Cfg<MK, MV, T>::QS][MK];  // piece totals of the log-decay scan
  float wl[MK];                         // e^{last} of the sub-chunk
  uint32_t vt_lo[Cfg<MK, MV, T>::TF ? MV * RW_C : 1];  // last: bf16 leaves the others where they were
};

template <int MK, int MV, typename T>
__global__ void __launch_bounds__(kThreads) rwkv_span_delta(const Args a) {
  using K = Cfg<MK, MV, T>;
  constexpr int RW_C = K::RW_C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& s = *reinterpret_cast<DeltaSmem<MK, MV, T>*>(smem_raw);
  const int sp = blockIdx.x, bhv = blockIdx.y, bh = bhv / K::VS, b = bh / a.H, h = bh % a.H;
  const int n0 = (bhv % K::VS) * MV;
  const int tid = threadIdx.x, warp = tid / 32, m = tid % MK, q = tid / MK;
  const Lane ln{(tid % 32) / 4, tid % 4};
  const int span0 = sp * kSpan;
  const int n_sub = min(kSub, (a.L - span0 + C - 1) / C);  // sub-chunks holding a token

  auto stage = [&](int j) {  // sub-chunk j into buffer j % 2
    StageKVW<MK, MV, T>& st = s.st[j % 2];
    stage_sub_chunk<MK, MV, T>(nullptr, st.k, st.v, st.w, a, b, h, n0, span0 + j * C, tid);
    cp_async_commit();
  };
  stage(0);
  if (n_sub > 1) stage(1);

  // dS by Horner's rule over the sub-chunks, like the state itself:
  // dS = e^{last_j} dS + kf_j^T V_j; warp = (16 rows m, MV / CG columns n)
  const int row0 = 16 * (warp % K::RT), col0 = (MV / K::CG) * (warp / K::RT);
  float acc[K::NT][4] = {};
  float decay = 1.f;  // W of channel tid (tid < MK)
  for (int j = 0; j < n_sub; ++j) {
    if (j + 1 < n_sub) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // stage j landed; last sub-chunk's readers done
    const StageKVW<MK, MV, T>& st = s.st[j % 2];
    float lw[K::QT], loc[K::QT];
    s.part[q][m] = scan_piece<MK, K::QT>(st.w, m, q, a.L - span0 - j * C, lw, loc);
    __syncthreads();
    const float off = prefix<K::QS, MK>(s.part, m, q), last = prefix<K::QS, MK>(s.part, m, K::QS);
    if (q == 0) {
      s.wl[m] = expf(last);
      decay *= s.wl[m];
    }
#pragma unroll
    for (int i = 0; i < K::QT; i += 2) {
      const int t = q * K::QT + i;
      const float k0 = to_f32(st.k[t * MK + m]), k1 = to_f32(st.k[(t + 1) * MK + m]);
      put2<K::TF>(s.kf_hi, s.kf_lo, RW_C, m, t, k0 * expf(last - (loc[i] + off)), k1 * expf(last - (loc[i + 1] + off)));
    }
    transpose_v<MV, K::VT, RW_C, T>(s.vt, s.vt_lo, st.v, tid % MV, tid / MV);
    __syncthreads();
    if (j + 2 < n_sub) stage(j + 2);  // buffer j % 2 is read: sub-chunk j + 2 into it
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= s.wl[row0 + ln.g + 8 * (e / 2)];
    }
#pragma unroll
    for (int ks = 0; ks < C / K::KS; ++ks) {
      uint32_t ah[4], al[4];
      load_a(ah, s.kf_hi, RW_C, row0, ks, ln);
      load_a(al, s.kf_lo, RW_C, row0, ks, ln);
#pragma unroll
      for (int nt = 0; nt < K::NT; ++nt) mma_v<K::TF>(acc[nt], ah, al, s.vt, s.vt_lo, RW_C, col0 + 8 * nt, ks, ln);
    }
  }

  if (tid < MK && n0 == 0) a.wspan[((long long)bh * a.NS + sp) * MK + tid] = decay;  // one value block writes it
  float* ds = a.dstate + ((long long)bhv * a.NS + sp) * MK * MV;
#pragma unroll
  for (int nt = 0; nt < K::NT; ++nt) {
    const int row = row0 + ln.g, col = col0 + 8 * nt + 2 * ln.t;
    *reinterpret_cast<float2*>(ds + row * MV + col) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(ds + (row + 8) * MV + col) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ------------------------------------------------------- B: state scan
// one thread per 4 state elements of a (b h, value block): element e of
// the block's MK x MV is row e / (MV / 4) of the (M x M) state, columns
// n0 + 4 (e % (MV / 4)) ..
template <int MK, int MV>
__global__ void __launch_bounds__(kScanThreads) rwkv_span_scan(const Args a) {
  constexpr int kVec = MK * MV / 4;  // float4s of one block
  const long long idx = (long long)blockIdx.x * kScanThreads + threadIdx.x;
  const long long bhv = idx / kVec, bh = bhv / (MK / MV);
  const int e = (int)(idx % kVec), m = e / (MV / 4);
  const long long at = (bh * MK + m) * MK + (bhv % (MK / MV)) * MV + 4 * (e % (MV / 4));
  float4* ds = reinterpret_cast<float4*>(a.dstate) + bhv * a.NS * kVec + e;
  const float* ws = a.wspan + bh * a.NS * MK + m;
  float4 s = a.s_in != nullptr ? *reinterpret_cast<const float4*>(a.s_in + at) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 d[kPrefetch] = {}, dn[kPrefetch] = {};
  float w[kPrefetch] = {}, wn[kPrefetch] = {};
  auto fetch = [&](int i0, float4(&dd)[kPrefetch], float(&ww)[kPrefetch]) {
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      if (i0 + q < a.NS) {
        dd[q] = ds[(long long)(i0 + q) * kVec];
        ww[q] = ws[(long long)(i0 + q) * MK];
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
  *reinterpret_cast<float4*>(a.s_out + at) = s;
}

// ------------------------------------------------------ C: span outputs
// NST stage buffers; SHARE: rq2 lives in rq's buffer (written before the
// scores, overwritten by rq after them)
template <int MK, int MV, typename T, int NST, bool SHARE>
struct OutSmem {
  static constexpr int RW_M = Cfg<MK, MV, T>::RW_M, RW_C = Cfg<MK, MV, T>::RW_C;
  Stage<MK, MV, T> st[NST];                                 // sub-chunks in flight
  uint32_t rq_hi[C * RW_M], rq_lo[C * RW_M];                // r_t e^{cum_{t-1}}        [t][m]
  uint32_t rq2_hi[SHARE ? 1 : C * RW_M], rq2_lo[SHARE ? 1 : C * RW_M];  // r_t e^{cum_{t-1} - mid} [t][m]
  uint32_t kd2_hi[C * RW_M], kd2_lo[C * RW_M];              // k_s e^{mid - cum_s}      [s][m]
  uint32_t kf_hi[MK * RW_C], kf_lo[MK * RW_C];              // k_s e^{last - cum_s}     [m][s]
  uint32_t vt[MV * RW_C];                                   // v                        [n][s]
  uint32_t p_hi[C * RW_C], p_lo[C * RW_C];                  // scores, bonus on the diagonal [t][s]
  uint32_t st_hi[MV * RW_M], st_lo[MV * RW_M];              // the state entering the sub-chunk [n][m]
  float part[Cfg<MK, MV, T>::QS][MK], first[Cfg<MK, MV, T>::QS][MK];  // piece totals; each piece's first log decay
  float wl[MK], bonus[C], u[MK];
  uint32_t vt_lo[Cfg<MK, MV, T>::TF ? MV * RW_C : 1];  // an fp32 v's lo parts; last: bf16 leaves the others where they were
};

// two stage buffers where they keep two CTAs an SM, else one (where only
// one CTA fits, two lost to one in an A/B on the card, PERF.md), and rq2
// in its own buffer where one CTA fits; the CTAs an SM that leaves (the
// register cap follows)
template <int MK, int MV, typename T>
struct OutStages {
  static constexpr int kHalf = 113 * 1024, kAll = 227 * 1024;
  static constexpr int value = sizeof(OutSmem<MK, MV, T, 2, false>) <= kHalf ? 2 : 1;
  static constexpr bool share = sizeof(OutSmem<MK, MV, T, value, false>) > kAll;
  using Smem = OutSmem<MK, MV, T, value, share>;
  static constexpr int ctas = sizeof(Smem) <= kHalf ? 2 : 1;
  static_assert(sizeof(Smem) <= kAll, "shared memory");
};

// The state is held in the accumulators as warp = (16 rows m, MV / CG
// columns n): rows row0 + g (+8), columns col0 + 8 nt + 2 t (+1).  Into
// st_hi / st_lo, transposed: [n][m].
template <int MK, int MV, typename T, typename Smem>
__device__ __forceinline__ void store_state(Smem& s, const float (&acc)[Cfg<MK, MV, T>::NT][4], int row0, int col0,
                                            Lane ln) {
#pragma unroll
  for (int nt = 0; nt < Cfg<MK, MV, T>::NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + ln.g + 8 * (e / 2), col = col0 + 8 * nt + 2 * ln.t + e % 2;
      put<Cfg<MK, MV, T>::TF>(s.st_hi, s.st_lo, Cfg<MK, MV, T>::RW_M, col, row, acc[nt][e]);
    }
  }
}

// ALONE: the one-launch path (no scratch: the given state in, the final
// state out), an instantiation of its own so that the three-launch path
// carries none of its code
template <int MK, int MV, typename T, bool ALONE>
__global__ void __launch_bounds__(kThreads, OutStages<MK, MV, T>::ctas) rwkv_span_out(const Args a) {
  using K = Cfg<MK, MV, T>;
  constexpr int NST = OutStages<MK, MV, T>::value, RW_M = K::RW_M, RW_C = K::RW_C;
  constexpr bool SHARE = OutStages<MK, MV, T>::share;
  using Smem = typename OutStages<MK, MV, T>::Smem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto& s = *reinterpret_cast<Smem*>(smem_raw);
  const int sp = blockIdx.x, bhv = blockIdx.y, bh = bhv / K::VS, b = bh / a.H, h = bh % a.H;
  const int n0 = (bhv % K::VS) * MV;
  const int tid = threadIdx.x, warp = tid / 32, m = tid % MK, q = tid / MK;
  const Lane ln{(tid % 32) / 4, tid % 4};
  const int span0 = sp * kSpan;
  const int n_sub = min(kSub, (a.L - span0 + C - 1) / C);
  float* ob = a.o + b * a.so.b + h * a.so.h + n0;

  auto stage = [&](int j) {  // sub-chunk j into buffer j % NST
    Stage<MK, MV, T>& st = s.st[j % NST];
    stage_sub_chunk<MK, MV, T>(st.r, st.k, st.v, st.w, a, b, h, n0, span0 + j * C, tid);
    cp_async_commit();
  };
  stage(0);
  if (NST > 1 && n_sub > 1) stage(1);
  if (tid < MK) s.u[tid] = a.u[h * MK + tid];

  // the state entering the span: from phase B, or the given one (zero if none)
  const int s_row0 = 16 * (warp % K::RT), s_col0 = (MV / K::CG) * (warp / K::RT);
  float sacc[K::NT][4] = {};
  {
    const float* sin = ALONE ? a.s_in : a.dstate + ((long long)bhv * a.NS + sp) * MK * MV;
    const int ld = ALONE ? MK : MV;
    if (ALONE && sin != nullptr) sin += (long long)bh * MK * MK + n0;
    if (!ALONE || sin != nullptr) {
#pragma unroll
      for (int nt = 0; nt < K::NT; ++nt) {
        const int row = s_row0 + ln.g, col = s_col0 + 8 * nt + 2 * ln.t;
        const float2 x = *reinterpret_cast<const float2*>(sin + row * ld + col);
        const float2 y = *reinterpret_cast<const float2*>(sin + (row + 8) * ld + col);
        sacc[nt][0] = x.x;
        sacc[nt][1] = x.y;
        sacc[nt][2] = y.x;
        sacc[nt][3] = y.y;
      }
    }
    store_state<MK, MV, T>(s, sacc, s_row0, s_col0, ln);
  }
  uint32_t* rq2_hi = SHARE ? s.rq_hi : s.rq2_hi;
  uint32_t* rq2_lo = SHARE ? s.rq_lo : s.rq2_lo;

  for (int j = 0; j < n_sub; ++j) {
    if (NST > 1 && j + 1 < n_sub) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // stage j landed; the state written; last sub-chunk's readers done
    const Stage<MK, MV, T>& st = s.st[j % NST];
    const int t0 = span0 + j * C, valid = min(C, a.L - t0);

    // 1. the scan and the factor rows
    float lw[K::QT], loc[K::QT], rqv[SHARE ? K::QT : 1];
    s.part[q][m] = scan_piece<MK, K::QT>(st.w, m, q, valid, lw, loc);
    s.first[q][m] = lw[0];
    {  // bonus r_t . u . k_t: 8 threads a token, MK / 8 channels each
       // (rotated by the token: no bank conflicts), then summed across the eight
      constexpr int CPT = MK / 8;
      const int t = tid / 8, c8 = tid % 8;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int mm = CPT * c8 + (i + 2 * t) % CPT;
        acc += to_f32(st.r[t * MK + mm]) * s.u[mm] * to_f32(st.k[t * MK + mm]);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      if (c8 == 0) s.bonus[t] = acc;
    }
    __syncthreads();
    {
      const float off = prefix<K::QS, MK>(s.part, m, q);
      const float mid = prefix<K::QS, MK>(s.part, m, K::QS / 2) + s.first[K::QS / 2][m];  // cum at token 16
      const float last = prefix<K::QS, MK>(s.part, m, K::QS);
      if (q == 0) s.wl[m] = expf(last);
      // two exponentials a token: e^{-mid} and e^{last - mid} are the
      // channel's (|exponent| <= 16 steps of log-decay, as the pair factors')
      const float e_nmid = expf(-mid), e_tail = expf(last - mid);
      float kf_prev = 0.f;
#pragma unroll
      for (int i = 0; i < K::QT; ++i) {
        const int t = q * K::QT + i;
        const float cum = loc[i] + off, prev = cum - lw[i];
        const float r = to_f32(st.r[t * MK + m]), k = to_f32(st.k[t * MK + m]);
        const float rq = r * expf(prev), kd2 = k * expf(mid - cum);
        if constexpr (SHARE) rqv[i] = rq;  // into rq's buffer once the scores have read rq2
        else put<K::TF>(s.rq_hi, s.rq_lo, RW_M, t, m, rq);
        put<K::TF>(rq2_hi, rq2_lo, RW_M, t, m, rq * e_nmid);
        put<K::TF>(s.kd2_hi, s.kd2_lo, RW_M, t, m, kd2);
        const float kf = kd2 * e_tail;
        if (i % 2) put2<K::TF>(s.kf_hi, s.kf_lo, RW_C, m, t - 1, kf_prev, kf);
        kf_prev = kf;
      }
      transpose_v<MV, K::VT, RW_C, T>(s.vt, s.vt_lo, st.v, tid % MV, tid / MV);
    }
    __syncthreads();
    if (j + NST < n_sub) stage(j + NST);  // buffer j % NST is read: sub-chunk j + NST into it

    // 2. scores, one 16 x 8 tile a warp: rows 16..31 with s 0..31 in warps
    //    0..3, rows 0..15 with s 0..15 in warps 4, 5 (s > t is zero); s < t
    //    kept, the bonus at s = t
    if (warp < 6) {
      const int rt = warp < 4 ? 1 : 0, s0 = 8 * (warp % 4);
      float acc[4] = {};
#pragma unroll
      for (int ks = 0; ks < MK / K::KS; ++ks) {
        uint32_t ah[4], al[4], bh0, bh1, bl0, bl1;
        load_a(ah, rq2_hi, RW_M, 16 * rt, ks, ln);
        load_a(al, rq2_lo, RW_M, 16 * rt, ks, ln);
        load_b(bh0, bh1, s.kd2_hi, RW_M, s0, ks, ln);
        load_b(bl0, bl1, s.kd2_lo, RW_M, s0, ks, ln);
        mma3<K::TF>(acc, ah, al, bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int t = 16 * rt + ln.g + 8 * e2, sc = s0 + 2 * ln.t;
        float x[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) x[c] = sc + c < t ? acc[2 * e2 + c] : (sc + c == t ? s.bonus[t] : 0.f);
        put2<K::TF>(s.p_hi, s.p_lo, RW_C, t, sc, x[0], x[1]);
      }
    }
    __syncthreads();
    if constexpr (SHARE) {  // the scores have read rq2: rq over it
#pragma unroll
      for (int i = 0; i < K::QT; ++i) put<K::TF>(s.rq_hi, s.rq_lo, RW_M, q * K::QT + i, m, rqv[i]);
      __syncthreads();
    }

    // 3. out = rq . S + P . V: warp = (16 rows t, MV / 4 columns n)
    {
      const int rt = warp % 2, nw = (MV / 4) * (warp / 2);
      float o[K::ONT][4] = {};
#pragma unroll
      for (int ks = 0; ks < MK / K::KS; ++ks) {
        uint32_t ah[4], al[4];
        load_a(ah, s.rq_hi, RW_M, 16 * rt, ks, ln);
        load_a(al, s.rq_lo, RW_M, 16 * rt, ks, ln);
#pragma unroll
        for (int nt = 0; nt < K::ONT; ++nt) {
          uint32_t bh0, bh1, bl0, bl1;
          load_b(bh0, bh1, s.st_hi, RW_M, nw + 8 * nt, ks, ln);
          load_b(bl0, bl1, s.st_lo, RW_M, nw + 8 * nt, ks, ln);
          mma3<K::TF>(o[nt], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      for (int ks = 0; ks < (16 / K::KS) * (rt + 1); ++ks) {  // s <= t: rows 0..15 need s 0..15 only
        uint32_t ah[4], al[4];
        load_a(ah, s.p_hi, RW_C, 16 * rt, ks, ln);
        load_a(al, s.p_lo, RW_C, 16 * rt, ks, ln);
#pragma unroll
        for (int nt = 0; nt < K::ONT; ++nt) mma_v<K::TF>(o[nt], ah, al, s.vt, s.vt_lo, RW_C, nw + 8 * nt, ks, ln);
      }
#pragma unroll
      for (int nt = 0; nt < K::ONT; ++nt) {
        const int col = nw + 8 * nt + 2 * ln.t;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int t = 16 * rt + ln.g + 8 * e2;
          if (t < valid)
            *reinterpret_cast<float2*>(ob + (long long)(t0 + t) * a.so.l + col) =
                make_float2(o[nt][2 * e2], o[nt][2 * e2 + 1]);
        }
      }
    }

    // 4. the state entering the next sub-chunk (or, alone, the final
    //    state): S = e^{last} S + kf^T V
    if (j + 1 < n_sub || ALONE) {
#pragma unroll
      for (int nt = 0; nt < K::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nt][e] *= s.wl[s_row0 + ln.g + 8 * (e / 2)];
      }
#pragma unroll
      for (int ks = 0; ks < C / K::KS; ++ks) {
        uint32_t ah[4], al[4];
        load_a(ah, s.kf_hi, RW_C, s_row0, ks, ln);
        load_a(al, s.kf_lo, RW_C, s_row0, ks, ln);
#pragma unroll
        for (int nt = 0; nt < K::NT; ++nt)
          mma_v<K::TF>(sacc[nt], ah, al, s.vt, s.vt_lo, RW_C, s_col0 + 8 * nt, ks, ln);
      }
      if (j + 1 < n_sub) {
        __syncthreads();  // every warp has read st_hi / st_lo
        store_state<MK, MV, T>(s, sacc, s_row0, s_col0, ln);
      }
    }
  }
  if constexpr (ALONE) {
    float* so = a.s_out + (long long)bh * MK * MK + n0;
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt) {
      const int row = s_row0 + ln.g, col = s_col0 + 8 * nt + 2 * ln.t;
      *reinterpret_cast<float2*>(so + row * MK + col) = make_float2(sacc[nt][0], sacc[nt][1]);
      *reinterpret_cast<float2*>(so + (row + 8) * MK + col) = make_float2(sacc[nt][2], sacc[nt][3]);
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

template <int MK, int MV, typename T>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const long long bhv = (long long)batch * a.H * (MK / MV);
  if (bhv > 65535 || bhv * (MK * MV / 4) / kScanThreads > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 spans((unsigned)a.NS, (unsigned)bhv);
  const size_t out_smem = sizeof(typename OutStages<MK, MV, T>::Smem);
  if (a.dstate == nullptr && a.NS > 0)  // one span: C alone
    return launch_one(rwkv_span_out<MK, MV, T, true>, spans, kThreads, out_smem, stream, a);
  cudaError_t err = cudaSuccess;
  if (a.NS > 0) err = launch_one(rwkv_span_delta<MK, MV, T>, spans, kThreads, sizeof(DeltaSmem<MK, MV, T>), stream, a);
  if (err == cudaSuccess)
    err = launch_one(rwkv_span_scan<MK, MV>, dim3((unsigned)(bhv * (MK * MV / 4) / kScanThreads)), kScanThreads, 0,
                     stream, a);
  if (err == cudaSuccess && a.NS > 0)
    err = launch_one(rwkv_span_out<MK, MV, T, false>, spans, kThreads, out_smem, stream, a);
  return err;
}

template <typename T>
cudaError_t launch_m(const Args& a, int m, int batch, cudaStream_t stream) {
  switch (m) {
    case 32: return launch<32, 32, T>(a, batch, stream);
    case 64: return launch<64, 64, T>(a, batch, stream);
    case 128: return launch<128, sizeof(T) == 4 ? 32 : 64, T>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32 r, k, v (route tc_fp32), 1 = bf16 (route tc); m 32, 64
// or 128.  w, u, the states, out and the scratch are fp32.  Strides are in
// elements, M is contiguous, and every (b, l, h) row of r, k, v, w starts
// on a 16-byte boundary; u (H, M), the states (B, H, M, M) and the scratch
// are contiguous and 16-byte aligned.  The scratch holds B H NS (M M + M)
// floats, NS = ceil(L / 128): dS, then W.
// A null scratch runs L <= 128 in one launch (phase C alone) and is refused
// for a longer L.  s_in may be null (zero initial state).  Returns a
// cudaError_t.
extern "C" int rwkv6_sm90_fwd(int dtype, int m, const void* r, const void* k, const void* v, const float* w,
                              const float* u, const float* s_in, float* o, float* s_out, float* scratch, int batch,
                              int seq, int heads, long long r_sb, long long r_sl, long long r_sh, long long k_sb,
                              long long k_sl, long long k_sh, long long v_sb, long long v_sl, long long v_sh,
                              long long w_sb, long long w_sl, long long w_sh, long long o_sb, long long o_sl,
                              long long o_sh, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch <= 0 || seq < 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  if (scratch == nullptr && seq > kSpan) return (int)cudaErrorInvalidValue;
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
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
  a.wspan = scratch == nullptr ? nullptr : scratch + (long long)batch * heads * a.NS * m * m;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_m<float>(a, m, batch, s);
  return (int)launch_m<__nv_bfloat16>(a, m, batch, s);
}
