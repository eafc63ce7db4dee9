// RWKV-6 chunked time-mix for Hopper (sm_90a), fp32 FMA: the kernel of
// route "fma" (fp32 r, k, v, and bf16 at M 32 or 128); bf16 at M 64, every
// full-width rwkv6-3b launch, goes to rwkv_sm90.cu (route "tc").
//
// Replaces: src/repro/kernels/rwkv/rwkv.py::rwkv6_chunked (Pallas body
// _rwkv_kernel), the TPU kernel of the full-sequence RWKV-6 recurrence
//
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t,   o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),
//
// in chunks of C = 32 tokens with an fp32 (M, M) state per (b, h) carried
// from chunk to chunk.  It computes the function of the model's
// _wkv_chunked (src/repro/models/rwkv.py): r, k, v (B, L, H, M) in fp32 or
// bf16, w (B, L, H, M) and u (H, M) in fp32, an optional initial state
// (B, H, M, M) fp32 (zero when absent); it writes out (B, L, H, M) in fp32
// (the model's layernorm reads the fp32 output, not r's dtype) and the final
// state (B, H, M, M) in fp32.  w must arrive in fp32: decays near 1 - 2^-9
// are the slow channels, and bf16 would round them to 1 or 1 - 2^-8.
// r, k, v, w and out are read and written through their (b, l, h) strides
// with M contiguous, so the model's (B, L, H·M) projections go in as views.
//
// Within a chunk, with cum_t = sum_{tau <= t} log w_tau (per channel):
//   state-in term   r_t e^{cum_t - log w_t} S
//   pairs s < t     (r_t e^{cum_{t-1} - cum_mid}) . (k_s e^{cum_mid - cum_s}) v_s
//   bonus           (r_t . u . k_t) v_t
//   state update    S' = e^{cum_last} S + sum_s (k_s e^{cum_last - cum_s})^T v_s
// The mid-chunk reference keeps every factor's exponent within ±16 steps of
// log-decay (>= -e each after the model's clamp), inside fp32's range; only
// the pairs s < t are formed, so no product of two large factors is built.
//
// What bounds it on an H100: per (b, h, chunk) the function needs
// 2CM^2 (state-in) + 2CM^2 (state update) flops, and over the causal pairs
// only 2M C(C-1)/2 (scores, s < t) + 2M C(C+1)/2 (scores . V, s <= t), so
// 4CM^2 + 2C^2M on 4CM input values and CM outputs; at M = 64 that is
// 655,360 flops on ~28 KB, so in fp32 (the state must stay fp32) it is
// bound by arithmetic: the least time is the flops over the fp32 peak,
// 0.10 ms at the 4 x 2048-token, 40-head prefill.
//
// What this design does about it: fp32 FMA chains on the CUDA cores (no
// wgmma, no TMA), in two kernels, because only the state product is
// sequential.  Everything in the list above but the state terms depends on
// one chunk alone:
//   rwkv6_intra, one block per (chunk, b, h), all in parallel: the chunk's
//     log-decay scan (M channels x 128/M token segments, the segment sums
//     joined through shared memory), the factor rows, the C x C scores with
//     the bonus on the diagonal, and out = scores . V written to out; the
//     two factors the state needs, r e^{cum_{t-1}} and k e^{cum_last - cum},
//     and e^{cum_last} go to a scratch buffer (fp32, 2CM + M per chunk).
//   rwkv6_state, one block per (b, h, tile of 16 value columns): the value
//     columns of the state are independent (out_t[n] = sum_m r_t[m] S[m, n];
//     the decay scales rows m), so M/16 blocks per head carry their M x 16
//     slice through the chunks in order: out += rq . S, then
//     S = e^{cum_last} S + kf^T V.  The next chunk's factors are loaded into
//     registers while the current one is computed.
// Tokens past L act as w = 1, k = v = 0 (masked, not padded); their rows
// are never stored, and the final state is the state after token L.  Every
// sum is one fixed-order chain and there are no atomics: two launches give
// bitwise-equal results.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kC = 32;       // tokens per chunk
constexpr int kMid = kC / 2; // the chunk's reference token
constexpr int kNT = 16;      // value columns per state block
constexpr int kLDP = kC + 1; // padded score row
static_assert(kThreads == 4 * kC, "the score phase maps 4 threads to each row t");
static_assert(kThreads % kNT == 0, "the state phases tile value columns over the block");

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
  float* rq;  // scratch (B H, NC, C, M): r_t e^{cum_{t-1}}
  float* kf;  // scratch (B H, NC, C, M): k_s e^{cum_last - cum_s}
  float* wt;  // scratch (B H, NC, M):    e^{cum_last}
  Strides sr, sk, sv, sw, so;
  int L, H, NC;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int M>
constexpr size_t intra_smem_floats() {
  return (size_t)3 * kC * (M + 1) + kC * M + kC * kLDP + (kThreads / M) * M + 2 * M;
}

template <int M>
constexpr int kStateLD = M + 4;  // padded factor row, 16-byte aligned for float4 stores

template <int M>
constexpr size_t state_smem_floats() {
  return (size_t)2 * kC * kStateLD<M> + kC * kNT + M * kNT + M;
}

// ---------------------------------------------------------------- intra-chunk
template <typename T, int M>
__global__ void __launch_bounds__(kThreads) rwkv6_intra(const Args a) {
  constexpr int LD = M + 1;           // padded factor row: conflict-free across rows
  constexpr int TPC = kThreads / M;   // threads per channel: 4, 2, 1
  constexpr int TL = kC / TPC;        // tokens per thread: 8, 16, 32
  extern __shared__ __align__(16) float smem[];
  float* rq2 = smem;             // kC x LD  r_t e^{cum_{t-1} - cum_mid}
  float* kd2 = rq2 + kC * LD;    // kC x LD  k_s e^{cum_mid - cum_s}
  float* ruk = kd2 + kC * LD;    // kC x LD  r_t u k_t
  float* vs = ruk + kC * LD;     // kC x M   v tile
  float* p = vs + kC * M;        // kC x kLDP scores, the bonus on the diagonal
  float* part = p + kC * kLDP;   // TPC x M  segment sums of log w
  float* ref = part + TPC * M;   // 2 x M    cum at the mid and at the last token

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int t0 = c * kC, valid = min(kC, a.L - t0);
  const int tid = threadIdx.x, m = tid % M, seg = tid / M, tb = seg * TL;
  const T* rb = static_cast<const T*>(a.r) + b * a.sr.b + h * a.sr.h + (long long)t0 * a.sr.l;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h + (long long)t0 * a.sk.l;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h + (long long)t0 * a.sv.l;
  const float* wb = a.w + b * a.sw.b + h * a.sw.h + (long long)t0 * a.sw.l;
  float* ob = a.o + b * a.so.b + h * a.so.h + (long long)t0 * a.so.l;
  const long long chunk = (long long)bh * a.NC + c;

  // 1. log decays over this thread's TL tokens of channel m, then the v tile
  float lw[TL], cum[TL];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < TL; ++i) {
    const int t = tb + i;
    const float w = t < valid ? wb[(long long)t * a.sw.l + m] : 1.f;
    lw[i] = logf(fmaxf(w, 1e-20f));
    run += lw[i];
    cum[i] = run;
  }
  part[seg * M + m] = run;
  for (int i = tid; i < kC * M; i += kThreads) {
    const int t = i / M, n = i % M;
    vs[i] = t < valid ? to_f32(vb[(long long)t * a.sv.l + n]) : 0.f;
  }
  __syncthreads();
  float off = 0.f;
  for (int s = 0; s < seg; ++s) off += part[s * M + m];
#pragma unroll
  for (int i = 0; i < TL; ++i) cum[i] += off;
#pragma unroll
  for (int i = 0; i < TL; ++i)
    if (tb + i == kMid) ref[m] = cum[i];  // unrolled: cum stays in registers
  if (tb + TL == kC) ref[M + m] = cum[TL - 1];
  __syncthreads();

  // 2. factor rows: the pair factors and the bonus to shared memory, the
  //    state factors to the scratch buffer
  const float mid = ref[m], last = ref[M + m];
  const float u_m = a.u[h * M + m];
  float* rqg = a.rq + chunk * kC * M;
  float* kfg = a.kf + chunk * kC * M;
#pragma unroll
  for (int i = 0; i < TL; ++i) {
    const int t = tb + i;
    float r = 0.f, k = 0.f;
    if (t < valid) {
      r = to_f32(rb[(long long)t * a.sr.l + m]);
      k = to_f32(kb[(long long)t * a.sk.l + m]);
    }
    const float prev = cum[i] - lw[i];  // cum_{t-1}
    rqg[t * M + m] = r * expf(prev);
    rq2[t * LD + m] = r * expf(prev - mid);
    kd2[t * LD + m] = k * expf(mid - cum[i]);
    kfg[t * M + m] = k * expf(last - cum[i]);
    ruk[t * LD + m] = r * u_m * k;
  }
  if (seg == 0) a.wt[chunk * M + m] = expf(last);
  __syncthreads();

  // 3. scores: thread (t, s = lane4 + 4j); s < t the decayed pair, s = t the bonus
  {
    const int t = tid >> 2, q = tid & 3;
    float acc[kC / 4];
#pragma unroll
    for (int j = 0; j < kC / 4; ++j) acc[j] = 0.f;
    for (int mm = 0; mm < M; ++mm) {
      const float x = rq2[t * LD + mm];
#pragma unroll
      for (int j = 0; j < kC / 4; ++j) acc[j] = fmaf(x, kd2[(q + 4 * j) * LD + mm], acc[j]);
    }
    float diag = 0.f;
    if ((t & 3) == q)
      for (int mm = 0; mm < M; ++mm) diag += ruk[t * LD + mm];
#pragma unroll
    for (int j = 0; j < kC / 4; ++j) {
      const int s = q + 4 * j;
      p[t * kLDP + s] = s < t ? acc[j] : (s == t ? diag : 0.f);
    }
  }
  __syncthreads();

  // 4. the chunk's own share of out: sum_{s <= t} p[t, s] v_s
  for (int i = tid; i < kC * M; i += kThreads) {
    const int t = i / M, n = i % M;
    if (t >= valid) break;  // i grows with t: every later row is masked too
    float acc = 0.f;
    for (int s = 0; s <= t; ++s) acc = fmaf(p[t * kLDP + s], vs[s * M + n], acc);
    ob[(long long)t * a.so.l + n] = acc;
  }
}

// ---------------------------------------------------------------- state scan
template <typename T, int M>
__global__ void __launch_bounds__(kThreads) rwkv6_state(const Args a) {
  constexpr int LD = kStateLD<M>;
  constexpr int V4 = kC * M / 4 / kThreads;  // float4s of each factor a thread stages per chunk
  static_assert(kC * M % (4 * kThreads) == 0, "the factor tiles split evenly over the block");
  extern __shared__ __align__(16) float smem[];
  float* rq = smem;            // kC x LD  r_t e^{cum_{t-1}}
  float* kf = rq + kC * LD;    // kC x LD  k_s e^{cum_last - cum_s}
  float* vs = kf + kC * LD;    // kC x kNT v tile
  float* st = vs + kC * kNT;   // M x kNT  state slice
  float* wt = st + M * kNT;    // M        e^{cum_last}

  const int tid = threadIdx.x;
  constexpr int n_tiles = M / kNT;
  const int bh = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * kNT;
  const int b = bh / a.H, h = bh % a.H;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h + n0;
  float* ob = a.o + b * a.so.b + h * a.so.h + n0;
  const long long s_base = (long long)bh * M * M + n0;  // state (bh, m, n0 + n) at s_base + m M + n

  for (int i = tid; i < M * kNT; i += kThreads) {
    const int m = i / kNT, n = i % kNT;
    st[i] = a.s_in != nullptr ? a.s_in[s_base + (long long)m * M + n] : 0.f;
  }

  // register stage of one chunk's inputs, loaded ahead of its use
  float4 rq_r[V4], kf_r[V4];
  float v_r[kC * kNT / kThreads];
  float wt_r = 0.f;
  auto fetch = [&](int c) {
    const long long chunk = (long long)bh * a.NC + c;
    const float4* rqg = reinterpret_cast<const float4*>(a.rq + chunk * kC * M);
    const float4* kfg = reinterpret_cast<const float4*>(a.kf + chunk * kC * M);
#pragma unroll
    for (int j = 0; j < V4; ++j) {
      rq_r[j] = rqg[tid + j * kThreads];
      kf_r[j] = kfg[tid + j * kThreads];
    }
    const int t0 = c * kC, valid = min(kC, a.L - t0);
#pragma unroll
    for (int j = 0; j < kC * kNT / kThreads; ++j) {
      const int i = tid + j * kThreads, t = i / kNT, n = i % kNT;
      v_r[j] = t < valid ? to_f32(vb[(long long)(t0 + t) * a.sv.l + n]) : 0.f;
    }
    if (tid < M) wt_r = a.wt[chunk * M + tid];
  };

  if (a.NC > 0) fetch(0);
  for (int c = 0; c < a.NC; ++c) {
    const int t0 = c * kC, valid = min(kC, a.L - t0);
#pragma unroll
    for (int j = 0; j < V4; ++j) {
      const int i = 4 * (tid + j * kThreads), t = i / M, m = i % M;
      *reinterpret_cast<float4*>(rq + t * LD + m) = rq_r[j];
      *reinterpret_cast<float4*>(kf + t * LD + m) = kf_r[j];
    }
#pragma unroll
    for (int j = 0; j < kC * kNT / kThreads; ++j) vs[tid + j * kThreads] = v_r[j];
    if (tid < M) wt[tid] = wt_r;
    __syncthreads();
    if (c + 1 < a.NC) fetch(c + 1);

    // out += r_t W_{t-1} S, on the rows the intra-chunk kernel wrote
    {
      const int n = tid % kNT;
      for (int t = tid / kNT; t < valid; t += kThreads / kNT) {
        float acc = 0.f;
        for (int m = 0; m < M; ++m) acc = fmaf(rq[t * LD + m], st[m * kNT + n], acc);
        float* o = ob + (long long)(t0 + t) * a.so.l + n;
        *o += acc;
      }
    }
    __syncthreads();

    // S' = e^{cum_last} S + sum_s kf_s^T v_s
    {
      const int n = tid % kNT;
      for (int m = tid / kNT; m < M; m += kThreads / kNT) {
        float kv = 0.f;
        for (int s = 0; s < kC; ++s) kv = fmaf(kf[s * LD + m], vs[s * kNT + n], kv);
        st[m * kNT + n] = st[m * kNT + n] * wt[m] + kv;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < M * kNT; i += kThreads) {
    const int m = i / kNT, n = i % kNT;
    a.s_out[s_base + (long long)m * M + n] = st[i];
  }
}

template <typename T, int M>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr size_t smem_a = intra_smem_floats<M>() * sizeof(float);
  constexpr size_t smem_b = state_smem_floats<M>() * sizeof(float);
  const long long bh = (long long)batch * a.H;
  const long long blocks_b = bh * (M / kNT);
  if (bh > 65535 || blocks_b > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (a.NC > 0) {
    auto intra = rwkv6_intra<T, M>;
    cudaError_t err = cudaFuncSetAttribute(intra, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
    if (err != cudaSuccess) return err;
    intra<<<dim3((unsigned)a.NC, (unsigned)bh), kThreads, smem_a, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto state = rwkv6_state<T, M>;
  cudaError_t err = cudaFuncSetAttribute(state, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;
  state<<<(unsigned)blocks_b, kThreads, smem_b, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_m(int m, const Args& a, int batch, cudaStream_t stream) {
  switch (m) {
    case 32: return launch<T, 32>(a, batch, stream);
    case 64: return launch<T, 64>(a, batch, stream);
    case 128: return launch<T, 128>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (r, k and v alike); w, u, the states, out and the
// scratch are fp32.  Strides are in elements, M is contiguous; u (H, M),
// the states (B, H, M, M) and the scratch are contiguous, the scratch
// 16-byte aligned, of 2 N + N / 32 floats, N = B H ceil(L / 32) 32 M: rq,
// kf, then wt.  s_in may be null (zero initial state).  Returns a
// cudaError_t.
extern "C" int rwkv6_fwd(int dtype, int m, const void* r, const void* k, const void* v, const float* w,
                         const float* u, const float* s_in, float* o, float* s_out, float* scratch,
                         int batch, int seq, int heads,
                         long long r_sb, long long r_sl, long long r_sh,
                         long long k_sb, long long k_sl, long long k_sh,
                         long long v_sb, long long v_sl, long long v_sh,
                         long long w_sb, long long w_sl, long long w_sh,
                         long long o_sb, long long o_sl, long long o_sh, void* stream) {
  if (batch <= 0 || seq < 0 || heads <= 0) return cudaErrorInvalidValue;
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
  a.NC = (seq + kC - 1) / kC;
  const long long n_fac = (long long)batch * heads * a.NC * kC * m;
  a.rq = scratch;
  a.kf = scratch + n_fac;
  a.wt = scratch + 2 * n_fac;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_m<float>(m, a, batch, s);
  if (dtype == 1) return (int)dispatch_m<__nv_bfloat16>(m, a, batch, s);
  return (int)cudaErrorInvalidValue;
}
