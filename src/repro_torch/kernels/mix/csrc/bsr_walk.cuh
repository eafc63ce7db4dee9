// The block-sparse walk shared by mix_bsr.cu and quant_mix.cu: output rows
//
//     y[r, :] = sum_k M[r, k] * src(k)[:]
//
// over the nonzeros of M only, M in the BSR form of sparse.py (block_cols,
// tiles, counts).  Output rows are r < n_rows; source rows k < n (a row
// block of a larger operator, n_rows < n, reads a [local | halo] buffer of n
// rows: the node-sharded round of core/shardplan.py).  src(k) is row k of W (mix_bsr, and the quantised round's
// second pass over H') or the row every peer decodes from X (the quantised
// raw mode); the caller supplies it, and the epilogue that stores a
// finished output row.
//
// Work.  A block owns kRows output rows of one row block and a range of
// kStripsPerBlock consecutive column strips of kThreads * VEC columns.  The
// row groups are the fastest launch index, so the blocks walking the same
// strips run at the same time: a source row that deg + 1 output rows
// reference is read from device memory about once, then from L2.
//
// Lists.  Before its first strip a block compacts each row's nonzeros into
// shared memory, one warp a row: the row's slice of the row block's real
// tiles in tile order t < counts[i], then ascending column inside the tile,
// exact zeros and source rows outside [0, n) dropped (padding tiles past
// counts[i] are never read).  A row with more than kCap entries is walked in
// pieces, compacted again for every strip.
//
// Two ways to walk a strip.  Staged: when two or more strips' worth of the
// block's sources (and the rows its epilogue reads) fit the kernel's dynamic
// shared memory, each thread copies its VEC columns of every source of the
// strips ahead into shared memory with cp.async while it adds the current
// one; a thread reads back only its own copies, so no barrier is needed.
// Otherwise from registers: kRows x kBatch source vectors (16/8/4-byte
// loads, neighbouring threads on neighbouring columns) loaded before their
// FMAs.  Either way a thread keeps kRows x VEC fp32 accumulators.
//
// Numerics.  One FMA per nonzero and column; each output one sequential
// fp32 FMA chain in the fixed list order, no atomics: two launches are
// bitwise equal, and equal to sparse.py::mix_bsr_rows_ref.  Skipping an
// exact zero leaves a finite sum unchanged; the one difference from a
// product over whole tiles is that 0 * inf or 0 * NaN in a source row adds
// nothing rather than NaN.
#pragma once

#include "mix_common.cuh"

namespace bsrw {

constexpr int kThreads = 256;
constexpr int kRows = 4;    // output rows a block owns; one compacting warp each
constexpr int kCap = 128;   // entries of a row held at once
constexpr int kMaxBatch = 8;  // list positions a thread loads before it adds them
constexpr int kStripsPerBlock = 32;  // consecutive column strips a block walks

static_assert(kRows == 4 && kRows <= kThreads / 32, "the walk reads a position's kRows entries as two int4");

struct Lists {
  int2 e[kCap + kMaxBatch][kRows];  // (source row, fp32 weight bits); source -1 past a row's entries
  int len[kRows];       // entries of each row in this piece
  int next[kRows];      // flat position t * bn + c where a row's next piece starts
  int open[kRows];      // the row has entries past this piece
};

struct Piece {
  int lmax;   // the longest row list of the piece
  bool more;  // some row continues in a further piece
};

// Compact the next piece of each row's nonzeros (the first one with
// `restart`).  Row block entries: tile t of the block is tiles[slot0 + t],
// its column block block_cols[slot0 + t].
__device__ __forceinline__ Piece compact(Lists& L, bool restart, const int* __restrict__ block_cols,
                                         const float* __restrict__ tiles, long long slot0, int nt, int bn,
                                         int rr0, int row0, int n, int n_rows) {
  __syncthreads();  // every thread is done with the previous piece
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < kRows) {
    const int r = warp;
    const int total = (rr0 + r < bn && row0 + r < n_rows) ? nt * bn : 0;
    int p = restart ? 0 : L.next[r];
    int cnt = 0;
    while (p < total && cnt < kCap) {
      const int e = p + lane;
      float w = 0.f;
      long long src = -1;
      if (e < total) {
        const int t = e / bn, c = e - t * bn;
        w = tiles[((slot0 + t) * bn + rr0 + r) * bn + c];
        src = (long long)block_cols[slot0 + t] * bn + c;
      }
      const bool kept = w != 0.f && src >= 0 && src < n;
      const unsigned ballot = __ballot_sync(0xffffffffu, kept);
      const int k = cnt + __popc(ballot & ((1u << lane) - 1u));
      if (kept && k < kCap) L.e[k][r] = make_int2((int)src, __float_as_int(w));
      if (__popc(ballot) > kCap - cnt) {  // full: the next piece starts at the first entry left out
        p += __ffs(__ballot_sync(0xffffffffu, kept && k == kCap)) - 1;
        cnt = kCap;
      } else {
        cnt += __popc(ballot);
        p += 32;
      }
    }
    for (int k = cnt + lane; k < kCap + kMaxBatch; k += 32) L.e[k][r] = make_int2(-1, 0);
    if (lane == 0) {
      L.len[r] = cnt;
      L.next[r] = p;
      L.open[r] = p < total;
    }
  }
  __syncthreads();
  Piece pc{0, false};
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    pc.lmax = max(pc.lmax, L.len[r]);
    pc.more = pc.more || L.open[r] != 0;
  }
  return pc;
}

__device__ __forceinline__ void entries(const Lists& L, int e, int (&row)[kRows], float (&w)[kRows]) {
  const int4 ab = reinterpret_cast<const int4*>(L.e[e])[0];
  const int4 cd = reinterpret_cast<const int4*>(L.e[e])[1];
  row[0] = ab.x, row[1] = ab.z, row[2] = cd.x, row[3] = cd.z;
  w[0] = __int_as_float(ab.y), w[1] = __int_as_float(ab.w), w[2] = __int_as_float(cd.y), w[3] = __int_as_float(cd.w);
}

// acc[r] += w * src(k) over list positions [0, lmax) of every row, in
// batches of Src::kBatch positions: all loads of a batch are issued before
// its FMAs (a ring's whole list is one batch).  Padding entries load and add
// nothing.  EDGE: the thread's VEC columns cross d.
template <int VEC, bool EDGE, class Src>
__device__ __forceinline__ void walk(const Lists& L, int lmax, const Src& src, long long c0,
                                     float (&acc)[kRows][VEC]) {
  constexpr int B = Src::kBatch;
  static_assert(B >= 1 && B <= kMaxBatch, "batch");
  for (int e0 = 0; e0 < lmax; e0 += B) {
    typename Src::Raw raw[B][kRows];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      int row[kRows];
      float w[kRows];
      entries(L, e0 + b, row, w);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (row[r] >= 0) src.template fetch<EDGE>(row[r], c0, raw[b][r]);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      int row[kRows];
      float w[kRows];
      entries(L, e0 + b, row, w);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row[r] >= 0) {
          float v[VEC];
          src.decode(raw[b][r], v);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[r][j] = fmaf(w[r], v[j], acc[r][j]);
        }
      }
    }
  }
}

// cp.async of 4, 8 or 16 bytes from global to shared memory, its group
// commit and wait (the copies of one strip are one group).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s), "l"(src), "n"(BYTES) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The staged walk's copies for strip columns c0 ..: this thread's VEC columns
// of every source in the lists, into slot e * kRows + r of stage `buf`, then
// those of the Store's kOwn arrays for the n_own rows the block owns, into
// slot (lmax + a) * kRows + r.
template <class Src, class Store>
__device__ __forceinline__ void stage_strip(const Lists& L, int lmax, const Src& src, const Store& store, int row0,
                                            int n_own, long long c0, typename Src::Pack* buf) {
  if (c0 < src.d) {
#pragma unroll 1
    for (int e = 0; e < lmax; ++e) {
      int row[kRows];
      float w[kRows];
      entries(L, e, row, w);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (row[r] >= 0) src.stage(row[r], c0, buf + (e * kRows + r) * kThreads + threadIdx.x);
    }
#pragma unroll
    for (int a = 0; a < Store::kOwn; ++a)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < n_own) store.stage_own(a, row0 + r, c0, buf + ((lmax + a) * kRows + r) * kThreads + threadIdx.x);
  }
  cp_async_commit();
}

template <int VEC, class Src>
__device__ __forceinline__ void add_staged(const Lists& L, int lmax, const typename Src::Pack* buf,
                                           float (&acc)[kRows][VEC]) {
#pragma unroll 1
  for (int e = 0; e < lmax; ++e) {
    int row[kRows];
    float w[kRows];
    entries(L, e, row, w);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row[r] >= 0) {
        const typename Src::Pack p = buf[(e * kRows + r) * kThreads + threadIdx.x];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[r][j] = fmaf(w[r], mixk::to_f32(p.v[j]), acc[r][j]);
      }
    }
  }
}

// The walk of one block (see the top of this file).  Src: kBatch, kStaged,
// begin_strip(c0), fetch<EDGE>(row, c0, raw), decode(raw, v[VEC]), and for
// the staged walk Pack, d and stage(row, c0, dst).  Store: what its
// epilogue reads of an owned row (Own), got by own_load(row, c0) before the
// walk, or by the staged walk as kOwn arrays copied by stage_own(a, row, c0,
// dst) (see stage_strip) and read back by own_staged(first slot); then
// store(row, c0, acc[VEC], own) writes the finished row.  A staged Src
// walks double-buffered in BYTES of dynamic shared memory when two strips'
// copies of the block's lists and own rows fit there.
template <int VEC, int BYTES, class Src, class Store>
__device__ __forceinline__ void rows_walk(const int* __restrict__ block_cols, const float* __restrict__ tiles,
                                          const int* __restrict__ counts, int n, int n_rows, long long d,
                                          int max_nnz, int bn, int groups_per_rb, int slices, Src& src,
                                          const Store& store) {
  __shared__ __align__(16) Lists L;
  // block -> (row group g, strip range k of `slices`), the row groups fastest:
  // the blocks of all row groups walk the same strips at the same time
  const long long n_groups = gridDim.x / slices;
  const long long g = blockIdx.x % n_groups;
  const long long k_range = blockIdx.x / n_groups;
  const int i = (int)(g / groups_per_rb);
  const int rr0 = (int)(g % groups_per_rb) * kRows;
  const int row0 = i * bn + rr0;
  const long long slot0 = (long long)i * max_nnz;
  const int nt = max(0, min(counts[i], max_nnz));
  const long long strip_cols = (long long)kThreads * VEC;
  const long long n_strips = (d + strip_cols - 1) / strip_cols;
  const long long per = (n_strips + slices - 1) / slices;
  const long long s_begin = k_range * per, s_end = min(n_strips, s_begin + per);
  Piece pc = compact(L, true, block_cols, tiles, slot0, nt, bn, rr0, row0, n, n_rows);
  const bool whole = !pc.more;
  if constexpr (Src::kStaged) {
    using P = typename Src::Pack;
    const int need = (pc.lmax + Store::kOwn) * kRows;  // slots of one strip's stage
    if (whole && 2 * need * kThreads * (int)sizeof(P) <= BYTES) {
      extern __shared__ __align__(16) unsigned char stage_smem[];
      P* stage[2] = {reinterpret_cast<P*>(stage_smem), reinterpret_cast<P*>(stage_smem) + need * kThreads};
      const int n_own = max(0, min(kRows, min(bn - rr0, n_rows - row0)));
      // strip s goes to stage (s - s_begin) & 1, its copies in flight while
      // the thread adds strip s - 1; each thread reads back only its own
      // copies, so no barrier is needed
      stage_strip(L, pc.lmax, src, store, row0, n_own, (s_begin * kThreads + threadIdx.x) * VEC, stage[0]);
      for (long long s = s_begin; s < s_end; ++s) {
        const int k = (int)((s - s_begin) & 1);
        if (s + 1 < s_end) {
          stage_strip(L, pc.lmax, src, store, row0, n_own, ((s + 1) * kThreads + threadIdx.x) * VEC, stage[k ^ 1]);
        } else {
          cp_async_commit();
        }
        cp_async_wait<1>();
        const long long c0 = (s * kThreads + threadIdx.x) * VEC;
        float acc[kRows][VEC];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;
        if (c0 < d) {
          add_staged<VEC, Src>(L, pc.lmax, stage[k], acc);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r < n_own)
              store(row0 + r, c0, acc[r],
                    store.own_staged(stage[k] + (pc.lmax * kRows + r) * kThreads + threadIdx.x));
        }
      }
      cp_async_wait<0>();
      return;
    }
  }
  for (long long s = s_begin; s < s_end; ++s) {
    const long long c0 = (s * kThreads + threadIdx.x) * VEC;
    src.begin_strip(c0);
    typename Store::Own own[kRows];  // the epilogue's loads, in flight during the walk
    if (c0 < d) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (rr0 + r < bn && row0 + r < n_rows) own[r] = store.own_load(row0 + r, c0);
    }
    float acc[kRows][VEC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;
    for (;;) {
      if (c0 + VEC <= d) {
        walk<VEC, false>(L, pc.lmax, src, c0, acc);
      } else if (c0 < d) {
        walk<VEC, true>(L, pc.lmax, src, c0, acc);
      }
      if (whole) break;
      // in pieces: the next one, or after the last the first again for the next strip
      const bool last = !pc.more;
      pc = compact(L, last, block_cols, tiles, slot0, nt, bn, rr0, row0, n, n_rows);
      if (last) break;
    }
    if (c0 < d) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (rr0 + r < bn && row0 + r < n_rows) store(row0 + r, c0, acc[r], own[r]);
    }
  }
}

// Copy p[c0 .. c0 + VEC) of a row (masked at d, zero past it) into dst: by
// cp.async where the copy is whole and 4 bytes or more.
template <typename T, int VEC>
__device__ __forceinline__ void stage_vec(const T* p, long long c0, long long d, mixk::Pack<T, VEC>* dst) {
  if constexpr (sizeof(mixk::Pack<T, VEC>) >= 4) {
    if (c0 + VEC <= d) {
      cp_async<(int)sizeof(mixk::Pack<T, VEC>)>(dst, p);
      return;
    }
  }
  mixk::Pack<T, VEC> v;
#pragma unroll
  for (int j = 0; j < VEC; ++j) v.v[j] = c0 + j < d ? p[j] : mixk::from_f32<T>(0.f);
  *dst = v;
}

// Stores of a finished output row y[row] = acc: nothing of the row is read.
template <typename T, int VEC>
struct StoreRows {
  static constexpr int kOwn = 0;
  struct Own {};
  T* __restrict__ y;
  long long d;

  template <class P>
  __device__ __forceinline__ void stage_own(int, int, long long, P*) const {}
  __device__ __forceinline__ Own own_staged(const void*) const { return {}; }
  __device__ __forceinline__ Own own_load(int, long long) const { return {}; }

  __device__ __forceinline__ void operator()(int row, long long c0, const float (&acc)[VEC], const Own&) const {
    mixk::store_row<T, VEC>(y, row, d, c0, acc);
  }
};

// Source rows of W, widened to fp32.  A batch of the register walk holds at
// most 4 values a row; the staged walk copies 4, 8 or 16 bytes a thread.
template <typename T, int VEC>
struct RowsOf {
  using Pack = mixk::Pack<T, VEC>;
  static constexpr int kBatch = VEC == 4 ? 1 : 2;
  static constexpr bool kStaged = sizeof(Pack) >= 4;
  const T* __restrict__ w;
  long long d;

  struct Raw {
    Pack p;
  };

  __device__ __forceinline__ void begin_strip(long long) {}

  template <bool EDGE>
  __device__ __forceinline__ void fetch(int row, long long c0, Raw& raw) const {
    const T* q = w + row * d + c0;
    if (!EDGE) {
      raw.p = *reinterpret_cast<const Pack*>(q);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) raw.p.v[j] = c0 + j < d ? q[j] : mixk::from_f32<T>(0.f);
    }
  }

  __device__ __forceinline__ void decode(const Raw& raw, float (&v)[VEC]) const {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = mixk::to_f32(raw.p.v[j]);
  }

  __device__ __forceinline__ void stage(int row, long long c0, Pack* dst) const {
    stage_vec<T, VEC>(w + row * d + c0, c0, d, dst);
  }
};

// Strip ranges a row group's columns split into: a launch is n_groups *
// slices_of(d, vec) blocks of kThreads.
inline long long slices_of(long long d, int vec) {
  const long long n_strips = (d + (long long)kThreads * vec - 1) / ((long long)kThreads * vec);
  return (n_strips + kStripsPerBlock - 1) / kStripsPerBlock;
}

}  // namespace bsrw

// Instantiate KERNEL_CALL(T, VEC) for the (dtype, vector width) the host
// picked; evaluates to cudaErrorInvalidValue otherwise.
#define BSRW_DISPATCH(dtype, vec, KERNEL_CALL)                \
  [&]() -> cudaError_t {                                      \
    switch ((dtype) * 10 + (vec)) {                           \
      case 1: KERNEL_CALL(float, 1); break;                   \
      case 2: KERNEL_CALL(float, 2); break;                   \
      case 4: KERNEL_CALL(float, 4); break;                   \
      case 11: KERNEL_CALL(__nv_bfloat16, 1); break;          \
      case 12: KERNEL_CALL(__nv_bfloat16, 2); break;          \
      case 14: KERNEL_CALL(__nv_bfloat16, 4); break;          \
      default: return cudaErrorInvalidValue;                  \
    }                                                         \
    return cudaGetLastError();                                \
  }()
