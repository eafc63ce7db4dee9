// Row-list (HYB) DecAvg mixing  Y = M . W  for Hopper (sm_90a): the sparse
// backend's static-topology round.
//
// Replaces: no pallas_call.  The JAX package renders this round in XLA,
// src/repro/core/decavg.py::mix_pytree_hyb (an ELL slot chain of fused
// full-length gathers, then a dense (H, n) product for the hub rows); the
// port gives it a kernel of its own.  M comes as its HYB layout
// (core/commplan.py::_hyb_layout): every row that is not a hub has n_slots
// ELL slots, slot s of row i reading source row slot_idx[s, i] with weight
// slot_w[s, i] (weight 0: padding), plus its self weight self_w[i]; a hub
// row holds its receive row as a compacted list of nonzeros, hub_ptr /
// hub_col / hub_val, ascending column.  hub_of[i] is the hub index of row i,
// or -1.
//
// Outputs are rows i < n_rows.  The ELL terms read W (n_src rows) and the
// hub lists read W_hub (n_hub_src rows): the unsharded call passes W twice;
// the node-sharded round (core/shardplan.py) passes the rank's [local | halo]
// buffer as W, its own rows first, and the all-gathered payload as W_hub.
//
// Numerics, in the JAX order: an ELL row is self_w[i] * w[i], rounded, then
// for each slot in slot order + slot_w * w[src], the product and the sum
// each rounded (no contraction into an FMA, so the plain version's separate
// torch multiply and add give the same bits); a slot of weight exactly 0 is
// skipped.  A hub row is one fp32 FMA chain from 0 over its nonzeros.
// fp32 accumulation whatever W's dtype; no atomics, each output row written
// once by one block: two launches are bitwise equal, and equal to
// hyb.py::mix_hyb_ref.  Whatever the tables hold, nothing outside them or
// the buffers is read: source rows outside [0, n_src) / [0, n_hub_src) add
// nothing, a hub index outside [0, H) makes an ELL row, and a hub's list
// is clipped to [0, nnz).
//
// Work.  A block of kThreads threads owns kRows consecutive output rows and
// one strip of kThreads * VEC columns; it walks its rows one after another,
// every thread on its own VEC columns, so the row's kind, slots and weights
// are the same for the whole block (no divergence).  The row blocks are the
// fastest launch index: the blocks resident at one time walk a few
// neighbouring strips of every row, so a source row that deg + 1 outputs
// read comes from device memory about once and then from L2.  Up to kBatch
// source vectors are loaded before their adds.
//
// What bounds it on an H100: reading W once and writing Y once, 8 n d bytes
// in fp32, against 2 d flops a nonzero: memory-bound for every sparse family.
//
// Two routes, picked on the host from the operator's shape, W's dtype and
// the staged rows (hyb.py::hyb_route, by the routes' times in turns on an
// H100; no pointer enters, so chunked and resumed runs sum alike), with the
// same sums in the same order: the results are bitwise equal.
//
// Route "rows" (mix_hyb_kernel; any n): the work above.  Its time follows
// the gathered rows at about L2's rate: a source row is read again from L2
// for every output row that reads it, and a hub row of hundreds of nonzeros
// is walked serially by one block while the others wait on theirs.
//
// Route "slab" (mix_hyb_slab_kernel; staged rows <= kSlabMaxRows, but for
// few output rows and fp32 rings, where the rows route wins): a block
// owns a column strip of every output row.  It stages the strip of all n_src
// rows of W (and, in the sharded form, of the n_hub_src rows of W_hub; the
// unsharded call passes W twice and stages it once) in shared memory, then
// gathers every ELL slot and hub nonzero from there: W is read from device
// memory once and Y written once.
// - A strip is K sub-strips of 128 bytes (32 fp32 or 64 bf16 columns), K
//   (4, 2, 1) the widest at which two slabs fit in the 227 KB a block may
//   take: the next strip's load overlaps this one's gathers.  Where one slab
//   only fits (n = 1024 takes 160 KB), the block loads, then gathers.  The
//   grid is persistent: the SMs times the blocks one SM holds.
// - Y is written in windows that start on its 32-byte sectors.  Row r's
//   window in strip t is the strip's columns moved left by the row's shift
//   (Y's element address of its column 0 mod a sector), so no sector is
//   written in parts by two blocks: at d = 567,434 fp32 rows start 8-byte
//   aligned, and windows on the strips' own edges made Y's stores cost more
//   than the gathers (PERF.md; tools/hyb_slab_probe.py times the
//   parts).  So a staged row holds the sector before the strip too:
//   128 K + 32 bytes.
// - Eight lanes walk one output row, lane l on 16 bytes at 16 l of every
//   sub-strip of its window: a warp holds four rows, and each quarter-warp
//   reads one source row's 128 bytes, the 32 banks once.  The reads are as
//   wide as the rows' alignment allows (16, 8, 4 or 2 bytes: G), the stores
//   16 bytes a lane, the window's 128 bytes one instruction.
// - Loads: cp.async of G = 4, 8 or 16 bytes a thread (bf16 rows of odd d:
//   plain 2-byte loads and stores), completing on an mbarrier.  TMA and
//   cp.async.bulk need 16-byte aligned rows; the training widths' are not.
// - The rows come as lists built once per operator on the host
//   (hyb.py::hyb_from_tables): walk holds, for each row in the order the
//   block deals them (heaviest first), (row, first entry, entries, 1 for a
//   hub row); entries holds (source row, weight) pairs, an ELL row's self
//   term first and its live slots after it (weight 0 dropped), a hub row's
//   nonzeros as they stand, the lists one after another in the walk's
//   order.  The kernel clips each list to the entries and each source row
//   to W (ELL) or W_hub (hub): a source outside reads a staged row of zeros
//   with weight -0, which leaves every sum as it was (slab_entry).  A block
//   takes each row's shift from Y's address as it starts.  The row groups
//   deal the rows in the walk's order, snaking (round r forward for even r,
//   backward for odd r), so no warp holds the hubs alone; a hub row stays
//   one group's FMA chain in ascending column, so the order of rows changes
//   no row's own sums.  A group loads its row's entries 8 at a time, one a
//   lane, three chunks ahead of their sums (one at K = 4), and shuffles
//   each to its lanes; the first chunk of a row two rounds ahead.  An
//   entry's slab offset is taken where it is used: taken where it is
//   loaded, the lane waited on L2 there (BA-1024, m 8, 10% slower on an
//   H100, tools/hyb_slab_probe.py).
// - fp32 at K = 4 moves 8 bytes at a time at most: its 16-byte form spills
//   at the 64 registers a thread of 1024 may have.
// - What limits it (tools/hyb_slab_probe.py): at n = 1024 the load of a
//   strip and its gathers take turns, and the gathers issue two shuffles
//   and one or two shared loads an entry a quarter-warp; rows of few
//   entries (ring, k-regular) pay as much again for the row itself.
#include <stdint.h>

#include "mix_common.cuh"

// tools/hyb_slab_probe.py builds copies of the slab route that do part of
// its work: 1 the loads only (no row is summed), 2 the gathers and stores
// only (every strip after a block's first keeps its first strip's rows), 4
// the gathers only (the stores behind a test the compiler cannot fold).  0,
// the default, is the kernel whole.
#ifndef MIX_HYB_PROBE
#define MIX_HYB_PROBE 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;   // output rows a block walks
constexpr int kBatch = 4;  // source vectors a thread loads before it adds them

template <typename T, int VEC>
__device__ __forceinline__ void ell_row(const int* __restrict__ slot_idx, const float* __restrict__ slot_w,
                                        float self_w, const T* __restrict__ w, int row, int n_src, int n_rows,
                                        int n_slots, long long d, long long c0, float (&acc)[VEC]) {
  float v[VEC];
  mixk::load_row<T, VEC>(w, row, n_src, d, c0, v);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = __fmul_rn(self_w, v[j]);
  for (int s0 = 0; s0 < n_slots; s0 += kBatch) {
    int src[kBatch];
    float wt[kBatch];
    float x[kBatch][VEC];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int s = s0 + b;
      src[b] = s < n_slots ? slot_idx[(long long)s * n_rows + row] : -1;
      wt[b] = s < n_slots ? slot_w[(long long)s * n_rows + row] : 0.f;
      if (wt[b] != 0.f && src[b] >= 0 && src[b] < n_src) mixk::load_row<T, VEC>(w, src[b], n_src, d, c0, x[b]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (wt[b] != 0.f && src[b] >= 0 && src[b] < n_src) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(wt[b], x[b][j]));
      }
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void hub_row(const int* __restrict__ hub_col, const float* __restrict__ hub_val, int e0,
                                        int e1, const T* __restrict__ w_hub, int n_hub_src, long long d, long long c0,
                                        float (&acc)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int b0 = e0; b0 < e1; b0 += kBatch) {
    int src[kBatch];
    float wt[kBatch];
    float x[kBatch][VEC];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = b0 + b;
      src[b] = e < e1 ? hub_col[e] : -1;
      wt[b] = e < e1 ? hub_val[e] : 0.f;
      if (src[b] >= 0 && src[b] < n_hub_src) mixk::load_row<T, VEC>(w_hub, src[b], n_hub_src, d, c0, x[b]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (src[b] >= 0 && src[b] < n_hub_src) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = fmaf(wt[b], x[b][j], acc[j]);
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    mix_hyb_kernel(const int* __restrict__ slot_idx, const float* __restrict__ slot_w,
                   const float* __restrict__ self_w, const int* __restrict__ hub_of, const int* __restrict__ hub_ptr,
                   const int* __restrict__ hub_col, const float* __restrict__ hub_val, const T* __restrict__ w,
                   const T* __restrict__ w_hub, T* __restrict__ y, int n_src, int n_hub_src, int n_rows,
                   long long d, int n_slots, int n_hubs, int nnz, int n_row_blocks) {
  const long long rb = blockIdx.x % n_row_blocks;
  const long long strip = blockIdx.x / n_row_blocks;
  const long long c0 = (strip * kThreads + threadIdx.x) * VEC;
  if (c0 >= d) return;  // the block shares no memory and waits at no barrier
  const int row_end = (int)min((long long)n_rows, (rb + 1) * kRows);
  for (int row = (int)(rb * kRows); row < row_end; ++row) {
    float acc[VEC];
    const int h = hub_of[row];
    if (h < 0 || h >= n_hubs) {
      ell_row<T, VEC>(slot_idx, slot_w, self_w[row], w, row, n_src, n_rows, n_slots, d, c0, acc);
    } else {
      hub_row<T, VEC>(hub_col, hub_val, max(0, hub_ptr[h]), min(nnz, hub_ptr[h + 1]), w_hub, n_hub_src, d, c0,
                      acc);
    }
    mixk::store_row<T, VEC>(y, row, d, c0, acc);
  }
}

// ---------------------------------------------------------------- slab route
constexpr int kSlabThreads = 1024;
constexpr int kGroup = 8;       // lanes that walk one output row: 16 bytes each of a sub-strip
constexpr int kSubStrip = 128;  // bytes of one sub-strip of a staged row
constexpr int kSector = 32;     // a staged row starts one sector before its strip
constexpr int kSmemMax = 232448;  // the shared memory a block may take on an H100
// two mbarriers (16 bytes); after them the walk's infos (16 bytes an output
// row), then the slabs, each after a staged row of zeros
constexpr int kSlabHeader = 16;
// staged rows at K = 1, counting an output row's info against each
// (n_rows <= n_src)
constexpr int kSlabMaxRows = (kSmemMax - kSlabHeader - (kSubStrip + kSector)) / (kSubStrip + kSector + 16);

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
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

// G bytes from global src to shared dst (zeros where !in); with G >= 4 an
// asynchronous cp.async, which the thread's next copy_arrive tracks
template <int G>
__device__ __forceinline__ void copy_in(uint32_t dst, const void* src, bool in) {
  if constexpr (G == 2) {
    const uint16_t v = in ? *static_cast<const uint16_t*>(src) : (uint16_t)0;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
  } else if constexpr (G == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(G), "r"(in ? G : 0)
                 : "memory");
  }
}

// this thread's arrival on bar once its copies have landed
template <int G>
__device__ __forceinline__ void copy_arrive(uint32_t bar) {
  if constexpr (G == 2) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
  } else {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
  }
}

// A lane's 16 bytes of a staged sub-strip at p, read in loads of the rows'
// alignment (G bytes: 16, 8, 4, or 2 for a bf16 row of odd d), widened to
// fp32
template <typename T, int G>
__device__ __forceinline__ void lane_vals(const uint8_t* p, float (&x)[16 / sizeof(T)]) {
  uint32_t wd[4];
  if constexpr (G >= 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    wd[0] = v.x, wd[1] = v.y, wd[2] = v.z, wd[3] = v.w;
  } else if constexpr (G == 8) {
    const uint2 v0 = *reinterpret_cast<const uint2*>(p), v1 = *reinterpret_cast<const uint2*>(p + 8);
    wd[0] = v0.x, wd[1] = v0.y, wd[2] = v1.x, wd[3] = v1.y;
  } else if constexpr (G == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) wd[i] = reinterpret_cast<const uint32_t*>(p)[i];
  } else {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) wd[i] = (uint32_t)h[2 * i] | ((uint32_t)h[2 * i + 1] << 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      x[i] = __uint_as_float(wd[i]);
    } else {
      x[2 * i] = __uint_as_float(wd[i] << 16);
      x[2 * i + 1] = __uint_as_float(wd[i] & 0xffff0000u);
    }
  }
}

// acc (op)= weight . x over one entry's sub-strips: 0 = x (the self term),
// 1 = + separate product and sum (a slot), 2 = FMA (a hub nonzero)
template <typename T, int G, int K, int OP>
__device__ __forceinline__ void gather(const uint8_t* at, float wt, float (&acc)[K][16 / sizeof(T)]) {
  constexpr int E = 16 / sizeof(T);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    float x[E];
    lane_vals<T, G>(at + s * kSubStrip, x);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (OP == 0) acc[s][e] = __fmul_rn(wt, x[e]);
      else if constexpr (OP == 1) acc[s][e] = __fadd_rn(acc[s][e], __fmul_rn(wt, x[e]));
      else acc[s][e] = fmaf(wt, x[e], acc[s][e]);
    }
  }
}

// an entry of the lists, (source row, weight's bits), as (byte offset of
// its source row from the slab, weight's bits), a staged row SB bytes: an
// ELL entry's source in W's [0, n_src), a hub entry's (hub) in W_hub's
// [0, n_hub_src), staged from slab row hub_row0 on.  A source outside them
// reads the row of zeros before the slab with weight -0: the product is
// -0, and acc + -0 (or fma(-0, 0, acc)) is acc, bit for bit, so it adds
// nothing with no test in the sums.  Taken where the entry is used, not
// where it is loaded, so a load ahead does not wait on L2 there.
template <int SB>
__device__ __forceinline__ int2 slab_entry(int2 v, bool hub, int n_src, int n_hub_src, int hub_row0) {
  return (unsigned)v.x < (unsigned)(hub ? n_hub_src : n_src) ? make_int2(((hub ? hub_row0 : 0) + v.x) * SB, v.y)
                                                             : make_int2(-SB, (int)0x80000000);
}

// one pass of a row group over the entries of its row of one kind (HUB:
// the hub rows, else the ELL rows, whose first entry, the self term, the
// caller has taken); n: this group's entries in the pass (0 if its row is
// of the other kind), m: the most any group of the warp has; first: this
// lane's entry of the first chunk, taken by slab_entry.  Chunks of kGroup
// entries are loaded one a lane, three chunks ahead of their sums (a hub
// row's list is hundreds of entries, read from L2; one at K = 4, whose
// chunks take four times as long, and deeper would spill), and each entry
// is broadcast in the group by shuffles.
template <typename T, int G, int K, bool HUB>
__device__ __forceinline__ void row_pass(const uint8_t* at, const int2* __restrict__ ent, int start, int n, int m,
                                         int n_src, int n_hub_src, int hub_row0, int2 first, int j_first,
                                         int sub, float (&acc)[K][16 / sizeof(T)]) {
  constexpr int SB = kSubStrip * K + kSector;
  constexpr bool kDeep = K < 4;
  auto load = [&](int j) { return j < n ? __ldg(ent + start + j) : make_int2(0, 0); };
  int2 chunk = first, ahead1 = make_int2(0, 0), ahead2 = ahead1, ahead3 = ahead1;
  if (m > kGroup) {  // a long row (warp-uniform): its next chunks
    ahead1 = load(kGroup + sub);
    if constexpr (kDeep) {
      ahead2 = load(2 * kGroup + sub);
      ahead3 = load(3 * kGroup + sub);
    }
  }
  for (int j0 = 0; j0 < m; j0 += kGroup) {
    const int2 ahead4 = load(j0 + (kDeep ? 4 : 2) * kGroup + sub);
    const int cnt = min(kGroup, m - j0);
    for (int j = j0 ? 0 : j_first; j < cnt; ++j) {
      const int off = __shfl_sync(0xffffffffu, chunk.x, j, kGroup);
      const float wt = __int_as_float(__shfl_sync(0xffffffffu, chunk.y, j, kGroup));
      if (j0 + j >= n) continue;  // past this group's row (other groups go on)
      gather<T, G, K, HUB ? 2 : 1>(at + off, wt, acc);
    }
    chunk = slab_entry<SB>(ahead1, HUB, n_src, n_hub_src, hub_row0);
    if constexpr (kDeep) {
      ahead1 = ahead2;
      ahead2 = ahead3;
      ahead3 = ahead4;
    } else {
      ahead1 = ahead4;
    }
  }
}

template <typename T, int G, int K>
__global__ void __launch_bounds__(kSlabThreads)
    mix_hyb_slab_kernel(const int4* __restrict__ walk, const int2* __restrict__ ent, int n_ent,
                        const T* __restrict__ w, const T* __restrict__ w_hub, T* __restrict__ y, int n_src,
                        int n_hub_src, int n_stage_hub, int hub_row0, int n_rows, long long d, long long n_strips,
                        int nbuf) {
  constexpr int GROUPS = kSlabThreads / kGroup;          // rows a block walks at once
  constexpr int E = 16 / sizeof(T);                      // columns a lane holds of a sub-strip
  constexpr int SE = kSector / sizeof(T);                // columns a 32-byte sector
  constexpr int SC = kSubStrip / sizeof(T);              // columns of a sub-strip
  constexpr int SB = kSubStrip * K + kSector;            // bytes of a staged row
  constexpr int UPR = SB / G;                            // copies a staged row
  constexpr int V = G / sizeof(T);                       // columns a copy moves
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem);
  const int rows_staged = n_src + n_stage_hub;
  const int slab_bytes = (rows_staged + 1) * SB;  // a row of zeros, then the staged rows
  const int head = kSlabHeader + n_rows * 16 + SB;   // the walk's infos, slab 0's row of zeros
  const uint32_t slab0 = bars + head;
  const uint8_t* slab_ptr = smem + head;
  const int lane = threadIdx.x % 32, sub = lane % kGroup;
  const int group = threadIdx.x / kGroup;
  int4* sinfo = reinterpret_cast<int4*>(smem + kSlabHeader);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(bars + 8 * i, kSlabThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the walk clipped to the entries and to Y's rows, each row's kind with
  // its shift: Y's element address of its column 0 mod a sector
  const int y_phase = (int)((reinterpret_cast<uintptr_t>(y) / sizeof(T)) & (SE - 1));
  for (int i = threadIdx.x; i < n_rows; i += kSlabThreads) {
    const int4 v = __ldg(walk + i);
    const int first = min(max(v.y, 0), n_ent), cnt = min(max(v.z, 0), n_ent - first);
    const int shift = (int)((y_phase + (long long)v.x * d) & (SE - 1));
    sinfo[i] = v.x >= 0 && v.x < n_rows ? make_int4(v.x, first, cnt, (v.w & 1) | shift << 1) : make_int4(-1, 0, 0, 0);
  }
  for (int i = threadIdx.x; i < nbuf * SB / 16; i += kSlabThreads)
    reinterpret_cast<uint4*>(smem + head - SB + i / (SB / 16) * slab_bytes)[i % (SB / 16)] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // every thread copies its share of strip st's staged rows into slab b:
  // columns [SC K st - SE, SC K (st + 1)), zeros outside [0, d)
  auto issue = [&](long long st, int b) {
    const long long c0 = st * (SC * K) - SE;
    const uint32_t dst = slab0 + b * slab_bytes;
    for (int u = threadIdx.x; u < rows_staged * UPR && ((MIX_HYB_PROBE != 2 && MIX_HYB_PROBE != 4) || st == blockIdx.x);
         u += kSlabThreads) {
      const int r = u / UPR, q = u % UPR;
      const long long col = c0 + (long long)q * V;
      const T* row = r < n_src ? w + (long long)r * d : w_hub + (long long)(r - n_src) * d;
      const bool in = col >= 0 && col < d;
      copy_in<G>(dst + r * SB + q * G, in ? row + col : row, in);
    }
    copy_arrive<G>(bars + 8 * b);
  };
  // the rows a group takes: the walk dealt in rounds of GROUPS, snaking
  auto info_of = [&](int k) {
    const int i = k * GROUPS + ((k & 1) ? GROUPS - 1 - group : group);
    return i < n_rows ? sinfo[i] : make_int4(-1, 0, 0, 0);
  };
  auto first_of = [&](const int4& inf) {
    return inf.x >= 0 && sub < inf.z ? __ldg(ent + inf.y + sub) : make_int2(0, 0);
  };
  const int rounds = (n_rows + GROUPS - 1) / GROUPS;

  int it = 0;
  if (blockIdx.x < n_strips) issue(blockIdx.x, 0);
  for (long long st = blockIdx.x; st < n_strips; st += gridDim.x, ++it) {
    const int b = nbuf == 2 ? (it & 1) : 0;
    const long long next = st + gridDim.x;
    if (nbuf == 2 && next < n_strips) issue(next, b ^ 1);  // slab b ^ 1 was released at the last strip's end
    // a row's first kGroup entries are loaded two rounds ahead of its sums
    int4 i0 = info_of(0), i1 = info_of(1);
    int2 e0 = first_of(i0), e1 = first_of(i1);
    mbar_wait(bars + 8 * b, (nbuf == 2 ? it >> 1 : it) & 1);
    const uint8_t* slab = slab_ptr + b * slab_bytes;
    for (int k = 0; k < (MIX_HYB_PROBE == 1 ? 0 : rounds); ++k) {
      const int4 i2 = info_of(k + 2);
      const int2 e2 = first_of(i2);
      const bool live = i0.x >= 0, hub = i0.w & 1;
      const int2 e = slab_entry<SB>(e0, hub, n_src, n_hub_src, hub_row0);
      const int n_ell = live && !hub ? i0.z : 0, n_hub = live && hub ? i0.z : 0;
      int m_ell = n_ell, m_hub = n_hub;
#pragma unroll
      for (int x = kGroup; x < 32; x *= 2) {
        m_ell = max(m_ell, __shfl_xor_sync(0xffffffffu, m_ell, x));
        m_hub = max(m_hub, __shfl_xor_sync(0xffffffffu, m_hub, x));
      }
      // the row's window: SC K columns from c0 - shift, which starts a
      // sector of Y (which block computes an element changes no sum); this
      // lane's E columns of each sub-strip at sub E
      const int shift = i0.w >> 1;
      const long long c0 = st * (SC * K) - shift;
      const uint8_t* at = slab + (SE - shift) * (int)sizeof(T) + sub * 16;
      float acc[K][E];
#pragma unroll
      for (int s = 0; s < K; ++s)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[s][e] = 0.f;
      if (m_ell) {  // an ELL row's first entry is its self term: acc = weight . x
        const int off = __shfl_sync(0xffffffffu, e.x, 0, kGroup);
        const float wt = __int_as_float(__shfl_sync(0xffffffffu, e.y, 0, kGroup));
        if (n_ell) gather<T, G, K, 0>(at + off, wt, acc);
        row_pass<T, G, K, false>(at, ent, i0.y, n_ell, m_ell, n_src, n_hub_src, hub_row0, e, 1, sub, acc);
      }
      if (m_hub) row_pass<T, G, K, true>(at, ent, i0.y, n_hub, m_hub, n_src, n_hub_src, hub_row0, e, 0, sub, acc);
      if (live && (MIX_HYB_PROBE != 4 || d < 0)) {
        T* yr = y + (long long)i0.x * d;
#pragma unroll
        for (int s = 0; s < K; ++s) {
          const long long col = c0 + s * SC + sub * E;
          uint32_t wd[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (sizeof(T) == 4) {
              wd[i] = __float_as_uint(acc[s][i]);
            } else {
              const __nv_bfloat162 v = __floats2bfloat162_rn(acc[s][2 * i], acc[s][2 * i + 1]);
              wd[i] = *reinterpret_cast<const uint32_t*>(&v);
            }
          }
          if (col >= 0 && col + E <= d) {  // this lane's 16 bytes of the window: one aligned store
            *reinterpret_cast<uint4*>(yr + col) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
          } else {  // a piece across column 0 or d: its columns inside one by one
#pragma unroll
            for (int e = 0; e < E; ++e)
              if (col + e >= 0 && col + e < d) yr[col + e] = mixk::from_f32<T>(acc[s][e]);
          }
        }
      }
      i0 = i1;
      i1 = i2;
      e0 = e1;
      e1 = e2;
    }
    __syncthreads();  // every warp is done with slab b
    if (nbuf == 1 && next < n_strips) issue(next, 0);
  }
}

template <typename T, int G, int K>
int launch_slab(const int4* walk, const int2* ent, int n_ent, const void* w, const void* w_hub, void* y, int n_src,
                int n_hub_src, int n_stage_hub, int n_rows, long long d, int nbuf, int smem, cudaStream_t s) {
  constexpr int SC = kSubStrip / sizeof(T);
  auto kernel = mix_hyb_slab_kernel<T, G, K>;
  // the blocks the card holds at this shared memory, asked once per device
  // and size (the calls cost microseconds, as much as a small mix)
  static int cached_dev = -1, cached_smem = -1, resident_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != cached_dev || smem != cached_smem) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
      return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSlabThreads, smem)) != cudaSuccess)
      return (int)err;
    cached_dev = dev, cached_smem = smem, resident_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  // a row's windows start up to a sector before the strips' edges
  const long long strips = (d + kSector / (long long)sizeof(T) - 1 + (long long)SC * K - 1) / ((long long)SC * K);
  const long long grid = strips < resident_blocks ? strips : resident_blocks;
  kernel<<<(unsigned)grid, kSlabThreads, smem, s>>>(walk, ent, n_ent, static_cast<const T*>(w),
                                                     static_cast<const T*>(w_hub), static_cast<T*>(y), n_src,
                                                     n_hub_src, n_stage_hub, n_stage_hub ? n_src : 0, n_rows, d,
                                                     strips, nbuf);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_slab_k(int k, const int4* walk, const int2* ent, int n_ent, const void* w, const void* w_hub, void* y,
                  int n_src, int n_hub_src, int n_stage_hub, int n_rows, long long d, int nbuf, int smem,
                  cudaStream_t s) {
  // bf16 holds 8 columns a lane a sub-strip: K <= 2 (1 for rows of odd d),
  // or its accumulators spill; fp32 at K = 4 copies and reads 8 bytes at a
  // time at most (its 16-byte form spills)
  if constexpr (sizeof(T) == 4) {
    if (k == 4)
      return launch_slab<T, (G < 8 ? G : 8), 4>(walk, ent, n_ent, w, w_hub, y, n_src, n_hub_src, n_stage_hub,
                                                 n_rows, d, nbuf, smem, s);
  }
  if constexpr (sizeof(T) == 4 || G > 2) {
    if (k == 2)
      return launch_slab<T, G, 2>(walk, ent, n_ent, w, w_hub, y, n_src, n_hub_src, n_stage_hub, n_rows, d, nbuf,
                                  smem, s);
  }
  return launch_slab<T, G, 1>(walk, ent, n_ent, w, w_hub, y, n_src, n_hub_src, n_stage_hub, n_rows, d, nbuf, smem,
                              s);
}

}  // namespace

// The most rows (of W, and of W_hub where it is another buffer) the slab
// route stages; hyb.py::SLAB_MAX_ROWS must equal it.
extern "C" int mix_hyb_slab_max_rows() { return kSlabMaxRows; }

// The slab route.  walk (n_rows, 4) and entries (n_ent, 2) are the HYB's
// lists (hyb.py::hyb_from_tables); W, W_hub, Y, n_src, n_hub_src, n_rows, d
// and vec as mix_hyb's below; n_stage_hub the W_hub rows it stages (0: the
// hub lists read W, or there are no hubs; else n_hub_src).  One launch.
// Returns a cudaError_t.
extern "C" int mix_hyb_slab(int dtype, const int* walk, const int* entries, int n_ent, const void* w,
                            const void* w_hub, void* y, int n_src, int n_hub_src, int n_stage_hub, int n_rows,
                            long long d, int vec, void* stream) {
  if (n_rows <= 0 || n_rows > n_src || n_hub_src < 0 || d <= 0 || n_ent < 0 ||
      (n_stage_hub != 0 && n_stage_hub != n_hub_src))
    return cudaErrorInvalidValue;
  const int rows_staged = n_src + n_stage_hub;
  if (rows_staged > kSlabMaxRows) return cudaErrorInvalidValue;
  // K: the widest of 4, 2, 1 sub-strips at which two slabs (each with its
  // row of zeros) fit; else one slab of 1
  const int head = kSlabHeader + 16 * n_rows;
  int k = 1, nbuf = 1;
  for (int kk = dtype == 0 ? 4 : (vec == 1 ? 1 : 2); kk >= 1; kk /= 2) {  // as launch_slab_k instantiates
    if (2 * (rows_staged + 1) * (kSubStrip * kk + kSector) <= kSmemMax - head) {
      k = kk;
      nbuf = 2;
      break;
    }
  }
  const int smem = head + nbuf * (rows_staged + 1) * (kSubStrip * k + kSector);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* wk = reinterpret_cast<const int4*>(walk);
  const int2* en = reinterpret_cast<const int2*>(entries);
  const void* wh = n_stage_hub ? w_hub : w;
#define MIX_HYB_SLAB_CALL(TT, GG) \
  return launch_slab_k<TT, GG>(k, wk, en, n_ent, w, wh, y, n_src, n_hub_src, n_stage_hub, n_rows, d, nbuf, smem, s);
  switch (dtype * 100 + vec * (dtype ? 2 : 4)) {
    case 4: MIX_HYB_SLAB_CALL(float, 4)
    case 8: MIX_HYB_SLAB_CALL(float, 8)
    case 16: MIX_HYB_SLAB_CALL(float, 16)
    case 102: MIX_HYB_SLAB_CALL(__nv_bfloat16, 2)
    case 104: MIX_HYB_SLAB_CALL(__nv_bfloat16, 4)
    case 108: MIX_HYB_SLAB_CALL(__nv_bfloat16, 8)
    default: return cudaErrorInvalidValue;
  }
#undef MIX_HYB_SLAB_CALL
}

// dtype: 0 = fp32, 1 = bf16 (W, W_hub and Y).  vec in {1, 2, 4} divides d
// and the host checked the three pointers' alignment for it.  W is
// (n_src, d), W_hub (n_hub_src, d), Y (n_rows, d) with n_rows <= n_src;
// slot_idx / slot_w are (n_slots, n_rows), self_w / hub_of (n_rows,),
// hub_ptr (n_hubs + 1,), hub_col / hub_val (nnz,).  Returns a cudaError_t.
extern "C" int mix_hyb(int dtype, const int* slot_idx, const float* slot_w, const float* self_w, const int* hub_of,
                       const int* hub_ptr, const int* hub_col, const float* hub_val, const void* w,
                       const void* w_hub, void* y, int n_src, int n_hub_src, int n_rows, long long d, int n_slots,
                       int n_hubs, int nnz, int vec, void* stream) {
  if (n_rows <= 0 || n_rows > n_src || n_hub_src < 0 || d <= 0 || n_slots < 0 || n_hubs < 0 || nnz < 0)
    return cudaErrorInvalidValue;
  const int n_row_blocks = (n_rows + kRows - 1) / kRows;
  const long long strip_cols = (long long)kThreads * vec;
  const long long strips = (d + strip_cols - 1) / strip_cols;
  const long long blocks = strips * n_row_blocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MIX_HYB_CALL(TT, VV)                                                                                    \
  mix_hyb_kernel<TT, VV><<<(unsigned)blocks, kThreads, 0, s>>>(                                                  \
      slot_idx, slot_w, self_w, hub_of, hub_ptr, hub_col, hub_val, static_cast<const TT*>(w),                    \
      static_cast<const TT*>(w_hub), static_cast<TT*>(y), n_src, n_hub_src, n_rows, d, n_slots, n_hubs, nnz,    \
      n_row_blocks);                                                                                            \
  break;
  switch (dtype * 10 + vec) {
    case 1: MIX_HYB_CALL(float, 1)
    case 2: MIX_HYB_CALL(float, 2)
    case 4: MIX_HYB_CALL(float, 4)
    case 11: MIX_HYB_CALL(__nv_bfloat16, 1)
    case 12: MIX_HYB_CALL(__nv_bfloat16, 2)
    case 14: MIX_HYB_CALL(__nv_bfloat16, 4)
    default: return cudaErrorInvalidValue;
  }
#undef MIX_HYB_CALL
  return (int)cudaGetLastError();
}
