// The chunked, deterministic segment reduction behind segment_sum.cu (rows
// read through the stable sort permutation), segment_sum_sorted.cu (rows
// read in place) and sage_aggregate.cu (weighted message rows gathered
// across the two sorted edge views):
//
//   out[b, n] = sum of the rows of window b in [p[b, n], p[b, n + 1])
//
// over a row pointer p that the row source gives (RowsInPlace, RowsPerm,
// RowsSage below).  Work is cut into chunks of at most kChunkRows (L) rows,
// never more than one segment's: the row space is cut at multiples of L and
// at the segment boundaries, so segment n owns chunk slots [n + p[n] / L,
// n + 1 + p[n + 1] / L), an exclusive prefix sum of per-segment chunk
// counts that telescopes to a closed form.  Every segment has at least one
// chunk (an empty one writes exact zeros), a long one ceil(len / L) or one
// more, and a window at most N + ceil(S / L) whatever its longest segment
// (S: the rows of the row space).  The chunk map comes from the row
// pointers on the card: one warp per chunk slot of the static bound finds
// its segment with a 32-way search over the pointers (2 rounds of loads at
// N = 1024, 3 at 4097); a warp on a slot no segment owns leaves at once, so
// the grid needs no count read back.
//
// Sums are f32, in a fixed order, with no atomics on values: a warp sums its
// chunk's rows (lanes over a row's packs, or over rows and packs when a row
// is narrow, folded by shuffles in a fixed tree), a one-chunk segment writes
// its row directly, and the chunks of a longer segment write f32 partials
// to a scratch row each.  The last chunk to arrive (a per-segment arrival
// counter after __threadfence(); it resets the counter to 0, so the
// wrapper's per-stream counters stay zero between launches) adds the
// partials in chunk order and writes the row.  A row source whose rows may
// all add nothing (RowsSage: weight-0 edges) lets such a chunk skip its
// partial: it writes a per-slot flag instead, and the combine adds only the
// flagged-live partials, still in chunk order.  The same inputs give the
// same bits on every run.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace nerrf {

// L, the rows of a chunk: one chunk map serves every row width, and with
// 32 rows a chunk's row numbers (and weights) are one coalesced load (a
// lane each), shared through shuffles
constexpr int kChunkRows = 32;

// loads a lane keeps in flight before adding them: at most 8 steps of rows
// and 32 registers, so 8 rows of 16-byte packs (F = 160 bf16) without the
// 90-120 registers that 8 rows of five scalar chunks cost sage_aggregate
constexpr int kInflightSteps = 8;
constexpr int kInflightRegs = 32;

// V consecutive elements of a row moved as one load: 16 bytes (V = 16 /
// sizeof(T)) when rows allow it, else one element.  add_to(acc) adds the
// pack, add_to(acc, w) adds w times the pack (a weighted message row).
template <typename T, int V>
struct Pack;

template <typename T>
struct Pack<T, 1> {
  T x;
  template <bool kCg>
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kCg && std::is_same<T, float>::value) x = __ldcg(p);
    else x = *p;
  }
  __device__ __forceinline__ void add_to(float (&acc)[1]) const { acc[0] += to_f32(x); }
  __device__ __forceinline__ void add_to(float (&acc)[1], float w) const {
    acc[0] += w * to_f32(x);
  }
};

template <>
struct Pack<float, 4> {
  float4 x;
  template <bool kCg>
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (kCg) x = __ldcg(reinterpret_cast<const float4*>(p));
    else x = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void add_to(float (&acc)[4]) const {
    acc[0] += x.x;
    acc[1] += x.y;
    acc[2] += x.z;
    acc[3] += x.w;
  }
  __device__ __forceinline__ void add_to(float (&acc)[4], float w) const {
    acc[0] += w * x.x;
    acc[1] += w * x.y;
    acc[2] += w * x.z;
    acc[3] += w * x.w;
  }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  uint4 x;
  template <bool kCg>
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    x = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void add_to(float (&acc)[8]) const { add_to(acc, 1.f); }
  __device__ __forceinline__ void add_to(float (&acc)[8], float w) const {
    add2(acc, 0, x.x, w);
    add2(acc, 2, x.y, w);
    add2(acc, 4, x.z, w);
    add2(acc, 6, x.w, w);
  }
  // w = 1 adds the values themselves: 1 * v is v exactly
  static __device__ __forceinline__ void add2(float (&acc)[8], int i, unsigned u, float w) {
    __nv_bfloat162 h;
    memcpy(&h, &u, sizeof(h));
    const float2 f = __bfloat1622float2(h);
    acc[i] += w * f.x;
    acc[i + 1] += w * f.y;
  }
};

// writes V f32 values as V elements of T (one store of V * sizeof(T) bytes)
template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = from_f32<T>(v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    static_assert(V % 4 == 0, "f32 packs are whole float4s");
#pragma unroll
    for (int i = 0; i < V; i += 4)
      reinterpret_cast<float4*>(p)[i / 4] = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
    static_assert(V % 4 == 0, "bf16 packs are whole 8-byte words");
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[i], v[i + 1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[i + 2], v[i + 3]);
      uint2 w;
      memcpy(&w.x, &lo, sizeof(lo));
      memcpy(&w.y, &hi, sizeof(hi));
      reinterpret_cast<uint2*>(p)[i / 4] = w;
    }
  }
}

// How a warp's lanes cover rows of P packs: 2^lpr_log2 lanes per row (the
// least power of two >= P, at most 32), so 32 >> lpr_log2 row groups take
// rows g, g + groups, ... and lane q of a group holds packs q, q + lpr, ...
struct RowLanes {
  int lpr, groups, g, q;
  __device__ __forceinline__ RowLanes(int lpr_log2, int lane)
      : lpr(1 << lpr_log2), groups(32 >> lpr_log2), g(lane >> lpr_log2),
        q(lane & ((1 << lpr_log2) - 1)) {}
};

// Where the i-th row a warp adds comes from: kInPlace, data row lo + i;
// kPerm, data row idx of lane i; kWeighted, idx of lane i times w of lane i
// (then i < 32: a chunk's rows, shared through shuffles)
enum class Rows { kInPlace, kPerm, kWeighted };

// acc += the `count` rows described by (kRows, lo, idx, w) of d (rows of F
// elements, P packs of V).  kCg: load through L2 only (partials other warps
// just wrote).  A group's rows are added in row order; U steps of loads are
// issued before their adds.
template <typename T, int V, int C, Rows kRows, bool kCg>
__device__ __forceinline__ void sum_rows(float (&acc)[C][V], const T* __restrict__ d, int lo,
                                         int count, int idx, float w, int P, int F,
                                         const RowLanes& ln) {
  constexpr int kPackRegs = (V * static_cast<int>(sizeof(T)) + 3) / 4;
  constexpr int kByRegs = kInflightRegs / (C * kPackRegs) > 0 ? kInflightRegs / (C * kPackRegs) : 1;
  constexpr int U = kByRegs < kInflightSteps ? kByRegs : kInflightSteps;
  for (int base = 0; base < count; base += U * ln.groups) {  // the same in every lane
    Pack<T, V> buf[U][C];
    float wt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * ln.groups + ln.g;
      int row = lo + i;
      if constexpr (kRows != Rows::kInPlace) row = __shfl_sync(kFullMask, idx, i & 31);
      if constexpr (kRows == Rows::kWeighted) wt[u] = __shfl_sync(kFullMask, w, i & 31);
      if (i < count) {
        const T* src = d + static_cast<long long>(row) * F;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int p = ln.q + c * ln.lpr;
          if (p < P) buf[u][c].template load<kCg>(src + p * V);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * ln.groups + ln.g < count) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (ln.q + c * ln.lpr < P) {
            if constexpr (kRows == Rows::kWeighted) buf[u][c].add_to(acc[c], wt[u]);
            else buf[u][c].add_to(acc[c]);
          }
        }
      }
    }
  }
}

// adds the row groups' sums into group 0 (lanes < lpr), a fixed tree
template <int C, int V>
__device__ __forceinline__ void fold_groups(float (&acc)[C][V], const RowLanes& ln) {
  for (int off = ln.lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[c][v] += __shfl_down_sync(kFullMask, acc[c][v], off);
  }
}

template <typename T, int C, int V>
__device__ __forceinline__ void store_row(T* __restrict__ dst, const float (&acc)[C][V], int P,
                                          const RowLanes& ln) {
  if (ln.g != 0) return;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int p = ln.q + c * ln.lpr;
    if (p < P) store_pack<T, V>(dst + p * V, acc[c]);
  }
}

// The position of the i-th set bit (from 0) of m, for i < popc(m): the
// last position with at most i set bits below it
__device__ __forceinline__ int nth_set_bit(unsigned m, int i) {
  int pos = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (__popc(m & ((1u << (pos + step)) - 1u)) <= i) pos += step;
  return pos;
}

// The segment n in [0, N) that owns chunk slot k, i.e. the last n with
// n + p(n) / L <= k (the caller checks p(0) / L <= k < N + p(N) / L): a
// 32-way search, one pointer read per lane per round
template <class Src>
__device__ __forceinline__ int find_segment(const Src& p, int N, int k, int lane) {
  int lo = 0, len = N;  // the answer lies in [lo, lo + len)
  while (len > 1) {
    const int step = (len + 31) / 32;
    const int cand = lo + lane * step;
    const bool ok = cand < lo + len && cand + p.ptr(cand) / kChunkRows <= k;
    const int j = 31 - __clz(__ballot_sync(kFullMask, ok));  // lane 0 is always ok
    lo += j * step;
    len = min(step, len - j * step);
  }
  return lo;
}

// Slot k's segment n, its first slot c0, its number of slots, and the rows
// [lo, hi) of slot k; false when no segment owns slot k
struct Chunk {
  int n, c0, chunks, lo, hi;
  template <class Src>
  __device__ __forceinline__ bool find(const Src& p, int N, int k, int lane) {
    if (k < p.ptr(0) / kChunkRows || k >= N + p.ptr(N) / kChunkRows) return false;
    n = find_segment(p, N, k, lane);
    const int p0 = p.ptr(n), p1 = p.ptr(n + 1), t0 = p0 / kChunkRows;
    c0 = n + t0;
    chunks = 1 + p1 / kChunkRows - t0;
    const int tile = t0 + (k - c0);
    lo = max(p0, tile * kChunkRows);
    hi = min(p1, (tile + 1) * kChunkRows);
    return true;
  }
};

// A chunk's rows as the warp adds them: `count` rows, described for
// sum_rows by (lo, lane's idx, lane's w)
struct ChunkRows {
  int lo, count, idx;
  float w;
};

// The row sources.  Each is one window's view (at(b)): ptr(i), the row
// pointer the chunk map cuts; rows(ch, lane), the chunk's rows; kRows, how
// sum_rows reads them; kDead, whether a chunk's rows may all add nothing.

// #4: rows of nondecreasing ids, in place: data [B, S, F], p [B, N + 1]
template <typename T>
struct RowsInPlace {
  static constexpr Rows kRows = Rows::kInPlace;
  static constexpr bool kDead = false;
  const T* data;
  const int* p;
  int N, S, F;
  __device__ __forceinline__ RowsInPlace at(int b) const {
    return {data + static_cast<long long>(b) * S * F, p + static_cast<long long>(b) * (N + 1), N,
            S, F};
  }
  __device__ __forceinline__ int ptr(int i) const { return p[i]; }
  __device__ __forceinline__ ChunkRows rows(const Chunk& ch, int) const {
    return {ch.lo, ch.hi - ch.lo, 0, 1.f};
  }
};

// #3: rows read through the stable sort permutation perm [B, S] (int64, as
// torch.sort gives it), or in place when perm is null (a plan of sorted ids)
template <typename T>
struct RowsPerm {
  static constexpr Rows kRows = Rows::kPerm;
  static constexpr bool kDead = false;
  const T* data;
  const long long* perm;
  const int* p;
  int N, S, F;
  __device__ __forceinline__ RowsPerm at(int b) const {
    return {data + static_cast<long long>(b) * S * F,
            perm == nullptr ? nullptr : perm + static_cast<long long>(b) * S,
            p + static_cast<long long>(b) * (N + 1), N, S, F};
  }
  __device__ __forceinline__ int ptr(int i) const { return p[i]; }
  __device__ __forceinline__ ChunkRows rows(const Chunk& ch, int lane) const {
    const int r = ch.lo + lane;
    const int idx = perm == nullptr ? r : (r < ch.hi ? static_cast<int>(perm[r]) : 0);
    return {0, ch.hi - ch.lo, idx, 1.f};
  }
};

// #1: both sorted edge views of a window as one row space.  Both id vectors
// are nondecreasing, so q(n) = pf[n] + pr[n] is itself a row pointer: node
// n's merged rows [q(n), q(n + 1)) are its dst-view band (edge r - pr[n]
// of the dst-sorted list, message row gf, weight wf) followed by its
// src-view band (edge r - pf[n + 1] of the src-sorted view, message row gr,
// weight wr), from r = pf[n + 1] + pr[n] on.  A row adds w * msg[idx]; an
// edge of weight 0 (the builder's padding) or a message row outside [0, N)
// adds nothing and is dropped before the loads: lane j loads merged row lo
// + j's index and weight, and the kept rows are packed to the first lanes
// in row order.  msg [B, N, F]; pf, pr [B, N + 1]; g*, w* [B, E].
template <typename T>
struct RowsSage {
  static constexpr Rows kRows = Rows::kWeighted;
  static constexpr bool kDead = true;
  const T* data;
  const int *pf, *gf;
  const float* wf;
  const int *pr, *gr;
  const float* wr;
  int N, E, F;
  __device__ __forceinline__ RowsSage at(int b) const {
    const long long pb = static_cast<long long>(b) * (N + 1), eb = static_cast<long long>(b) * E;
    return {data + static_cast<long long>(b) * N * F, pf + pb, gf + eb, wf + eb, pr + pb,
            gr + eb, wr + eb, N, E, F};
  }
  __device__ __forceinline__ int ptr(int i) const { return pf[i] + pr[i]; }
  __device__ __forceinline__ ChunkRows rows(const Chunk& ch, int lane) const {
    const int r = ch.lo + lane;
    int idx = 0;
    float w = 0.f;
    if (r < ch.hi) {
      const int mid = pf[ch.n + 1] + pr[ch.n];
      if (r < mid) {
        idx = gf[r - pr[ch.n]];
        w = wf[r - pr[ch.n]];
      } else {
        idx = gr[r - pf[ch.n + 1]];
        w = wr[r - pf[ch.n + 1]];
      }
    }
    const unsigned kept = __ballot_sync(
        kFullMask, w != 0.f && static_cast<unsigned>(idx) < static_cast<unsigned>(N));
    const int from = nth_set_bit(kept, lane);  // any lane past the kept ones
    return {0, __popc(kept), __shfl_sync(kFullMask, idx, from),
            __shfl_sync(kFullMask, w, from)};
  }
};

// o = the sum of partial rows [c0, c0 + chunks) (f32, layout (Vp, Cp) over
// 2^lpr_p lanes), in chunk order; read through L2 (other warps wrote them).
// With live flags (kDead sources), only the partials of flagged slots.
template <typename T, int Vp, int Cp, bool kDead>
__device__ __forceinline__ void combine_partials(const float* __restrict__ part,
                                                 const unsigned char* __restrict__ live, int c0,
                                                 int chunks, int F, int lpr_p, int lane,
                                                 T* __restrict__ o) {
  const RowLanes lp(lpr_p, lane);
  float tot[Cp][Vp];
#pragma unroll
  for (int c = 0; c < Cp; ++c)
#pragma unroll
    for (int v = 0; v < Vp; ++v) tot[c][v] = 0.f;
  if constexpr (kDead) {
    for (int base = 0; base < chunks; base += 32) {  // the same in every lane
      const int c = c0 + base + lane;
      const unsigned on =
          __ballot_sync(kFullMask, base + lane < chunks && __ldcg(live + c) != 0);
      const int idx = c0 + base + nth_set_bit(on, lane);
      sum_rows<float, Vp, Cp, Rows::kPerm, true>(tot, part, 0, __popc(on), idx, 1.f, F / Vp, F,
                                                 lp);
    }
  } else {
    sum_rows<float, Vp, Cp, Rows::kInPlace, true>(tot, part, c0, chunks, 0, 1.f, F / Vp, F, lp);
  }
  fold_groups(tot, lp);
  store_row<T>(o, tot, F / Vp, lp);
}

// Chunk sums of the row source Src over every chunk slot of the batch
// (K per window), data in layout (Vd, Cd) over 2^lpr_d lanes, partials
// (f32) in layout (Vp, Cp) over 2^lpr_p lanes.  partial [B, K, F] and live
// [B, K] (kDead sources only) need no initial value; arrivals [B, N] are
// zero and left zero.
template <typename T, int Vd, int Cd, int Vp, int Cp, class Src>
__global__ void __launch_bounds__(kThreadsPerBlock)
segment_chunks_kernel(const Src src, int B, int N, int K, int F, int lpr_d, int lpr_p,
                      float* __restrict__ partial, unsigned char* __restrict__ live,
                      int* arrivals, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (slot >= static_cast<long long>(B) * K) return;  // whole warps leave together
  const int b = static_cast<int>(slot / K);
  const int k = static_cast<int>(slot - static_cast<long long>(b) * K);
  const Src win = src.at(b);
  Chunk ch;
  if (!ch.find(win, N, k, lane)) return;

  const ChunkRows rows = win.rows(ch, lane);
  const RowLanes ld(lpr_d, lane);
  float acc[Cd][Vd];
#pragma unroll
  for (int c = 0; c < Cd; ++c)
#pragma unroll
    for (int v = 0; v < Vd; ++v) acc[c][v] = 0.f;
  sum_rows<T, Vd, Cd, Src::kRows, false>(acc, win.data, rows.lo, rows.count, rows.idx, rows.w,
                                         F / Vd, F, ld);
  fold_groups(acc, ld);
  T* o = out + (static_cast<long long>(b) * N + ch.n) * F;
  if (ch.chunks == 1) {
    store_row<T>(o, acc, F / Vd, ld);
    return;
  }

  float* part = partial + static_cast<long long>(b) * K * F;
  unsigned char* flags = nullptr;
  if constexpr (Src::kDead) {  // a chunk that adds nothing leaves its partial unwritten
    flags = live + static_cast<long long>(b) * K;
    if (lane == 0) flags[k] = rows.count != 0;
  }
  if (!Src::kDead || rows.count != 0)
    store_row<float>(part + static_cast<long long>(k) * F, acc, F / Vd, ld);
  __threadfence();  // this chunk's partial is visible before it counts as arrived
  __syncwarp();
  int* arrived = arrivals + static_cast<long long>(b) * N + ch.n;
  int before = 0;
  if (lane == 0) before = atomicAdd(arrived, 1);
  before = __shfl_sync(kFullMask, before, 0);
  if (before != ch.chunks - 1) return;  // not the last of the segment's chunks
  if (lane == 0) *arrived = 0;          // ready for the next launch
  __threadfence();
  combine_partials<T, Vp, Cp, Src::kDead>(part, flags, ch.c0, ch.chunks, F, lpr_p, lane, o);
}

inline int log2_lanes(int packs) {
  int l = 0;
  while (l < 5 && (1 << l) < packs) ++l;
  return l;
}

// One launch over every chunk slot of the batch: N + ceil(rows / L) per
// window, for a row space of `rows` rows.  Rows go as 16-byte packs when F
// is a multiple of 8 and data is 16-byte aligned, else element by element;
// C, the packs a lane holds per row, is a compile-time constant.
template <typename T, class Src>
int launch_segment_chunks(const Src& src, int B, int N, int rows, int F, void* partial,
                          void* live, void* arrivals, void* out, cudaStream_t s) {
  const int K = N + (rows + kChunkRows - 1) / kChunkRows;
  const dim3 grid(row_blocks(static_cast<long long>(B) * K));
  const bool vec = F % 8 == 0 && reinterpret_cast<uintptr_t>(src.data) % 16 == 0;
  constexpr int kVd = 16 / sizeof(T);
  const int packs_d = vec ? F / kVd : F, packs_p = vec ? F / 4 : F;
  const int cd = (packs_d + 31) / 32, cp = (packs_p + 31) / 32;
  const int lpr_d = log2_lanes(packs_d), lpr_p = log2_lanes(packs_p);
#define NERRF_CHUNKS_LAUNCH(VD, CD, VP, CP)                                                 \
  segment_chunks_kernel<T, VD, CD, VP, CP, Src><<<grid, kThreadsPerBlock, 0, s>>>(          \
      src, B, N, K, F, lpr_d, lpr_p, static_cast<float*>(partial),                          \
      static_cast<unsigned char*>(live), static_cast<int*>(arrivals), static_cast<T*>(out))
  if (vec) {
    if (cd == 1 && cp == 1) NERRF_CHUNKS_LAUNCH(kVd, 1, 4, 1);
    else if (cd == 1 && cp == 2) NERRF_CHUNKS_LAUNCH(kVd, 1, 4, 2);
    else if (cd == 2 && cp == 2) NERRF_CHUNKS_LAUNCH(kVd, 2, 4, 2);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    switch (cd) {
      case 1: NERRF_CHUNKS_LAUNCH(1, 1, 1, 1); break;
      case 2: NERRF_CHUNKS_LAUNCH(1, 2, 1, 2); break;
      case 3: NERRF_CHUNKS_LAUNCH(1, 3, 1, 3); break;
      case 4: NERRF_CHUNKS_LAUNCH(1, 4, 1, 4); break;
      case 5: NERRF_CHUNKS_LAUNCH(1, 5, 1, 5); break;
      case 6: NERRF_CHUNKS_LAUNCH(1, 6, 1, 6); break;
      case 7: NERRF_CHUNKS_LAUNCH(1, 7, 1, 7); break;
      case 8: NERRF_CHUNKS_LAUNCH(1, 8, 1, 8); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef NERRF_CHUNKS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nerrf
