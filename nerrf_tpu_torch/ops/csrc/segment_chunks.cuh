// The chunked, deterministic segment reduction behind segment_sum.cu (rows
// read through the stable sort permutation) and segment_sum_sorted.cu (rows
// read in place):
//
//   out[b, n] = sum of the rows of window b in [ptr[b, n], ptr[b, n + 1])
//
// Work is cut into chunks of at most kChunkRows (L) rows, never more than
// one segment's: the row space is cut at multiples of L and at the segment
// boundaries, so segment n owns chunk slots [n + ptr[n] / L, n + 1 +
// ptr[n + 1] / L), an exclusive prefix sum of per-segment chunk counts that
// telescopes to a closed form.  Every segment has at least one chunk (an
// empty one writes exact zeros), a long one ceil(len / L) or one more, and
// a window at most N + ceil(S / L) whatever its longest segment.  The chunk
// map comes from the row pointers on the card: one warp per chunk slot of
// the static bound finds its segment with a 32-way search over the
// pointers (2 rounds of loads at N = 1024, 3 at 4097); a warp on a slot no
// segment owns leaves at once, so the grid needs no count read back.
//
// Sums are f32, in a fixed order, with no atomics on values: a warp sums its
// chunk's rows (lanes over a row's packs, or over rows and packs when a row
// is narrow, folded by shuffles in a fixed tree), a one-chunk segment writes
// its row directly, and the chunks of a longer segment write f32 partials
// to a scratch row each.  The last chunk to arrive (a per-segment arrival
// counter after __threadfence(); it resets the counter to 0, so the
// wrapper's per-stream counters stay zero between launches) adds the
// partials in chunk order and writes the row.  The same inputs give the
// same bits on every run.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace nerrf {

// L, the rows of a chunk: one chunk map serves every row width, and with
// 32 rows a chunk's permuted row numbers are one coalesced load (a lane
// each), shared through shuffles
constexpr int kChunkRows = 32;

// loads a lane keeps in flight before adding them: at most 8 steps of rows
// and 32 registers, so 8 rows of 16-byte packs (F = 160 bf16) without the
// 90-120 registers that 8 rows of five scalar chunks cost sage_aggregate
constexpr int kInflightSteps = 8;
constexpr int kInflightRegs = 32;

// V consecutive elements of a row moved as one load: 16 bytes (V = 16 /
// sizeof(T)) when rows allow it, else one element
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
};

template <>
struct Pack<__nv_bfloat16, 8> {
  uint4 x;
  template <bool kCg>
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    x = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void add_to(float (&acc)[8]) const {
    add2(acc, 0, x.x);
    add2(acc, 2, x.y);
    add2(acc, 4, x.z);
    add2(acc, 6, x.w);
  }
  static __device__ __forceinline__ void add2(float (&acc)[8], int i, unsigned w) {
    __nv_bfloat162 h;
    memcpy(&h, &w, sizeof(h));
    const float2 f = __bfloat1622float2(h);
    acc[i] += f.x;
    acc[i + 1] += f.y;
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

// acc += rows [lo, hi) of d (rows of F elements, P packs of V).  kPerm: row r
// is d's row perm[r], and lane j's `pidx` holds perm[lo + j] (hi - lo <= 32).
// kCg: load through L2 only (partials other warps just wrote).  A group's
// rows are added in row order; U steps of loads are issued before their adds.
template <typename T, int V, int C, bool kPerm, bool kCg>
__device__ __forceinline__ void sum_rows(float (&acc)[C][V], const T* __restrict__ d, int pidx,
                                         int lo, int hi, int P, int F, const RowLanes& ln) {
  constexpr int kPackRegs = (V * static_cast<int>(sizeof(T)) + 3) / 4;
  constexpr int kByRegs = kInflightRegs / (C * kPackRegs) > 0 ? kInflightRegs / (C * kPackRegs) : 1;
  constexpr int U = kByRegs < kInflightSteps ? kByRegs : kInflightSteps;
  for (int base = lo; base < hi; base += U * ln.groups) {  // the same in every lane
    Pack<T, V> buf[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * ln.groups + ln.g;
      int row = r;
      if constexpr (kPerm) row = __shfl_sync(kFullMask, pidx, (r - lo) & 31);
      if (r < hi) {
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
      if (base + u * ln.groups + ln.g < hi) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (ln.q + c * ln.lpr < P) buf[u][c].add_to(acc[c]);
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

// o = the sum of partial rows [c0, c0 + chunks) (f32, layout (Vp, Cp) over
// 2^lpr_p lanes), in chunk order; read through L2 (other warps wrote them)
template <typename T, int Vp, int Cp>
__device__ __forceinline__ void combine_partials(const float* __restrict__ part, int c0,
                                                 int chunks, int F, int lpr_p, int lane,
                                                 T* __restrict__ o) {
  const RowLanes lp(lpr_p, lane);
  float tot[Cp][Vp];
#pragma unroll
  for (int c = 0; c < Cp; ++c)
#pragma unroll
    for (int v = 0; v < Vp; ++v) tot[c][v] = 0.f;
  sum_rows<float, Vp, Cp, false, true>(tot, part, 0, c0, c0 + chunks, F / Vp, F, lp);
  fold_groups(tot, lp);
  store_row<T>(o, tot, F / Vp, lp);
}

// The segment n in [0, N) that owns chunk slot k, i.e. the last n with
// n + p[n] / L <= k (the caller checks p[0] / L <= k < N + p[N] / L): a
// 32-way search, one load per lane per round
__device__ __forceinline__ int find_segment(const int* __restrict__ p, int N, int k, int lane) {
  int lo = 0, len = N;  // the answer lies in [lo, lo + len)
  while (len > 1) {
    const int step = (len + 31) / 32;
    const int cand = lo + lane * step;
    const bool ok = cand < lo + len && cand + p[cand] / kChunkRows <= k;
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
  __device__ __forceinline__ bool find(const int* __restrict__ p, int N, int k, int lane) {
    if (k < p[0] / kChunkRows || k >= N + p[N] / kChunkRows) return false;
    n = find_segment(p, N, k, lane);
    const int p0 = p[n], p1 = p[n + 1], t0 = p0 / kChunkRows;
    c0 = n + t0;
    chunks = 1 + p1 / kChunkRows - t0;
    const int tile = t0 + (k - c0);
    lo = max(p0, tile * kChunkRows);
    hi = min(p1, (tile + 1) * kChunkRows);
    return true;
  }
};

// Chunk sums, data in layout (Vd, Cd) over 2^lpr_d lanes, partials (f32) in
// layout (Vp, Cp) over 2^lpr_p lanes.  perm is read only when kPerm, and may
// then be null: rows in place (a plan of sorted ids).
template <typename T, int Vd, int Cd, int Vp, int Cp, bool kPerm>
__global__ void __launch_bounds__(kThreadsPerBlock)
segment_chunks_kernel(const T* __restrict__ data, const long long* __restrict__ perm,
                      const int* __restrict__ ptr, int B, int N, int S, int K, int F, int lpr_d,
                      int lpr_p, float* __restrict__ partial, int* arrivals,
                      T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (slot >= static_cast<long long>(B) * K) return;  // whole warps leave together
  const int b = static_cast<int>(slot / K);
  const int k = static_cast<int>(slot - static_cast<long long>(b) * K);
  Chunk ch;
  if (!ch.find(ptr + static_cast<long long>(b) * (N + 1), N, k, lane)) return;

  int pidx = 0;
  if constexpr (kPerm) {
    const int r = ch.lo + lane;
    pidx = perm == nullptr ? r
                           : (r < ch.hi ? static_cast<int>(perm[static_cast<long long>(b) * S + r]) : 0);
  }
  const RowLanes ld(lpr_d, lane);
  float acc[Cd][Vd];
#pragma unroll
  for (int c = 0; c < Cd; ++c)
#pragma unroll
    for (int v = 0; v < Vd; ++v) acc[c][v] = 0.f;
  sum_rows<T, Vd, Cd, kPerm, false>(acc, data + static_cast<long long>(b) * S * F, pidx, ch.lo,
                                    ch.hi, F / Vd, F, ld);
  fold_groups(acc, ld);
  T* o = out + (static_cast<long long>(b) * N + ch.n) * F;
  if (ch.chunks == 1) {
    store_row<T>(o, acc, F / Vd, ld);
    return;
  }

  float* part = partial + static_cast<long long>(b) * K * F;
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
  combine_partials<T, Vp, Cp>(part, ch.c0, ch.chunks, F, lpr_p, lane, o);
}

inline int log2_lanes(int packs) {
  int l = 0;
  while (l < 5 && (1 << l) < packs) ++l;
  return l;
}

// One launch over every chunk slot of the batch.  Rows go as 16-byte packs
// when F is a multiple of 8 and data is 16-byte aligned, else element by
// element; C, the packs a lane holds per row, is a compile-time constant.
template <typename T, bool kPerm>
int launch_segment_chunks(const void* data, const void* perm, const void* ptr, int B, int N,
                          int S, int F, void* partial, void* arrivals, void* out,
                          cudaStream_t s) {
  const int K = N + (S + kChunkRows - 1) / kChunkRows;
  const dim3 grid(row_blocks(static_cast<long long>(B) * K));
  const bool vec = F % 8 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
  constexpr int kVd = 16 / sizeof(T);
  const int packs_d = vec ? F / kVd : F, packs_p = vec ? F / 4 : F;
  const int cd = (packs_d + 31) / 32, cp = (packs_p + 31) / 32;
  const int lpr_d = log2_lanes(packs_d), lpr_p = log2_lanes(packs_p);
#define NERRF_CHUNKS_LAUNCH(VD, CD, VP, CP)                                                \
  segment_chunks_kernel<T, VD, CD, VP, CP, kPerm><<<grid, kThreadsPerBlock, 0, s>>>(       \
      static_cast<const T*>(data), static_cast<const long long*>(perm),                    \
      static_cast<const int*>(ptr), B, N, S, K, F, lpr_d, lpr_p,                            \
      static_cast<float*>(partial), static_cast<int*>(arrivals), static_cast<T*>(out))
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
