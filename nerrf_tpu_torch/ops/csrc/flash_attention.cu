// Exact softmax attention over [B, T, H, D], causal or not: a forward that
// keeps the scores on chip (online softmax) and a backward of two kernels
// that recompute them from the forward's row log-sum-exp.
//
// Replaces the reference's XLA attention, nerrf_tpu/parallel/ring.py
// `_attention_local` (reached through `ring_self_attention` at sp = 1): the
// materialised f32 softmax for T <= 1024, above it a blockwise scan with an
// online softmax over 512-wide key blocks, each block update rematerialised.
// It is no Pallas kernel; on the TPU XLA fuses it.
//
// Bound: operations.  At StreamNet's shapes (D = 128, T = 1024-4096) the two
// products cost 4·T²·D/2 flops a (b, h) causal forward against 8·T·D bytes
// of bf16 Q, K, V and O, hundreds of flops a byte, past the H100's ~295.
//
// Two routes, chosen in launch() from the type and D alone (no probe, no
// fallback: a failed launch returns its error):
//  * bf16 at D = 64 and 128 (StreamNet's D is 128): attention_fwd and
//    attention_bwd_dkdv on the tensor cores (namespace hop below).  TMA
//    loads bf16 tiles, 128-byte swizzled, into shared memory; wgmma
//    (m64nNk16, f32 accumulators) reads them there.  A block is a producer
//    warpgroup (one thread, or in dK/dV one warp, issues the loads into a
//    ring of kStages stages, each with a "full" and an "empty" mbarrier; it
//    gives its registers up with setmaxnreg) and two consumer warpgroups of
//    64 rows.  Forward: query tiles of 128, key tiles of 128; S = Q·Kᵀ with
//    both operands from shared memory; the online softmax in registers, the
//    row max and sum across the four threads of an accumulator row; P
//    rounded to bf16 in registers and fed as wgmma's A operand for O += P·V
//    (the reference's blockwise path rounds it too, ring.py:110), the
//    denominator summed from the f32 P.  dK/dV: key tiles of 128, query tiles
//    of 64 streamed from the diagonal on with their log-sum-exp and Δ =
//    rowsum(dO∘O), which attention_bwd_dq writes once per row; Sᵀ = K·Qᵀ and
//    dPᵀ = V·dOᵀ from shared memory, Pᵀ and dSᵀ = Pᵀ∘(dPᵀ - Δ) in f32, rounded
//    to bf16 as the A operand of dV += Pᵀ·dO and dK += dSᵀ·Q.  O, dK and dV
//    leave through shared memory by TMA stores, which clip rows past T.
//  * float32 at every D, bf16 at D = 16 and 32, and attention_bwd_dq at
//    every type: the CUDA-core kernels below, f32 FMAs for both products
//    (every score, probability and sum f32), so the float32 parity checks
//    hold at 1e-5·(1 + Σ|terms|), which neither bf16 nor TF32 products can
//    meet.
// The CUDA-core design:
//  * tiles of 64 queries by 64 keys, 256 threads as 16 x 16; a thread owns
//    4 x 4 scores (rows ty + 16i, columns tx + 16j) and 4 rows of D / 16
//    output columns.  Tiles sit in shared memory as f32 rows padded to D + 1,
//    so the 16 threads of a half warp read 16 banks;
//  * forward: one block a (query tile, b, h); K and then V of a key tile
//    take turns in one buffer; scores scaled, masked (keys past T, and keys
//    after the query when causal), the running max, the denominator and the
//    output rescaled per key tile; writes O in the input type and the row
//    log-sum-exp m + log(l) in f32.  Causal blocks stop at the diagonal
//    tile, so no tile wholly in the future is read; the grid runs the
//    longest rows first;
//  * backward: dS = P o (dP - rowsum(dO o O)), P recomputed as
//    exp(scale·q·k - lse).  attention_bwd_dq: one block a query tile, over
//    the key tiles it sees, dQ += dS·K·scale; it also writes the tile's
//    rowsum(dO o O) (Δ) for the tensor-core dK/dV.  attention_bwd_dkdv: one
//    block a key tile, over the query tiles that see it, dV += Pᵀ·dO and
//    dK += dSᵀ·Q·scale.
// Each output element has one writer and every sum a fixed order on both
// routes: no atomics, so two runs give the same bits.
#include <cuda.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace nerrf {
namespace attn {

constexpr int kTile = 64;                 // queries, and keys, per tile
constexpr int kSide = 16;                 // threads per side of the 16 x 16 block
constexpr int kThreads = kSide * kSide;
constexpr int kRows = kTile / kSide;      // tile rows (and columns) per thread
constexpr int kPRow = kTile + 1;          // padded row of a score tile

struct Layout {  // element strides of a [B, T, H, D] operand (D's is 1)
  long long sb, st, sh;
  __device__ __forceinline__ long long base(int b, int h) const { return b * sb + h * sh; }
};

// rows [t0, t0 + kTile) of one (b, h) into s[kTile][D + 1] as f32, zero rows
// past T
template <typename Elem, int D>
__device__ __forceinline__ void load_tile(float* s, const Elem* x, long long base,
                                          long long st, int t0, int T) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D, t = t0 + r;
    s[r * (D + 1) + d] = t < T ? to_f32(x[base + t * st + d]) : 0.f;
  }
}

// rowsum(dO o O) of rows [t0, t0 + kTile), four threads a row in a fixed
// order, and the rows' log-sum-exp (0 past T)
template <typename Elem, int D>
__device__ __forceinline__ void load_row_terms(float* delta, float* lse_s, const Elem* o,
                                               const Elem* dout, Layout ol, int b, int h,
                                               int H, const float* lse, int t0, int T) {
  const int r = threadIdx.x / 4, part = threadIdx.x % 4, t = t0 + r;
  float acc = 0.f;
  if (t < T) {
    const long long row = ol.base(b, h) + t * ol.st;
    for (int d = part; d < D; d += 4)
      acc = fmaf(to_f32(dout[row + d]), to_f32(o[row + d]), acc);
  }
  acc += __shfl_xor_sync(kFullMask, acc, 1);
  acc += __shfl_xor_sync(kFullMask, acc, 2);
  if (part == 0) {
    delta[r] = acc;
    lse_s[r] = t < T ? lse[((long long)b * H + h) * T + t] : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = kSide / 2; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = kSide / 2; off; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// s[i][j] += a[row i]·b[row j] over D, a and b tiles of padded rows; the
// thread's rows of a are ty + 16i, its rows of b tx + 16j
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[kRows][kRows], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[kRows], y[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) x[i] = a[(ty + kSide * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kRows; ++j) y[j] = b[(tx + kSide * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// acc[i][c] += Σ_kk p[row ty + 16i][kk] · x[kk][tx + 16c], p a score tile,
// x a tile of padded rows
template <int D>
__device__ __forceinline__ void tile_apply(float (&acc)[kRows][D / kSide], const float* p,
                                           const float* x, int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kTile; ++kk) {
    float w[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) w[i] = p[(ty + kSide * i) * kPRow + kk];
#pragma unroll
    for (int c = 0; c < D / kSide; ++c) {
      const float xv = x[kk * (D + 1) + tx + kSide * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(w[i], xv, acc[i][c]);
    }
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int T, int causal) {
  return qi < T && kj < T && (!causal || kj <= qi);
}

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                     const Elem* __restrict__ v, Layout in, Layout ol, int T, int H,
                     int causal, float scale, Elem* __restrict__ o,
                     float* __restrict__ lse) {
  extern __shared__ float smem[];
  constexpr int C = D / kSide;
  float* sQ = smem;
  float* sKV = sQ + kTile * (D + 1);
  float* sP = sKV + kTile * (D + 1);
  const int nq = (T + kTile - 1) / kTile;
  const int qt = nq - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const long long base = in.base(b, h);
  const int q0 = qt * kTile;
  load_tile<Elem, D>(sQ, q, base, in.st, q0, T);

  float acc[kRows][C], m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }
  const int nk = causal ? qt + 1 : nq;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's reads of sKV (V) and sP are done
    load_tile<Elem, D>(sKV, k, base, in.st, k0, T);
    __syncthreads();
    float s[kRows][kRows] = {};
    tile_dot<D>(s, sQ, sKV, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + kSide * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int kj = k0 + tx + kSide * j;
        // every row sees key k0 of each tile it visits (k0 <= q0 < T), so
        // the row max is finite and exp(-inf - max) is 0
        s[i][j] = (kj < T && (!causal || kj <= qi)) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < kRows; ++j) sP[(ty + kSide * i) * kPRow + tx + kSide * j] = s[i][j];
    }
    __syncthreads();  // every read of K is done and sP is whole
    load_tile<Elem, D>(sKV, v, base, in.st, k0, T);
    __syncthreads();
    tile_apply<D>(acc, sP, sKV, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kSide * i;
    if (qi >= T) continue;
    const long long row = ol.base(b, h) + qi * ol.st;
#pragma unroll
    for (int c = 0; c < C; ++c) o[row + tx + kSide * c] = from_f32<Elem>(acc[i][c] / l[i]);
    if (tx == 0) lse[((long long)b * H + h) * T + qi] = m[i] + logf(l[i]);
  }
}

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                        const Elem* __restrict__ v, Layout in, const Elem* __restrict__ o,
                        const Elem* __restrict__ dout, Layout ol,
                        const float* __restrict__ lse, int T, int H, int causal,
                        float scale, Elem* __restrict__ dq, float* __restrict__ delta) {
  extern __shared__ float smem[];
  constexpr int C = D / kSide;
  float* sQ = smem;
  float* sdO = sQ + kTile * (D + 1);
  float* sK = sdO + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sS = sV + kTile * (D + 1);
  float* sDelta = sS + kTile * kPRow;
  float* sLse = sDelta + kTile;
  const int nq = (T + kTile - 1) / kTile;
  const int qt = nq - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const long long base = in.base(b, h);
  const int q0 = qt * kTile;
  load_tile<Elem, D>(sQ, q, base, in.st, q0, T);
  load_tile<Elem, D>(sdO, dout, ol.base(b, h), ol.st, q0, T);
  load_row_terms<Elem, D>(sDelta, sLse, o, dout, ol, b, h, H, lse, q0, T);
  __syncthreads();
  if (threadIdx.x < kTile && q0 + threadIdx.x < T)
    delta[((long long)b * H + h) * T + q0 + threadIdx.x] = sDelta[threadIdx.x];

  float acc[kRows][C] = {};
  const int nk = causal ? qt + 1 : nq;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's reads of sK and sS are done
    load_tile<Elem, D>(sK, k, base, in.st, k0, T);
    load_tile<Elem, D>(sV, v, base, in.st, k0, T);
    __syncthreads();
    float s[kRows][kRows] = {}, dp[kRows][kRows] = {};
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int c = tx + kSide * j;
        const float p = visible(q0 + r, k0 + c, T, causal)
                            ? expf(s[i][j] * scale - sLse[r]) : 0.f;
        sS[r * kPRow + c] = p * (dp[i][j] - sDelta[r]);
      }
    }
    __syncthreads();
    tile_apply<D>(acc, sS, sK, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kSide * i;
    if (qi >= T) continue;
    const long long row = ol.base(b, h) + qi * ol.st;
#pragma unroll
    for (int c = 0; c < C; ++c) dq[row + tx + kSide * c] = from_f32<Elem>(acc[i][c] * scale);
  }
}

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                          const Elem* __restrict__ v, Layout in, const Elem* __restrict__ o,
                          const Elem* __restrict__ dout, Layout ol,
                          const float* __restrict__ lse, int T, int H, int causal,
                          float scale, Elem* __restrict__ dk, Elem* __restrict__ dv) {
  extern __shared__ float smem[];
  constexpr int C = D / kSide;
  float* sK = smem;
  float* sV = sK + kTile * (D + 1);
  float* sQ = sV + kTile * (D + 1);
  float* sdO = sQ + kTile * (D + 1);
  float* sP = sdO + kTile * (D + 1);
  float* sdS = sP + kTile * kPRow;
  float* sDelta = sdS + kTile * kPRow;
  float* sLse = sDelta + kTile;
  const int nq = (T + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // causal: the first key tiles are seen by the most rows
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const long long base = in.base(b, h);
  const int k0 = kt * kTile;
  load_tile<Elem, D>(sK, k, base, in.st, k0, T);
  load_tile<Elem, D>(sV, v, base, in.st, k0, T);

  float acc_k[kRows][C] = {}, acc_v[kRows][C] = {};
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the last tile's reads of sQ, sdO, sP, sdS and the row terms are done
    load_tile<Elem, D>(sQ, q, base, in.st, q0, T);
    load_tile<Elem, D>(sdO, dout, ol.base(b, h), ol.st, q0, T);
    load_row_terms<Elem, D>(sDelta, sLse, o, dout, ol, b, h, H, lse, q0, T);
    __syncthreads();
    // transposed tiles: rows are keys (ty + 16i), columns queries (tx + 16j)
    float s[kRows][kRows] = {}, dp[kRows][kRows] = {};
    tile_dot<D>(s, sK, sQ, ty, tx);
    tile_dot<D>(dp, sV, sdO, ty, tx);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int c = tx + kSide * j;
        const float p = visible(q0 + c, k0 + r, T, causal)
                            ? expf(s[i][j] * scale - sLse[c]) : 0.f;
        sP[r * kPRow + c] = p;
        sdS[r * kPRow + c] = p * (dp[i][j] - sDelta[c]);
      }
    }
    __syncthreads();
    tile_apply<D>(acc_v, sP, sdO, ty, tx);
    tile_apply<D>(acc_k, sdS, sQ, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kj = k0 + ty + kSide * i;
    if (kj >= T) continue;
    const long long row = ol.base(b, h) + kj * ol.st;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[row + tx + kSide * c] = from_f32<Elem>(acc_k[i][c] * scale);
      dv[row + tx + kSide * c] = from_f32<Elem>(acc_v[i][c]);
    }
  }
}

// ---- the tensor-core route: bf16 at D = 64 and 128 ----------------------
//
// Tiles live in shared memory as TMA writes them: slabs of 64 bf16 columns
// (128 bytes a row, 128-byte swizzle), one slab per 64 columns of D, rows
// in boxes of kBox.  A block is one producer warpgroup (in the forward one
// thread, in dK/dV the first warp, does the loading; it gives its registers
// to the consumers) and two consumer warpgroups, each the owner of 64 rows
// of the block's tile.
namespace hop {

using namespace nerrf::sm90;

constexpr int kBox = 64;                    // rows of a TMA box, and of a consumer's share
constexpr int kBoxBytes = kBox * 128;       // one box of one slab
constexpr int kThreads = 384;               // producer warpgroup + two consumer warpgroups
constexpr int kStages = 2;                  // the ring of streamed tiles
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// accumulator element i of a thread of an m64nN product: row (of the
// warpgroup's 64) warp·16 + lane/4 + 8·((i/2)%2), column 8·(i/4) + 2·(lane%4)
// + i%2
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
}
__device__ __forceinline__ int acc_half(int i) { return (i / 2) % 2; }

// rows [t0, t0 + nbox·kBox) of every slab of one (b, h) into ``dst`` (slab
// after slab, each nbox·kBoxBytes), completing on ``bar``
template <int D>
__device__ __forceinline__ void load_rows(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                          int nbox, int t0, int h, int b) {
#pragma unroll
  for (int s = 0; s < D / 64; ++s)
    for (int r = 0; r < nbox; ++r)
      tma_load(dst + (s * nbox + r) * kBoxBytes, map, bar, 64 * s, t0 + r * kBox, h, b);
}

// an m64nD accumulator times one factor per row half, as bf16, into a
// warpgroup's 64 rows of a tile (``region``: row 0 of slab 0; slabs
// ``slab_bytes`` apart), in the 128-byte swizzle, then stored by TMA at
// rows [t0, t0 + 64): the store clips rows past T
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], const float (&f)[2],
                                           uint32_t region, uint32_t slab_bytes,
                                           const CUtensorMap* map, int t0, int h, int b,
                                           int wg_barrier) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = warp * 16 + lane / 4 + 8 * e;  // row % 8 == lane / 4
      st_shared(region + (j / 8) * slab_bytes + row * 128 + (((j % 8) ^ (lane / 4)) << 4) +
                    4 * (lane % 4),
                pack_bf16(acc[4 * j + 2 * e] * f[e], acc[4 * j + 2 * e + 1] * f[e]));
    }
  fence_async_shared();
  warpgroup_sync(wg_barrier);
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < D / 64; ++s) tma_store(map, region + s * slab_bytes, 64 * s, t0, h, b);
    tma_store_drain();
  }
}

// Forward: one block a (query tile of 128 rows, b, h), the longest causal
// rows first.  The producer loads Q once, then K and V tiles of 128 keys
// into the ring; each consumer warpgroup runs S = Q·Kᵀ (m64n128k16, both
// operands K-major in shared memory), the online softmax in registers, and
// O += P·V with P rounded to bf16 in registers (the accumulator's layout is
// the A operand's) and V MN-major.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_sm90(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                   int T, int H, int causal, float scale, float* __restrict__ lse) {
  constexpr int kTile = 2 * kBoxBytes * (D / 64);  // 128 rows, every slab
  constexpr int kSlab = 2 * kBoxBytes;             // one slab of 128 rows
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + kTile;  // stage s: K at sKV + 2s·kTile, V after it
  const uint32_t bars = sKV + 2 * kStages * kTile;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int nq = (T + 127) / 128;
  const int qt = nq - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = qt * 128;
  const int nk = causal ? qt + 1 : nq;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_shrink<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect(q_full, kTile);
      load_rows<D>(&mq, sQ, q_full, 2, q0, h, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect(full(s), 2 * kTile);
        load_rows<D>(&mk, sKV + 2 * s * kTile, full(s), 2, kt * 128, h, b);
        load_rows<D>(&mv, sKV + (2 * s + 1) * kTile, full(s), 2, kt * 128, h, b);
      }
    }
    return;
  }
  regs_grow<kConsumerRegs>();
  const int cw = wg - 1;  // rows [q0 + 64·cw, +64) of the tile
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row0 = q0 + 64 * cw + 16 * warp + lane / 4;  // element rows row0, row0 + 8
  const float c = scale * kLog2e;
  const uint32_t qa = sQ + cw * kBoxBytes;
  float o[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  mbar_wait(q_full, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    const uint32_t sK = sKV + 2 * s * kTile, sV = sK + kTile;
    mbar_wait(full(s), (kt / kStages) & 1);
    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kSlab + (kk % 4) * 32;
      wgmma_ss(sc, desc_sw128(qa + off, 0, 1024), desc_sw128(sK + off, 0, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    const int k0 = kt * 128;
    if ((causal && kt == qt) || k0 + 128 > T) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int kj = k0 + acc_col(i, lane), qi = row0 + 8 * acc_half(i);
        if (kj >= T || (causal && kj > qi)) sc[i] = -INFINITY;
      }
    }
    // every row sees key k0 of each tile it visits (k0 <= q0), so the new
    // max is finite and exp2(-inf) is 0
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[acc_half(i)] = fmaxf(mx[acc_half(i)], sc[i]);
    float alpha[2], mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(kFullMask, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(kFullMask, mx[e], 2));
      alpha[e] = exp2_approx((m[e] - mx[e]) * c);
      m[e] = mx[e];
      mc[e] = mx[e] * c;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = exp2_approx(fmaf(sc[i], c, -mc[acc_half(i)]));
      sum[acc_half(i)] += sc[i];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sum[e] += __shfl_xor_sync(kFullMask, sum[e], 1);
      sum[e] += __shfl_xor_sync(kFullMask, sum[e], 2);
      l[e] = l[e] * alpha[e] + sum[e];  // from the f32 probabilities
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[acc_half(i)];
    uint32_t p[32];  // k-block kk of P·V takes p[4kk .. 4kk + 3]
#pragma unroll
    for (int j = 0; j < 32; ++j) p[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs(o, &p[4 * kk], desc_sw128(sV + kk * 16 * 128, kSlab, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p);
    if (t == 0) mbar_arrive(empty(s));
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  store_rows<D>(o, inv, qa, kSlab, &mo, q0 + 64 * cw, h, b, 1 + cw);
  if (lane % 4 == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (row0 + 8 * e < T)
        lse[((long long)b * H + h) * T + row0 + 8 * e] = m[e] * scale + logf(l[e]);
  }
}

// dK and dV: one block a (key tile of 128 keys, b, h), over the query tiles
// of 64 that see it, from the diagonal on.  The producer loads K and V
// once, then Q and dO tiles into the ring with their rows' log-sum-exp
// (times log2 e; +inf past T) and Δ = rowsum(dO∘O) (attention_bwd_dq wrote
// it).  Each consumer warpgroup (64 keys) runs Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
// (m64n64k16 from shared memory), Pᵀ = exp(scale·Sᵀ - lse) and dSᵀ = Pᵀ∘(dPᵀ
// - Δ) in registers, then dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ
// rounded to bf16 as the register A operand, dO and Q MN-major.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const __grid_constant__ CUtensorMap mdo,
                        const __grid_constant__ CUtensorMap mdk,
                        const __grid_constant__ CUtensorMap mdv, const float* __restrict__ lse,
                        const float* __restrict__ delta, int T, int H, int causal, float scale) {
  constexpr int kTile = 2 * kBoxBytes * (D / 64);  // 128 keys, every slab
  constexpr int kSlab = 2 * kBoxBytes;
  constexpr int kQ = kBoxBytes * (D / 64);         // 64 queries, every slab
  constexpr int kStage = 2 * kQ + 1024;            // Q, dO, then lse and Δ (64 floats each)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + kTile;
  const uint32_t stages = sV + kTile;  // stage s at stages + s·kStage
  const uint32_t bars = stages + kStages * kStage;
  float* rows_base = reinterpret_cast<float*>(smem_raw + (stages + 2 * kQ - smem_addr(smem_raw)));
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + kStages + s); };

  const int nq = (T + kBox - 1) / kBox;
  const int kt = blockIdx.x;  // causal: the first key tiles are seen by the most rows
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const long long bh = (long long)b * H + h;
  const int k0 = kt * 128;
  const int first = causal ? k0 / kBox : 0;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes (lane 0 with the bytes)
      mbar_init(empty(s), 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_shrink<kProducerRegs>();
    const int lane = threadIdx.x;
    if (lane < 32) {
      if (lane == 0) {
        mbar_arrive_expect(kv_full, 2 * kTile);
        load_rows<D>(&mk, sK, kv_full, 2, k0, h, b);
        load_rows<D>(&mv, sV, kv_full, 2, k0, h, b);
      }
      for (int qt = first, i = 0; qt < nq; ++qt, ++i) {
        const int s = i % kStages, q0 = qt * kBox;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        float* rows = rows_base + s * (kStage / 4);
#pragma unroll
        for (int j = lane; j < kBox; j += 32) {
          const bool in = q0 + j < T;
          rows[j] = in ? lse[bh * T + q0 + j] * kLog2e : INFINITY;
          rows[kBox + j] = in ? delta[bh * T + q0 + j] : 0.f;
        }
        if (lane == 0) {
          const uint32_t sQ = stages + s * kStage;
          mbar_arrive_expect(full(s), 2 * kQ);
          load_rows<D>(&mq, sQ, full(s), 1, q0, h, b);
          load_rows<D>(&mdo, sQ + kQ, full(s), 1, q0, h, b);
        } else {
          mbar_arrive(full(s));
        }
      }
    }
    return;
  }
  regs_grow<kConsumerRegs>();
  const int cw = wg - 1;  // keys [k0 + 64·cw, +64)
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int kw = k0 + 64 * cw;
  const int key0 = kw + 16 * warp + lane / 4;  // element rows key0, key0 + 8
  const float c = scale * kLog2e;
  const uint32_t ka = sK + cw * kBoxBytes, va = sV + cw * kBoxBytes;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);
  for (int qt = first, i = 0; qt < nq; ++qt, ++i) {
    const int s = i % kStages, q0 = qt * kBox;
    const uint32_t sQ = stages + s * kStage, sdO = sQ + kQ;
    const float* rows = rows_base + s * (kStage / 4);
    mbar_wait(full(s), (i / kStages) & 1);
    if (!causal || q0 + kBox > kw) {  // else every query of the tile precedes every key
      // K's and V's descriptors are the same every tile: made anew from an
      // opaque copy of the address, so that the compiler does not keep all
      // 2·D/16 of them in registers across the loop beside dK and dV
      uint32_t kva = ka;
      asm volatile("" : "+r"(kva));
      float st[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kSlab + (kk % 4) * 32;
        const uint32_t offq = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss(st, desc_sw128(kva + off, 0, 1024), desc_sw128(sQ + offq, 0, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = kTile + (kk / 4) * kSlab + (kk % 4) * 32;  // V after K
        const uint32_t offq = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss(dp, desc_sw128(kva + off, 0, 1024), desc_sw128(sdO + offq, 0, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dp);
      const bool diag = causal && q0 < kw + 64;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        // the row terms are read where they are used (volatile loads): the
        // compiler would otherwise hold all 32 across the products and
        // spill beside dK and dV at D = 128
        const int col = acc_col(j, lane);
        const float lse2 = ld_shared(smem_addr(rows + col));
        const float dl = ld_shared(smem_addr(rows + kBox + col));
        float p = exp2_approx(fmaf(st[j], c, -lse2));
        if (diag && q0 + col < key0 + 8 * acc_half(j)) p = 0.f;
        dp[j] = p * (dp[j] - dl);
        st[j] = p;
      }
      uint32_t pa[16], da[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        pa[j] = pack_bf16(st[2 * j], st[2 * j + 1]);
        da[j] = pack_bf16(dp[2 * j], dp[2 * j + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk)
        wgmma_rs(dv, &pa[4 * kk], desc_sw128(sdO + kk * 16 * 128, kBoxBytes, 1024));
#pragma unroll
      for (int kk = 0; kk < kBox / 16; ++kk)
        wgmma_rs(dk, &da[4 * kk], desc_sw128(sQ + kk * 16 * 128, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);
    }
    if (t == 0) mbar_arrive(empty(s));
  }
  const float fk[2] = {scale, scale}, fv[2] = {1.f, 1.f};
  store_rows<D>(dk, fk, ka, kSlab, &mdk, kw, h, b, 1 + cw);
  store_rows<D>(dv, fv, va, kSlab, &mdv, kw, h, b, 1 + cw);
}

}  // namespace hop

constexpr size_t fwd_smem(int D) { return sizeof(float) * (2 * kTile * (D + 1) + kTile * kPRow); }
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kPRow + 2 * kTile);
}
constexpr size_t dkdv_smem(int D) {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kPRow + 2 * kTile);
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  float* delta;  // rowsum(dO o O) [B, H, T]: dQ writes it, the tensor-core dK/dV reads it
  void *out0, *out1;
  Layout in, ol;
  int B, T, H, causal;
  float scale;
};

enum Entry { kFwd = 0, kDq = 1, kDkdv = 2 };

// ---- the tensor-core route's host side: TMA tensor maps, encoded on each call

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, reached through the runtime so the
// library needs no -lcuda; null when the driver has none
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a bf16 [B, T, H, D] operand with element strides l (D's 1) as a 4-D map
// (D, T, H, B) of boxes of 64 columns by kBox rows, 128-byte swizzled; TMA
// fills rows past T with zeros on loads and drops them on stores
bool tensor_map(CUtensorMap* map, const void* ptr, const Layout& l, int B, int T, int H, int D) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)l.st * 2, (cuuint64_t)l.sh * 2,
                                 (cuuint64_t)l.sb * 2};
  const cuuint32_t box[4] = {64, hop::kBox, 1, 1}, unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
constexpr int hop_fwd_smem() {
  return 1024 + 2 * hop::kBoxBytes * (D / 64) * (1 + 2 * hop::kStages) + 8 * (1 + 2 * hop::kStages);
}
template <int D>
constexpr int hop_dkdv_smem() {
  return 1024 + 2 * hop::kBoxBytes * (D / 64) * 2 +
         hop::kStages * (2 * hop::kBoxBytes * (D / 64) + 1024) + 8 * (1 + 2 * hop::kStages);
}

// attention_fwd or attention_bwd_dkdv of bf16 at D = 64 or 128
template <int D>
int launch_hopper(Entry which, const Args& a, cudaStream_t stream) {
  // q, k, v, then the first output (O, or dK) and, for dK/dV, dO and dV
  CUtensorMap mq, mk, mv, mout0, mdo, mout1;
  if (!tensor_map(&mq, a.q, a.in, a.B, a.T, a.H, D) ||
      !tensor_map(&mk, a.k, a.in, a.B, a.T, a.H, D) ||
      !tensor_map(&mv, a.v, a.in, a.B, a.T, a.H, D) ||
      !tensor_map(&mout0, a.out0, a.ol, a.B, a.T, a.H, D))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.T + 127) / 128, a.B * a.H);
  if (which == kFwd) {
    auto kern = hop::attention_fwd_sm90<D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, hop_fwd_smem<D>());
    kern<<<grid, hop::kThreads, hop_fwd_smem<D>(), stream>>>(
        mq, mk, mv, mout0, a.T, a.H, a.causal, a.scale, static_cast<float*>(a.out1));
  } else {
    if (!tensor_map(&mdo, a.dout, a.ol, a.B, a.T, a.H, D) ||
        !tensor_map(&mout1, a.out1, a.ol, a.B, a.T, a.H, D))
      return (int)cudaErrorInvalidValue;
    auto kern = hop::attention_bwd_dkdv_sm90<D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, hop_dkdv_smem<D>());
    kern<<<grid, hop::kThreads, hop_dkdv_smem<D>(), stream>>>(
        mq, mk, mv, mdo, mout0, mout1, static_cast<const float*>(a.lse), a.delta, a.T, a.H,
        a.causal, a.scale);
  }
  return (int)cudaGetLastError();
}

// bf16 at D = 64 and 128 runs its forward and dK/dV on the tensor cores
template <typename Elem, int D>
constexpr bool tensor_core_route() {
  return std::is_same<Elem, __nv_bfloat16>::value && (D == 64 || D == 128);
}

template <typename Elem, int D>
int launch(Entry which, const Args& a, cudaStream_t stream) {
  const int nt = (a.T + kTile - 1) / kTile;
  const dim3 grid(nt, a.B * a.H);
  const Elem *q = static_cast<const Elem*>(a.q), *k = static_cast<const Elem*>(a.k),
             *v = static_cast<const Elem*>(a.v), *o = static_cast<const Elem*>(a.o),
             *dout = static_cast<const Elem*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  if (which == kDq) {
    auto kern = attention_bwd_dq_kernel<Elem, D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem(D));
    kern<<<grid, kThreads, dq_smem(D), stream>>>(q, k, v, a.in, o, dout, a.ol, lse, a.T, a.H,
                                                 a.causal, a.scale,
                                                 static_cast<Elem*>(a.out0), a.delta);
  } else if constexpr (tensor_core_route<Elem, D>()) {
    return launch_hopper<D>(which, a, stream);
  } else if (which == kFwd) {
    auto kern = attention_fwd_kernel<Elem, D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fwd_smem(D));
    kern<<<grid, kThreads, fwd_smem(D), stream>>>(q, k, v, a.in, a.ol, a.T, a.H, a.causal,
                                                  a.scale, static_cast<Elem*>(a.out0),
                                                  static_cast<float*>(a.out1));
  } else {
    auto kern = attention_bwd_dkdv_kernel<Elem, D>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkdv_smem(D));
    kern<<<grid, kThreads, dkdv_smem(D), stream>>>(q, k, v, a.in, o, dout, a.ol, lse, a.T,
                                                   a.H, a.causal, a.scale,
                                                   static_cast<Elem*>(a.out0),
                                                   static_cast<Elem*>(a.out1));
  }
  return (int)cudaGetLastError();
}

template <typename Elem>
int dispatch_d(Entry which, int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<Elem, 16>(which, a, stream);
    case 32: return launch<Elem, 32>(which, a, stream);
    case 64: return launch<Elem, 64>(which, a, stream);
    case 128: return launch<Elem, 128>(which, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(Entry which, int dtype, int D, const Args& a, void* stream) {
  if (a.T <= 0 || a.B * a.H <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_d<float>(which, D, a, s);
  if (dtype == kBFloat16) return dispatch_d<__nv_bfloat16>(which, D, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace attn
}  // namespace nerrf

using nerrf::attn::Args;
using nerrf::attn::Layout;

// q, k, v [B,T,H,D] (f32 or bf16, strides sb/st/sh, D contiguous) -> o
// [B,T,H,D] contiguous in their type, lse [B,H,T] f32.  Returns
// cudaGetLastError(); D other than 16, 32, 64, 128 -> cudaErrorInvalidValue.
// bf16 at D = 64 or 128 (the tensor-core route) reads and writes through TMA:
// every base 16-byte aligned, every stride a multiple of 16 bytes.
extern "C" int nerrf_attention_fwd(const void* q, const void* k, const void* v, int dtype,
                                   long long sb, long long st, long long sh, int B, int T,
                                   int H, int D, int causal, float scale, void* o, void* lse,
                                   void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, o, lse,
         Layout{sb, st, sh}, Layout{(long long)T * H * D, (long long)H * D, D},
         B, T, H, causal, scale};
  return nerrf::attn::run(nerrf::attn::kFwd, dtype, D, a, stream);
}

// o, dout contiguous [B,T,H,D], lse [B,H,T] f32 from the forward -> dq
// contiguous [B,T,H,D] and delta [B,H,T] f32, rowsum(dout o o)
extern "C" int nerrf_attention_bwd_dq(const void* q, const void* k, const void* v, int dtype,
                                      long long sb, long long st, long long sh, const void* o,
                                      const void* dout, const void* lse, void* delta, int B,
                                      int T, int H, int D, int causal, float scale, void* dq,
                                      void* stream) {
  Args a{q, k, v, o, dout, lse, static_cast<float*>(delta), dq, nullptr,
         Layout{sb, st, sh}, Layout{(long long)T * H * D, (long long)H * D, D},
         B, T, H, causal, scale};
  return nerrf::attn::run(nerrf::attn::kDq, dtype, D, a, stream);
}

// as nerrf_attention_bwd_dq, delta from it (read by the tensor-core route) ->
// dk, dv contiguous [B,T,H,D]
extern "C" int nerrf_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                        int dtype, long long sb, long long st, long long sh,
                                        const void* o, const void* dout, const void* lse,
                                        void* delta, int B, int T, int H, int D, int causal,
                                        float scale, void* dk, void* dv, void* stream) {
  Args a{q, k, v, o, dout, lse, static_cast<float*>(delta), dk, dv,
         Layout{sb, st, sh}, Layout{(long long)T * H * D, (long long)H * D, D},
         B, T, H, causal, scale};
  return nerrf::attn::run(nerrf::attn::kDkdv, dtype, D, a, stream);
}

// the dynamic shared memory a launch of the tensor-core entry ``entry`` (0
// forward, 2 dK/dV) asks for at head width D (64 or 128); 0 for others
extern "C" int nerrf_attention_smem(int entry, int D) {
  namespace na = nerrf::attn;
  if (D != 64 && D != 128) return 0;
  if (entry == na::kFwd) return D == 64 ? na::hop_fwd_smem<64>() : na::hop_fwd_smem<128>();
  if (entry == na::kDkdv) return D == 64 ? na::hop_dkdv_smem<64>() : na::hop_dkdv_smem<128>();
  return 0;
}
