// The row copy of both gathers: out[b, e] = table[b, idx[b, e]], a zero row
// where idx is outside [0, N).  gather_rows.cu (#2) and gather_rows_sorted.cu
// (#5) are entry points into this one kernel.
//
// Replaces the TPU kernels nerrf_tpu/ops/pallas_segment.py `_gather_call`
// (body `_gather_kernel`) and `_gather_sorted_call` (body
// `_gather_sorted_kernel`).  Both build the gather as a one-hot MXU product
// (`_gather_onehot`: onehot(idx, 128 table rows) @ table tile, summed over
// the table's row tiles; the sorted one walks only the band of row tiles its
// 128 sorted ids span), because a scatter or gather serialises on the TPU's
// vector unit.  On Hopper a gather is a copy.
//
// Bound on the H100: bytes, no arithmetic: the table rows the ids touch, the
// ids and the output, over 3.35 TB/s (0.0016 ms for #2, 0.0022 for #5 at the
// training rung's [8, 1024, 160] bf16 by [8, 2048]).  Design:
// * the unit of work is a 16-byte pack of an output row (8 bf16 or 4 f32
//   values; a row of 160 bf16 is 20 packs): one thread per pack, a row's
//   packs on consecutive lanes, so a warp's loads and stores are contiguous
//   16-byte accesses.  Each thread loads its row's id once; the lanes of one
//   row read the same id (a broadcast).
// * the copy moves bits, not values: the pack type is an unsigned integer of
//   the pack's width, so the result is bit-equal to the plain version's, and
//   one kernel serves f32 and bf16.  The 16-byte layout runs where the row is
//   a multiple of 16 bytes and table and out are 16-byte aligned; otherwise
//   the 4-byte layout (4-byte rows and pointers: every f32 row), otherwise the
//   element-wise 2-byte one (a bf16 row of odd width, or a bf16 table one
//   element off alignment).  The C entry point picks the layout.
// * index math in 32 bits, one 32-bit division per pack (pack -> row).  The
//   window is the grid's y index, so no division finds it; the wrapper
//   refuses operands whose B·N·F or B·E·F reach 2^31.
// * the grid is sized from the pack count (no grid-stride loop, no cap):
//   every pack's load is independent, so one pack per thread keeps the most
//   loads in flight; the training rung is 327,680 packs, about 1.2 waves of
//   the card's resident threads.
// * plain stores: the next op reads the output at once (5.2 MB at the
//   training rung, inside the 50 MB L2).
// * sorted ids gain the copy nothing: the band the TPU needed to bound its
//   one-hot contraction is free here.  The builder's padding tail (1192
//   edges on one row per window at the training rung) reads one table row
//   over and over; L1 and L2 serve those reads.
#pragma once

#include "common.cuh"

namespace nerrf {

constexpr int kGatherThreads = 256;

// Pack: uint4 (16 bytes), unsigned (4) or unsigned short (2); P packs per row
template <typename Pack>
__global__ void __launch_bounds__(kGatherThreads)
    gather_packs_kernel(const Pack* __restrict__ table, const int* __restrict__ idx,
                        unsigned N, unsigned E, unsigned P, Pack* __restrict__ out) {
  const unsigned b = blockIdx.y;
  const unsigned g = blockIdx.x * kGatherThreads + threadIdx.x;  // pack of window b
  const unsigned EP = E * P;
  if (g >= EP) return;
  const unsigned e = g / P;
  const unsigned r = static_cast<unsigned>(__ldg(idx + b * E + e));
  Pack v{};
  if (r < N) v = table[(b * N + r) * P + (g - e * P)];
  out[b * EP + g] = v;
}

template <typename Pack>
int launch_gather_packs(const void* table, const void* idx, int B, int N, int E,
                        long long row_bytes, void* out, cudaStream_t stream) {
  const unsigned P = static_cast<unsigned>(row_bytes / sizeof(Pack));
  const unsigned packs = static_cast<unsigned>(E) * P;
  const dim3 grid((packs + kGatherThreads - 1) / kGatherThreads, static_cast<unsigned>(B));
  gather_packs_kernel<Pack><<<grid, kGatherThreads, 0, stream>>>(
      static_cast<const Pack*>(table), static_cast<const int*>(idx), static_cast<unsigned>(N),
      static_cast<unsigned>(E), P, static_cast<Pack*>(out));
  return static_cast<int>(cudaGetLastError());
}

// table [B,N,F] (f32 or bf16), idx [B,E] int32, out [B,E,F] in table's type;
// B·N·F and B·E·F below 2^31, B at most 65535.  Returns cudaGetLastError().
inline int gather_rows(const void* table, int dtype, const void* idx, int B, int N, int E,
                       int F, void* out, void* stream) {
  const int elt = dtype == kFloat32 ? 4 : dtype == kBFloat16 ? 2 : 0;
  if (elt == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long row_bytes = static_cast<long long>(F) * elt;
  const auto fits = [&](unsigned align) {
    return row_bytes % align == 0 && reinterpret_cast<uintptr_t>(table) % align == 0 &&
           reinterpret_cast<uintptr_t>(out) % align == 0;
  };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fits(16)) return launch_gather_packs<uint4>(table, idx, B, N, E, row_bytes, out, s);
  if (fits(4)) return launch_gather_packs<unsigned>(table, idx, B, N, E, row_bytes, out, s);
  return launch_gather_packs<unsigned short>(table, idx, B, N, E, row_bytes, out, s);
}

}  // namespace nerrf
