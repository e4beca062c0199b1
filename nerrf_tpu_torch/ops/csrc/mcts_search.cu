// The undo planner's whole PUCT search, select -> expand -> evaluate ->
// backup, for `num_sims` simulations in one launch: one thread block per
// search tree, resumable across launches.
//
// Replaces the XLA program nerrf_tpu/planner/device_mcts.py `search_chunk`
// (:205), the counterpart of one `DeviceMCTS.plan()` chunk, and its vmap over
// incidents nerrf_tpu/respond/planner.py `_batched_programs` (:64): gridDim =
// B trees, one per incident.  It is not the port of a Pallas kernel.
//
// What bounds it: a chain of dependent steps.  Simulations are sequential; a
// simulation descends level by level, and each level's argmax over the
// node's A actions names the next node to read; then one leaf's step, its 8
// features and its value, then the backup of the path.  The bytes are few:
// latency sets the time, not bandwidth or arithmetic.  Two entries, the
// route fixed by the shape alone (ops/mcts.py `search_route`):
//
// * `mcts_search_resident_kernel`, the main one.  For the launch the
//   working set of select and backup lives in shared memory: each node's
//   visit count and value sum, its select terms as `ucb` forms them
//   (sqrt of the visits, Q and the edge reward on the PUCT scale, updated
//   when the backup changes them), its flags, the edge reward into it and
//   a bitmask of its legal actions (from its state floats, s[j] < 0.5 and
//   the open flag, set once when the node is made).  At a select level each
//   thread scores its own actions (c_puct·prior in registers): one
//   coalesced read of the node's row of `children` in device memory, the
//   rest from shared memory.  Each warp takes its argmax with two
//   `redux.sync`, the winner's child index riding in the low bits of the
//   second, then one barrier and every thread merges the eight warp
//   winners as a tree (double-buffered, so no second barrier).  Expand
//   reads the parent's state row once a simulation, prefetched into L1
//   while the descent goes on; warp 0 sums the live processes and the
//   leaf's features as halving trees with lane l holding elements l + 32k
//   (in-lane adds for the upper levels, then shuffles: the same additions
//   as the plain version's), and computes the reward and the heuristic
//   value; the other seven warps write the leaf's state row and its legal
//   mask.  The value net runs on the whole block.  Warp 0 backs up the
//   path, the edge rewards added leaf to root one at a time.  The tree
//   arrays in device memory stay the output: each new node is written
//   through at expand, visits and value sums at the end.  About L + 1
//   barriers a simulation of L levels (L + 3 with the value net).
// * `mcts_search_kernel`, the first design, for shapes whose working set
//   does not fit in a block's shared memory: the tree in device memory, 256
//   threads a tree and `__syncthreads()` between the phases.
//
// Arithmetic (shared with the plain version in ops/mcts.py, so the two agree
// bit for bit with the heuristic value): every product and sum is rounded on
// its own (this source is built with -fmad=false); a division by a constant
// is a product with the constant's f32 reciprocal, given in `consts`, as the
// reference's XLA program computes it; a division by a runtime value is a
// true division; sums over the files and the processes (powers of two) run
// as a halving tree, x[:n/2] + x[n/2:] repeated; the argmax breaks ties to
// the lowest index.  No float atomics: two runs are bit-equal.  The value
// net (Linear 8->h, tanh GELU, Linear h->h, tanh GELU, Linear h->1) sums in
// its own order and is held to its PyTorch module within a tolerance.
//
// `mcts_chain_floor_kernel` is a yardstick, on no path: one warp walks a
// chain of argmaxes over rows of A floats in shared memory, each winner
// naming the next row, the chain of dependent steps a select level cannot
// do without.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nerrf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSharedBytes = 232448;  // 227 KB, the H100's per-block limit
// the resident entry's halving sums hold at most this many values a lane
// (Fp and Pp up to 512: more would cost the whole kernel registers)
constexpr int kLaneValues = 16;
// a thread's share of the A <= 2 * 32 * kLaneValues + 1 actions at a level
constexpr int kActs = (64 * kLaneValues + kThreads) / kThreads;
// the value net's h x h rows lie h + kPad floats apart in shared memory, so
// that the 4 threads of a unit and 8 units of a warp hit 32 banks
constexpr int kPad = 8;
constexpr uint8_t kExpanded = 1, kTerminal = 2;

// slots of `consts`, in the order of ops/mcts.py CONST_SLOTS
enum Const {
  kRevertSecondsPerMb, kFpRevertScale, kFpRevertFloorMb, kDowntimeWeight,
  kOngoingLossMbPerSec, kKillDowntimeSec, kKillCost, kFpKillFactor, kLossCapSec,
  kHeuristicHorizonSec, kRecipQScale, kRecipDowntimeScale, kRecipMaxSteps,
  kMaxSteps, kCPuct, kNumConsts
};
constexpr int kConstSlots = 16;

struct Tree {
  int* visits;          // [B, M]
  float* value_sum;     // [B, M]
  int* parent;          // [B, M]
  int* parent_action;   // [B, M]
  int* children;        // [B, M, A], -1 = unvisited
  float* child_reward;  // [B, M, A]
  uint8_t* expanded;    // [B, M]
  uint8_t* terminal;    // [B, M]
  float* state;         // [B, M, D]
  int* n_nodes;         // [B]
};

struct Ctx {
  const float* file_scores;  // [B, Fp]
  const float* file_loss;    // [B, Fp]
  const float* proc_scores;  // [B, Pp]
  const float* prior;        // [B, A]
  const float* real;         // [B, 2]
};

// --- shared pieces -------------------------------------------------------

// argmax merge: the larger score, and on equal scores the lower index
__device__ __forceinline__ void merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// `merge` carrying the candidate's child index along
__device__ __forceinline__ void merge_child(float& v, int& i, int& ch, float ov, int oi,
                                            int och) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
    ch = och;
  }
}

// A score as an unsigned key in the order of `merge`: larger floats give
// larger keys, -0 and +0 one key, NaN (which `merge` never takes) the least.
__device__ __forceinline__ unsigned order_key(float f) {
  if (f != f) return 0u;
  const unsigned u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The PUCT score of an action: its child's visits and value sum (0 and 0
// unvisited) and the reward of the edge to it
__device__ __forceinline__ float ucb(int nv, float vs, float crw, float prior, float root,
                                     const float* c) {
  float q = nv > 0 ? vs / (float)max(nv, 1) : 0.0f;
  q = q * c[kRecipQScale];
  float u = c[kCPuct] * prior;
  u = u * root;
  u = u / (1.0f + (float)nv);
  return (q + u) + crw * c[kRecipQScale];
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + k1 * x * x * x)));
}

// The value net in shared memory: the flat weights [W1 (8 x h), b1 (h),
// W2 (h x h), b2 (h), W3 (h), b3 (1)], rows in-major, with W2's rows h +
// kPad apart, then two scratch rows [h] for the hidden layers.
struct Net {
  const float* W1;
  const float* b1;
  const float* W2;
  const float* b2;
  const float* W3;
  const float* b3;
  float* h1;
  float* h2;
  int h;
};

__host__ __device__ inline int net_floats(int h) {
  return h > 0 ? h * (h + kPad) + 13 * h + 1 : 0;
}

// Copies the flat weights `w` into `dst` [net_floats(h)]; the caller syncs.
__device__ Net load_net(float* dst, const float* w, int h) {
  Net net;
  net.h = h;
  float* W1 = dst;
  float* W2 = W1 + 9 * h;  // after W1 and b1
  float* b2 = W2 + h * (h + kPad);
  net.W1 = W1;
  net.b1 = W1 + 8 * h;
  net.W2 = W2;
  net.b2 = b2;
  net.W3 = b2 + h;
  net.b3 = b2 + 2 * h;
  net.h1 = b2 + 2 * h + 1;
  net.h2 = net.h1 + h;
  if (h > 0) {
    for (int k = threadIdx.x; k < 9 * h; k += kThreads) W1[k] = w[k];
    const float* w2 = w + 9 * h;
    for (int k = threadIdx.x; k < h * h; k += kThreads) W2[(k / h) * (h + kPad) + k % h] = w2[k];
    for (int k = threadIdx.x; k < 2 * h + 1; k += kThreads) b2[k] = w2[h * h + k];
  }
  return net;
}

// The leaf value of features f[8] (the same on every lane of warp 0),
// returned on warp 0: the closed-form heuristic, or the value net by the
// whole block (layer 1 on warp 0; layer 2 on every thread, 4 a unit, their
// partial sums combined by shuffles; layer 3 on warp 0).  Every thread of
// the block calls it; with the value net it holds two barriers.
__device__ __forceinline__ float leaf_value(const float (&f)[8], const float* c,
                                            const Net& net) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, h = net.h;
  if (h == 0) {
    const float future = f[0] - (f[2] * c[kOngoingLossMbPerSec]) * c[kHeuristicHorizonSec];
    return f[7] > 0.5f ? 0.0f : future;
  }
  if (warp == 0) {
    for (int j = lane; j < h; j += 32) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += f[k] * net.W1[k * h + j];
      net.h1[j] = gelu_tanh(acc + net.b1[j]);
    }
  }
  __syncthreads();
  const int q = threadIdx.x & 3, S = h + kPad;
  for (int jb = 0; jb < h; jb += kThreads / 4) {
    const int j = jb + (threadIdx.x >> 2);
    float p = 0.0f;
    if (j < h)
      for (int k = q; k < h; k += 4) p += net.h1[k] * net.W2[k * S + j];
    p += __shfl_xor_sync(kFullMask, p, 1);
    p += __shfl_xor_sync(kFullMask, p, 2);
    if (q == 0 && j < h) net.h2[j] = gelu_tanh(p + net.b2[j]);
  }
  __syncthreads();
  float v = 0.0f;
  if (warp == 0) {
    for (int j = lane; j < h; j += 32) v += net.h2[j] * net.W3[j];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
    v = __shfl_sync(kFullMask, v, 0) + net.b3[0];
  }
  return v;
}

// --- warp halving sums (the resident entry) -------------------------------

struct F3 {
  float x, y, z;
};

__device__ __forceinline__ F3 operator+(F3 a, F3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }

__device__ __forceinline__ F3 shfl_down(F3 v, int off) {
  return {__shfl_down_sync(kFullMask, v.x, off), __shfl_down_sync(kFullMask, v.y, off),
          __shfl_down_sync(kFullMask, v.z, off)};
}

__device__ __forceinline__ F3 shfl0(F3 v) {
  return {__shfl_sync(kFullMask, v.x, 0), __shfl_sync(kFullMask, v.y, 0),
          __shfl_sync(kFullMask, v.z, 0)};
}

// The halving tree over a lane's K values at(k0), at(k0 + stride), ...:
// x[:K/2] + x[K/2:] repeated is the tree of the even-indexed values plus the
// tree of the odd-indexed ones.
template <int K, typename G>
__device__ __forceinline__ F3 lane_tree(const G& at, int k0, int stride) {
  if constexpr (K == 1) {
    return at(k0);
  } else {
    return lane_tree<K / 2>(at, k0, 2 * stride) + lane_tree<K / 2>(at, k0 + stride, 2 * stride);
  }
}

// Three halving-tree sums of the n values at(j) (n a power of two, at most
// 32 * kLaneValues) by one warp: lane l holds the values l + 32k and adds
// them as the tree's upper levels do, then the last five levels are
// shuffles.  Every lane gets the sums.
template <typename G>
__device__ F3 warp_sums(int n, const G& at) {
  const int lane = threadIdx.x & 31;
  const auto lane_at = [&](int k) { return at(lane + 32 * k); };
  F3 v = {0.0f, 0.0f, 0.0f};
  int off = 16;
  switch (n >> 5) {
    case 0:
      if (lane < n) v = at(lane);
      off = n >> 1;
      break;
    case 1: v = lane_tree<1>(lane_at, 0, 1); break;
    case 2: v = lane_tree<2>(lane_at, 0, 1); break;
    case 4: v = lane_tree<4>(lane_at, 0, 1); break;
    case 8: v = lane_tree<8>(lane_at, 0, 1); break;
    default: v = lane_tree<kLaneValues>(lane_at, 0, 1); break;
  }
  for (; off > 0; off >>= 1) v = v + shfl_down(v, off);
  return shfl0(v);
}

// --- the resident entry ----------------------------------------------------

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Its dynamic shared memory, in the order `carve` lays it out.
__host__ __device__ inline size_t resident_bytes(int M, int Fp, int Pp, int hidden) {
  const int A = Fp + Pp + 1, W = (A + 31) / 32;
  return align16(4 * kConstSlots) + 2 * align16(4 * (size_t)Fp) + align16(4 * (size_t)Pp) +
         align16(4 * (size_t)net_floats(hidden)) + 2 * kWarps * sizeof(uint2) +
         7 * align16(4 * (size_t)M) + align16(4 * (size_t)M * W) + align16((size_t)M);
}

struct Resident {
  float* c;          // [kConstSlots]
  float* fs;         // [Fp]
  float* fl;         // [Fp]
  float* ps;         // [Pp]
  float* net;        // [net_floats(hidden)]
  uint2* cand;       // [2][kWarps] warp winners (key, action << 16 | child + 1)
  int* visits;       // [M]
  float* vsum;       // [M]
  float* root;       // [M] sqrt(max(visits, 1))
  float* qv;         // [M] Q on the PUCT scale: value_sum / visits · 1/50
  float* ew;         // [M] the edge reward into the node on the PUCT scale
  float* reward;     // [M] the edge reward into the node
  int* path;         // [M] this simulation's path from the root
  unsigned* legal;   // [M, W] legal actions
  uint8_t* flags;    // [M] kExpanded | kTerminal
};

__device__ Resident carve(unsigned char* p, int M, int Fp, int Pp, int hidden) {
  const int A = Fp + Pp + 1, W = (A + 31) / 32;
  Resident r;
  auto take = [&](size_t bytes) {
    unsigned char* at = p;
    p += align16(bytes);
    return at;
  };
  r.c = (float*)take(4 * kConstSlots);
  r.fs = (float*)take(4 * (size_t)Fp);
  r.fl = (float*)take(4 * (size_t)Fp);
  r.ps = (float*)take(4 * (size_t)Pp);
  r.net = (float*)take(4 * (size_t)net_floats(hidden));
  r.cand = (uint2*)take(2 * kWarps * sizeof(uint2));
  r.visits = (int*)take(4 * (size_t)M);
  r.vsum = (float*)take(4 * (size_t)M);
  r.root = (float*)take(4 * (size_t)M);
  r.qv = (float*)take(4 * (size_t)M);
  r.ew = (float*)take(4 * (size_t)M);
  r.reward = (float*)take(4 * (size_t)M);
  r.path = (int*)take(4 * (size_t)M);
  r.legal = (unsigned*)take(4 * (size_t)M * W);
  r.flags = take((size_t)M);
  return r;
}

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// A node's select terms from its visits and value sum, as `ucb` forms them:
// sqrt(max(visits, 1)) when it is the parent, Q on the PUCT scale when it is
// the child
__device__ __forceinline__ void node_terms(const Resident& r, int i, int nv, float vs, float rq) {
  const float q = nv > 0 ? vs / (float)max(nv, 1) : 0.0f;
  r.qv[i] = q * rq;
  r.root[i] = sqrtf((float)max(nv, 1));
}

// argmax candidates (key, action << 16 | child + 1) in the order of `merge`
__device__ __forceinline__ uint2 merge2(uint2 a, uint2 b) {
  return (b.x > a.x || (b.x == a.x && b.y < a.y)) ? b : a;
}

__global__ void __launch_bounds__(kThreads, 1)
    mcts_search_resident_kernel(Tree t, Ctx ctx, const float* consts, const float* weights,
                                int hidden, int M, int Fp, int Pp, int num_sims) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int FP = Fp + Pp, A = FP + 1, D = FP + 3, W = (A + 31) / 32;
  int* visits = t.visits + (size_t)b * M;
  float* value_sum = t.value_sum + (size_t)b * M;
  int* parent = t.parent + (size_t)b * M;
  int* parent_action = t.parent_action + (size_t)b * M;
  int* children = t.children + (size_t)b * M * A;
  float* child_reward = t.child_reward + (size_t)b * M * A;
  uint8_t* expanded = t.expanded + (size_t)b * M;
  uint8_t* terminal = t.terminal + (size_t)b * M;
  float* state = t.state + (size_t)b * M * D;
  const float rF = ctx.real[2 * b], rP = ctx.real[2 * b + 1];

  // --- the launch's working set from the tree so far ---
  const Resident r = carve(smem_raw, M, Fp, Pp, hidden);
  for (int k = tid; k < kNumConsts; k += kThreads) r.c[k] = consts[k];
  for (int j = tid; j < Fp; j += kThreads) {
    r.fs[j] = ctx.file_scores[(size_t)b * Fp + j];
    r.fl[j] = ctx.file_loss[(size_t)b * Fp + j];
  }
  for (int p = tid; p < Pp; p += kThreads) r.ps[p] = ctx.proc_scores[(size_t)b * Pp + p];
  const Net net = load_net(r.net, weights, hidden);
  int n = t.n_nodes[b];
  for (int i = tid; i < M; i += kThreads) {
    r.visits[i] = visits[i];
    r.vsum[i] = value_sum[i];
  }
  if (tid == 0) r.path[0] = 0;
  __syncthreads();
  const float* c = r.c;
  const float max_steps = c[kMaxSteps], rq = c[kRecipQScale];
  const float z = 0.0f * rq;  // an unvisited action's Q and edge term
  // this thread's actions at every level, and their c_puct · prior
  float my_cp[kActs];
#pragma unroll
  for (int k = 0; k < kActs; ++k) {
    const int a = tid + k * kThreads;
    my_cp[k] = a < A ? c[kCPuct] * ctx.prior[(size_t)b * A + a] : 0.0f;
  }
  // each node's flags, select terms and edge reward
  for (int i = tid; i < n; i += kThreads) {
    r.flags[i] = (expanded[i] ? kExpanded : 0) | (terminal[i] ? kTerminal : 0);
    node_terms(r, i, r.visits[i], r.vsum[i], rq);
    const int p = parent[i], a = parent_action[i];
    const float rw = p >= 0 && a >= 0 ? __ldg(child_reward + (size_t)p * A + a) : 0.0f;
    r.reward[i] = rw;
    r.ew[i] = rw * rq;
  }
  // the legal actions from the state rows: a warp takes (node, word) pairs,
  // four at a time, their loads before their ballots
  const int pairs = n * W;
  for (int base = warp * 4; base < pairs; base += kWarps * 4) {
    float x[4];
    bool open[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pr = min(base + u, pairs - 1);
      const int i = pr / W, j = (pr - i * W) * 32 + lane;
      const float* s = state + (size_t)i * D;
      x[u] = j < FP ? __ldg(s + j) : 0.0f;
      open[u] = __ldg(s + FP + 2) < 0.5f && __ldg(s + FP + 1) < max_steps;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pr = base + u;
      if (pr < pairs) {
        const int i = pr / W, j = (pr - i * W) * 32 + lane;
        const bool bit = j < FP ? x[u] < 0.5f : j == FP;
        const unsigned m = __ballot_sync(kFullMask, bit && open[u]);
        if (lane == 0) r.legal[pr] = m;
      }
    }
  }
  __syncthreads();

  int buf = 0;
  for (int sim = 0; sim < num_sims; ++sim) {
    // SELECT: descend by UCB until an unvisited child slot or a frontier
    // (unexpanded or terminal) node; every thread follows the same path.
    // A thread scores its own actions: their children from the node's row
    // of `children` (one coalesced read a level), each child's terms from
    // shared memory
    int cur = 0, len = 1, act = -1;
    bool need = false, going = r.flags[0] == kExpanded;
    while (going) {
      const int* krow = children + (size_t)cur * A;
      const unsigned* lg = r.legal + cur * W;
      int kid[kActs];
      unsigned lw[kActs];
#pragma unroll
      for (int k = 0; k < kActs; ++k) {
        const int a = tid + k * kThreads;
        kid[k] = a < A ? krow[a] : -1;
        lw[k] = a < A ? lg[a >> 5] : 0u;
      }
      const float root = r.root[cur];
      float best = -INFINITY;
      int best_a = 0xffff, best_c = -1;
#pragma unroll
      for (int k = 0; k < kActs; ++k) {
        const int a = tid + k * kThreads;
        if (a < A) {
          float score = -INFINITY;
          if (lw[k] >> (a & 31) & 1u) {
            // `ucb`: (Q + c_puct·prior·root / (1 + visits)) + edge term, with
            // Q, visits and the edge term 0 for an action without a child
            const int i = kid[k];
            float u = my_cp[k] * root;
            if (i >= 0) {
              u = u / (1.0f + (float)r.visits[i]);
              score = (r.qv[i] + u) + r.ew[i];
            } else {
              score = (z + u) + z;
            }
          }
          merge_child(best, best_a, best_c, score, a, kid[k]);
        }
      }
      // the warp's winner: the largest key, then the lowest action, whose
      // child rides in the low 16 bits (A and M + 1 below 2^16)
      const unsigned key = order_key(best);
      const unsigned kmax = __reduce_max_sync(kFullMask, key);
      const unsigned ac = ((unsigned)best_a << 16) | (unsigned)(best_c + 1);
      const unsigned wac = __reduce_min_sync(kFullMask, key == kmax ? ac : 0xffffffffu);
      uint2* cand = r.cand + buf * kWarps;
      if (lane == 0) cand[warp] = make_uint2(kmax, wac);
      __syncthreads();
      const uint2 w = merge2(merge2(merge2(cand[0], cand[1]), merge2(cand[2], cand[3])),
                             merge2(merge2(cand[4], cand[5]), merge2(cand[6], cand[7])));
      buf ^= 1;
      act = (int)(w.y >> 16);
      const int child = (int)(w.y & 0xffffu) - 1;
      need = child < 0 && act < A;
      going = false;
      if (child >= 0) {
        cur = child;
        if (tid == 0) r.path[len] = cur;
        ++len;
        going = r.flags[cur] == kExpanded;
        // the row expand reads if the descent ends here, into L1 meanwhile
        if (tid * 32 < D)
          asm volatile("prefetch.global.L1 [%0];" ::"l"(state + (size_t)cur * D + tid * 32));
      }
    }

    // EXPAND: the chosen child into slot n, from the parent's state row
    const bool grow = need && !(r.flags[cur] & kTerminal) && n < M;
    const float* s = state + (size_t)cur * D;  // the parent's row, or the leaf's
    const bool is_file = act < Fp, is_kill = act >= Fp && act < FP, is_stop = act == FP;
    const int fi = min(max(act, 0), Fp - 1), pi = min(max(act - Fp, 0), Pp - 1);
    bool leaf_term;
    if (grow) {
      const float steps2 = s[FP + 1] + 1.0f;
      const float stopped2 = fmaxf(s[FP + 2], is_stop ? 1.0f : 0.0f);
      leaf_term = (stopped2 > 0.5f) || (steps2 >= max_steps);
      if (warp > 0) {
        // warps 1-7: the leaf's state row and its legal mask
        const bool open2 = stopped2 < 0.5f && steps2 < max_steps;
        float* s2 = state + (size_t)n * D;
        for (int base = (warp - 1) * 32; base < A; base += (kWarps - 1) * 32) {
          const int j = base + lane;
          bool bit = j == FP;
          if (j < FP) {
            const bool hit = (is_file && j == fi) || (is_kill && j == Fp + pi);
            const float x = clamp01(s[j] + (hit ? 1.0f : 0.0f));
            s2[j] = x;
            bit = x < 0.5f;
          }
          const unsigned m = __ballot_sync(kFullMask, bit && open2);
          if (lane == 0) r.legal[n * W + (base >> 5)] = m;
        }
        if (tid == 32) {
          const float t_op = c[kRevertSecondsPerMb] * r.fl[fi];
          s2[FP] = s[FP] + (is_file ? t_op : 0.0f);
          s2[FP + 1] = steps2;
          s2[FP + 2] = stopped2;
          parent[n] = cur;
          parent_action[n] = act;
          expanded[n] = 1;
          terminal[n] = leaf_term;
          children[(size_t)cur * A + act] = n;
          r.flags[n] = kExpanded | (leaf_term ? kTerminal : 0);
        }
      }
    } else {
      leaf_term = r.flags[cur] & kTerminal;
    }

    // EVALUATE on warp 0: the reward of the new edge and the leaf's
    // features, from one pass over the parent's (or the leaf's) marks
    float f[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (warp == 0 && (grow || !leaf_term)) {
      const F3 fsum = warp_sums(Fp, [&](int j) {
        const float x = s[j];
        const float done = grow ? clamp01(x + ((is_file && j == fi) ? 1.0f : 0.0f)) : x;
        const float open = 1.0f - done;
        return F3{(open * r.fs[j]) * r.fl[j], open * (1.0f - r.fs[j]), done};
      });
      const F3 psum = warp_sums(Pp, [&](int p) {
        const float x = s[Fp + p];
        const float killed = grow ? clamp01(x + ((is_kill && p == pi) ? 1.0f : 0.0f)) : x;
        return F3{r.ps[p] * (killed < 0.5f ? 1.0f : 0.0f), killed,
                  r.ps[p] * (x < 0.5f ? 1.0f : 0.0f)};
      });
      float downtime = s[FP], steps = s[FP + 1], stopped = s[FP + 2];
      if (grow) {
        const float live = psum.z;
        const float remaining = fmaxf(max_steps - steps, 0.0f);
        const float cap = fminf(remaining, c[kLossCapSec]);
        const float sc_f = r.fs[fi], loss = r.fl[fi];
        const float t_op = c[kRevertSecondsPerMb] * loss;
        const float fp_cost = c[kFpRevertScale] * loss + c[kFpRevertFloorMb];
        const float r_file =
            (sc_f * loss - (1.0f - sc_f) * fp_cost) - c[kDowntimeWeight] * t_op;
        const float sc_p = r.ps[pi];
        const float r_kill =
            ((sc_p * c[kOngoingLossMbPerSec]) * cap - c[kKillCost] * sc_p) -
            (((1.0f - sc_p) * c[kDowntimeWeight]) * c[kKillDowntimeSec]) * c[kFpKillFactor];
        const float r_stop = (-live * c[kOngoingLossMbPerSec]) * cap;
        const float rw = is_file ? r_file : is_kill ? r_kill : is_stop ? r_stop : 0.0f;
        if (lane == 0) {
          child_reward[(size_t)cur * A + act] = rw;
          r.reward[n] = rw;
          r.ew[n] = rw * rq;
          r.path[len] = n;
        }
        downtime = downtime + (is_file ? t_op : 0.0f);
        stopped = fmaxf(stopped, is_stop ? 1.0f : 0.0f);
        steps = steps + 1.0f;
      }
      f[0] = fsum.x;
      f[1] = fsum.y;
      f[2] = psum.x;
      f[3] = (fsum.z - ((float)Fp - rF)) / fmaxf(rF, 1.0f);
      f[4] = (psum.y - ((float)Pp - rP)) / fmaxf(rP, 1.0f);
      f[5] = downtime * c[kRecipDowntimeScale];
      f[6] = steps * c[kRecipMaxSteps];
      f[7] = stopped;
    }
    // the leaf's value, 0 at a terminal leaf (block-uniform branch)
    const float v = leaf_term ? 0.0f : leaf_value(f, c, net);
    if (grow) ++len;

    // BACKUP on warp 0, leaf to root: each node's value the leaf value plus
    // the edge rewards below it, added one edge at a time (lane k takes the
    // k-th node from the leaf; every lane gathers a chunk's 32 rewards by
    // shuffles first, then runs the sums)
    if (warp == 0) {
      __syncwarp();
      float acc = v;
      for (int base = 0; base < len; base += 32) {
        const int k = base + lane;
        const int node = k < len ? r.path[len - 1 - k] : -1;
        const float rw = node >= 0 ? r.reward[node] : 0.0f;
        const int cnt = len - base;
        float rws[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) rws[j] = __shfl_sync(kFullMask, rw, j);
        float mine = acc;
#pragma unroll
        for (int j = 0; j < 31; ++j) {
          const float next = acc + rws[j];
          acc = j < cnt ? next : acc;
          mine = lane == j + 1 ? acc : mine;
        }
        if (cnt > 31) acc = acc + rws[31];
        if (node >= 0) {
          const int nv = r.visits[node] + 1;
          const float vs = r.vsum[node] + mine;
          r.visits[node] = nv;
          r.vsum[node] = vs;
          node_terms(r, node, nv, vs, rq);
        }
      }
    }
    if (grow) ++n;
    __syncthreads();
  }
  for (int i = tid; i < n; i += kThreads) {
    visits[i] = r.visits[i];
    value_sum[i] = r.vsum[i];
  }
  if (tid == 0) t.n_nodes[b] = n;
}

// --- the global entry: the tree in device memory --------------------------

// block-wide argmax of (v, i); every thread gets the winner's index
__device__ int block_argmax(float v, int i, float* red_v, int* red_i) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(kFullMask, v, off);
    int oi = __shfl_down_sync(kFullMask, i, off);
    merge(v, i, ov, oi);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = red_v[0];
    int bi = red_i[0];
    for (int w = 1; w < kWarps; ++w) merge(bv, bi, red_v[w], red_i[w]);
    red_i[0] = bi;
  }
  __syncthreads();
  const int best = red_i[0];
  __syncthreads();  // red_i is reused by the next call
  return best;
}

// Halving-tree sums, in place: `nf` arrays of Fp values at `sums` (stride
// Fp) and `np_` arrays of Pp values after them (stride Pp); each array's sum
// lands in its element 0.  The levels start at the longest array summed.
__device__ void halving_sums(float* sums, int Fp, int nf, int Pp, int np_) {
  float* procs = sums + nf * Fp;
  const int top = max(nf > 0 ? Fp : 1, np_ > 0 ? Pp : 1);
  for (int n = top / 2; n >= 1; n >>= 1) {
    if (n <= Fp / 2) {
      for (int j = threadIdx.x; j < n; j += kThreads)
        for (int q = 0; q < nf; ++q) sums[q * Fp + j] = sums[q * Fp + j] + sums[q * Fp + j + n];
    }
    if (n <= Pp / 2) {
      for (int j = threadIdx.x; j < n; j += kThreads)
        for (int q = 0; q < np_; ++q) procs[q * Pp + j] = procs[q * Pp + j] + procs[q * Pp + j + n];
    }
    __syncthreads();
  }
}

// The 8 value features of padded state `s` into `feat` (shared), through
// `sums` [3 Fp + 2 Pp] of shared scratch.
__device__ void features(const float* s, const float* fs, const float* fl, const float* ps,
                         const float* real, const float* c, int Fp, int Pp, float* sums,
                         float* feat) {
  for (int j = threadIdx.x; j < Fp; j += kThreads) {
    const float done = s[j];
    const float open = 1.0f - done;
    sums[j] = (open * fs[j]) * fl[j];
    sums[Fp + j] = open * (1.0f - fs[j]);
    sums[2 * Fp + j] = done;
  }
  for (int p = threadIdx.x; p < Pp; p += kThreads) {
    const float killed = s[Fp + p];
    sums[3 * Fp + p] = ps[p] * (killed < 0.5f ? 1.0f : 0.0f);
    sums[3 * Fp + Pp + p] = killed;
  }
  __syncthreads();
  halving_sums(sums, Fp, 3, Pp, 2);
  if (threadIdx.x == 0) {
    const float rF = real[0], rP = real[1];
    feat[0] = sums[0];
    feat[1] = sums[Fp];
    feat[2] = sums[3 * Fp];
    feat[3] = (sums[2 * Fp] - ((float)Fp - rF)) / fmaxf(rF, 1.0f);
    feat[4] = (sums[3 * Fp + Pp] - ((float)Pp - rP)) / fmaxf(rP, 1.0f);
    feat[5] = s[Fp + Pp] * c[kRecipDowntimeScale];
    feat[6] = s[Fp + Pp + 1] * c[kRecipMaxSteps];
    feat[7] = s[Fp + Pp + 2];
  }
  __syncthreads();
}

struct Shared {
  float* c;      // [kConstSlots]
  float* net;    // [net_floats(hidden)]
  float* sums;   // [3 Fp + 2 Pp]
  float* feat;   // [8]
};

__host__ __device__ inline int shared_floats(int Fp, int Pp, int hidden) {
  return kConstSlots + net_floats(hidden) + 3 * Fp + 2 * Pp + 8;
}

__device__ Shared carve_global(float* smem, int Fp, int Pp, int hidden) {
  Shared sh;
  sh.c = smem;
  sh.net = sh.c + kConstSlots;
  sh.sums = sh.net + net_floats(hidden);
  sh.feat = sh.sums + 3 * Fp + 2 * Pp;
  return sh;
}

__global__ void __launch_bounds__(kThreads)
    mcts_search_kernel(Tree t, Ctx ctx, const float* consts, const float* weights, int hidden,
                       int M, int Fp, int Pp, int num_sims) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int s_cur, s_act, s_need, s_going, s_leaf, s_n;
  __shared__ float s_value;

  const int b = blockIdx.x;
  const int A = Fp + Pp + 1, D = Fp + Pp + 3;
  int* visits = t.visits + (size_t)b * M;
  float* value_sum = t.value_sum + (size_t)b * M;
  int* parent = t.parent + (size_t)b * M;
  int* parent_action = t.parent_action + (size_t)b * M;
  int* children = t.children + (size_t)b * M * A;
  float* child_reward = t.child_reward + (size_t)b * M * A;
  uint8_t* expanded = t.expanded + (size_t)b * M;
  uint8_t* terminal = t.terminal + (size_t)b * M;
  float* state = t.state + (size_t)b * M * D;
  const float* fs = ctx.file_scores + (size_t)b * Fp;
  const float* fl = ctx.file_loss + (size_t)b * Fp;
  const float* ps = ctx.proc_scores + (size_t)b * Pp;
  const float* prior = ctx.prior + (size_t)b * A;
  const float* real = ctx.real + (size_t)b * 2;

  const Shared sh = carve_global(smem, Fp, Pp, hidden);
  for (int k = threadIdx.x; k < kNumConsts; k += kThreads) sh.c[k] = consts[k];
  const Net net = load_net(sh.net, weights, hidden);
  const float* c = sh.c;
  if (threadIdx.x == 0) s_n = t.n_nodes[b];
  __syncthreads();

  for (int sim = 0; sim < num_sims; ++sim) {
    // SELECT: descend by UCB until an unvisited child slot or a terminal node
    if (threadIdx.x == 0) {
      s_cur = 0;
      s_act = -1;
      s_need = 0;
      s_going = expanded[0] && !terminal[0];
    }
    __syncthreads();
    while (s_going) {
      const int cur = s_cur;
      const float* sc = state + (size_t)cur * D;
      const int* kids = children + (size_t)cur * A;
      const float* crw = child_reward + (size_t)cur * A;
      const bool open = sc[Fp + Pp + 2] < 0.5f && sc[Fp + Pp + 1] < c[kMaxSteps];
      const float root = sqrtf((float)max(visits[cur], 1));
      float best = -INFINITY;
      int best_a = 0x7fffffff;
      for (int a = threadIdx.x; a < A; a += kThreads) {
        float score = -INFINITY;
        if (open && (a == Fp + Pp || sc[a] < 0.5f)) {
          const int kid = kids[a];
          int nv = 0;
          float vs = 0.0f;
          if (kid >= 0) {
            nv = visits[kid];
            vs = value_sum[kid];
          }
          score = ucb(nv, vs, crw[a], prior[a], root, c);
        }
        merge(best, best_a, score, a);
      }
      const int a = block_argmax(best, best_a, red_v, red_i);
      if (threadIdx.x == 0) {
        const int child = kids[a];
        const int need = child < 0;
        const int nxt = need ? cur : child;
        s_act = a;
        s_need = need;
        s_cur = nxt;
        s_going = !need && expanded[nxt] && !terminal[nxt];
      }
      __syncthreads();
    }

    // EXPAND: materialize the chosen child into slot n_nodes
    const int cur = s_cur, act = s_act, n = s_n;
    const bool grow = s_need && !terminal[cur] && n < M;
    if (grow) {
      const float* s = state + (size_t)cur * D;
      float* s2 = state + (size_t)n * D;
      for (int p = threadIdx.x; p < Pp; p += kThreads)
        sh.sums[p] = ps[p] * (s[Fp + p] < 0.5f ? 1.0f : 0.0f);
      __syncthreads();
      halving_sums(sh.sums, Fp, 0, Pp, 1);
      const bool is_file = act < Fp;
      const bool is_kill = act >= Fp && act < Fp + Pp;
      const bool is_stop = act == Fp + Pp;
      const int fi = min(max(act, 0), Fp - 1);
      const int pi = min(max(act - Fp, 0), Pp - 1);
      for (int j = threadIdx.x; j < Fp + Pp; j += kThreads) {
        const bool hit = (is_file && j == fi) || (is_kill && j == Fp + pi);
        s2[j] = clamp01(s[j] + (hit ? 1.0f : 0.0f));
      }
      if (threadIdx.x == 0) {
        const float live = sh.sums[0];
        const float steps = s[Fp + Pp + 1];
        const float remaining = fmaxf(c[kMaxSteps] - steps, 0.0f);
        const float cap = fminf(remaining, c[kLossCapSec]);
        const float sc_f = fs[fi], loss = fl[fi];
        const float t_op = c[kRevertSecondsPerMb] * loss;
        const float fp_cost = c[kFpRevertScale] * loss + c[kFpRevertFloorMb];
        const float r_file =
            (sc_f * loss - (1.0f - sc_f) * fp_cost) - c[kDowntimeWeight] * t_op;
        const float sc_p = ps[pi];
        const float r_kill =
            ((sc_p * c[kOngoingLossMbPerSec]) * cap - c[kKillCost] * sc_p) -
            (((1.0f - sc_p) * c[kDowntimeWeight]) * c[kKillDowntimeSec]) * c[kFpKillFactor];
        const float r_stop = (-live * c[kOngoingLossMbPerSec]) * cap;
        const float r = is_file ? r_file : is_kill ? r_kill : is_stop ? r_stop : 0.0f;
        s2[Fp + Pp] = s[Fp + Pp] + (is_file ? t_op : 0.0f);
        s2[Fp + Pp + 1] = steps + 1.0f;
        const float stopped = fmaxf(s[Fp + Pp + 2], is_stop ? 1.0f : 0.0f);
        s2[Fp + Pp + 2] = stopped;
        parent[n] = cur;
        parent_action[n] = act;
        expanded[n] = 1;
        terminal[n] = (stopped > 0.5f) || (steps + 1.0f >= c[kMaxSteps]);
        children[(size_t)cur * A + act] = n;
        child_reward[(size_t)cur * A + act] = r;
        s_leaf = n;
        s_n = n + 1;
      }
    } else if (threadIdx.x == 0) {
      s_leaf = cur;
    }
    __syncthreads();

    // EVALUATE: the leaf's value, 0 at a terminal leaf
    const int leaf = s_leaf;
    if (!terminal[leaf]) {
      features(state + (size_t)leaf * D, fs, fl, ps, real, c, Fp, Pp, sh.sums, sh.feat);
      float f[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = sh.feat[k];
      const float v = leaf_value(f, c, net);
      if (threadIdx.x == 0) s_value = v;
    } else if (threadIdx.x == 0) {
      s_value = 0.0f;
    }
    __syncthreads();

    // BACKUP: one thread climbs the parent chain, adding the edge rewards
    if (threadIdx.x == 0) {
      float v = s_value;
      for (int i = leaf; i >= 0;) {
        visits[i] += 1;
        value_sum[i] = value_sum[i] + v;
        const int pa = parent_action[i];
        const int pr = parent[i];
        v = v + (pa >= 0 ? child_reward[(size_t)max(pr, 0) * A + pa] : 0.0f);
        i = pr;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) t.n_nodes[b] = s_n;
}

// --- the value entry and the chain floor -----------------------------------

// The search's leaf value on given feature rows, one block a row: the same
// device function as both search entries call, for holding it to the value
// net.
__global__ void __launch_bounds__(kThreads)
    mcts_value_kernel(const float* features, const float* consts, const float* weights,
                      int hidden, float* out) {
  extern __shared__ __align__(16) float smem[];
  for (int k = threadIdx.x; k < kNumConsts; k += kThreads) smem[k] = consts[k];
  const Net net = load_net(smem + kConstSlots, weights, hidden);
  __syncthreads();
  float f[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = features[(size_t)blockIdx.x * 8 + k];
  const float v = leaf_value(f, smem, net);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

// `levels` dependent steps of one warp: the argmax of row `cur` of the R x A
// table (loaded into shared memory first; R a power of two) names the next
// row.  Writes the
// last row reached, so that nothing is dead code.
__global__ void __launch_bounds__(kThreads)
    mcts_chain_floor_kernel(const float* table, int R, int A, int levels, int* out) {
  extern __shared__ __align__(16) float rows[];
  for (int k = threadIdx.x; k < R * A; k += kThreads) rows[k] = table[k];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int cur = 0;
  for (int l = 0; l < levels; ++l) {
    const float* row = rows + cur * A;
    float best = -INFINITY;
    int best_a = 0x7fffffff;
#pragma unroll 8
    for (int a = lane; a < A; a += 32) merge(best, best_a, row[a], a);
    const unsigned key = order_key(best);
    const unsigned kmax = __reduce_max_sync(kFullMask, key);
    const unsigned amin =
        __reduce_min_sync(kFullMask, key == kmax ? (unsigned)best_a : 0xffffffffu);
    cur = (int)((amin + (unsigned)l) & (unsigned)(R - 1));
  }
  if (lane == 0) out[blockIdx.x] = cur;
}

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

}  // namespace nerrf

using nerrf::Ctx;
using nerrf::Tree;

// One launch of `num_sims` simulations on B trees (layout in the Tree and
// Ctx structs above; `weights` may be null when hidden == 0, the heuristic)
// by the global entry.  Fp and Pp are powers of two.  Returns
// cudaGetLastError().
extern "C" int nerrf_mcts_search(int* visits, float* value_sum, int* parent, int* parent_action,
                                 int* children, float* child_reward, uint8_t* expanded,
                                 uint8_t* terminal, float* state, int* n_nodes,
                                 const float* file_scores, const float* file_loss,
                                 const float* proc_scores, const float* prior, const float* real,
                                 const float* consts, const float* weights, int hidden, int B,
                                 int M, int Fp, int Pp, int num_sims, void* stream) {
  if (B <= 0 || num_sims <= 0) return cudaGetLastError();
  const size_t bytes = sizeof(float) * (size_t)nerrf::shared_floats(Fp, Pp, hidden);
  cudaError_t err = nerrf::prepare(nerrf::mcts_search_kernel, bytes);
  if (err != cudaSuccess) return err;
  Tree t{visits, value_sum, parent, parent_action, children, child_reward,
         expanded, terminal, state, n_nodes};
  Ctx ctx{file_scores, file_loss, proc_scores, prior, real};
  nerrf::mcts_search_kernel<<<B, nerrf::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      t, ctx, consts, weights, hidden, M, Fp, Pp, num_sims);
  return cudaGetLastError();
}

// The same by the resident entry; Fp and Pp at most 32 * kLaneValues, and
// nerrf_mcts_resident_bytes(M, Fp, Pp, hidden) within a block's shared memory.
extern "C" int nerrf_mcts_search_resident(
    int* visits, float* value_sum, int* parent, int* parent_action, int* children,
    float* child_reward, uint8_t* expanded, uint8_t* terminal, float* state, int* n_nodes,
    const float* file_scores, const float* file_loss, const float* proc_scores,
    const float* prior, const float* real, const float* consts, const float* weights,
    int hidden, int B, int M, int Fp, int Pp, int num_sims, void* stream) {
  if (B <= 0 || num_sims <= 0) return cudaGetLastError();
  if (Fp > 32 * nerrf::kLaneValues || Pp > 32 * nerrf::kLaneValues) return cudaErrorInvalidValue;
  const size_t bytes = nerrf::resident_bytes(M, Fp, Pp, hidden);
  cudaError_t err = nerrf::prepare(nerrf::mcts_search_resident_kernel, bytes);
  if (err != cudaSuccess) return err;
  Tree t{visits, value_sum, parent, parent_action, children, child_reward,
         expanded, terminal, state, n_nodes};
  Ctx ctx{file_scores, file_loss, proc_scores, prior, real};
  nerrf::mcts_search_resident_kernel<<<B, nerrf::kThreads, bytes,
                                       static_cast<cudaStream_t>(stream)>>>(
      t, ctx, consts, weights, hidden, M, Fp, Pp, num_sims);
  return cudaGetLastError();
}

// The resident entry's dynamic shared memory for trees of M slots (no stream).
extern "C" int nerrf_mcts_resident_bytes(int M, int Fp, int Pp, int hidden) {
  return (int)nerrf::resident_bytes(M, Fp, Pp, hidden);
}

// The leaf value of N feature rows [N, 8] into out [N].
extern "C" int nerrf_mcts_value(const float* features, const float* consts, const float* weights,
                                int hidden, int N, float* out, void* stream) {
  if (N <= 0) return cudaGetLastError();
  const size_t bytes = sizeof(float) * (size_t)(nerrf::kConstSlots + nerrf::net_floats(hidden));
  cudaError_t err = nerrf::prepare(nerrf::mcts_value_kernel, bytes);
  if (err != cudaSuccess) return err;
  nerrf::mcts_value_kernel<<<N, nerrf::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      features, consts, weights, hidden, out);
  return cudaGetLastError();
}

// The chain floor over an R x A table: one block, `levels` steps, the last
// row into out[0].
extern "C" int nerrf_mcts_chain_floor(const float* table, int R, int A, int levels, int* out,
                                      void* stream) {
  const size_t bytes = sizeof(float) * (size_t)R * A;
  cudaError_t err = nerrf::prepare(nerrf::mcts_chain_floor_kernel, bytes);
  if (err != cudaSuccess) return err;
  nerrf::mcts_chain_floor_kernel<<<1, nerrf::kThreads, bytes,
                                   static_cast<cudaStream_t>(stream)>>>(table, R, A, levels, out);
  return cudaGetLastError();
}
