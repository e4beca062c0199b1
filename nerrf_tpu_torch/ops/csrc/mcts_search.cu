// The undo planner's whole PUCT search, select -> expand -> evaluate ->
// backup, for `num_sims` simulations in one launch: one thread block per
// search tree, the tree in device memory, resumable across launches.
//
// Replaces the XLA program nerrf_tpu/planner/device_mcts.py `search_chunk`
// (:205), the counterpart of one `DeviceMCTS.plan()` chunk, and its vmap over
// incidents nerrf_tpu/respond/planner.py `_batched_programs` (:64): gridDim =
// B trees, one per incident.  It is not the port of a Pallas kernel.
//
// What bounds it: a chain of dependent steps.  A simulation descends level by
// level, and each level is an A-wide UCB score and a block-wide argmax whose
// winner names the next node to read; then one leaf's step, its 8 features
// (halving-tree sums over the padded files and processes) and its value, then
// one thread climbs the parent chain.  The bytes are few (a level reads the
// node's A child ids, their visit counts and value sums): latency sets the
// time, not bandwidth or arithmetic.  The design is the simple one: 256
// threads a tree, `__syncthreads()` between the phases, the value net's
// weights in shared memory.  One block per tree leaves 131 of the H100's 132
// SMs idle at B = 1; more than one SM per search, a warp-level argmax and the
// tree in shared memory for small M are later work.
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
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nerrf {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxSharedBytes = 232448;  // 227 KB, the H100's per-block limit

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

__host__ __device__ inline int weight_count(int h) { return h * h + 11 * h + 1; }

// argmax merge: the larger score, and on equal scores the lower index
__device__ __forceinline__ void merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

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

// block-wide sum in a fixed order (the value net's last layer)
__device__ float block_sum(float v, float* red_v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red_v[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) total += red_v[w];
  }
  __syncthreads();
  return total;  // valid on thread 0
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + k1 * x * x * x)));
}

// The value net on one feature row `f` [8] (shared), weights `w` in the
// kernel layout [W1 (8 x h), b1 (h), W2 (h x h), b2 (h), W3 (h), b3 (1)],
// rows in-major; `h1`, `h2` are [h] of shared scratch.  Returns the value
// on thread 0.
__device__ float mlp_value(const float* f, const float* w, int h, float* h1, float* h2,
                           float* red_v) {
  const float* W1 = w;
  const float* b1 = W1 + 8 * h;
  const float* W2 = b1 + h;
  const float* b2 = W2 + h * h;
  const float* W3 = b2 + h;
  const float* b3 = W3 + h;
  for (int j = threadIdx.x; j < h; j += kThreads) {
    float acc = 0.0f;
    for (int k = 0; k < 8; ++k) acc += f[k] * W1[k * h + j];
    h1[j] = gelu_tanh(acc + b1[j]);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < h; j += kThreads) {
    float acc = 0.0f;
    for (int k = 0; k < h; ++k) acc += h1[k] * W2[k * h + j];
    h2[j] = gelu_tanh(acc + b2[j]);
  }
  __syncthreads();
  float part = 0.0f;
  for (int j = threadIdx.x; j < h; j += kThreads) part += h2[j] * W3[j];
  return block_sum(part, red_v) + b3[0];
}

// Halving-tree sums, in place: `nf` arrays of Fp values at `sums` (stride
// Fp) and `np_` arrays of Pp values after them (stride Pp); each array's sum
// lands in its element 0.
__device__ void halving_sums(float* sums, int Fp, int nf, int Pp, int np_) {
  float* procs = sums + nf * Fp;
  for (int n = max(Fp, Pp) / 2; n >= 1; n >>= 1) {
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

// The leaf value of `feat`: the heuristic (hidden == 0) or the value net.
// Returns it on thread 0.
__device__ float leaf_value(const float* feat, const float* c, const float* w, int hidden,
                            float* h1, float* h2, float* red_v) {
  if (hidden > 0) return mlp_value(feat, w, hidden, h1, h2, red_v);
  const float future = feat[0] - (feat[2] * c[kOngoingLossMbPerSec]) * c[kHeuristicHorizonSec];
  return feat[7] > 0.5f ? 0.0f : future;
}

struct Shared {
  float* c;      // [kConstSlots]
  float* w;      // [weight_count(hidden)] or nothing
  float* sums;   // [3 Fp + 2 Pp]
  float* h1;     // [hidden]
  float* h2;     // [hidden]
  float* feat;   // [8]
};

__host__ __device__ inline int shared_floats(int Fp, int Pp, int hidden) {
  return kConstSlots + (hidden > 0 ? weight_count(hidden) : 0) + 3 * Fp + 2 * Pp +
         2 * hidden + 8;
}

__device__ Shared carve(float* smem, int Fp, int Pp, int hidden) {
  Shared sh;
  sh.c = smem;
  sh.w = sh.c + kConstSlots;
  sh.sums = sh.w + (hidden > 0 ? weight_count(hidden) : 0);
  sh.h1 = sh.sums + 3 * Fp + 2 * Pp;
  sh.h2 = sh.h1 + hidden;
  sh.feat = sh.h2 + hidden;
  return sh;
}

__device__ void load_shared(const Shared& sh, const float* consts, const float* weights,
                            int hidden) {
  for (int k = threadIdx.x; k < kNumConsts; k += kThreads) sh.c[k] = consts[k];
  if (hidden > 0) {
    const int n = weight_count(hidden);
    for (int k = threadIdx.x; k < n; k += kThreads) sh.w[k] = weights[k];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    mcts_search_kernel(Tree t, Ctx ctx, const float* consts, const float* weights, int hidden,
                       int M, int Fp, int Pp, int num_sims) {
  extern __shared__ float smem[];
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

  const Shared sh = carve(smem, Fp, Pp, hidden);
  load_shared(sh, consts, weights, hidden);
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
          float q = nv > 0 ? vs / (float)max(nv, 1) : 0.0f;
          q = q * c[kRecipQScale];
          float u = c[kCPuct] * prior[a];
          u = u * root;
          u = u / (1.0f + (float)nv);
          score = (q + u) + crw[a] * c[kRecipQScale];
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
        s2[j] = fminf(fmaxf(s[j] + (hit ? 1.0f : 0.0f), 0.0f), 1.0f);
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
      const float v = leaf_value(sh.feat, c, sh.w, hidden, sh.h1, sh.h2, red_v);
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

// The search's leaf value on given feature rows, one block a row: the same
// device function as the search calls, for holding it to the value net.
__global__ void __launch_bounds__(kThreads)
    mcts_value_kernel(const float* features, const float* consts, const float* weights,
                      int hidden, float* out) {
  extern __shared__ float smem[];
  __shared__ float red_v[kWarps];
  const Shared sh = carve(smem, 0, 0, hidden);
  load_shared(sh, consts, weights, hidden);
  if (threadIdx.x < 8) sh.feat[threadIdx.x] = features[(size_t)blockIdx.x * 8 + threadIdx.x];
  __syncthreads();
  const float v = leaf_value(sh.feat, sh.c, sh.w, hidden, sh.h1, sh.h2, red_v);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
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
// Ctx structs above; `weights` may be null when hidden == 0, the heuristic).
// Fp and Pp are powers of two.  Returns cudaGetLastError().
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

// The leaf value of N feature rows [N, 8] into out [N].
extern "C" int nerrf_mcts_value(const float* features, const float* consts, const float* weights,
                                int hidden, int N, float* out, void* stream) {
  if (N <= 0) return cudaGetLastError();
  const size_t bytes = sizeof(float) * (size_t)nerrf::shared_floats(0, 0, hidden);
  cudaError_t err = nerrf::prepare(nerrf::mcts_value_kernel, bytes);
  if (err != cudaSuccess) return err;
  nerrf::mcts_value_kernel<<<N, nerrf::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      features, consts, weights, hidden, out);
  return cudaGetLastError();
}
