// lp_chunk_step: one chunk step of the size-constrained label propagation
// sweep, for B label rows at once.
//
// Replaces no TPU kernel: the reference's step is the jnp body of a scan
// (repro/core/label_propagation.py::_lp_sweep), and the port's plain
// version is repro_torch/core/label_propagation.py::lp_sweep_plain, which
// the CPU runs and the card tests hold this kernel to.  Row b moves the
// node slots of chunk perm[b, c] synchronously: every decision reads the
// labels and block weights as the step found them.  For each valid node v
// (slot s):
//
//     runs   = (label, weight) of v's arcs (restricted to restrict[v]'s
//              class), one run per label, each summed in pack order
//     elig   = over(own) ? fits && l != own          (refine mode only)
//                        : w > 0 && (fits || l == own)
//              fits = weights[l] + c(v) <= U
//     score  = w + jitter(base_jit, s, l)     (uint32 murmur, in [0, .49))
//     new    = the label of the best score, the least label on a tie; own
//              if no run is eligible
//
// and in refine mode the influx gate: a mover to block t is kept iff
// jitter(base_gate, v, t) / .49 < clip((U - weights[t] + outflow[t]) /
// max(inflow[t], 1e-9), 0, 1), with the flows of the step's proposed moves.
// Every float32 operation is the plain version's, in its order, rounded
// as it is (__fadd_rn and friends: no FMA contraction).
//
// Bound.  The step's bytes: the chunk's arcs (head, weight, slot, valid:
// 21 B an arc) and a label gather for each, the node slots (id and valid,
// then a valid node's label and weight), and a label and two block weights
// for each move.  A finest kron19 chunk (~484 k arcs, 8 k slots) is ~12 MB:
// 3.6 us at 3.35 TB/s.  The torch chain it replaces took milliseconds:
// about a hundred launches, each idle on the host's dispatch, and scatters
// whose atomics piled onto a few addresses (monotone run ids, the padded
// slot N, the sentinel label T).
//
// Design.  Three launches a step, for all rows.
//   segment: one warp a node slot finds the slot's arcs, one contiguous
//     run of the chunk (the pack invariant of repro_torch/graph/packing.py),
//     with 32-way searches over the chunk's valid prefix of edge_src_slot.
//     A node with more than kLightArcs arcs (a hub) is cut into pieces of
//     kPieceArcs arcs, listed for the next launch, and its table of (label,
//     sum) in device scratch (twice the node's arc offset, so the tables
//     of a chunk never overlap) is emptied.
//   propose: one warp a light node (8 a block, slots strided over the
//     grid): it folds the node's arcs, 32 at a time, into a hash table in
//     the warp's shared memory.  A tile's lanes that share a label are
//     found with __match_any_sync and their leader adds their weights to
//     the run's sum one by one in lane order, so each run is summed in
//     pack order, as the plain version's stable sort of slot * A + label
//     and its scatter_add sum it.  Then each block takes pieces from the
//     list until none is left, so one hub's arcs are spread over many
//     blocks (a block per hub left the whole step waiting on the block
//     with the largest).  A piece adds its weights to the hub's table with
//     atomics, a warp's share of a run in one.  That order is free only
//     when it cannot change a sum: every weight of the hub an integer and
//     all of them together at most 2^24.  The block that finishes a hub's
//     last piece checks this (where it fails, it sums the runs again from
//     zero in pack order: each warp walks every arc and adds those of the
//     runs it owns), scores the table and proposes; the counter
//     block_nodes counts the hub.  The argmax is order free (max score,
//     then least label).  In refine mode a mover adds its weight to the
//     row's inflow of its target and outflow of its block.  Padded slots
//     and arcs do no work.
//   apply: one thread a node slot.  In refine mode the influx gate; then
//     the label write and the block-weight deltas of real moves only (the
//     sentinel slot T is never touched) and the row's move count.
// Node weights are integers below the 2^24 exact-weight gate of the
// callers, so the atomic flow and block-weight sums are exact in any order
// (as the plain version's scatter_add_ on the card already assumed).  In
// refine mode the gate reads the block weights as the step found them
// while the moves change them, so they are double buffered: segment copies
// this step's weights into the other buffer and zeroes the other parity's
// flows; apply gates on this step's buffer and moves the other.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                   // node slots a block takes
constexpr int kThreads = kWarp * kWarps;
constexpr int kApplyThreads = 256;
constexpr int kLightArcs = 256;             // more arcs: a hub, in pieces
constexpr int kLightCap = 2 * kLightArcs;   // a warp's hash slots (a power of two)
constexpr int kUnroll = 4;                  // a piece: arcs a lane has in flight
constexpr int kPieceArcs = 2 * kThreads * kUnroll;
constexpr int kEmpty = -1;
constexpr int kNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;
constexpr unsigned long long kExactSum = 1ull << 24;

// Every field is 8 bytes, in the order of the ctypes structure of the
// wrapper (repro_torch/kernels/lp_step/chunk_step.py).
struct Args {
  const int64_t* nodes;        // (C, N), or (B, C, N) with node_row = C * N
  const uint8_t* node_valid;
  long long node_row;
  const int64_t* edge_dst;     // (C, E), or (B, C, E) with edge_row = C * E
  const float* edge_w;
  const int64_t* edge_slot;
  const uint8_t* edge_valid;
  long long edge_row;
  const int32_t* nvalid;       // (C,), or (B, C) with nvalid_row = C: valid arcs a chunk
  long long nvalid_row;
  long long N, E;
  const int64_t* perm;         // (B, steps) chunk ids
  long long steps;
  const int64_t* base_jit;     // (iters, B, steps) uint32 hash bases
  const int64_t* base_gate;    // the same, refine mode
  void* labels;                // (B, A) int32 or int64
  long long A;
  float* w0;                   // (B, W) block weights; w1 their second buffer
  float* w1;
  long long W;
  const float* nw;             // (A,), or (B, A) with nw_row = A
  long long nw_row;
  const int32_t* restr;        // (A,) node classes, with use_restrict
  const float* U;              // (B,)
  long long T, B;
  int32_t* seg;                // (B, N, 2) scratch: each valid slot's arcs [lo, hi)
  int32_t* prop;               // (B, N) scratch: the proposed label, -1 none
  float* flow;                 // (2, 2, B, W) scratch: [parity][in, out]
  int32_t* hub;                // (H, 4) scratch: a hub's row, slot, lo, hi
  int32_t* hub_state;          // (H, 3): its pieces, pieces done, inexact
  unsigned long long* hub_tot; // (H,): the sum of its weights while exact
  int32_t* piece;              // (P, 2): hub, piece index
  int32_t* ctr;                // (3,): hubs, pieces, pieces taken; zero between steps
  int32_t* tkey;               // (B, 2E) hub tables
  float* tsum;
  int32_t* trun;               // (B, E): each hub arc's table slot
  unsigned long long* moves;   // (B,) int64
  unsigned long long* block_nodes;
};

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t x) {
  h = (h ^ x) * 0xC2B2AE35u;
  return h ^ (h >> 15);
}

// hash_jitter: (h & 0xFFFFFF) / 2^24 * 0.49 in float32 (the division by a
// power of two is exact)
__device__ __forceinline__ float jitter(uint32_t base, uint32_t a, uint32_t b) {
  const uint32_t h = mix(mix(base, a), b);
  return __fmul_rn(__fmul_rn(__uint2float_rn(h & 0xFFFFFFu), 5.9604644775390625e-08f), 0.49f);
}

__device__ __forceinline__ int home(int l, int cap) {
  return (int)(((unsigned long long)((uint32_t)l * 0x9E3779B1u) * (unsigned)cap) >> 32);
}

// The slot of label l in a table of cap slots, inserting it if new; the
// table holds at most cap / 2 labels, so a free slot is always found.
__device__ __forceinline__ int insert_shared(int* key, int cap, int l) {
  int p = home(l, cap);
  while (true) {
    int k = *(volatile int*)(key + p);
    if (k == kEmpty) k = atomicCAS(key + p, kEmpty, l);
    if (k == kEmpty || k == l) return p;
    if (++p == cap) p = 0;
  }
}

// The same in device memory, read at L2 (where the atomics are) before
// paying for one: a hub inserts its few labels many times.
__device__ __forceinline__ int insert_global(int* key, int cap, int l) {
  int p = home(l, cap);
  while (true) {
    int k = __ldcg(key + p);
    if (k == kEmpty) k = atomicCAS(key + p, kEmpty, l);
    if (k == kEmpty || k == l) return p;
    if (++p == cap) p = 0;
  }
}

// First index in [lo, hi) where pred holds, else hi; pred is monotone
// (false, then true).  Each round the warp probes 32 points, one a lane.
template <class P>
__device__ __forceinline__ int warp_first(int lo, int hi, int lane, P pred) {
  while (lo < hi) {
    const int step = (hi - lo + kWarp - 1) / kWarp;
    const int q = lo + lane * step;
    const unsigned m = __ballot_sync(kFull, q >= hi || pred(q));
    if (m & 1u) return lo;
    if (m == 0) {
      lo += (kWarp - 1) * step + 1;
      continue;
    }
    const int f = __ffs(m) - 1;
    hi = min(hi, lo + f * step);
    lo += (f - 1) * step + 1;
  }
  return lo;
}

__device__ __forceinline__ void better(float& best, int& bl, float s, int l) {
  if (s > best || (s == best && l < bl)) {
    best = s;
    bl = l;
  }
}

__device__ __forceinline__ void warp_best(float& best, int& bl) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int ol = __shfl_xor_sync(kFull, bl, off);
    better(best, bl, ob, ol);
  }
}

// One row's view of the step: its chunk, labels, weights and outputs.
template <typename Lab>
struct Row {
  const int64_t* nodes;
  const uint8_t* node_valid;
  const int64_t* dst;
  const float* ew;
  const int64_t* eslot;
  const Lab* lab;
  const float* wrow;
  const float* nwrow;
  float* fin;
  float* fout;
  int32_t* prop;
  int32_t* seg;
  float U;
  uint32_t bj;
  int nv;  // valid arcs of the chunk
};

template <bool kRefine, typename Lab>
__device__ __forceinline__ Row<Lab> row_of(const Args& a, int b, int it, int c, int parity) {
  const long long cc = a.perm[(long long)b * a.steps + c];
  const long long eoff = b * a.edge_row + cc * a.E;
  Row<Lab> r;
  r.nodes = a.nodes + b * a.node_row + cc * a.N;
  r.node_valid = a.node_valid + b * a.node_row + cc * a.N;
  r.dst = a.edge_dst + eoff;
  r.ew = a.edge_w + eoff;
  r.eslot = a.edge_slot + eoff;
  r.lab = static_cast<const Lab*>(a.labels) + (long long)b * a.A;
  r.wrow = ((kRefine && parity) ? a.w1 : a.w0) + (long long)b * a.W;
  r.nwrow = a.nw + b * a.nw_row;
  r.fin = a.flow + ((long long)parity * 2 * a.B + b) * a.W;
  r.fout = r.fin + a.B * a.W;
  r.prop = a.prop + (long long)b * a.N;
  r.seg = a.seg + (long long)b * a.N * 2;
  r.U = a.U[b];
  r.bj = (uint32_t)a.base_jit[((long long)it * a.B + b) * a.steps + c];
  r.nv = a.nvalid[b * a.nvalid_row + cc];
  return r;
}

// What the step knows of one node slot.
struct Node {
  long long v;
  int slot, own, rv;
  float nwv;
  bool over;
};

template <bool kRefine, bool kRestrict, typename Lab>
__device__ __forceinline__ Node node_at(const Args& a, const Row<Lab>& r, int slot) {
  Node nd;
  nd.slot = slot;
  nd.v = r.nodes[slot];
  nd.own = (int)r.lab[nd.v];
  nd.nwv = r.nwrow[nd.v];
  nd.over = kRefine && r.wrow[min(nd.own, (int)a.T)] > r.U;
  nd.rv = kRestrict ? a.restr[nd.v] : 0;
  return nd;
}

// Score one run (label l, summed weight rw) of node nd, as the plain
// version's eligibility and score, into (best, bl).
template <bool kRefine, typename Lab>
__device__ __forceinline__ void consider(const Row<Lab>& r, const Node& nd, int l, float rw,
                                         float& best, int& bl) {
  const bool fits = __fadd_rn(r.wrow[l], nd.nwv) <= r.U;
  const bool elig = (kRefine && nd.over) ? (fits && l != nd.own)
                                         : (rw > 0.f && (fits || l == nd.own));
  if (elig) better(best, bl, __fadd_rn(rw, jitter(r.bj, (uint32_t)nd.slot, (uint32_t)l)), l);
}

// The proposal of one node: the mover's flows, then its slot's label.
template <bool kRefine, typename Lab>
__device__ __forceinline__ void propose(const Row<Lab>& r, const Node& nd, int bl) {
  const int t = bl != kNone ? bl : nd.own;
  if (kRefine && t != nd.own) {
    atomicAdd(r.fin + t, nd.nwv);
    atomicAdd(r.fout + nd.own, nd.nwv);
  }
  r.prop[nd.slot] = t != nd.own ? t : -1;
}

template <bool kRefine, typename Lab>
__global__ void __launch_bounds__(kThreads)
segment_kernel(Args a, int it, int c, int parity) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  if (kRefine) {
    // the next step's weights start as this step's; the other parity's
    // flows start at zero
    const float* wcur = parity ? a.w1 : a.w0;
    float* wnext = parity ? a.w0 : a.w1;
    float* fnext = a.flow + (long long)(1 - parity) * 2 * a.B * a.W;
    const long long n = a.B * a.W;
    const long long stride = (long long)gridDim.x * gridDim.y * kThreads;
    for (long long i = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kThreads + threadIdx.x;
         i < n; i += stride) {
      wnext[i] = wcur[i];
      fnext[i] = 0.f;
      fnext[n + i] = 0.f;
    }
  }
  const int slot = blockIdx.x * kWarps + warp;
  if (slot >= a.N) return;
  const Row<Lab> r = row_of<kRefine, Lab>(a, b, it, c, parity);
  if (!r.node_valid[slot]) return;
  const int lo = warp_first(0, r.nv, lane, [&](int i) { return r.eslot[i] >= slot; });
  // most nodes end within 32 arcs: one coalesced probe, else the search
  const int q = lo + lane;
  const unsigned m = __ballot_sync(kFull, q >= r.nv || r.eslot[q] > slot);
  const int hi = m ? lo + __ffs(m) - 1
                   : warp_first(lo + kWarp, r.nv, lane, [&](int i) { return r.eslot[i] > slot; });
  if (lane == 0) {
    r.seg[2 * slot] = lo;
    r.seg[2 * slot + 1] = hi;
  }
  const int d = hi - lo;
  if (d <= kLightArcs) return;
  // a hub: its pieces into the list, its table emptied
  const int np = (d + kPieceArcs - 1) / kPieceArcs;
  int h = 0, p0 = 0;
  if (lane == 0) {
    h = atomicAdd(a.ctr, 1);
    p0 = atomicAdd(a.ctr + 1, np);
    a.hub[4 * h] = b;
    a.hub[4 * h + 1] = slot;
    a.hub[4 * h + 2] = lo;
    a.hub[4 * h + 3] = hi;
    a.hub_state[3 * h] = np;
    a.hub_state[3 * h + 1] = 0;
    a.hub_state[3 * h + 2] = 0;
    a.hub_tot[h] = 0;
  }
  h = __shfl_sync(kFull, h, 0);
  p0 = __shfl_sync(kFull, p0, 0);
  for (int i = lane; i < np; i += kWarp) {
    a.piece[2 * (p0 + i)] = h;
    a.piece[2 * (p0 + i) + 1] = i;
  }
  const int cap = 2 * min(d, (int)a.T);
  int* key = a.tkey + (long long)b * 2 * a.E + 2LL * lo;
  float* sum = a.tsum + (long long)b * 2 * a.E + 2LL * lo;
  for (int p = lane; p < cap; p += kWarp) {
    __stcg(key + p, kEmpty);
    __stcg(sum + p, 0.f);
  }
}

template <bool kRefine, bool kRestrict, typename Lab>
__global__ void __launch_bounds__(kThreads)
propose_kernel(Args a, int it, int c, int parity) {
  __shared__ int s_key[kWarps][kLightCap];
  __shared__ float s_sum[kWarps][kLightCap];
  __shared__ float s_stage[kWarps][kWarp];
  __shared__ float s_best[kWarps];
  __shared__ int s_bl[kWarps];
  __shared__ int s_piece, s_last;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int T = (int)a.T;
  float* stage = s_stage[warp];

  // ---- light nodes, one warp each
  const int slot = blockIdx.x + warp * gridDim.x;
  if (slot < a.N) {
    const Row<Lab> r = row_of<kRefine, Lab>(a, blockIdx.y, it, c, parity);
    if (!r.node_valid[slot]) {
      if (lane == 0) r.prop[slot] = -1;
    } else if (r.seg[2 * slot + 1] - r.seg[2 * slot] <= kLightArcs) {
      const int lo = r.seg[2 * slot], hi = r.seg[2 * slot + 1];
      const Node nd = node_at<kRefine, kRestrict>(a, r, slot);
      int* key = s_key[warp];
      float* sum = s_sum[warp];
      int cap = kWarp;
      while (cap < 2 * (hi - lo)) cap <<= 1;
      for (int p = lane; p < cap; p += kWarp) {
        key[p] = kEmpty;
        sum[p] = 0.f;
      }
      __syncwarp();
      for (int base = lo; base < hi; base += kWarp) {
        const int j = base + lane;
        int run = -1;
        float w = 0.f;
        if (j < hi) {
          const long long d = r.dst[j];
          if (!kRestrict || a.restr[d] == nd.rv) {
            w = r.ew[j];
            run = insert_shared(key, cap, (int)r.lab[d]);
          }
        }
        stage[lane] = w;
        const unsigned grp = __match_any_sync(kFull, run);
        __syncwarp();
        // the run's leader adds the tile's weights of its run in lane
        // (= pack) order
        if (run >= 0 && lane == __ffs(grp) - 1) {
          float s = sum[run];
          for (unsigned m = grp; m; m &= m - 1) s = __fadd_rn(s, stage[__ffs(m) - 1]);
          sum[run] = s;
        }
        __syncwarp();
      }
      float best = kNeg;
      int bl = kNone;
      for (int p = lane; p < cap; p += kWarp) {
        const int l = key[p];
        if (l != kEmpty) consider<kRefine>(r, nd, l, sum[p], best, bl);
      }
      warp_best(best, bl);
      if (lane == 0) propose<kRefine>(r, nd, bl);
    }
  }

  // ---- hub pieces, taken by any block until none is left
  const int npieces = a.ctr[1];
  while (true) {
    __syncthreads();  // s_piece, s_stage and s_best of the last piece are free
    if (threadIdx.x == 0) s_piece = atomicAdd(a.ctr + 2, 1);
    __syncthreads();
    const int i = s_piece;
    if (i >= npieces) break;
    const int h = a.piece[2 * i], pi = a.piece[2 * i + 1];
    const int b = a.hub[4 * h], hs = a.hub[4 * h + 1];
    const int lo = a.hub[4 * h + 2], hi = a.hub[4 * h + 3];
    const Row<Lab> r = row_of<kRefine, Lab>(a, b, it, c, parity);
    const Node nd = node_at<kRefine, kRestrict>(a, r, hs);
    const int cap = 2 * min(hi - lo, T);
    int* key = a.tkey + (long long)b * 2 * a.E + 2LL * lo;
    float* sum = a.tsum + (long long)b * 2 * a.E + 2LL * lo;
    int32_t* run = a.trun + (long long)b * a.E;
    const int j1 = min(hi, lo + (pi + 1) * kPieceArcs);
    // fill the table and add the weights in any order, a warp's share of a
    // run in one atomic, kUnroll arcs a lane in flight
    int inexact = 0;
    unsigned long long tot = 0;   // while every weight is an integer
    for (int base = lo + pi * kPieceArcs + warp * kWarp * kUnroll; base < j1;
         base += kThreads * kUnroll) {
      long long hd[kUnroll];
      float hw[kUnroll];
      int hl[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kWarp + lane;
        hd[u] = j < j1 ? r.dst[j] : -1;
        hw[u] = j < j1 ? r.ew[j] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = hd[u] >= 0 && (!kRestrict || a.restr[hd[u]] == nd.rv);
        hl[u] = ok ? (int)r.lab[hd[u]] : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kWarp + lane;
        int t = -1;
        float w = 0.f;
        if (hl[u] >= 0) {
          w = hw[u];
          t = insert_global(key, cap, hl[u]);
          if (w == truncf(w) && fabsf(w) <= (float)kExactSum) {
            tot += (unsigned long long)fabsf(w);
          } else {
            inexact = 1;
          }
        }
        if (j < j1) __stcg(run + j, t);
        stage[lane] = w;
        const unsigned grp = __match_any_sync(kFull, t);
        __syncwarp();
        if (t >= 0 && lane == __ffs(grp) - 1) {
          float s = 0.f;
          for (unsigned m = grp; m; m &= m - 1) s += stage[__ffs(m) - 1];
          atomicAdd(sum + t, s);
        }
        __syncwarp();
      }
    }
    inexact = __any_sync(kFull, inexact);
    for (int off = kWarp / 2; off > 0; off >>= 1) tot += __shfl_xor_sync(kFull, tot, off);
    if (lane == 0) {
      if (inexact) atomicOr(a.hub_state + 3 * h + 2, 1);
      if (tot) atomicAdd(a.hub_tot + h, tot);
    }
    // the piece's writes are seen by the block that finishes the hub
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      s_last = atomicAdd(a.hub_state + 3 * h + 1, 1) == a.hub_state[3 * h] - 1;
      __threadfence();
    }
    __syncthreads();
    if (!s_last) continue;

    // ---- the hub's last piece: its runs are summed
    if (__ldcg(a.hub_state + 3 * h + 2) || __ldcg(a.hub_tot + h) > kExactSum) {
      // a sum the order could change: again from zero, in pack order; warp
      // w walks every arc and adds those of the runs t with t % 8 == w
      for (int p = threadIdx.x; p < cap; p += kThreads) __stcg(sum + p, 0.f);
      __syncthreads();
      for (int base = lo; base < hi; base += kWarp) {
        const int j = base + lane;
        const int t = j < hi ? __ldcg(run + j) : -1;
        const bool mine = t >= 0 && t % kWarps == warp;
        stage[lane] = mine ? r.ew[j] : 0.f;
        const unsigned grp = __match_any_sync(kFull, mine ? t : -2 - lane);
        __syncwarp();
        if (mine && lane == __ffs(grp) - 1) {
          float s = __ldcg(sum + t);
          for (unsigned m = grp; m; m &= m - 1) s = __fadd_rn(s, stage[__ffs(m) - 1]);
          __stcg(sum + t, s);
        }
        __syncwarp();
      }
      __syncthreads();
    }
    float best = kNeg;
    int bl = kNone;
    for (int p = threadIdx.x; p < cap; p += kThreads) {
      const int l = __ldcg(key + p);
      if (l != kEmpty) consider<kRefine>(r, nd, l, __ldcg(sum + p), best, bl);
    }
    warp_best(best, bl);
    if (lane == 0) {
      s_best[warp] = best;
      s_bl[warp] = bl;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) better(best, bl, s_best[w], s_bl[w]);
      propose<kRefine>(r, nd, bl);
      atomicAdd(a.block_nodes, 1ull);
    }
  }
}

template <bool kRefine, typename Lab>
__global__ void __launch_bounds__(kApplyThreads)
apply_kernel(Args a, int it, int c, int parity) {
  __shared__ unsigned s_moved;
  const int b = blockIdx.y;
  const long long slot = (long long)blockIdx.x * kApplyThreads + threadIdx.x;
  if (threadIdx.x == 0) {
    s_moved = 0;
    // the next step's hub list starts empty
    if (blockIdx.x == 0 && b == 0) a.ctr[0] = a.ctr[1] = a.ctr[2] = 0;
  }
  __syncthreads();
  bool moved = false;
  const int t = slot < a.N ? a.prop[(long long)b * a.N + slot] : -1;
  if (t >= 0) {
    const long long cc = a.perm[(long long)b * a.steps + c];
    const long long v = a.nodes[b * a.node_row + cc * a.N + slot];
    Lab* lab = static_cast<Lab*>(a.labels) + (long long)b * a.A;
    const int own = (int)lab[v];
    const float nwv = a.nw[b * a.nw_row + v];
    float* wnext;
    if (kRefine) {
      const long long row = (long long)b * a.W;
      const float* wcur = (parity ? a.w1 : a.w0) + row;
      const float* fin = a.flow + (long long)parity * 2 * a.B * a.W + row;
      const float* fout = fin + a.B * a.W;
      const float head = __fadd_rn(__fsub_rn(a.U[b], wcur[t]), fout[t]);
      const float in = fin[t];
      float p = __fdiv_rn(head, in < 1e-9f ? 1e-9f : in);
      p = p < 0.f ? 0.f : (p > 1.f ? 1.f : p);
      const uint32_t bg = (uint32_t)a.base_gate[((long long)it * a.B + b) * a.steps + c];
      moved = __fdiv_rn(jitter(bg, (uint32_t)v, (uint32_t)t), 0.49f) < p;
      wnext = (parity ? a.w0 : a.w1) + row;
    } else {
      moved = true;
      wnext = a.w0 + (long long)b * a.W;
    }
    if (moved) {
      lab[v] = (Lab)t;
      atomicAdd(wnext + own, -nwv);
      atomicAdd(wnext + t, nwv);
    }
  }
  const unsigned m = __ballot_sync(kFull, moved);
  if (threadIdx.x % kWarp == 0 && m) atomicAdd(&s_moved, (unsigned)__popc(m));
  __syncthreads();
  if (threadIdx.x == 0 && s_moved) atomicAdd(a.moves + b, (unsigned long long)s_moved);
}

template <bool kRefine, bool kRestrict, typename Lab>
cudaError_t launch(const Args& a, int it, int c, int parity, cudaStream_t s) {
  const unsigned rows = (unsigned)a.B;
  const unsigned slot_blocks = (unsigned)((a.N + kWarps - 1) / kWarps);
  segment_kernel<kRefine, Lab><<<dim3(slot_blocks, rows), kThreads, 0, s>>>(a, it, c, parity);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  propose_kernel<kRefine, kRestrict, Lab><<<dim3(slot_blocks, rows), kThreads, 0, s>>>(
      a, it, c, parity);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned apply_blocks = (unsigned)((a.N + kApplyThreads - 1) / kApplyThreads);
  apply_kernel<kRefine, Lab><<<dim3(apply_blocks, rows), kApplyThreads, 0, s>>>(
      a, it, c, parity);
  return cudaGetLastError();
}

template <typename Lab>
cudaError_t launch_lab(const Args& a, int it, int c, int parity, int refine, int restr,
                       cudaStream_t s) {
  if (refine) {
    return restr ? launch<true, true, Lab>(a, it, c, parity, s)
                 : launch<true, false, Lab>(a, it, c, parity, s);
  }
  return restr ? launch<false, true, Lab>(a, it, c, parity, s)
               : launch<false, false, Lab>(a, it, c, parity, s);
}

}  // namespace

extern "C" long long lp_chunk_step_args_size(void) { return (long long)sizeof(Args); }

extern "C" int lp_chunk_step_light_arcs(void) { return kLightArcs; }

extern "C" int lp_chunk_step_piece_arcs(void) { return kPieceArcs; }

// Launches step (it, c) of a sweep on `stream`: segment, propose, apply
// (three launches); returns the cudaError_t of the launches.  parity picks
// the buffers of refine mode: this step reads w0 and flow[0] when it is 0.
extern "C" int lp_chunk_step_launch(const void* args, int it, int c, int parity, int refine,
                                    int restr, int lab64, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(lab64 ? launch_lab<int64_t>(a, it, c, parity, refine, restr, s)
                     : launch_lab<int32_t>(a, it, c, parity, refine, restr, s));
}

extern "C" const char* lp_chunk_step_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
