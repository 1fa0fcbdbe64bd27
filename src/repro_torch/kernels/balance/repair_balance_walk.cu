// repair_balance_walk: the sequential walk of the final balance repair.
//
// Replaces no TPU kernel: the reference repairs balance on the host
// (repro/core/initial_partition.py::repair_balance, a Python loop over every
// node).  This is that loop, run on the card over the candidates that the
// prelude (repro_torch/kernels/balance/ops.py) has already found and
// ordered: the nodes of blocks above L at the start, cheapest to move first.
// For each candidate v of block b, in order, exactly as the host decides:
//
//     if bw[b] <= L: skip
//     t = argmin(bw)                    (first index of the minimum)
//     if bw[t] + c(v) > L or t == b: skip
//     move v to t; bw[b] -= c(v); bw[t] += c(v)
//     stop once no block is above L
//
// Input: cand (C,) int64 node ids, cand_lab (C,) int32 and cand_nw (C,)
// float32 (each candidate's block and weight, gathered by the prelude),
// labels (n_labels,) int32, written in place (the wrapper hands in a
// clone), bw (k,) float64 block weights, a scratch copy the kernel may
// write.  Output: the number of nodes moved, one int64.
//
// Bound.  The walk is serial by definition: each decision reads the block
// weights the previous move left.  So it is bound by the latency of one
// step's chain of dependent instructions, not by bytes (C * 16 bytes read,
// a few bytes written per move).
//
// Design.  One warp.  The k block weights live in shared memory as float64
// (any k up to the card's opt-in shared memory, ~27 k blocks on an H100;
// beyond that they stay in the scratch copy in global memory, where the
// same code reads them through L1), and every sum and comparison is the
// host's, in the host's order, so the decisions are bit for bit the host's
// for any weights.  The candidates stream through a shared tile in
// coalesced loads, and the tile's moves go out to the labels after its
// walk, all lanes at once.  Lane l owns blocks l, l + 32, ... and keeps the
// minimum of its slice in registers; the argmin is a warp reduction of
// those (ties to the lowest index, as np.argmin).  A move changes two
// blocks, so only their owners rescan their slices before the reduction; a
// skip changes nothing, so the argmin is kept.  A count of blocks above L
// takes the place of the host's bw.max() <= L test.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kTile = 1024;
constexpr int kDefaultSmem = 48 * 1024;  // shared memory a block gets without an opt-in
constexpr unsigned kFull = 0xffffffffu;

// The lane's share of the argmin: first index of the minimum over the
// blocks lane, lane + 32, ... (k / 32 of them, one when k <= 32).
__device__ __forceinline__ void slice_min(const double* w, int k, int lane, double& v,
                                          int& i) {
  v = __longlong_as_double(0x7ff0000000000000LL);  // +inf
  i = 0x7fffffff;
  for (int b = lane; b < k; b += kWarp) {
    const double x = w[b];
    if (x < v) {
      v = x;
      i = b;
    }
  }
}

// The warp's minimum of (v, i) pairs, ties to the lower index; the same in
// every lane.
__device__ __forceinline__ void warp_min(double& v, int& i) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// kShared: the block weights are copied into dynamic shared memory;
// otherwise the walk reads and writes them in bw itself.
template <bool kShared>
__global__ void __launch_bounds__(kWarp)
repair_balance_walk_kernel(const int64_t* __restrict__ cand,
                           const int32_t* __restrict__ cand_lab,
                           const float* __restrict__ cand_nw, long long C,
                           int32_t* __restrict__ labels, long long n_labels, double* bw,
                           int k, double L, long long* __restrict__ moved_out) {
  extern __shared__ double s_dyn[];
  __shared__ long long s_id[kTile];
  __shared__ int s_lab[kTile];
  __shared__ float s_nw[kTile];
  const int lane = threadIdx.x;
  double* w = kShared ? s_dyn : bw;

  int over = 0;  // blocks above L
  for (int i = lane; i < k; i += kWarp) {
    const double x = bw[i];
    if (kShared) w[i] = x;
    over += x > L;
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) over += __shfl_xor_sync(kFull, over, off);
  __syncwarp();
  double lv;  // this lane's slice minimum and its block
  int li;
  slice_min(w, k, lane, lv, li);
  double wt = lv;  // the lightest block's weight and index: the target
  int tgt = li;
  warp_min(wt, tgt);

  long long moved = 0;
  for (long long base = 0; base < C && over > 0; base += kTile) {
    const int cnt = (int)min((long long)kTile, C - base);
    __syncwarp();  // the previous tile is consumed
#pragma unroll 4
    for (int j = lane; j < cnt; j += kWarp) {
      s_id[j] = cand[base + j];
      const int b = cand_lab[base + j];
      s_lab[j] = (unsigned)b < (unsigned)k ? b : k;  // k: out of range, skipped
      s_nw[j] = cand_nw[base + j];
    }
    __syncwarp();
    for (int j = 0; j < cnt; ++j) {
      // every lane reads the same words, so the warp branches as one
      const int b = s_lab[j];
      if ((unsigned)b >= (unsigned)k) continue;
      const double wb = w[b];
      if (wb <= L) continue;
      const double x = (double)s_nw[j];
      if (wt + x > L || tgt == b) continue;
      const double nb = wb - x;
      const double nt = wt + x;
      __syncwarp();  // every lane has read w[b] before its owner writes it
      // the lanes that own blocks b and t write them and refresh their slice
      const bool own_b = lane == (b & (kWarp - 1));
      const bool own_t = lane == (tgt & (kWarp - 1));
      if (own_b) w[b] = nb;
      if (own_t) w[tgt] = nt;
      if (own_b || own_t) slice_min(w, k, lane, lv, li);
      if (lane == 0) s_lab[j] = ~tgt;  // moved: written out with the tile
      ++moved;
      // b was above L; t is at or below L now (nt <= L was tested)
      over -= (nb <= L) + (wt > L);
      __syncwarp();
      if (over == 0) break;
      wt = lv;
      tgt = li;
      warp_min(wt, tgt);
    }
    __syncwarp();
    // the tile's moves, off the serial path: no global store waits on a
    // warp barrier inside the walk
    for (int j = lane; j < cnt; j += kWarp) {
      const int t = s_lab[j];
      const long long v = s_id[j];
      if (t < 0 && v >= 0 && v < n_labels) labels[v] = ~t;
    }
  }
  if (lane == 0) *moved_out = moved;
}

// The most block weights the shared-memory variant holds on the current
// device, beside its static tile (0 on an error: the global variant runs).
long long shared_k_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&fa, repair_balance_walk_kernel<true>) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return ((long long)optin - (long long)fa.sharedSizeBytes) / (long long)sizeof(double);
}

}  // namespace

extern "C" long long repair_balance_walk_shared_k(void) { return shared_k_limit(); }

// Launches one warp on `stream`: with the k block weights in dynamic shared
// memory beside the 16 KiB static tile where they fit (opting in above the
// default 48 KiB), else in bw; returns the cudaError_t of the launch.
extern "C" int repair_balance_walk_launch(const void* cand, const void* cand_lab,
                                          const void* cand_nw, long long C, void* labels,
                                          long long n_labels, void* bw, int k, double L,
                                          void* moved, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* c = static_cast<const int64_t*>(cand);
  const int32_t* cl = static_cast<const int32_t*>(cand_lab);
  const float* cn = static_cast<const float*>(cand_nw);
  int32_t* lab = static_cast<int32_t*>(labels);
  double* w = static_cast<double*>(bw);
  long long* mv = static_cast<long long*>(moved);
  if ((long long)k <= shared_k_limit()) {
    const size_t dyn = (size_t)k * sizeof(double);
    const size_t tile = (size_t)kTile * (sizeof(long long) + sizeof(int) + sizeof(float));
    if (tile + dyn > (size_t)kDefaultSmem) {
      const cudaError_t e = cudaFuncSetAttribute(
          repair_balance_walk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)dyn);
      if (e != cudaSuccess) return (int)e;
    }
    repair_balance_walk_kernel<true><<<1, kWarp, dyn, s>>>(c, cl, cn, C, lab, n_labels, w, k,
                                                           L, mv);
  } else {
    repair_balance_walk_kernel<false><<<1, kWarp, 0, s>>>(c, cl, cn, C, lab, n_labels, w, k,
                                                          L, mv);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repair_balance_walk_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
