// lp_score_rows: per-ELL-row block-connection scores for LP refinement.
//
// Replaces the Pallas TPU kernel repro/kernels/lp_score/lp_score.py::
// lp_score_rows.  For every row r of a row-split ELL pack,
//
//     S[r, b] = sum_j w[r, j] * [lbl[r, j] == b],   b in [0, k),
//
// where labels outside [0, k) contribute nothing (the sentinel label k marks
// padding).  Input: lbl (R, W) int32, w (R, W) float32, row-major and
// contiguous.  Output: S (R, k) float32.  Unlike the TPU kernel there is no
// 128-lane padding of k and no 8-wide slicing of W: the output is (R, k).
//
// Bound.  The function reads R*W*8 bytes and writes R*k*4 bytes and does
// R*W adds, so it is bound by memory bandwidth: at the dense refinement's
// finest shape (R = 2^21 rows, W = 128, k = 16) that is 2.15 GB read and
// 0.13 GB written per launch.
//
// Design (simple first).  One block of 256 threads owns a tile of
// rows_per_block consecutive rows and keeps their (rows, k) float
// accumulator in shared memory.  The threads sweep the tile's
// rows_per_block * W slots with coalesced 16-byte loads of lbl and w
// (4 slots per thread per step; a tile is one contiguous range of both
// arrays), marked streaming (__ldcs) since every byte is read once.  Each
// in-range slot adds into its (row, label) cell with a shared-memory
// atomic, and the tile is written back in one coalesced pass.  Device
// memory is touched exactly once per input and output byte, which is what
// the bound asks for; the shared-memory atomics are the open cost (labels
// of one row often agree, so the 32 lanes of a warp collide on few cells).
// Sums are exact for integral weights below 2^24; for other weights their
// order varies from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void add_slot(float* acc_row, int label, float w, int k) {
  if ((unsigned)label < (unsigned)k) atomicAdd(acc_row + label, w);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
lp_score_rows_kernel(const int32_t* __restrict__ lbl, const float* __restrict__ w,
                     float* __restrict__ out, long long R, int W, int k,
                     int rows_per_block) {
  extern __shared__ float acc[];
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int nrows = (int)min((long long)rows_per_block, R - row0);
  const int tile = nrows * k;
  for (int i = threadIdx.x; i < tile; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const long long base = row0 * W;
  const int n_slots = nrows * W;
  if (kVec) {
    // W % 4 == 0 and 16-byte aligned bases: the 4 slots of a vector share
    // one row
    const int4* l4 = reinterpret_cast<const int4*>(lbl + base);
    const float4* w4 = reinterpret_cast<const float4*>(w + base);
    const int n_vec = n_slots >> 2;
    for (int v = threadIdx.x; v < n_vec; v += kThreads) {
      const int4 l = __ldcs(l4 + v);
      const float4 x = __ldcs(w4 + v);
      float* a = acc + ((v << 2) / W) * k;
      add_slot(a, l.x, x.x, k);
      add_slot(a, l.y, x.y, k);
      add_slot(a, l.z, x.z, k);
      add_slot(a, l.w, x.w, k);
    }
  } else {
    for (int e = threadIdx.x; e < n_slots; e += kThreads) {
      add_slot(acc + (e / W) * k, __ldcs(lbl + base + e), __ldcs(w + base + e), k);
    }
  }
  __syncthreads();

  float* o = out + row0 * k;
  for (int i = threadIdx.x; i < tile; i += kThreads) o[i] = acc[i];
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
extern "C" int lp_score_rows_launch(const void* lbl, const void* w, void* out,
                                    long long R, int W, int k,
                                    int rows_per_block, int vec, void* stream) {
  const long long blocks = (R + rows_per_block - 1) / rows_per_block;
  const size_t smem = (size_t)rows_per_block * k * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    lp_score_rows_kernel<true><<<(unsigned)blocks, kThreads, smem, s>>>(
        static_cast<const int32_t*>(lbl), static_cast<const float*>(w),
        static_cast<float*>(out), R, W, k, rows_per_block);
  } else {
    lp_score_rows_kernel<false><<<(unsigned)blocks, kThreads, smem, s>>>(
        static_cast<const int32_t*>(lbl), static_cast<const float*>(w),
        static_cast<float*>(out), R, W, k, rows_per_block);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lp_score_rows_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
