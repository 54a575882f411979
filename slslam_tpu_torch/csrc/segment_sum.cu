// K1: segment_sum -- per-segment row sums (O, D) x idx (O,) -> (P, D), and
// the segment plan that groups the rows by index.
//
// Replaces the TPU kernel segment_sum_pallas / _seg_sum_kernel
// (slslam_tpu/ops/pallas_kernels.py:30-81), which builds a one-hot tile in
// VMEM and multiplies it on the MXU over a sequential (P-tiles, O-chunks)
// grid.  Rows whose index is outside [0, P) are padding and are dropped.
//
// What bounds it on the H100: nothing the card is short of.  The window BA
// calls it at O = 162..1600 rows, D = 1..42 lanes, P = 4..1620 segments,
// the refine's PCG at O = 29,600 rows, D = 6 or 36, P = 400 cameras: at
// most ~4.3 MB read, a few microseconds of work.  It is launch-bound;
// what the design can cut is the serial work inside each block.
//
// The segment plan (seg_plan) is a stable counting sort of the rows by
// index: perm (O,) lists the rows of segment 0, then segment 1, ..., each
// in observation order, then the dropped rows; offsets (P + 1,) holds where
// each segment starts, and offsets[P] counts the kept rows.  One block per
// segment p (plus one block for the dropped rows): it counts the rows with
// a smaller index (__syncthreads_count over tiles of the index array) and
// writes its own rows in order (warp ballots, a prefix over the warps of
// the tile).  Integer work only, no atomics, no data-dependent order.  Each
// block reads the whole key twice, so a plan costs (P + 1) x 2 O reads of
// the key, from L2 at the window's sizes; the (cam, line) pair plan, P =
// C L = 1620, is the costliest.  A BA solve builds its plans once and
// reuses them in every LM iteration.
//
// Design of the sum: one block per (segment, column tile), driven by a
// plan.  A block of kThreads threads holds D' = min(D, kThreads) columns
// and R = kThreads / D' row slots, so at D = 1 all threads take rows.  Slot
// r sums the segment's rows r, r + R, ... in plan order, and the R partials
// meet in a fixed tree in shared memory.  The result is the same from run
// to run.  Every output element is written, so the caller need not zero
// the output.  Nothing is allocated.  A caller without a plan builds one
// first (the wrapper does: segment_plan, then the sum).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int plan_key(const int* __restrict__ idx, int o,
                                        int P) {
  const int k = idx[o];
  return (k >= 0 && k < P) ? k : P;
}

// Stable in-order compaction of the rows o in [base, base + kThreads) with
// key == p into rows[0, n); returns n.  Every thread must call it.
__device__ __forceinline__ int compact_tile(const int* __restrict__ idx,
                                            int base, int O, int P, int p,
                                            int* rows, int* warp_n) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int o = base + t;
  const bool hit = o < O && plan_key(idx, o, P) == p;
  const unsigned mask = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) warp_n[warp] = __popc(mask);
  __syncthreads();
  int before = 0;
  int total = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_n[w];
    total += warp_n[w];
  }
  if (hit) rows[before + __popc(mask & ((1u << lane) - 1u))] = o;
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads) seg_plan_kernel(
    const int* __restrict__ idx, int O, int P, int* __restrict__ perm,
    int* __restrict__ offsets) {
  __shared__ int rows[kThreads];
  __shared__ int warp_n[kWarps];
  const int p = blockIdx.x;  // P: the dropped rows
  int start = 0;
  for (int base = 0; base < O; base += kThreads) {
    const int o = base + threadIdx.x;
    start += __syncthreads_count(o < O && plan_key(idx, o, P) < p);
  }
  if (threadIdx.x == 0) offsets[p] = start;
  int done = 0;
  for (int base = 0; base < O; base += kThreads) {
    const int n = compact_tile(idx, base, O, P, p, rows, warp_n);
    if (threadIdx.x < n) perm[start + done + threadIdx.x] = rows[threadIdx.x];
    done += n;
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) seg_sum_kernel(
    const T* __restrict__ vals, const int* __restrict__ perm,
    const int* __restrict__ offsets, T* __restrict__ out, int D, int cols) {
  __shared__ T part[kThreads];
  const int p = blockIdx.x;
  const int t = threadIdx.x;
  const int R = kThreads / cols;
  const int j = t % cols;
  const int r = t / cols;
  const int d = blockIdx.y * cols + j;
  const int* seg = perm + offsets[p];
  const int n = offsets[p + 1] - offsets[p];
  T acc = T(0);
  if (r < R && d < D)
    for (int k = r; k < n; k += R)
      acc += vals[static_cast<size_t>(seg[k]) * D + d];
  part[t] = acc;
  __syncthreads();
  // fixed tree over the R row slots of each column
  int span = 1;
  while (span < R) span <<= 1;
  for (int s = span >> 1; s > 0; s >>= 1) {
    if (r < s && r + s < R) part[t] += part[t + s * cols];
    __syncthreads();
  }
  if (r == 0 && d < D) out[static_cast<size_t>(p) * D + d] = part[t];
}

template <typename T>
int launch_sum(const void* vals, const void* perm, const void* offsets,
               void* out, int D, int P, void* stream) {
  const int cols = D < kThreads ? D : kThreads;
  dim3 grid(P, (D + cols - 1) / cols);
  seg_sum_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(perm),
      static_cast<const int*>(offsets), static_cast<T*>(out), D, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// perm / offsets: the plan of the rows' indices (seg_plan) over P
// segments.  P >= 1, D >= 1.
extern "C" int seg_sum_f32(const void* vals, const void* perm,
                           const void* offsets, void* out, int D, int P,
                           void* stream) {
  return launch_sum<float>(vals, perm, offsets, out, D, P, stream);
}

extern "C" int seg_sum_f64(const void* vals, const void* perm,
                           const void* offsets, void* out, int D, int P,
                           void* stream) {
  return launch_sum<double>(vals, perm, offsets, out, D, P, stream);
}

// perm (O,) and offsets (P + 1,) of the int32 keys idx (O,).
extern "C" int seg_plan(const void* idx, int O, int P, void* perm,
                        void* offsets, void* stream) {
  seg_plan_kernel<<<P + 1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), O, P, static_cast<int*>(perm),
      static_cast<int*>(offsets));
  return static_cast<int>(cudaGetLastError());
}
