// K1: segment_sum -- per-segment row sums (O, D) x idx (O,) -> (P, D).
//
// Replaces the TPU kernel segment_sum_pallas / _seg_sum_kernel
// (slslam_tpu/ops/pallas_kernels.py:30-81), which builds a one-hot tile in
// VMEM and multiplies it on the MXU over a sequential (P-tiles, O-chunks)
// grid.  Rows whose index is >= P are padding and are dropped.
//
// What bounds it on the H100: nothing the card is short of.  The BA path
// calls it at O = 162..1600 rows, D = 1..42 lanes, P = 4..81 segments: at
// most ~270 KB read, a few microseconds of work.  It is launch-bound.
//
// Design: one block per (segment, 32-column tile), 32 x 8 threads.  Thread
// (x, y) walks the rows o = y, y + 8, ... and sums column x of the rows
// whose index is p; the 8 partials are then added in a fixed order.  The
// index reads are warp-uniform (one broadcast per row), value reads are
// coalesced along the columns, no atomics are needed and the result is
// deterministic.  Every output element is written, so the caller need not
// zero the output.  The kernel allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;
constexpr int kRowGroups = 8;

template <typename T>
__global__ void seg_sum_kernel(const T* __restrict__ vals,
                               const int* __restrict__ idx,
                               T* __restrict__ out, int O, int D) {
  __shared__ T part[kRowGroups][kCols];
  const int p = blockIdx.x;
  const int d = blockIdx.y * kCols + threadIdx.x;
  T acc = T(0);
  if (d < D) {
    for (int o = threadIdx.y; o < O; o += kRowGroups) {
      if (idx[o] == p) acc += vals[static_cast<size_t>(o) * D + d];
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && d < D) {
    T s = part[0][threadIdx.x];
    for (int y = 1; y < kRowGroups; ++y) s += part[y][threadIdx.x];
    out[static_cast<size_t>(p) * D + d] = s;
  }
}

template <typename T>
int launch(const T* vals, const int* idx, T* out, int O, int D, int P,
           cudaStream_t stream) {
  dim3 grid(P, (D + kCols - 1) / kCols);
  dim3 block(kCols, kRowGroups);
  seg_sum_kernel<T><<<grid, block, 0, stream>>>(vals, idx, out, O, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int seg_sum_f32(const void* vals, const void* idx, void* out,
                           int O, int D, int P, void* stream) {
  return launch(static_cast<const float*>(vals), static_cast<const int*>(idx),
                static_cast<float*>(out), O, D, P,
                static_cast<cudaStream_t>(stream));
}

extern "C" int seg_sum_f64(const void* vals, const void* idx, void* out,
                           int O, int D, int P, void* stream) {
  return launch(static_cast<const double*>(vals),
                static_cast<const int*>(idx), static_cast<double*>(out), O, D,
                P, static_cast<cudaStream_t>(stream));
}
