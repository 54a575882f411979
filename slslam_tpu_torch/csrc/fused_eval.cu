// K2: fused_eval -- the window-BA evaluate in one kernel.
//
// Replaces the TPU's fused_eval_pallas (slslam_tpu/ops/pallas_kernels.py:
// 335-428) and its two kernels _make_fused_camline_kernel (:278-307) and
// _make_fused_w_kernel (:310-332) with their shared body _fused_common
// (:210-271) and the scalarised residual _resid_soa (:141-207).  From
// camera poses (C,6), orth lines (L,4), observations (O,8) with their
// camera / line indices, validity weights and free flags it computes the
// Huber cost and the normal-equation blocks Hcc (C,6,6), Hll (L,4,4),
// gc (C,6), gl (L,4) and the cam-line coupling W (C,L,6,4): the semantics
// of slslam_tpu/ops/schur_ba.py _eval_system (:93-176).
//
// Dropped from the TPU version, all Mosaic workarounds: the split into two
// kernels that both recompute the Jacobians, the chunk <= 64 limit, the
// per-chunk partial outputs summed outside, and the separate XLA pass for
// the cost.
//
// What bounds it on the H100: at the window shape (C = 20, L = 81,
// O = 1600) the kernel reads ~70 KB (f32) and does ~4 MFLOP (~2.4k per
// observation: the residual carried with 10 tangents, then the block
// products): it is bound by launch latency and by the serial dependency
// chain of one observation's residual + derivatives (13 blocks of 128
// threads on 132 SMs), not by bandwidth or FLOPs.  In f64 the 11-wide dual
// numbers exceed the 255-register limit and spill to local memory.  The
// reduce pass (C + L + 1 = 102 blocks) is bound by each block's serial walk
// over all O rows.
//
// Design: two passes, both launched on the caller's stream.  Pass 1 gives
// each observation one thread.  The 10 Jacobian columns come from
// forward-mode dual numbers (a value plus 10 tangents, the block-basis idea
// of _fused_common) run through a scalar copy of the residual, so primal and
// derivatives come out of one pass.  Each valid observation writes its cost,
// its camera row Hcc|gc (42), its line row Hll|gl (20) and its pair block W
// (24) to a caller-allocated scratch buffer, column-major so that the
// writes of a warp coalesce.  Pass 2 reduces the scratch by index in a
// fixed order: one block per camera (Hcc|gc in registers, W[c, l] added in
// place, one thread per column, so repeated (cam, line) pairs sum), one
// block per line (Hll|gl), and one block for the cost (strided partials,
// then a fixed tree).  The indices are staged through shared memory in
// tiles of the block size.  No atomics: the result is the same from run to
// run, and each segment's sum follows the observation order, as the plain
// version's index_add_ on the CPU does.  No fast-math; the kernels allocate
// nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 10;  // 6 camera + 4 line parameters
constexpr int kBlock = 128;

template <typename T>
struct Dual {
  T v;
  T d[kN];
};

template <typename T>
__device__ __forceinline__ Dual<T> constant(T c) {
  Dual<T> r;
  r.v = c;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = T(0);
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a,
                                             const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a,
                                             const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a) {
  Dual<T> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = -a.d[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a,
                                             const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, const Dual<T>& b) {
  Dual<T> r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a * b.d[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a,
                                             const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v / b.v;
  const T inv2 = T(1) / (b.v * b.v);
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] / b.v - b.d[i] * a.v * inv2;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> dsin(const Dual<T>& a) {
  Dual<T> r;
  r.v = sin(a.v);
  const T c = cos(a.v);
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = c * a.d[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> dcos(const Dual<T>& a) {
  Dual<T> r;
  r.v = cos(a.v);
  const T s = -sin(a.v);
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = s * a.d[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> dsqrt(const Dual<T>& a) {
  Dual<T> r;
  r.v = sqrt(a.v);
  const T h = T(0.5) / r.v;
#pragma unroll
  for (int i = 0; i < kN; ++i) r.d[i] = a.d[i] * h;
  return r;
}

// max(a, c) for a constant c: the derivative follows the larger operand
template <typename T>
__device__ __forceinline__ Dual<T> dmax(const Dual<T>& a, T c) {
  return a.v > c ? a : constant(c);
}

// One side of the stereo pair (residuals.py segment_residuals): the
// normalized image line of the projected 3D line, and the two endpoint
// distances to it.
template <typename T>
__device__ __forceinline__ void segment(const Dual<T>& px, const Dual<T>& py,
                                        const Dual<T>& pz, const Dual<T>& dx,
                                        const Dual<T>& dy, const Dual<T>& dz,
                                        const T* ob, Dual<T>* r) {
  Dual<T> nx = py * dz - pz * dy;
  Dual<T> ny = pz * dx - px * dz;
  Dual<T> nz = px * dy - py * dx;
  Dual<T> den = dmax(dsqrt(nx * nx + ny * ny), T(1e-12));
  nx = nx / den;
  ny = ny / den;
  nz = nz / den;
  r[0] = -(ob[0] * nx + ob[1] * ny + nz);
  r[1] = -(ob[2] * nx + ob[3] * ny + nz);
}

// lba_residual (residuals.py:50-76) with orth_to_av and rodrigues
// (geometry.py:45-62, 288-312) written out per scalar.
template <typename T>
__device__ void residual(const Dual<T>* p, const T* ob, T baseline,
                         Dual<T>* r) {
  const Dual<T>& w0 = p[0];
  const Dual<T>& w1 = p[1];
  const Dual<T>& w2 = p[2];
  // orth decode: dv = R[:, 1], cp = -R[:, 2] * cos(theta) / sin(theta)
  Dual<T> s1 = dsin(p[6]), c1 = dcos(p[6]);
  Dual<T> s2 = dsin(p[7]), c2 = dcos(p[7]);
  Dual<T> s3 = dsin(p[8]), c3 = dcos(p[8]);
  Dual<T> dvx = s1 * s2 * c3 - c1 * s3;
  Dual<T> dvy = s1 * s2 * s3 + c1 * c3;
  Dual<T> dvz = s1 * c2;
  Dual<T> d = dcos(p[9]) / dsin(p[9]);
  Dual<T> cpx = -(c1 * s2 * c3 + s1 * s3) * d;
  Dual<T> cpy = -(c1 * s2 * s3 - s1 * c3) * d;
  Dual<T> cpz = -(c1 * c2) * d;

  // camera rotation R = I + a W + b W^2, W = [w]x
  Dual<T> th2 = w0 * w0 + w1 * w1 + w2 * w2;
  Dual<T> th = dsqrt(dmax(th2, T(1e-12)));
  Dual<T> a, b;
  if (th2.v < T(1e-16)) {
    a = constant(T(1)) - T(1.0 / 6.0) * th2;
    b = constant(T(0.5)) - T(1.0 / 24.0) * th2;
  } else {
    a = dsin(th) / th;
    b = (constant(T(1)) - dcos(th)) / th2;
  }
  Dual<T> R00 = constant(T(1)) + b * ((-w2) * w2 - w1 * w1);
  Dual<T> R01 = a * (-w2) + b * (w1 * w0);
  Dual<T> R02 = a * w1 + b * (w2 * w0);
  Dual<T> R10 = a * w2 + b * (w0 * w1);
  Dual<T> R11 = constant(T(1)) + b * ((-w2) * w2 - w0 * w0);
  Dual<T> R12 = a * (-w0) + b * (w2 * w1);
  Dual<T> R20 = a * (-w1) + b * (w0 * w2);
  Dual<T> R21 = a * w0 + b * (w1 * w2);
  Dual<T> R22 = constant(T(1)) + b * ((-w1) * w1 - w0 * w0);

  Dual<T> pcx = R00 * cpx + R01 * cpy + R02 * cpz + p[3];
  Dual<T> pcy = R10 * cpx + R11 * cpy + R12 * cpz + p[4];
  Dual<T> pcz = R20 * cpx + R21 * cpy + R22 * cpz + p[5];
  Dual<T> dcx = R00 * dvx + R01 * dvy + R02 * dvz;
  Dual<T> dcy = R10 * dvx + R11 * dvy + R12 * dvz;
  Dual<T> dcz = R20 * dvx + R21 * dvy + R22 * dvz;

  segment(pcx, pcy, pcz, dcx, dcy, dcz, ob, r);
  Dual<T> pcx_r = pcx - constant(baseline);
  segment(pcx_r, pcy, pcz, dcx, dcy, dcz, ob + 4, r + 2);
}

__device__ __forceinline__ bool row_valid(int c, int l, bool w_pos, int C,
                                          int L) {
  return w_pos && c >= 0 && c < C && l >= 0 && l < L;
}

// Scratch layout, column-major over the O observations: cost (1) | camera
// row Hcc|gc (42) | line row Hll|gl (20) | pair block W (24).
constexpr int kCamCols = 42;
constexpr int kLineCols = 20;
constexpr int kPairCols = 24;

// Pass 1.  huber < 0 selects the plain least-squares cost (robust = False).
template <typename T>
__global__ void __launch_bounds__(kBlock) fused_eval_rows(
    const T* __restrict__ cam, const T* __restrict__ line,
    const T* __restrict__ obs, const int* __restrict__ oc,
    const int* __restrict__ ol, const T* __restrict__ wv,
    const T* __restrict__ cfree, const T* __restrict__ lfree, T baseline,
    T huber, int C, int L, int O, T* __restrict__ scratch) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= O) return;
  const int c = oc[o];
  const int l = ol[o];
  T* cost_o = scratch;
  if (!row_valid(c, l, wv[o] > T(0), C, L)) {
    cost_o[o] = T(0);
    return;
  }
  Dual<T> p[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    p[k] = constant(k < 6 ? cam[c * 6 + k] : line[l * 4 + (k - 6)]);
    p[k].d[k] = T(1);
  }
  T ob[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) ob[k] = obs[static_cast<size_t>(o) * 8 + k];
  Dual<T> r[4];
  residual(p, ob, baseline, r);

  // Huber weights (schur_ba.py _robust_weights)
  const T s = r[0].v * r[0].v + r[1].v * r[1].v + r[2].v * r[2].v +
              r[3].v * r[3].v;
  T w_r = T(1);
  T cost_i = T(0.5) * s;
  if (huber >= T(0)) {
    const T d2 = huber * huber;
    const bool out = s > d2;
    const T safe = s > static_cast<T>(1e-300) ? s : static_cast<T>(1e-300);
    const T rho = out ? T(2) * huber * sqrt(safe) - d2 : s;
    const T rho1 = out ? huber / sqrt(safe) : T(1);
    w_r = sqrt(rho1);
    cost_i = T(0.5) * rho;
  }
  cost_o[o] = cost_i;
  const T cf = cfree[c];
  const T lf = lfree[l];
  T rw[4], Jc[4][6], Jl[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rw[k] = r[k].v * w_r;
#pragma unroll
    for (int j = 0; j < 6; ++j) Jc[k][j] = r[k].d[j] * w_r * cf;
#pragma unroll
    for (int j = 0; j < 4; ++j) Jl[k][j] = r[k].d[6 + j] * w_r * lf;
  }

  const size_t n = static_cast<size_t>(O);
  T* rc = scratch + n;                  // (42, O): Hcc (36) | gc (6)
  T* rl = rc + kCamCols * n;            // (20, O): Hll (16) | gl (4)
  T* rp = rl + kLineCols * n;           // (24, O): W
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      T v = T(0);
#pragma unroll
      for (int k = 0; k < 4; ++k) v += Jc[k][i] * Jc[k][j];
      rc[(i * 6 + j) * n + o] = v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T v = T(0);
#pragma unroll
      for (int k = 0; k < 4; ++k) v += Jc[k][i] * Jl[k][j];
      rp[(i * 4 + j) * n + o] = v;
    }
    T g = T(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) g += Jc[k][i] * rw[k];
    rc[(36 + i) * n + o] = g;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T v = T(0);
#pragma unroll
      for (int k = 0; k < 4; ++k) v += Jl[k][i] * Jl[k][j];
      rl[(i * 4 + j) * n + o] = v;
    }
    T g = T(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) g += Jl[k][i] * rw[k];
    rl[(16 + i) * n + o] = g;
  }
}

// Pass 2.  Blocks [0, C): camera c -- threads [0, 42) sum Hcc|gc, threads
// [64, 88) add W[c, l] in place (one thread per column walks the rows in
// order, so no two threads touch one element).  Blocks [C, C + L): line l --
// threads [0, 20) sum Hll|gl.  Block C + L: the cost.
template <typename T>
__global__ void __launch_bounds__(kBlock) fused_eval_reduce(
    const int* __restrict__ oc, const int* __restrict__ ol,
    const T* __restrict__ wv, int C, int L, int O,
    const T* __restrict__ scratch, T* __restrict__ cost, T* __restrict__ Hcc,
    T* __restrict__ Hll, T* __restrict__ gc, T* __restrict__ gl,
    T* __restrict__ W) {
  __shared__ int s_key[kBlock];
  __shared__ int s_line[kBlock];
  __shared__ T s_part[kBlock];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const size_t n = static_cast<size_t>(O);

  if (b == C + L) {
    T acc = T(0);
    for (int o = t; o < O; o += kBlock) acc += scratch[o];
    s_part[t] = acc;
    __syncthreads();
    for (int w = kBlock / 2; w > 0; w >>= 1) {
      if (t < w) s_part[t] += s_part[t + w];
      __syncthreads();
    }
    if (t == 0) cost[0] = s_part[0];
    return;
  }

  const bool is_cam = b < C;
  const int seg = is_cam ? b : b - C;
  const T* rc = scratch + n;
  const T* rl = rc + kCamCols * n;
  const T* rp = rl + kLineCols * n;
  const int cols = is_cam ? kCamCols : kLineCols;
  const T* rows = is_cam ? rc : rl;
  const bool sums = t < cols;
  const int pj = t - 64;
  const bool pair = is_cam && pj >= 0 && pj < kPairCols;
  T* wc = W + static_cast<size_t>(seg) * L * kPairCols;
  T acc = T(0);
  for (int base = 0; base < O; base += kBlock) {
    const int o = base + t;
    int key = -1;
    int l = -1;
    if (o < O) {
      const int c = oc[o];
      l = ol[o];
      if (row_valid(c, l, wv[o] > T(0), C, L)) key = is_cam ? c : l;
    }
    s_key[t] = key;
    s_line[t] = l;
    __syncthreads();
    const int m = O - base < kBlock ? O - base : kBlock;
    for (int k = 0; k < m; ++k) {
      if (s_key[k] != seg) continue;
      const size_t oo = static_cast<size_t>(base + k);
      if (sums) acc += rows[t * n + oo];
      if (pair) wc[s_line[k] * kPairCols + pj] += rp[pj * n + oo];
    }
    __syncthreads();
  }
  if (!sums) return;
  if (is_cam) {
    if (t < 36)
      Hcc[seg * 36 + t] = acc;
    else
      gc[seg * 6 + t - 36] = acc;
  } else {
    if (t < 16)
      Hll[seg * 16 + t] = acc;
    else
      gl[seg * 4 + t - 16] = acc;
  }
}

template <typename T>
int launch(const void* cam, const void* line, const void* obs, const void* oc,
           const void* ol, const void* wv, const void* cfree,
           const void* lfree, double baseline, double huber, int C, int L,
           int O, void* out, void* scratch, void* stream) {
  T* base = static_cast<T*>(out);
  T* cost = base;
  T* Hcc = cost + 1;
  T* Hll = Hcc + static_cast<size_t>(C) * 36;
  T* gc = Hll + static_cast<size_t>(L) * 16;
  T* gl = gc + static_cast<size_t>(C) * 6;
  T* W = gl + static_cast<size_t>(L) * 4;
  T* rows = static_cast<T*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (O > 0) {
    fused_eval_rows<T><<<(O + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        static_cast<const T*>(cam), static_cast<const T*>(line),
        static_cast<const T*>(obs), static_cast<const int*>(oc),
        static_cast<const int*>(ol), static_cast<const T*>(wv),
        static_cast<const T*>(cfree), static_cast<const T*>(lfree),
        static_cast<T>(baseline), static_cast<T>(huber), C, L, O, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_eval_reduce<T><<<C + L + 1, kBlock, 0, s>>>(
      static_cast<const int*>(oc), static_cast<const int*>(ol),
      static_cast<const T*>(wv), C, L, O, rows, cost, Hcc, Hll, gc, gl, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Output buffer layout (W zeroed by the caller; the other outputs are
// written whole): cost (1) | Hcc (C*36) | Hll (L*16) | gc (C*6) | gl (L*4) |
// W (C*L*24).  Scratch: (1 + 42 + 20 + 24) * O elements, left uninitialised.
extern "C" int fused_eval_f32(const void* cam, const void* line,
                              const void* obs, const void* oc, const void* ol,
                              const void* wv, const void* cfree,
                              const void* lfree, double baseline, double huber,
                              int C, int L, int O, void* out, void* scratch,
                              void* stream) {
  return launch<float>(cam, line, obs, oc, ol, wv, cfree, lfree, baseline,
                       huber, C, L, O, out, scratch, stream);
}

extern "C" int fused_eval_f64(const void* cam, const void* line,
                              const void* obs, const void* oc, const void* ol,
                              const void* wv, const void* cfree,
                              const void* lfree, double baseline, double huber,
                              int C, int L, int O, void* out, void* scratch,
                              void* stream) {
  return launch<double>(cam, line, obs, oc, ol, wv, cfree, lfree, baseline,
                        huber, C, L, O, out, scratch, stream);
}
