// K2: fused_eval -- the BA evaluate in one launch, in three variants.
//
// Replaces the TPU's fused_eval_pallas (slslam_tpu/ops/pallas_kernels.py:
// 335-428) and its two kernels _make_fused_camline_kernel (:278-307) and
// _make_fused_w_kernel (:310-332) with their shared body _fused_common
// (:210-271) and the scalarised residual _resid_soa (:141-207).  From
// camera poses (C,6), orth lines (L,4) and observations (O,8) with their
// camera / line indices, validity weights and free flags it computes the
// Huber cost and the normal-equation blocks: the semantics of
// slslam_tpu/ops/schur_ba.py _eval_system (:93-176).  Variants (template
// argument, one kernel each):
//
//   full   cost, Hcc (C,6,6), gc (C,6), Hll (L,4,4), gl (L,4) and the
//          cam-line coupling W (C,L,6,4), a sum over repeated pairs: the
//          window BA.
//   cams   cost, Hcc, gc: full with every line fixed, the pose-only
//          evaluate of the VO polish (_eval_pose_system, schur_ba.py:
//          179-209).  It never builds a line block or W.
//   lines  Hll, gl and the per-line cost (L,): full with every camera fixed,
//          the evaluate of lines-GN (lines_gn_impl's eval_lines, schur_ba.py:
//          269-291).
//
// What bounds it on the H100: at the window shape (C = 20, L = 81,
// O = 1600) the full variant reads ~73 KB and writes ~165 KB (f32); its
// function needs ~1.8 MFLOP (~1.5k per valid row, counted in closed form in
// kernel_checks._K2_OPS), and the dual-number passes below do about five
// times that: by bytes or FLOPs well under a microsecond.  What it takes
// is launch latency plus the serial dependency chain of one observation's
// residual and derivatives; one launch and no round trip through device
// memory is the most this design can do about that.
//
// Design.  Rows are reached through segment plans (segment_sum.cu
// seg_plan), built once per BA solve and reused in every LM iteration:
// stable groupings of the valid rows by camera (cams), by line (full,
// lines) and by (camera, line) pair (full; camera c is then the run of
// pair segments [c L, c L + L), its rows grouped by line).  One block per
// camera and one per line, each reducing only its own rows:
//
//   * a thread takes one row of the segment (the block loops in chunks of
//     kBlock rows) and runs a scalar copy of the residual on forward-mode
//     dual numbers: 6 camera tangents in camera blocks, 4 line tangents in
//     line blocks.  The full variant's camera blocks run the 4-tangent pass
//     as well, for the W block.  Splitting the 10 tangents into two passes
//     halves the live state of one pass (the first design's 10-tangent
//     f64 build spilled);
//   * the row's contributions (Hcc|gc|cost: 43 values; Hll|gl|cost: 21)
//     are summed over the block by a warp-shuffle tree, then over the warps
//     and the chunks in order, in registers and shared memory;
//   * W: each row of a camera block puts its 24 values in shared memory,
//     and thread e of the block owns the elements e, e + kBlock, ... of
//     W[c]: it sums the rows of pair (c, l) in plan order and writes the
//     element, zero where the pair has no row.  Repeated pairs sum, no two
//     threads touch one element, and every element of W is written;
//   * the scalar cost (full, cams): each camera block writes its partial to
//     a C-entry scratch and takes a ticket; the block that takes the last
//     ticket adds the partials in camera order and resets the ticket to 0
//     for the next launch (a counter that the wrapper keeps per stream, and
//     per launch inside a CUDA graph: two launches in flight at once must
//     never share one).
//
// No atomics on values: the result is the same from run to run.  No
// fast-math.  The kernel allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kFull = 0;
constexpr int kCams = 1;
constexpr int kLines = 2;
constexpr int kCamCols = 43;   // Hcc (36) | gc (6) | cost
constexpr int kLineCols = 21;  // Hll (16) | gl (4) | cost
constexpr int kPairCols = 24;  // W

template <typename T, int N>
struct Dual {
  T v;
  T d[N];

  __device__ __forceinline__ static Dual cst(T c) {
    Dual r;
    r.v = c;
#pragma unroll
    for (int i = 0; i < N; ++i) r.d[i] = T(0);
    return r;
  }
};

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] + b.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] - b.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -a.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(T a, const Dual<T, N>& b) {
  Dual<T, N> r = b;
  r.v = a + b.v;
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a, T b) {
  Dual<T, N> r = a;
  r.v = a.v - b;
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(T a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = -b.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * b.v + a.v * b.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(T a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a * b.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(const Dual<T, N>& a,
                                                const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v / b.v;
  const T inv2 = T(1) / (b.v * b.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] / b.v - b.d[i] * a.v * inv2;
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> dsin(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = sin(a.v);
  const T c = cos(a.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = c * a.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> dcos(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = cos(a.v);
  const T s = -sin(a.v);
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = s * a.d[i];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> dsqrt(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = sqrt(a.v);
  const T h = T(0.5) / r.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.d[i] = a.d[i] * h;
  return r;
}

// max(a, c) for a constant c: the derivative follows the larger operand
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> dmax(const Dual<T, N>& a, T c) {
  return a.v > c ? a : Dual<T, N>::cst(c);
}

// One side of the stereo pair (residuals.py segment_residuals): the
// normalized image line of the projected 3D line, and the two endpoint
// distances to it.
template <typename T, int N>
__device__ __forceinline__ void segment(
    const Dual<T, N>& px, const Dual<T, N>& py, const Dual<T, N>& pz,
    const Dual<T, N>& dx, const Dual<T, N>& dy, const Dual<T, N>& dz,
    const T* ob, Dual<T, N>* r) {
  Dual<T, N> nx = py * dz - pz * dy;
  Dual<T, N> ny = pz * dx - px * dz;
  Dual<T, N> nz = px * dy - py * dx;
  Dual<T, N> den = dmax(dsqrt(nx * nx + ny * ny), T(1e-12));
  nx = nx / den;
  ny = ny / den;
  nz = nz / den;
  r[0] = -(ob[0] * nx + ob[1] * ny + nz);
  r[1] = -(ob[2] * nx + ob[3] * ny + nz);
}

// lba_residual (residuals.py:50-76) with orth_to_av and rodrigues
// (geometry.py:45-62, 288-312) written out per scalar.  p: camera (0-5)
// then line (6-9) parameters.
template <typename T, int N>
__device__ void residual(const Dual<T, N>* p, const T* ob, T baseline,
                         Dual<T, N>* r) {
  using D = Dual<T, N>;
  const D& w0 = p[0];
  const D& w1 = p[1];
  const D& w2 = p[2];
  // orth decode: dv = R[:, 1], cp = -R[:, 2] * cos(theta) / sin(theta)
  D s1 = dsin(p[6]), c1 = dcos(p[6]);
  D s2 = dsin(p[7]), c2 = dcos(p[7]);
  D s3 = dsin(p[8]), c3 = dcos(p[8]);
  D dvx = s1 * s2 * c3 - c1 * s3;
  D dvy = s1 * s2 * s3 + c1 * c3;
  D dvz = s1 * c2;
  D d = dcos(p[9]) / dsin(p[9]);
  D cpx = -(c1 * s2 * c3 + s1 * s3) * d;
  D cpy = -(c1 * s2 * s3 - s1 * c3) * d;
  D cpz = -(c1 * c2) * d;

  // camera rotation R = I + a W + b W^2, W = [w]x
  D th2 = w0 * w0 + w1 * w1 + w2 * w2;
  D th = dsqrt(dmax(th2, T(1e-12)));
  D a, b;
  if (th2.v < T(1e-16)) {
    a = T(1) - T(1.0 / 6.0) * th2;
    b = T(0.5) - T(1.0 / 24.0) * th2;
  } else {
    a = dsin(th) / th;
    b = (T(1) - dcos(th)) / th2;
  }
  D R00 = T(1) + b * ((-w2) * w2 - w1 * w1);
  D R01 = a * (-w2) + b * (w1 * w0);
  D R02 = a * w1 + b * (w2 * w0);
  D R10 = a * w2 + b * (w0 * w1);
  D R11 = T(1) + b * ((-w2) * w2 - w0 * w0);
  D R12 = a * (-w0) + b * (w2 * w1);
  D R20 = a * (-w1) + b * (w0 * w2);
  D R21 = a * w0 + b * (w1 * w2);
  D R22 = T(1) + b * ((-w1) * w1 - w0 * w0);

  D pcx = R00 * cpx + R01 * cpy + R02 * cpz + p[3];
  D pcy = R10 * cpx + R11 * cpy + R12 * cpz + p[4];
  D pcz = R20 * cpx + R21 * cpy + R22 * cpz + p[5];
  D dcx = R00 * dvx + R01 * dvy + R02 * dvz;
  D dcy = R10 * dvx + R11 * dvy + R12 * dvz;
  D dcz = R20 * dvx + R21 * dvy + R22 * dvz;

  segment(pcx, pcy, pcz, dcx, dcy, dcz, ob, r);
  segment(pcx - baseline, pcy, pcz, dcx, dcy, dcz, ob + 4, r + 2);
}

// The residual of observation ob of camera c and line l, with tangents on
// the N parameters starting at kFirst (0: camera, 6: line).
template <typename T, int N, int kFirst>
__device__ __forceinline__ void row_residual(const T* __restrict__ cam,
                                             const T* __restrict__ line,
                                             int c, int l, const T* ob,
                                             T baseline, Dual<T, N>* r) {
  static_assert(kFirst + N <= 10, "tangents past the 10 parameters");
  Dual<T, N> p[10];
#pragma unroll
  for (int k = 0; k < 10; ++k)
    p[k] = Dual<T, N>::cst(k < 6 ? cam[c * 6 + k] : line[l * 4 + (k - 6)]);
#pragma unroll
  for (int i = 0; i < N; ++i) p[kFirst + i].d[i] = T(1);
  residual(p, ob, baseline, r);
}

// Ceres's Huber loss (schur_ba.py _robust_weights); huber < 0 selects the
// plain least-squares cost (robust = False).
template <typename T>
__device__ __forceinline__ void huber_weights(T s, T huber, T* w_r, T* cost) {
  *w_r = T(1);
  *cost = T(0.5) * s;
  if (huber >= T(0)) {
    const T d2 = huber * huber;
    const bool out = s > d2;
    const T safe = s > static_cast<T>(1e-300) ? s : static_cast<T>(1e-300);
    const T rho = out ? T(2) * huber * sqrt(safe) - d2 : s;
    const T rho1 = out ? huber / sqrt(safe) : T(1);
    *w_r = sqrt(rho1);
    *cost = T(0.5) * rho;
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

template <typename T>
struct Args {
  const T* cam;
  const T* line;
  const T* obs;
  const int* oc;
  const int* ol;
  const T* wv;
  const T* cfree;
  const T* lfree;
  T baseline;
  T huber;
  int C;
  int L;
  // camera c's rows: row_perm[row_off[c * row_stride] ...
  // row_off[(c + 1) * row_stride]); the pair plan (row_stride = L) in full,
  // the camera plan (row_stride = 1) in cams
  const int* row_perm;
  const int* row_off;
  int row_stride;
  const int* line_perm;
  const int* line_off;
  T* cost;
  T* Hcc;
  T* gc;
  T* Hll;
  T* gl;
  T* W;
  T* cost_l;
  T* partial;
  int* tickets;
};

__device__ __forceinline__ bool row_valid(int c, int l, bool w_pos, int C,
                                          int L) {
  return w_pos && c >= 0 && c < C && l >= 0 && l < L;
}

template <typename T>
__device__ __forceinline__ void load_obs(const T* __restrict__ obs, int o,
                                         T* ob) {
#pragma unroll
  for (int k = 0; k < 8; ++k) ob[k] = obs[static_cast<size_t>(o) * 8 + k];
}

// Adds column j of the block's rows, summed in a fixed order, to acc of
// thread j (j < cols).  s_part is (kWarps, cols).
template <typename T, int kCols>
__device__ __forceinline__ void block_column_sums(const T (&v)[kCols],
                                                  T* s_part, T* acc) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const T s = warp_sum(v[j]);
    if ((t & 31) == 0) s_part[(t >> 5) * kCols + j] = s;
  }
  __syncthreads();
  if (t < kCols) {
    T s = s_part[t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += s_part[w * kCols + t];
    *acc += s;
  }
}

template <typename T, int kVariant>
__device__ void camera_block(const Args<T>& a, int c) {
  __shared__ T s_part[kWarps * kCamCols];
  __shared__ T s_w[kVariant == kFull ? kBlock * kPairCols : 1];
  __shared__ int s_last;
  const int t = threadIdx.x;
  const int L = a.L;
  const int seg0 = a.row_off[c * a.row_stride];
  const int n = a.row_off[(c + 1) * a.row_stride] - seg0;
  T acc = T(0);  // thread j < 43: column j of Hcc | gc | cost
  for (int base = 0; base < (n > 0 ? n : 1); base += kBlock) {
    T Jc[4][6], Jl[4][4], rw[4];
    T cost_i = T(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rw[k] = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) Jc[k][j] = T(0);
#pragma unroll
      for (int j = 0; j < 4; ++j) Jl[k][j] = T(0);
    }
    if (base + t < n) {
      const int o = a.row_perm[seg0 + base + t];
      const int cc = a.oc[o];
      const int l = a.ol[o];
      if (row_valid(cc, l, a.wv[o] > T(0), a.C, L)) {
        T ob[8];
        load_obs(a.obs, o, ob);
        Dual<T, 6> r[4];
        row_residual<T, 6, 0>(a.cam, a.line, cc, l, ob, a.baseline, r);
        const T s = r[0].v * r[0].v + r[1].v * r[1].v + r[2].v * r[2].v +
                    r[3].v * r[3].v;
        T w_r;
        huber_weights(s, a.huber, &w_r, &cost_i);
        const T cf = a.cfree[cc];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          rw[k] = r[k].v * w_r;
#pragma unroll
          for (int j = 0; j < 6; ++j) Jc[k][j] = r[k].d[j] * w_r * cf;
        }
        if constexpr (kVariant == kFull) {
          Dual<T, 4> q[4];
          row_residual<T, 4, 6>(a.cam, a.line, cc, l, ob, a.baseline, q);
          const T lf = a.lfree[l];
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int j = 0; j < 4; ++j) Jl[k][j] = q[k].d[j] * w_r * lf;
        }
      }
    }
    T v[kCamCols];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        T x = T(0);
#pragma unroll
        for (int k = 0; k < 4; ++k) x += Jc[k][i] * Jc[k][j];
        v[i * 6 + j] = x;
      }
      T g = T(0);
#pragma unroll
      for (int k = 0; k < 4; ++k) g += Jc[k][i] * rw[k];
      v[36 + i] = g;
    }
    v[42] = cost_i;
    block_column_sums<T, kCamCols>(v, s_part, &acc);

    if constexpr (kVariant == kFull) {
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          T x = T(0);
#pragma unroll
          for (int k = 0; k < 4; ++k) x += Jc[k][i] * Jl[k][j];
          s_w[t * kPairCols + i * 4 + j] = x;
        }
      __syncthreads();
      const int end = (n < base + kBlock ? n : base + kBlock);
      for (int e = t; e < L * kPairCols; e += kBlock) {
        const int l = e / kPairCols;
        const int j = e - l * kPairCols;
        int lo = a.row_off[c * L + l] - seg0;
        int hi = a.row_off[c * L + l + 1] - seg0;
        lo = lo > base ? lo : base;
        hi = hi < end ? hi : end;
        T x = T(0);
        for (int k = lo; k < hi; ++k) x += s_w[(k - base) * kPairCols + j];
        T* w = a.W + (static_cast<size_t>(c) * L + l) * kPairCols + j;
        *w = base == 0 ? x : *w + x;
      }
    }
    __syncthreads();
  }
  if (t < 36)
    a.Hcc[c * 36 + t] = acc;
  else if (t < 42)
    a.gc[c * 6 + t - 36] = acc;
  else if (t == 42) {
    a.partial[c] = acc;
    __threadfence();
    s_last = atomicAdd(a.tickets, 1) == a.C - 1;
  }
  __syncthreads();
  if (s_last && t == 0) {
    __threadfence();
    const volatile T* part = a.partial;
    T s = T(0);
    for (int i = 0; i < a.C; ++i) s += part[i];
    a.cost[0] = s;
    *a.tickets = 0;
  }
}

template <typename T, int kVariant>
__device__ void line_block(const Args<T>& a, int l) {
  __shared__ T s_part[kWarps * kLineCols];
  const int t = threadIdx.x;
  const int seg0 = a.line_off[l];
  const int n = a.line_off[l + 1] - seg0;
  T acc = T(0);  // thread j < 21: column j of Hll | gl | cost
  for (int base = 0; base < n; base += kBlock) {
    T Jl[4][4], rw[4];
    T cost_i = T(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rw[k] = T(0);
#pragma unroll
      for (int j = 0; j < 4; ++j) Jl[k][j] = T(0);
    }
    if (base + t < n) {
      const int o = a.line_perm[seg0 + base + t];
      const int c = a.oc[o];
      const int ll = a.ol[o];
      if (row_valid(c, ll, a.wv[o] > T(0), a.C, a.L)) {
        T ob[8];
        load_obs(a.obs, o, ob);
        Dual<T, 4> r[4];
        row_residual<T, 4, 6>(a.cam, a.line, c, ll, ob, a.baseline, r);
        const T s = r[0].v * r[0].v + r[1].v * r[1].v + r[2].v * r[2].v +
                    r[3].v * r[3].v;
        T w_r;
        huber_weights(s, a.huber, &w_r, &cost_i);
        const T lf = a.lfree[ll];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          rw[k] = r[k].v * w_r;
#pragma unroll
          for (int j = 0; j < 4; ++j) Jl[k][j] = r[k].d[j] * w_r * lf;
        }
      }
    }
    T v[kLineCols];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        T x = T(0);
#pragma unroll
        for (int k = 0; k < 4; ++k) x += Jl[k][i] * Jl[k][j];
        v[i * 4 + j] = x;
      }
      T g = T(0);
#pragma unroll
      for (int k = 0; k < 4; ++k) g += Jl[k][i] * rw[k];
      v[16 + i] = g;
    }
    v[20] = cost_i;
    block_column_sums<T, kLineCols>(v, s_part, &acc);
    __syncthreads();
  }
  if (t < 16)
    a.Hll[l * 16 + t] = acc;
  else if (t < 20)
    a.gl[l * 4 + t - 16] = acc;
  else if (kVariant == kLines && t == 20)
    a.cost_l[l] = acc;
}

template <typename T, int kVariant>
__global__ void __launch_bounds__(kBlock) fused_eval_kernel(Args<T> a) {
  const int b = blockIdx.x;
  if constexpr (kVariant == kLines) {
    line_block<T, kVariant>(a, b);
  } else if constexpr (kVariant == kCams) {
    camera_block<T, kVariant>(a, b);
  } else {
    if (b < a.C)
      camera_block<T, kVariant>(a, b);
    else
      line_block<T, kVariant>(a, b - a.C);
  }
}

template <typename T>
int launch(int variant, const void* cam, const void* line, const void* obs,
           const void* oc, const void* ol, const void* wv, const void* cfree,
           const void* lfree, double baseline, double huber, int C, int L,
           const void* row_perm, const void* row_off, int row_stride,
           const void* line_perm, const void* line_off, void* out,
           void* tickets, void* stream) {
  Args<T> a = {};
  a.cam = static_cast<const T*>(cam);
  a.line = static_cast<const T*>(line);
  a.obs = static_cast<const T*>(obs);
  a.oc = static_cast<const int*>(oc);
  a.ol = static_cast<const int*>(ol);
  a.wv = static_cast<const T*>(wv);
  a.cfree = static_cast<const T*>(cfree);
  a.lfree = static_cast<const T*>(lfree);
  a.baseline = static_cast<T>(baseline);
  a.huber = static_cast<T>(huber);
  a.C = C;
  a.L = L;
  a.row_perm = static_cast<const int*>(row_perm);
  a.row_off = static_cast<const int*>(row_off);
  a.row_stride = row_stride;
  a.line_perm = static_cast<const int*>(line_perm);
  a.line_off = static_cast<const int*>(line_off);
  a.tickets = static_cast<int*>(tickets);
  T* o = static_cast<T*>(out);
  if (variant != kLines) {
    a.cost = o;
    o += 1;
    a.Hcc = o;
    o += static_cast<size_t>(C) * 36;
    a.gc = o;
    o += static_cast<size_t>(C) * 6;
  }
  if (variant != kCams) {
    a.Hll = o;
    o += static_cast<size_t>(L) * 16;
    a.gl = o;
    o += static_cast<size_t>(L) * 4;
  }
  if (variant == kFull) {
    a.W = o;
    o += static_cast<size_t>(C) * L * kPairCols;
  }
  if (variant == kLines)
    a.cost_l = o;
  else
    a.partial = o;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kFull)
    fused_eval_kernel<T, kFull><<<C + L, kBlock, 0, s>>>(a);
  else if (variant == kCams)
    fused_eval_kernel<T, kCams><<<C, kBlock, 0, s>>>(a);
  else if (variant == kLines)
    fused_eval_kernel<T, kLines><<<L, kBlock, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 full, 1 cams, 2 lines.  Output buffer, every element written:
//   full   cost (1) | Hcc (C*36) | gc (C*6) | Hll (L*16) | gl (L*4) |
//          W (C*L*24) | partial costs (C)
//   cams   cost (1) | Hcc (C*36) | gc (C*6) | partial costs (C)
//   lines  Hll (L*16) | gl (L*4) | per-line cost (L)
// tickets: one int, 0 before the launch and 0 again after it, used by no
// other launch in flight.  C, L >= 1.
extern "C" int fused_eval_f32(int variant, const void* cam, const void* line,
                              const void* obs, const void* oc, const void* ol,
                              const void* wv, const void* cfree,
                              const void* lfree, double baseline, double huber,
                              int C, int L, const void* row_perm,
                              const void* row_off, int row_stride,
                              const void* line_perm, const void* line_off,
                              void* out, void* tickets, void* stream) {
  return launch<float>(variant, cam, line, obs, oc, ol, wv, cfree, lfree,
                       baseline, huber, C, L, row_perm, row_off, row_stride,
                       line_perm, line_off, out, tickets, stream);
}

extern "C" int fused_eval_f64(int variant, const void* cam, const void* line,
                              const void* obs, const void* oc, const void* ol,
                              const void* wv, const void* cfree,
                              const void* lfree, double baseline, double huber,
                              int C, int L, const void* row_perm,
                              const void* row_off, int row_stride,
                              const void* line_perm, const void* line_off,
                              void* out, void* tickets, void* stream) {
  return launch<double>(variant, cam, line, obs, oc, ol, wv, cfree, lfree,
                        baseline, huber, C, L, row_perm, row_off, row_stride,
                        line_perm, line_off, out, tickets, stream);
}
