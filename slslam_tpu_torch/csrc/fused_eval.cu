// K2: fused_eval -- the BA evaluate in one launch (lm: two), in four
// variants, and a fifth, cost, that returns the robust cost alone.
//
// Replaces the TPU's fused_eval_pallas (slslam_tpu/ops/pallas_kernels.py:
// 335-428) and its two kernels _make_fused_camline_kernel (:278-307) and
// _make_fused_w_kernel (:310-332) with their shared body _fused_common
// (:210-271) and the scalarised residual _resid_soa (:141-207).  From
// camera poses (C,6), orth lines (L,4) and observations (O,8) with their
// camera / line indices, validity weights and free flags it computes the
// Huber cost and the normal-equation blocks: the semantics of
// slslam_tpu/ops/schur_ba.py _eval_system (:93-176).  Variants (a template
// argument of one kernel; lm has two kernels of its own):
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
//   lm     cost, Hcc, gc, Hll, gl and the cam-line coupling per observation,
//          Wb (O,6,4) in the caller's row order: the line-major evaluate of
//          the global refine (slslam_tpu/ops/schur_cg.py _eval_system_lm,
//          :118-166), whose PCG matvec consumes the per-row blocks.  Rows
//          that the plans drop (w_valid <= 0: the line-major padding) get
//          exact zeros in Wb.  Two launches (below).
//   cost   the robust cost alone at the parameters given: the global BA's
//          score of an LM trial point and of its start (one launch, below).
//
// What bounds it on the H100: at the window shape (C = 20, L = 81,
// O = 1600) the full variant reads ~73 KB and writes ~165 KB (f32); its
// function needs ~1.8 MFLOP (~1.5k per valid row, counted in closed form in
// kernel_checks._K2_OPS), and the dual-number passes below do about five
// times that: by bytes or FLOPs well under a microsecond.  What it takes
// is launch latency plus the serial dependency chain of one observation's
// residual and derivatives; one launch and no round trip through device
// memory is the most this design can do about that.  At the refine's
// shape (C = 400, L = 74, O = 29,600) lm reads ~2 MB and writes Wb's
// ~2.8 MB (f32), ~1.5 us at the HBM rate; its ~43 MFLOP take ~0.6 us at
// the f32 rate.  At the large map's (C = 8192, L = 109,147, O = 3,492,704
// line-major rows of kL = 32, 929,796 of them valid) it must write Wb,
// 335 MB in f32 of which 73 % are the padding rows' zeros: 0.12 ms at the
// HBM rate, the bound; its ~1.3 GFLOP take ~0.02 ms.
//
// Design.  Rows are reached through segment plans (segment_sum.cu
// seg_plan), built once per BA solve and reused in every LM iteration:
// stable groupings of the valid rows by camera (cams, lm), by line (full,
// lines, lm) and by (camera, line) pair (full; camera c is then the run of
// pair segments [c L, c L + L), its rows grouped by line).  full, cams and
// lines run one block per camera and one per line, each reducing only its
// own rows:
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
//   * the scalar cost (full, cams, lm): each camera block writes its partial to
//     a C-entry scratch and takes a ticket; the block that takes the last
//     ticket adds the partials in camera order and resets the ticket to 0
//     for the next launch (a counter that the wrapper keeps per stream, and
//     per launch inside a CUDA graph: two launches in flight at once must
//     never share one).
//
// lm is laid out for the large map, where a line has ~8.5 valid rows of
// its bucket's 32 and a camera ~113: one block a line would idle ~93 % of
// its threads and run a block reduction for 8 rows, and a row's residual
// would be taken three times (camera block 6 + 4 tangents, line block 4).
// Two launches instead:
//
//   * the row pass (lm_rows_kernel): one thread a kept row of the line
//     plan, so a block has 128 rows whatever the lines' lengths.  A row
//     runs the residual on its 4 line tangents (Jl, the Huber weight, its
//     Hll|gl terms: 14 values, Hll's upper triangle), then on its 6
//     camera tangents for its Wb = Jc^T Jl.  Hll|gl are summed over each
//     line's run in the block by a segmented warp scan and the earlier
//     warps' tails; a line inside one block is written there, a line
//     across blocks leaves a partial a side in the buffer's scratch.  The
//     block's Wb rows and the plan's dropped rows in its range (zeros: the
//     buckets' padding, contiguous in line-major order) go out through
//     shared memory, element by element, so neighbouring threads write
//     neighbouring bytes.  Wb heads lm's buffer, so each 96-byte row (f32)
//     fills three whole 32-byte sectors;
//   * the camera pass (lm_cams_kernel): the cams variant's camera blocks
//     over the camera plan (the residual on the 6 camera tangents only,
//     Hcc|gc|cost by block_column_sums, the cost by the ticket); then
//     ceil(L / 128) blocks write the lines the row pass left: zeros for a
//     line with no kept row, and for a line across row blocks its partials
//     in block order.
//
// So a valid row's residual runs on 4 + 6 tangents in the row pass and on
// 6 in the camera pass (one pass of 10 tangents spilled in float64).
// Parking Jl in Wb for the camera pass to finish Wb instead, which saves
// one 6-tangent pass, took the camera pass from 0.40 to 0.76 ms at the
// map's shape on an H100 80GB HBM3 at 700 W (random 64-byte reads and
// 96-byte writes over 335 MB).
//
// cost replaces no TPU kernel: the JAX package left the trial point's
// score to XLA (slslam_tpu/ops/schur_cg.py:394-406 cost_only, which
// gathers every padded row's camera and line, runs the residual and masks
// the padding).  Its work is the residual's value and the Huber cost of
// each valid row, ~180 operations, so it is bound by bytes: at the large
// map's shape it reads the parameters (~1.9 MB in f32) and each of the
// 929,796 valid rows' observation, camera index and weight (~37 MB), one
// value out: ~0.012 ms at the HBM rate (kernel_checks.cost_work).  The
// 40-odd PyTorch operations over all 3.49M padded rows that it replaces
// took ~20 ms a call there on an H100 80GB HBM3 at 700 W, the kernel
// 0.033 ms.  Design (cost_kernel):
//
//   * a fixed grid of at most kCostBlocks blocks (one block a kBlock rows
//     where there are fewer) splits the line plan's kept rows into equal
//     contiguous chunks, read from the plan's offsets on the device, so
//     the host needs no count and the dropped rows (the padding) are
//     never read.  Neighbouring threads take neighbouring kept rows: a
//     line's rows are adjacent in the line-major layout, so the
//     observation reads coalesce, and the camera table (196 KB in f32)
//     stays in L1 / L2 for the gathers;
//   * a row runs the residual on Dual<T, 0>, the values without a tangent
//     (the other variants' arithmetic), then the Huber cost;
//   * each thread sums its rows in order, the block by a warp-shuffle tree
//     and then the warps in order; the block's partial goes to scratch, and
//     the block that takes the last ticket (the other variants' counter)
//     adds the partials in block order, its threads over strided slices,
//     then a warp tree and the warps in order.
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
constexpr int kLm = 3;
constexpr int kCost = 4;
constexpr int kCamCols = 43;   // Hcc (36) | gc (6) | cost
constexpr int kLineCols = 21;  // Hll (16) | gl (4) | cost
constexpr int kPairCols = 24;  // W

// N = 0 carries the value alone (the cost variant); its one slot of d is
// never touched
template <typename T, int N>
struct Dual {
  T v;
  T d[N > 0 ? N : 1];

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
  int O;
  // camera c's rows: row_perm[row_off[c * row_stride] ...
  // row_off[(c + 1) * row_stride]); the pair plan (row_stride = L) in full,
  // the camera plan (row_stride = 1) in cams and lm
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
  T* Wb;
  T* cost_l;
  T* partial;
  // lm: the line partials of the row blocks, (2 blocks, kLmLineCols)
  T* line_part;
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
    static_assert(kVariant == kFull, "lm has kernels of its own");
    if (b < a.C)
      camera_block<T, kVariant>(a, b);
    else
      line_block<T, kVariant>(a, b - a.C);
  }
}

// ---------------------------------------------------------------------------
// lm: the line-major evaluate, a row pass and a camera pass (see the header)
// ---------------------------------------------------------------------------

constexpr int kLmLineCols = 14;  // Hll's upper triangle (10) | gl (4)

// Writes the n x n symmetric block whose upper triangle is u to m.
template <typename T, int n>
__device__ __forceinline__ void write_symmetric(const T* u, T* m) {
  int e = 0;
#pragma unroll
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int j = i; j < n; ++j, ++e) {
      m[i * n + j] = u[e];
      m[j * n + i] = u[e];
    }
}

// The row pass: block b takes the kept rows b kBlock ... of the line plan,
// one a thread, so every thread of a full block has a row whatever the
// lines' lengths.  A row's residual runs on the 4 line tangents (Jl, the
// Huber weight, its Hll|gl terms), then on the 6 camera tangents for its
// Wb = Jc^T Jl.  Hll|gl are summed over each line's run of rows in the
// block (a segmented warp scan, then the earlier warps of the run); a line
// inside one block is written here, the partials of a line that crosses
// blocks go to line_part (the run holding the block's first row, then the
// one holding its last) for lm_cams_kernel.  The block's Wb rows, its kept
// rows' and the plan's dropped rows' (zeros), go out through shared memory
// in one flat loop over (row, element), so neighbouring threads write
// neighbouring elements.
constexpr int kWbStride = kPairCols + 1;  // shared rows, no bank conflicts

template <typename T>
__global__ void __launch_bounds__(kBlock) lm_rows_kernel(Args<T> a) {
  __shared__ T s_tail[kWarps][kLmLineCols];
  __shared__ int s_tail_l[kWarps];
  __shared__ int s_head_l[kWarps];
  __shared__ int s_row[kBlock];
  __shared__ T s_wb[kBlock * kWbStride];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int first = blockIdx.x * kBlock;
  const int i = first + t;
  const int kept = a.line_off[a.L];
  T Jl[4][4], v[kLmLineCols];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) Jl[k][j] = T(0);
#pragma unroll
  for (int j = 0; j < kLmLineCols; ++j) v[j] = T(0);
  T w_r = T(0);
  int o = 0, c = 0;
  int l = -1 - t;  // rows past the kept ones: a run of their own
  bool valid = false;
  if (i < kept) {
    o = a.line_perm[i];
    c = a.oc[o];
    l = a.ol[o];
    valid = row_valid(c, l, a.wv[o] > T(0), a.C, a.L);
    if (valid) {
      T ob[8];
      load_obs(a.obs, o, ob);
      Dual<T, 4> q[4];
      row_residual<T, 4, 6>(a.cam, a.line, c, l, ob, a.baseline, q);
      const T s = q[0].v * q[0].v + q[1].v * q[1].v + q[2].v * q[2].v +
                  q[3].v * q[3].v;
      T cost_i;
      huber_weights(s, a.huber, &w_r, &cost_i);
      const T lf = a.lfree[l];
      T rw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        rw[k] = q[k].v * w_r;
#pragma unroll
        for (int j = 0; j < 4; ++j) Jl[k][j] = q[k].d[j] * w_r * lf;
      }
      int e = 0;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = ii; jj < 4; ++jj, ++e) {
          T x = T(0);
#pragma unroll
          for (int k = 0; k < 4; ++k) x += Jl[k][ii] * Jl[k][jj];
          v[e] = x;
        }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        T g = T(0);
#pragma unroll
        for (int k = 0; k < 4; ++k) g += Jl[k][ii] * rw[k];
        v[10 + ii] = g;
      }
    }
  }
  // segmented inclusive scan over the warp's rows of one line (a plan's
  // rows are grouped by line, so a run is contiguous)
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int lu = __shfl_up_sync(0xffffffffu, l, s);
#pragma unroll
    for (int j = 0; j < kLmLineCols; ++j) {
      const T x = __shfl_up_sync(0xffffffffu, v[j], s);
      if (lane >= s && lu == l) v[j] += x;
    }
  }
  if (lane == 31) {
    s_tail_l[w] = l;
#pragma unroll
    for (int j = 0; j < kLmLineCols; ++j) s_tail[w][j] = v[j];
  }
  if (lane == 0) s_head_l[w] = l;
  __syncthreads();
  if (i < kept && l >= 0 && l < a.L) {
    const int s0 = a.line_off[l];
    const int s1 = a.line_off[l + 1];
    if (i == s1 - 1 || t == kBlock - 1) {  // the run's last row here
      if (s_head_l[w] == l) {
        for (int w2 = w - 1; w2 >= 0 && s_tail_l[w2] == l; --w2) {
#pragma unroll
          for (int j = 0; j < kLmLineCols; ++j) v[j] += s_tail[w2][j];
          if (s_head_l[w2] != l) break;
        }
      }
      if (s0 >= first && i == s1 - 1) {
        write_symmetric<T, 4>(v, a.Hll + static_cast<size_t>(l) * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) a.gl[l * 4 + j] = v[10 + j];
      } else {
        T* part = a.line_part + static_cast<size_t>(blockIdx.x) * 2 *
                                    kLmLineCols;
        if (s0 < first)
#pragma unroll
          for (int j = 0; j < kLmLineCols; ++j) part[j] = v[j];
        if (i < s1 - 1)
#pragma unroll
          for (int j = 0; j < kLmLineCols; ++j) part[kLmLineCols + j] = v[j];
      }
    }
  }
  const int n = a.O - first < kBlock ? a.O - first : kBlock;
  if (t < n) s_row[t] = i < kept ? o : a.line_perm[i];
  if (i < kept) {
    T* wb = s_wb + t * kWbStride;
    if (valid) {
      T ob[8];
      load_obs(a.obs, o, ob);
      Dual<T, 6> r[4];
      row_residual<T, 6, 0>(a.cam, a.line, c, l, ob, a.baseline, r);
      const T cf = a.cfree[c];
      T Jc[4][6];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 6; ++j) Jc[k][j] = r[k].d[j] * w_r * cf;
#pragma unroll
      for (int ii = 0; ii < 6; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          T x = T(0);
#pragma unroll
          for (int k = 0; k < 4; ++k) x += Jc[k][ii] * Jl[k][jj];
          wb[ii * 4 + jj] = x;
        }
    } else {
#pragma unroll
      for (int j = 0; j < kPairCols; ++j) wb[j] = T(0);
    }
  }
  __syncthreads();
  const int m = kept - first;  // the block's rows before m are kept
  for (int e = t; e < n * kPairCols; e += kBlock) {
    const int k = e / kPairCols;
    const int j = e - k * kPairCols;
    a.Wb[static_cast<size_t>(s_row[k]) * kPairCols + j] =
        k < m ? s_wb[k * kWbStride + j] : T(0);
  }
}

// Hll | gl of line l where lm_rows_kernel did not write them: zero for a
// line with no kept row; for a line across row blocks b0 < b1, the run
// ending block b0, then the runs starting blocks b0 + 1 ... b1, in order.
template <typename T>
__device__ void lm_line_combine(const Args<T>& a, int l) {
  if (l >= a.L) return;
  const int s0 = a.line_off[l];
  const int s1 = a.line_off[l + 1];
  const int b0 = s0 / kBlock;
  const int b1 = (s1 - 1) / kBlock;
  if (s0 < s1 && b0 == b1) return;
  T v[kLmLineCols];
#pragma unroll
  for (int j = 0; j < kLmLineCols; ++j) v[j] = T(0);
  if (s0 < s1) {
    const T* part = a.line_part + static_cast<size_t>(b0) * 2 * kLmLineCols;
#pragma unroll
    for (int j = 0; j < kLmLineCols; ++j) v[j] = part[kLmLineCols + j];
    for (int b = b0 + 1; b <= b1; ++b) {
      part = a.line_part + static_cast<size_t>(b) * 2 * kLmLineCols;
#pragma unroll
      for (int j = 0; j < kLmLineCols; ++j) v[j] += part[j];
    }
  }
  write_symmetric<T, 4>(v, a.Hll + static_cast<size_t>(l) * 16);
#pragma unroll
  for (int j = 0; j < 4; ++j) a.gl[l * 4 + j] = v[10 + j];
}

// The camera pass: C camera blocks (the cams variant's, over the camera
// plan), then ceil(L / kBlock) blocks of line combines.  It runs after
// lm_rows_kernel on the same stream.
template <typename T>
__global__ void __launch_bounds__(kBlock) lm_cams_kernel(Args<T> a) {
  if (static_cast<int>(blockIdx.x) < a.C)
    camera_block<T, kCams>(a, blockIdx.x);
  else
    lm_line_combine<T>(a, (blockIdx.x - a.C) * kBlock + threadIdx.x);
}

int lm_row_blocks(int O) { return (O + kBlock - 1) / kBlock; }

// ---------------------------------------------------------------------------
// cost: the robust cost alone over the line plan's kept rows (see the header)
// ---------------------------------------------------------------------------

// the cost grid's most blocks: one wave in float32 on the H100's 132 SMs
// (46 registers a thread, 10 blocks an SM), and few partials for the last
// block to add
constexpr int kCostBlocks = 1024;

int cost_blocks(int O) {
  const int b = lm_row_blocks(O);
  return b < 1 ? 1 : (b < kCostBlocks ? b : kCostBlocks);
}

// Adds the kBlock threads' v in a fixed order (a warp tree, then the warps
// in order); thread 0 returns the sum.  s_part holds kWarps values.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* s_part) {
  const int t = threadIdx.x;
  v = warp_sum(v);
  if ((t & 31) == 0) s_part[t >> 5] = v;
  __syncthreads();
  T s = s_part[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += s_part[w];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kBlock) cost_kernel(Args<T> a) {
  __shared__ T s_part[kWarps];
  __shared__ int s_last;
  const int t = threadIdx.x;
  const int nb = gridDim.x;
  const long long kept = a.line_off[a.L];
  const long long chunk = (kept + nb - 1) / nb;
  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < kept ? lo + chunk : kept;
  T acc = T(0);
  for (long long i = lo + t; i < hi; i += kBlock) {
    const int o = a.line_perm[i];
    const int c = a.oc[o];
    const int l = a.ol[o];
    if (row_valid(c, l, a.wv[o] > T(0), a.C, a.L)) {
      T ob[8];
      load_obs(a.obs, o, ob);
      Dual<T, 0> r[4];
      row_residual<T, 0, 0>(a.cam, a.line, c, l, ob, a.baseline, r);
      const T s = r[0].v * r[0].v + r[1].v * r[1].v + r[2].v * r[2].v +
                  r[3].v * r[3].v;
      T w_r, cost_i;
      huber_weights(s, a.huber, &w_r, &cost_i);
      acc += cost_i;
    }
  }
  const T part = block_sum(acc, s_part);
  if (t == 0) {
    a.partial[blockIdx.x] = part;
    __threadfence();
    s_last = atomicAdd(a.tickets, 1) == nb - 1;
  }
  __syncthreads();  // s_part read, s_last written
  if (!s_last) return;
  __threadfence();
  const volatile T* partial = a.partial;
  T s = T(0);
  for (int b = t; b < nb; b += kBlock) s += partial[b];
  s = block_sum(s, s_part);
  if (t == 0) {
    a.cost[0] = s;
    *a.tickets = 0;
  }
}

template <typename T>
int launch(int variant, const void* cam, const void* line, const void* obs,
           const void* oc, const void* ol, const void* wv, const void* cfree,
           const void* lfree, double baseline, double huber, int C, int L,
           int O, const void* row_perm, const void* row_off, int row_stride,
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
  a.O = O;
  a.row_perm = static_cast<const int*>(row_perm);
  a.row_off = static_cast<const int*>(row_off);
  a.row_stride = row_stride;
  a.line_perm = static_cast<const int*>(line_perm);
  a.line_off = static_cast<const int*>(line_off);
  a.tickets = static_cast<int*>(tickets);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kCost) {
    a.cost = o;
    a.partial = o + 1;
    cost_kernel<T><<<cost_blocks(O), kBlock, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant == kLm) {  // first: its rows start on 32-byte sectors
    a.Wb = o;
    o += static_cast<size_t>(O) * kPairCols;
  }
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
  if (variant == kLines) {
    a.cost_l = o;
  } else {
    a.partial = o;
    o += C;
  }
  if (variant == kLm) a.line_part = o;
  if (variant == kFull)
    fused_eval_kernel<T, kFull><<<C + L, kBlock, 0, s>>>(a);
  else if (variant == kCams)
    fused_eval_kernel<T, kCams><<<C, kBlock, 0, s>>>(a);
  else if (variant == kLines)
    fused_eval_kernel<T, kLines><<<L, kBlock, 0, s>>>(a);
  else if (variant != kLm)
    return static_cast<int>(cudaErrorInvalidValue);
  else {
    if (O > 0) {
      lm_rows_kernel<T><<<lm_row_blocks(O), kBlock, 0, s>>>(a);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    lm_cams_kernel<T><<<C + (L + kBlock - 1) / kBlock, kBlock, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 full, 1 cams, 2 lines, 3 lm, 4 cost.  Output buffer, every
// element written:
//   full   cost (1) | Hcc (C*36) | gc (C*6) | Hll (L*16) | gl (L*4) |
//          W (C*L*24) | partial costs (C)
//   cams   cost (1) | Hcc (C*36) | gc (C*6) | partial costs (C)
//   lines  Hll (L*16) | gl (L*4) | per-line cost (L)
//   lm     Wb (O*24) | cost (1) | Hcc (C*36) | gc (C*6) | Hll (L*16) |
//          gl (L*4) | partial costs (C) | line partials
//          (fused_eval_scratch: 2 x 14 a row block)
//   cost   cost (1) | block partials (fused_eval_scratch: one a block)
// cost reads cam, line, obs, oc, ol, wv and the line plan, nothing else.
// tickets: one int, 0 before the launch and 0 again after it, used by no
// other launch in flight.  C, L >= 1.
extern "C" int fused_eval_f32(int variant, const void* cam, const void* line,
                              const void* obs, const void* oc, const void* ol,
                              const void* wv, const void* cfree,
                              const void* lfree, double baseline, double huber,
                              int C, int L, int O, const void* row_perm,
                              const void* row_off, int row_stride,
                              const void* line_perm, const void* line_off,
                              void* out, void* tickets, void* stream) {
  return launch<float>(variant, cam, line, obs, oc, ol, wv, cfree, lfree,
                       baseline, huber, C, L, O, row_perm, row_off,
                       row_stride, line_perm, line_off, out, tickets, stream);
}

extern "C" int fused_eval_f64(int variant, const void* cam, const void* line,
                              const void* obs, const void* oc, const void* ol,
                              const void* wv, const void* cfree,
                              const void* lfree, double baseline, double huber,
                              int C, int L, int O, const void* row_perm,
                              const void* row_off, int row_stride,
                              const void* line_perm, const void* line_off,
                              void* out, void* tickets, void* stream) {
  return launch<double>(variant, cam, line, obs, oc, ol, wv, cfree, lfree,
                        baseline, huber, C, L, O, row_perm, row_off,
                        row_stride, line_perm, line_off, out, tickets, stream);
}

// Elements of the buffer past its outputs and partial costs: lm's line
// partials, cost's block partials, none for the other variants.
extern "C" long long fused_eval_scratch(int variant, int C, int L, int O) {
  (void)C;
  (void)L;
  if (variant == kCost) return cost_blocks(O);
  return variant == kLm ? 2LL * kLmLineCols * lm_row_blocks(O) : 0;
}
