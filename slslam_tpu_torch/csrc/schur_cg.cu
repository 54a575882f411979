// K3 schur_matvec and schur_pcg, K4 schur_jacobi -- the global refine's
// PCG on the reduced camera system, on the line-major layout.
//
// Replace the XLA einsums and the lax.while_loop of slslam_tpu/ops/
// schur_cg.py _solve_step_cg (:173-279), which the JAX package never wrote
// as a Pallas kernel: the matvec (:198-214), the right-hand side
// (:216-219), the SCHUR_JACOBI blocks (:221-229), the PCG loop (:233-266)
// and the back-substitution's coupling (:269-271), and with them K1's
// per-camera sums at the PCG's shapes (segment_sum_pallas,
// slslam_tpu/ops/pallas_kernels.py:52-81).  The problem is a line-major
// bucketed layout: L lines of kL rows, row o = l kL + k, each row holding
// the camera-line coupling block Wb (6 x 4) of one observation (zero on
// the padding rows).  With S = Hcc_d - W Binv W^T (+ the pose priors'
// coupling blocks Hoff of camera pairs (ei, ej)):
//
//   K3 line pass (schur_line_*): z_l = sum over the valid rows of line l
//        of Wb^T x_m[cam(row)], x_m = x * m (m the camera free flags),
//        and w_l = Binv_l z_l.  Writes w (L, 4) and z (L, 4), the
//        back-substitution's coupling.
//   K3 camera pass (schur_cam_*): v_c = sum over the valid rows of camera
//        c of Wb w[line(row)]; writes (Hcc_d x_m - v) m + x (1 - m) -- the
//        matvec, fixed cameras mapped to the identity -- or, for the
//        right-hand side, (-gc + v) m.
//   K3 PCG (schur_pcg_*): the whole PCG of one damped LM step in one
//        cooperative launch (below).
//   K4 (schur_jacobi_*): P_c = Hcc_d,c - sum over the valid rows of
//        camera c of Wb Binv[line] Wb^T, the identity for a fixed camera.
//
// What bounds them on the H100: bytes, and at the refine's shapes the
// latency of dependent steps.  A pass reads each valid row's Wb (96 bytes
// in f32) once, its plan entry and one gathered vector; the small
// per-camera and per-line blocks once.  At the large map's shape (C 8192,
// L 109,147, 3,492,704 flat rows of which 929,796 are valid) a pass needs
// ~0.1 GB, ~0.03 ms at 3.35 TB/s.  At the refine's shape (400, 74,
// 29,600) a PCG iteration's work is ~6 MB: a launch and a host read an
// iteration cost more than the passes, so the PCG runs as one launch.
//
// Segments.  A group of G threads takes one segment of the solve's
// segment plans (kernels.ba_plan's "lm" plans, built once per solve): the
// line plan in the line pass, the camera plan in the camera pass and K4.
// G follows the layout's shape (O flat rows, P segments) and no data: 8
// lanes where a segment holds at most 32 rows (the map's lines: kL 32,
// ~8.5 valid), a warp where it holds up to 256 or where the segments are
// enough to give each resident warp one (the map's 8192 cameras), else a
// whole block of 128 threads (the refine's 400-row lines, the front-end
// refine's ~500-row cameras).  Each thread walks the segment's rows
// lane, lane + G, ..., loads a row's Wb with 16-byte vector loads and adds
// its contribution to its own sums; the group then meets in a fixed
// xor-butterfly of warp shuffles (both lanes of a pair add the same two
// values, so every lane holds the same sum) and, for a block, adds its
// warps' sums in warp order through shared memory.  Only valid rows are
// read: the plans drop the padding rows.  No atomics: the sums run in a
// fixed order (bit for bit from run to run), and the kernels allocate
// nothing.  No fast-math.
//
// The PCG (schur_pcg_*).  One persistent cooperative launch runs the loop
// of _solve_step_cg from rhs and Minv (the inverted SCHUR_JACOBI blocks):
// tol2 = eta^2 rhs.rhs, x = 0, r = rhs, z = Minv r, p = z, rz = r.z;
// while it < iters and r.r > tol2: Ap = S p, alpha = rz / p.Ap (0 unless
// p.Ap > 0), x += alpha p, r -= alpha Ap, z = Minv r, beta = r.z / rz (rz
// = 0: 1), p = z + beta p.  An iteration is three phases between grid
// barriers (cooperative_groups::this_grid().sync()):
//   (a) p = z + beta p_old into the other of two p buffers, and the line
//       pass on p_m, each gathered p formed from z and p_old on the fly;
//   (b) the camera pass: Ap = (Hcc_d p_m - W w) m + p (1 - m) + the
//       priors' rows, Hoff_e p_m[ej] for camera ei and Hoff_e^T p_m[ei]
//       for camera ej over the edges' node plan, times m; and p.Ap;
//   (c) alpha; x, r; z = Minv r, a 6 x 6 a camera; r.z and r.r.
// Each block adds its threads' share of a dot product in a fixed tree
// and writes it to its own slot of a scratch array; after the barrier
// every block adds all the slots in the same fixed order, so every block
// holds the same alpha, beta and stop test, and two launches agree bit
// for bit.
// The grid is as many blocks as the card keeps resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), capped by the
// work of the widest phase: a function of the shapes (C, L, O) alone.
// The segments and cameras are walked in grid-stride loops.  Buffers the
// launch writes (p, r, z, Ap, w, the slots) are read by ordinary cached
// loads after the barrier, never through the non-coherent read-only path.
// The cameras' update takes 8 lanes a camera.  The wrapper
// allocates every buffer; the count of iterations run is written to a
// device int, so the host reads nothing between the step's start and
// its end.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cgrp = cooperative_groups;

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kRow = 24;  // a Wb row: 6 x 4

__device__ __forceinline__ void load_row(const float* __restrict__ Wb,
                                         int o, float* wb) {
  const float4* p =
      reinterpret_cast<const float4*>(Wb + static_cast<size_t>(o) * kRow);
#pragma unroll
  for (int k = 0; k < kRow / 4; ++k) {
    const float4 v = __ldg(p + k);
    wb[4 * k] = v.x;
    wb[4 * k + 1] = v.y;
    wb[4 * k + 2] = v.z;
    wb[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ void load_row(const double* __restrict__ Wb,
                                         int o, double* wb) {
  const double2* p =
      reinterpret_cast<const double2*>(Wb + static_cast<size_t>(o) * kRow);
#pragma unroll
  for (int k = 0; k < kRow / 2; ++k) {
    const double2 v = __ldg(p + k);
    wb[2 * k] = v.x;
    wb[2 * k + 1] = v.y;
  }
}

// Four consecutive values (16-byte aligned) through the read-only path.
__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load4(const double* __restrict__ p,
                                      double* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// A value of a buffer: where this launch writes the buffer (kCoherent),
// an ordinary cached load (ld.global.ca), which a grid barrier's fence
// keeps coherent, never the non-coherent read-only path (__ldg) that the
// other inputs take.
template <bool kCoherent, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kCoherent)
    return __ldca(p);
  else
    return __ldg(p);
}

// The sum over the G threads of a group (G a power of two <= 32, or
// kBlock) of each of v's N values, the same sums in every thread.  Every
// thread of the warp (of the block, for kBlock) must call it; ``sh``
// holds N kWarps values of shared memory (kBlock only).
template <int G, int N, typename T>
__device__ __forceinline__ void group_sum(T (&v)[N], T* sh) {
#pragma unroll
  for (int s = (G < 32 ? G : 32) / 2; s > 0; s >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], s);
  }
  if constexpr (G == kBlock) {
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) sh[warp * N + k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) {
      T s = sh[k];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += sh[w * N + k];
      v[k] = s;
    }
    __syncthreads();
  }
}

// v[j] for a j known only at run time, without a local-memory array.
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&v)[N], int j) {
  T r = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k == j) r = v[k];
  return r;
}

// This thread's group: its first segment g0, the number of groups ng (the
// stride of a grid-stride walk over segments) and its lane.
template <int G>
__device__ __forceinline__ void group_of(int* g0, int* ng, int* lane) {
  if constexpr (G == kBlock) {
    *g0 = blockIdx.x;
    *ng = gridDim.x;
    *lane = threadIdx.x;
  } else {
    const int t = blockIdx.x * kBlock + threadIdx.x;
    *g0 = t / G;
    *ng = gridDim.x * (kBlock / G);
    *lane = t & (G - 1);
  }
}

// Lanes a segment (the header's rule): O flat rows in P segments.
int group_lanes(int O, int P) {
  if (O <= 32LL * P) return 8;
  if (O <= 256LL * P || P >= 2048) return 32;
  return kBlock;
}

int blocks(int P, int G) {
  if (G == kBlock) return P;
  return static_cast<int>((static_cast<long long>(P) * G + kBlock - 1) /
                          kBlock);
}

template <typename T>
struct Args {
  const T* Wb;      // (L kL, 24)
  const int* oc;    // (L kL,) the rows' cameras
  const T* m;       // (C,) camera free flags, 0 or 1
  const T* x;       // (C, 6)
  const T* Binv;    // (L, 16)
  const T* w;       // (L, 4), the camera pass's input
  const T* Hcc_d;   // (C, 36)
  const T* gc;      // (C, 6), the right-hand side's
  const int* perm;  // the segment plan: rows of segment 0, 1, ...
  const int* off;   // (P + 1,) segment starts
  int C;
  int L;
  int kL;
  T* out;           // line pass: w (L, 4); camera pass (C, 6); K4 (C, 36)
  T* z;             // line pass: z (L, 4)
};

// x_m of a camera for the standalone line pass: x[c] m[c].
template <typename T>
struct XmOf {
  const T* x;
  const T* m;
  __device__ __forceinline__ void operator()(int c, T (&xm)[6]) const {
    const T mc = __ldg(m + c);
#pragma unroll
    for (int j = 0; j < 6; ++j) xm[j] = __ldg(x + c * 6 + j) * mc;
  }
};

// K3's line pass over segment l (l >= L: an empty segment): y = the sum
// over line l's rows of Wb^T xm[cam], in every thread of the group.
template <int G, typename T, typename XM>
__device__ __forceinline__ void line_segment(const T* Wb, const int* oc,
                                             const int* perm, const int* off,
                                             int C, int L, int l, int lane,
                                             const XM& xm_of, T (&y)[4],
                                             T* sh) {
#pragma unroll
  for (int b = 0; b < 4; ++b) y[b] = T(0);
  const int s0 = l < L ? __ldg(off + l) : 0;
  const int s1 = l < L ? __ldg(off + l + 1) : 0;
#pragma unroll 2
  for (int i = s0 + lane; i < s1; i += G) {
    const int o = __ldg(perm + i);
    const int c = __ldg(oc + o);
    if (c < 0 || c >= C) continue;
    T xm[6], wb[kRow];
    xm_of(c, xm);
    load_row(Wb, o, wb);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) s += wb[j * 4 + b] * xm[j];
      y[b] += s;
    }
  }
  group_sum<G>(y, sh);
}

// The line pass over every segment, grid-stride: w = Binv y (and z = y
// where z is given).
template <int G, typename T, typename XM>
__device__ __forceinline__ void line_groups(const Args<T>& a, const XM& xm_of,
                                            T* w, T* z, T* sh) {
  int g0, ng, lane;
  group_of<G>(&g0, &ng, &lane);
  for (int base = 0; base < a.L; base += ng) {
    const int l = base + g0;
    T y[4];
    line_segment<G>(a.Wb, a.oc, a.perm, a.off, a.C, a.L, l, lane, xm_of, y,
                    sh);
    if (l < a.L && lane < 4) {
      const T* B = a.Binv + static_cast<size_t>(l) * 16 + lane * 4;
      w[l * 4 + lane] = __ldg(B) * y[0] + __ldg(B + 1) * y[1] +
                        __ldg(B + 2) * y[2] + __ldg(B + 3) * y[3];
      if (z != nullptr) z[l * 4 + lane] = pick(y, lane);
    }
  }
}

// K3's camera pass over segment c (c >= C: empty): v = the sum over
// camera c's rows of Wb w[line], in every thread of the group.
template <int G, bool kCoherent, typename T>
__device__ __forceinline__ void cam_segment(const Args<T>& a, int c,
                                            int lane, T (&v)[6], T* sh) {
#pragma unroll
  for (int j = 0; j < 6; ++j) v[j] = T(0);
  const int s0 = c < a.C ? __ldg(a.off + c) : 0;
  const int s1 = c < a.C ? __ldg(a.off + c + 1) : 0;
#pragma unroll 2
  for (int i = s0 + lane; i < s1; i += G) {
    const int o = __ldg(a.perm + i);
    const T* wl = a.w + static_cast<size_t>(o / a.kL) * 4;
    const T w0 = ld<kCoherent>(wl), w1 = ld<kCoherent>(wl + 1),
            w2 = ld<kCoherent>(wl + 2), w3 = ld<kCoherent>(wl + 3);
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      T wb[4];  // row j of the row's Wb
      load4(a.Wb + static_cast<size_t>(o) * kRow + 4 * j, wb);
      v[j] += wb[0] * w0 + wb[1] * w1 + wb[2] * w2 + wb[3] * w3;
    }
  }
  group_sum<G>(v, sh);
}

// Row j of the matvec at camera c from v_j: (Hcc_d x_m - v) m + x (1 - m).
template <bool kCoherent, typename T>
__device__ __forceinline__ T cam_matvec_row(const Args<T>& a, int c, int j,
                                            T vj) {
  const T mc = __ldg(a.m + c);
  const T* H = a.Hcc_d + static_cast<size_t>(c) * 36 + j * 6;
  T hx = T(0);
#pragma unroll
  for (int k = 0; k < 6; ++k)
    hx += __ldg(H + k) * (ld<kCoherent>(a.x + c * 6 + k) * mc);
  return (hx - vj) * mc + ld<kCoherent>(a.x + c * 6 + j) * (T(1) - mc);
}

template <typename T, int G>
__global__ void __launch_bounds__(kBlock) schur_line_kernel(Args<T> a) {
  __shared__ T sh[4 * kWarps];
  line_groups<G>(a, XmOf<T>{a.x, a.m}, a.out, a.z, sh);
}

template <typename T, int G, bool kRhs>
__global__ void __launch_bounds__(kBlock) schur_cam_kernel(Args<T> a) {
  __shared__ T sh[6 * kWarps];
  int c, ng, lane;
  group_of<G>(&c, &ng, &lane);
  T v[6];
  cam_segment<G, false>(a, c, lane, v, sh);
  if (c < a.C && lane < 6) {
    const T vj = pick(v, lane);
    T r;
    if constexpr (kRhs)
      r = (-__ldg(a.gc + c * 6 + lane) + vj) * __ldg(a.m + c);
    else
      r = cam_matvec_row<false>(a, c, lane, vj);
    a.out[c * 6 + lane] = r;
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kBlock) schur_jacobi_kernel(Args<T> a) {
  __shared__ T sh[36 * kWarps];
  int c, ng, lane;
  group_of<G>(&c, &ng, &lane);
  T acc[36];
#pragma unroll
  for (int e = 0; e < 36; ++e) acc[e] = T(0);
  const int s0 = c < a.C ? __ldg(a.off + c) : 0;
  const int s1 = c < a.C ? __ldg(a.off + c + 1) : 0;
  for (int i = s0 + lane; i < s1; i += G) {
    const int o = __ldg(a.perm + i);
    const T* B = a.Binv + static_cast<size_t>(o / a.kL) * 16;
    T wb[kRow], Bl[16];
    load_row(a.Wb, o, wb);
#pragma unroll
    for (int e = 0; e < 16; ++e) Bl[e] = __ldg(B + e);
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      T V[4];  // row r of Wb Binv
#pragma unroll
      for (int k = 0; k < 4; ++k)
        V[k] = wb[r * 4] * Bl[k] + wb[r * 4 + 1] * Bl[4 + k] +
               wb[r * 4 + 2] * Bl[8 + k] + wb[r * 4 + 3] * Bl[12 + k];
#pragma unroll
      for (int d = 0; d < 6; ++d)
        acc[r * 6 + d] += V[0] * wb[d * 4] + V[1] * wb[d * 4 + 1] +
                          V[2] * wb[d * 4 + 2] + V[3] * wb[d * 4 + 3];
    }
  }
  group_sum<G>(acc, sh);
  if (c < a.C) {
    const bool free_cam = __ldg(a.m + c) > T(0);
#pragma unroll
    for (int e = 0; e < 36; ++e)
      if ((e & (G - 1)) == lane)
        a.out[static_cast<size_t>(c) * 36 + e] =
            free_cam ? __ldg(a.Hcc_d + static_cast<size_t>(c) * 36 + e) -
                           acc[e]
                     : T(e / 6 == e % 6 ? 1 : 0);
  }
}

// ---------------------------------------------------------------------------
// The PCG in one cooperative launch
// ---------------------------------------------------------------------------

template <typename T>
struct Pcg {
  Args<T> line;     // the line pass: Wb, oc, m, Binv, line plan, C, L
  Args<T> cam;      // the camera pass: Wb, m, Hcc_d, camera plan, C, kL
  const T* Hoff;    // (E, 36) the priors' coupling blocks, or E = 0
  const int* gkey;  // (2 E,) the edges' node rows: ei, then ej
  const int* gperm; // the edges' node plan over C cameras
  const int* goff;  // (C + 1,)
  int E;
  const T* rhs;     // (C, 6)
  const T* Minv;    // (C, 36)
  T eta2;           // eta^2
  int iters;
  int gl;           // lanes a line segment, lanes a camera segment
  int gc;
  T* x;             // (C, 6) out
  int* it;          // () out: PCG iterations run
  T* p0;            // (C, 6) scratch: the direction, double-buffered
  T* p1;
  T* r;             // (C, 6)
  T* z;             // (C, 6)
  T* Ap;            // (C, 6)
  T* w;             // (L, 4)
  T* part;          // (3 blocks,) a block's p.Ap, r.z, r.r
};

// p of the iteration from z and the previous p: the same expression
// wherever it is formed, so every copy of a p value holds the same bits.
template <typename T>
__device__ __forceinline__ T pdir(T z, T p_old, T beta, bool first) {
  return first ? z : fma(beta, p_old, z);
}

// x_m of a camera for the PCG's line pass: p_m formed from z and p_old.
template <typename T>
struct PdirOf {
  const T* z;
  const T* p_old;
  const T* m;
  T beta;
  bool first;
  __device__ __forceinline__ void operator()(int c, T (&xm)[6]) const {
    const T mc = __ldg(m + c);
#pragma unroll
    for (int j = 0; j < 6; ++j)
      xm[j] = pdir(ld<true>(z + c * 6 + j), first ? T(0) :
                   ld<true>(p_old + c * 6 + j), beta, first) * mc;
  }
};

// This block's sums of its threads' v (N values) into slots
// part[3 blockIdx.x + k0 + k], in a fixed order: the warps' butterflies,
// then the warps in order.
template <int N, typename T>
__device__ __forceinline__ void block_slots(T (&v)[N], T* part, int k0,
                                            T* sh) {
  group_sum<kBlock>(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) part[3 * blockIdx.x + k0 + k] = v[k];
  }
}

// The sums over the blocks' slots k0 .. k0 + N - 1, the same values in
// every thread of every block: thread t adds slots t, t + kBlock, ... in
// order (the loads unrolled, so several are in flight), then the block
// adds its threads' sums in group_sum's fixed order.  After a grid
// barrier.
template <int N, typename T>
__device__ __forceinline__ void grid_sums(const T* part, int k0, T (&s)[N],
                                          T* sh) {
#pragma unroll
  for (int k = 0; k < N; ++k) s[k] = T(0);
#pragma unroll 8
  for (int b = threadIdx.x; b < gridDim.x; b += kBlock) {
#pragma unroll
    for (int k = 0; k < N; ++k) s[k] += ld<true>(part + 3 * b + k0 + k);
  }
  group_sum<kBlock>(s, sh);
}

// Phase (a)'s line pass on p_m.
template <int G, typename T>
__device__ __forceinline__ void pcg_line(const Pcg<T>& q, const T* p_old,
                                         T beta, bool first, T* sh) {
  line_groups<G>(q.line, PdirOf<T>{q.z, p_old, q.line.m, beta, first}, q.w,
                 static_cast<T*>(nullptr), sh);
}

// Phase (b): Ap = S p over the camera segments; returns this thread's
// share of p.Ap.
template <int G, typename T>
__device__ __forceinline__ T pcg_cam(const Pcg<T>& q, const T* p, T* sh) {
  int g0, ng, lane;
  group_of<G>(&g0, &ng, &lane);
  Args<T> a = q.cam;
  a.w = q.w;
  a.x = p;
  T pap = T(0);
  for (int base = 0; base < a.C; base += ng) {
    const int c = base + g0;
    T v[6];
    cam_segment<G, true>(a, c, lane, v, sh);
    T pr[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) pr[j] = T(0);
    if (q.E > 0) {
      // the priors' rows of camera c over the edges' node plan
      const int s0 = c < a.C ? __ldg(q.goff + c) : 0;
      const int s1 = c < a.C ? __ldg(q.goff + c + 1) : 0;
      for (int i = s0 + lane; i < s1; i += G) {
        const int row = __ldg(q.gperm + i);
        const bool lo = row < q.E;
        const int e = lo ? row : row - q.E;
        const int other = __ldg(q.gkey + (lo ? q.E + e : e));
        const T mo = __ldg(a.m + other);
        T po[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) po[k] = ld<true>(p + other * 6 + k) * mo;
        const T* H = q.Hoff + static_cast<size_t>(e) * 36;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          T s = T(0);
#pragma unroll
          for (int k = 0; k < 6; ++k)
            s += __ldg(H + (lo ? j * 6 + k : k * 6 + j)) * po[k];
          pr[j] += s;
        }
      }
      group_sum<G>(pr, sh);
    }
    if (c < a.C && lane < 6) {
      const T Apj = cam_matvec_row<true>(a, c, lane, pick(v, lane)) +
                    pick(pr, lane) * __ldg(a.m + c);
      q.Ap[c * 6 + lane] = Apj;
      pap += ld<true>(p + c * 6 + lane) * Apj;
    }
  }
  return pap;
}

// The cameras' update, 8 lanes a camera (lane j < 6 holds row j): with
// ``setup`` x = 0, r = rhs; else x += alpha p, r -= alpha Ap; then z =
// Minv r, r_k from the camera's lanes by shuffles; adds this thread's
// share of r.z and r.r to d.
template <typename T>
__device__ __forceinline__ void update_cameras(const Pcg<T>& q, const T* p,
                                               T alpha, bool setup,
                                               T (&d)[2]) {
  const int C = q.cam.C;
  const int t = blockIdx.x * kBlock + threadIdx.x;
  const int j = t & 7;
  const int n8 = gridDim.x * (kBlock / 8);
  const int first_lane = threadIdx.x & 24;  // the group's lane 0 in its warp
  for (int base = 0; base < C; base += n8) {
    const int c = base + t / 8;
    const bool on = c < C && j < 6;
    const int i = c * 6 + j;
    T rj = T(0);
    if (on) {
      if (setup) {
        rj = __ldg(q.rhs + i);
        q.x[i] = T(0);
      } else {
        q.x[i] = ld<true>(q.x + i) + alpha * ld<true>(p + i);
        rj = ld<true>(q.r + i) - alpha * ld<true>(q.Ap + i);
      }
      q.r[i] = rj;
    }
    T zj = T(0);
    const T* M = q.Minv + static_cast<size_t>(on ? c : 0) * 36 + j * 6;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const T rk = __shfl_sync(0xffffffffu, rj, first_lane + k);
      if (on) zj += __ldg(M + k) * rk;
    }
    if (on) {
      q.z[i] = zj;
      d[0] += rj * zj;
      d[1] += rj * rj;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock) schur_pcg_kernel(Pcg<T> q) {
  cgrp::grid_group grid = cgrp::this_grid();
  __shared__ T sh[6 * kWarps];
  const int tid = blockIdx.x * kBlock + threadIdx.x;
  const int nthreads = gridDim.x * kBlock;
  const int C = q.cam.C;

  // x = 0, r = rhs, z = Minv r; r.z and r.r
  T d[2] = {T(0), T(0)};
  update_cameras(q, static_cast<const T*>(nullptr), T(0), true, d);
  block_slots(d, q.part, 1, sh);
  grid.sync();
  T s[2];
  grid_sums(q.part, 1, s, sh);
  T rz = s[0], rr = s[1];
  const T tol2 = q.eta2 * rr;

  int it = 0;
  T beta = T(0);
  while (it < q.iters && rr > tol2) {
    const bool first = it == 0;
    T* p = it & 1 ? q.p1 : q.p0;
    const T* p_old = it & 1 ? q.p0 : q.p1;
    // (a) p, and the line pass on p_m
    for (int i = tid; i < 6 * C; i += nthreads)
      p[i] = pdir(ld<true>(q.z + i), first ? T(0) : ld<true>(p_old + i),
                  beta, first);
    if (q.gl == 8)
      pcg_line<8>(q, p_old, beta, first, sh);
    else if (q.gl == 32)
      pcg_line<32>(q, p_old, beta, first, sh);
    else
      pcg_line<kBlock>(q, p_old, beta, first, sh);
    grid.sync();
    // (b) Ap = S p and p.Ap
    T pap[1];
    if (q.gc == 8)
      pap[0] = pcg_cam<8>(q, p, sh);
    else if (q.gc == 32)
      pap[0] = pcg_cam<32>(q, p, sh);
    else
      pap[0] = pcg_cam<kBlock>(q, p, sh);
    block_slots(pap, q.part, 0, sh);
    grid.sync();
    // (c) alpha; x, r, z; r.z and r.r
    grid_sums(q.part, 0, pap, sh);
    const T alpha = pap[0] > T(0) ? rz / pap[0] : T(0);
    d[0] = d[1] = T(0);
    update_cameras(q, p, alpha, false, d);
    block_slots(d, q.part, 1, sh);
    grid.sync();
    grid_sums(q.part, 1, s, sh);
    beta = s[0] / (rz != T(0) ? rz : T(1));
    rz = s[0];
    rr = s[1];
    ++it;
  }
  if (tid == 0) *q.it = it;
}

template <typename T>
Args<T> line_args(const void* Wb, const void* oc, const void* m,
                  const void* Binv, const void* perm, const void* off, int C,
                  int L) {
  Args<T> a = {};
  a.Wb = static_cast<const T*>(Wb);
  a.oc = static_cast<const int*>(oc);
  a.m = static_cast<const T*>(m);
  a.Binv = static_cast<const T*>(Binv);
  a.perm = static_cast<const int*>(perm);
  a.off = static_cast<const int*>(off);
  a.C = C;
  a.L = L;
  return a;
}

template <typename T>
Args<T> cam_args(const void* Wb, const void* perm, const void* off,
                 const void* m, const void* Hcc_d, int C, int kL) {
  Args<T> a = {};
  a.Wb = static_cast<const T*>(Wb);
  a.perm = static_cast<const int*>(perm);
  a.off = static_cast<const int*>(off);
  a.m = static_cast<const T*>(m);
  a.Hcc_d = static_cast<const T*>(Hcc_d);
  a.C = C;
  a.kL = kL;
  return a;
}

template <typename T>
int line_pass(const void* Wb, const void* oc, const void* x, const void* m,
              const void* Binv, const void* perm, const void* off, int C,
              int L, int O, void* w, void* z, void* stream) {
  Args<T> a = line_args<T>(Wb, oc, m, Binv, perm, off, C, L);
  a.x = static_cast<const T*>(x);
  a.out = static_cast<T*>(w);
  a.z = static_cast<T*>(z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = group_lanes(O, L);
  if (G == 8)
    schur_line_kernel<T, 8><<<blocks(L, 8), kBlock, 0, s>>>(a);
  else if (G == 32)
    schur_line_kernel<T, 32><<<blocks(L, 32), kBlock, 0, s>>>(a);
  else
    schur_line_kernel<T, kBlock><<<blocks(L, kBlock), kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kRhs>
void cam_launch(const Args<T>& a, int G, cudaStream_t s) {
  if (G == 8)
    schur_cam_kernel<T, 8, kRhs><<<blocks(a.C, 8), kBlock, 0, s>>>(a);
  else if (G == 32)
    schur_cam_kernel<T, 32, kRhs><<<blocks(a.C, 32), kBlock, 0, s>>>(a);
  else
    schur_cam_kernel<T, kBlock, kRhs>
        <<<blocks(a.C, kBlock), kBlock, 0, s>>>(a);
}

template <typename T>
int cam_pass(int rhs, const void* Wb, const void* w, const void* perm,
             const void* off, const void* m, const void* Hcc_d,
             const void* x, const void* gc, int C, int kL, int O, void* out,
             void* stream) {
  Args<T> a = cam_args<T>(Wb, perm, off, m, Hcc_d, C, kL);
  a.w = static_cast<const T*>(w);
  a.x = static_cast<const T*>(x);
  a.gc = static_cast<const T*>(gc);
  a.out = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rhs)
    cam_launch<T, true>(a, group_lanes(O, C), s);
  else
    cam_launch<T, false>(a, group_lanes(O, C), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int jacobi(const void* Wb, const void* Binv, const void* perm,
           const void* off, const void* m, const void* Hcc_d, int C, int kL,
           int O, void* P, void* stream) {
  Args<T> a = cam_args<T>(Wb, perm, off, m, Hcc_d, C, kL);
  a.Binv = static_cast<const T*>(Binv);
  a.out = static_cast<T*>(P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = group_lanes(O, C);
  if (G == 8)
    schur_jacobi_kernel<T, 8><<<blocks(C, 8), kBlock, 0, s>>>(a);
  else if (G == 32)
    schur_jacobi_kernel<T, 32><<<blocks(C, 32), kBlock, 0, s>>>(a);
  else
    schur_jacobi_kernel<T, kBlock><<<blocks(C, kBlock), kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The PCG's grid at (C, L, O): the blocks the card keeps resident, capped
// by the widest phase's work; <= 0: the card cannot take the launch
// (minus a CUDA error).
template <typename T>
int pcg_blocks(int C, int L, int O) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, schur_pcg_kernel<T>, kBlock, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (!coop) return 0;
  const long long resident = static_cast<long long>(per_sm) * sms;
  long long work = blocks(L, group_lanes(O, L));
  work = work > blocks(C, group_lanes(O, C)) ? work
                                             : blocks(C, group_lanes(O, C));
  const long long upd = (6LL * C + kBlock - 1) / kBlock;
  work = work > upd ? work : upd;
  return static_cast<int>(work < resident ? work : resident);
}

template <typename T>
int pcg(const void* Wb, const void* oc, const void* m, const void* Binv,
        const void* Hcc_d, const void* lperm, const void* loff,
        const void* cperm, const void* coff, const void* Hoff,
        const void* gkey, const void* gperm, const void* goff, int C, int L,
        int kL, int E, const void* rhs, const void* Minv, double eta,
        int iters, int nblocks, void* scratch, void* x, void* it,
        void* stream) {
  if (nblocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int O = L * kL;
  Pcg<T> q = {};
  q.line = line_args<T>(Wb, oc, m, Binv, lperm, loff, C, L);
  q.cam = cam_args<T>(Wb, cperm, coff, m, Hcc_d, C, kL);
  q.Hoff = static_cast<const T*>(Hoff);
  q.gkey = static_cast<const int*>(gkey);
  q.gperm = static_cast<const int*>(gperm);
  q.goff = static_cast<const int*>(goff);
  q.E = E;
  q.rhs = static_cast<const T*>(rhs);
  q.Minv = static_cast<const T*>(Minv);
  q.eta2 = static_cast<T>(eta * eta);
  q.iters = iters;
  q.gl = group_lanes(O, L);
  q.gc = group_lanes(O, C);
  q.x = static_cast<T*>(x);
  q.it = static_cast<int*>(it);
  T* s = static_cast<T*>(scratch);
  const size_t n6 = 6 * static_cast<size_t>(C);
  q.p0 = s;
  q.p1 = s + n6;
  q.r = s + 2 * n6;
  q.z = s + 3 * n6;
  q.Ap = s + 4 * n6;
  q.w = s + 5 * n6;
  q.part = q.w + 4 * static_cast<size_t>(L);
  void* args[] = {&q};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)schur_pcg_kernel<T>, dim3(nblocks), dim3(kBlock), args, 0,
      static_cast<cudaStream_t>(stream));
  // a refused launch (a grid the card cannot keep resident) is returned
  // here; take it out of the runtime's last error so that the next
  // kernel's cudaGetLastError() does not report it again
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// Each entry takes the pointers of contiguous tensors (Wb 16-byte aligned)
// and the CUDA stream, launches one kernel and returns cudaGetLastError()
// (the PCG: cudaLaunchCooperativeKernel's error).  C, L >= 1; O = L kL
// flat rows; perm / off: the segment plan of the flat rows by line (line
// pass, L + 1 offsets) or by camera (C + 1).

// K3 line pass: w (L, 4) = Binv z and z (L, 4).
extern "C" int schur_line_f32(const void* Wb, const void* oc, const void* x,
                              const void* m, const void* Binv,
                              const void* perm, const void* off, int C, int L,
                              int O, void* w, void* z, void* stream) {
  return line_pass<float>(Wb, oc, x, m, Binv, perm, off, C, L, O, w, z,
                          stream);
}

extern "C" int schur_line_f64(const void* Wb, const void* oc, const void* x,
                              const void* m, const void* Binv,
                              const void* perm, const void* off, int C, int L,
                              int O, void* w, void* z, void* stream) {
  return line_pass<double>(Wb, oc, x, m, Binv, perm, off, C, L, O, w, z,
                           stream);
}

// K3 camera pass: out (C, 6); rhs = 0 reads Hcc_d and x (the matvec),
// rhs = 1 reads gc (the right-hand side).
extern "C" int schur_cam_f32(int rhs, const void* Wb, const void* w,
                             const void* perm, const void* off, const void* m,
                             const void* Hcc_d, const void* x, const void* gc,
                             int C, int kL, int O, void* out, void* stream) {
  return cam_pass<float>(rhs, Wb, w, perm, off, m, Hcc_d, x, gc, C, kL, O,
                         out, stream);
}

extern "C" int schur_cam_f64(int rhs, const void* Wb, const void* w,
                             const void* perm, const void* off, const void* m,
                             const void* Hcc_d, const void* x, const void* gc,
                             int C, int kL, int O, void* out, void* stream) {
  return cam_pass<double>(rhs, Wb, w, perm, off, m, Hcc_d, x, gc, C, kL, O,
                          out, stream);
}

// K4: P (C, 36).
extern "C" int schur_jacobi_f32(const void* Wb, const void* Binv,
                                const void* perm, const void* off,
                                const void* m, const void* Hcc_d, int C,
                                int kL, int O, void* P, void* stream) {
  return jacobi<float>(Wb, Binv, perm, off, m, Hcc_d, C, kL, O, P, stream);
}

extern "C" int schur_jacobi_f64(const void* Wb, const void* Binv,
                                const void* perm, const void* off,
                                const void* m, const void* Hcc_d, int C,
                                int kL, int O, void* P, void* stream) {
  return jacobi<double>(Wb, Binv, perm, off, m, Hcc_d, C, kL, O, P, stream);
}

// The PCG's grid at (C, L, O) in f32 (f64 = 0) or f64 (f64 = 1): blocks,
// 0 where the card has no cooperative launch, minus a CUDA error.
extern "C" int schur_pcg_blocks(int f64, int C, int L, int O) {
  return f64 ? pcg_blocks<double>(C, L, O) : pcg_blocks<float>(C, L, O);
}

// K3 PCG: x (C, 6) and it (int32) from rhs (C, 6) and Minv (C, 36) over
// the line plan (lperm, loff) and the camera plan (cperm, coff); E prior
// edges (Hoff (E, 36), gkey (2 E,), their node plan gperm / goff over C;
// E = 0: none, the pointers unread); scratch of 30 C + 4 L + 3 nblocks
// values; nblocks from schur_pcg_blocks.
extern "C" int schur_pcg_f32(const void* Wb, const void* oc, const void* m,
                             const void* Binv, const void* Hcc_d,
                             const void* lperm, const void* loff,
                             const void* cperm, const void* coff,
                             const void* Hoff, const void* gkey,
                             const void* gperm, const void* goff, int C,
                             int L, int kL, int E, const void* rhs,
                             const void* Minv, double eta, int iters,
                             int nblocks, void* scratch, void* x, void* it,
                             void* stream) {
  return pcg<float>(Wb, oc, m, Binv, Hcc_d, lperm, loff, cperm, coff, Hoff,
                    gkey, gperm, goff, C, L, kL, E, rhs, Minv, eta, iters,
                    nblocks, scratch, x, it, stream);
}

extern "C" int schur_pcg_f64(const void* Wb, const void* oc, const void* m,
                             const void* Binv, const void* Hcc_d,
                             const void* lperm, const void* loff,
                             const void* cperm, const void* coff,
                             const void* Hoff, const void* gkey,
                             const void* gperm, const void* goff, int C,
                             int L, int kL, int E, const void* rhs,
                             const void* Minv, double eta, int iters,
                             int nblocks, void* scratch, void* x, void* it,
                             void* stream) {
  return pcg<double>(Wb, oc, m, Binv, Hcc_d, lperm, loff, cperm, coff, Hoff,
                     gkey, gperm, goff, C, L, kL, E, rhs, Minv, eta, iters,
                     nblocks, scratch, x, it, stream);
}
