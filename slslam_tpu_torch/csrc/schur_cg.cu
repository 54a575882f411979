// K3 schur_matvec and K4 schur_jacobi -- the global refine's PCG on the
// reduced camera system, on the line-major layout.
//
// Replace the XLA einsums of slslam_tpu/ops/schur_cg.py _solve_step_cg
// (:173-279), which the JAX package never wrote as a Pallas kernel: the
// matvec (:198-214), the right-hand side (:216-219), the SCHUR_JACOBI
// blocks (:221-229) and the back-substitution's coupling (:269-271), and
// with them K1's per-camera sums at the PCG's shapes (segment_sum_pallas,
// slslam_tpu/ops/pallas_kernels.py:52-81).  The problem is a line-major
// bucketed layout: L lines of kL rows, row o = l kL + k, each row holding
// the camera-line coupling block Wb (6 x 4) of one observation (zero on
// the padding rows).  With S = Hcc_d - W Binv W^T:
//
//   K3 line pass (schur_line_*): z_l = sum over the valid rows of line l
//        of Wb^T x_m[cam(row)], x_m = x * m (m the camera free flags),
//        and w_l = Binv_l z_l.  Writes w (L, 4) and z (L, 4), the
//        back-substitution's coupling.
//   K3 camera pass (schur_cam_*): v_c = sum over the valid rows of camera
//        c of Wb w[line(row)]; writes (Hcc_d x_m - v) m + x (1 - m) -- the
//        matvec, fixed cameras mapped to the identity -- or, for the
//        right-hand side, (-gc + v) m.
//   K4 (schur_jacobi_*): P_c = Hcc_d,c - sum over the valid rows of
//        camera c of Wb Binv[line] Wb^T, the identity for a fixed camera.
//
// What bounds them on the H100: bytes.  A pass reads each valid row's Wb
// (96 bytes in f32) once, its plan entry and one gathered vector; the
// small per-camera and per-line blocks once.  At the large map's shape
// (C 8192, L 109,147, 3,492,704 flat rows of which 929,796 are valid) a
// pass needs ~0.1 GB, ~0.03 ms at 3.35 TB/s, where the einsum chain
// streamed all 3.49M rows' Wb twice and wrote and re-read the (O, 4) and
// (O, 6) intermediates, and the Jacobi einsum wrote a 503 MB T.  At the
// refine's shape (400, 74, 29,600) the work is ~3 MB: launch latency
// bounds it, and the design spends one launch a pass.
//
// Design.  A group of G lanes (8 or 32, by the segments' row capacity
// O / P, so the choice reads no data) takes one segment of the solve's
// segment plans (kernels.ba_plan's "lm" plans, built once per solve): the
// line plan in the line pass, the camera plan in the camera pass and K4.
// Each lane walks the segment's rows lane, lane + G, ..., loads a row's Wb
// with 16-byte vector loads, forms its contribution in registers and adds
// it to its own sums; the G lanes then meet in a fixed xor-butterfly of
// warp shuffles (both lanes of a pair add the same two values, so every
// lane holds the same sum).  Only valid rows are read: the plans drop the
// padding rows, so the 73 % padding of the map costs nothing.  No atomics
// and no shared state: the sums run in a fixed order (bit for bit from
// run to run), launches on two streams or in a CUDA graph are independent,
// and the kernels allocate nothing.  No fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
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

// The sum over the G lanes of a group (G a power of two <= 32), the same
// value in every lane.  Every lane of the warp must call it.
template <int G, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
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

// The segment of this thread's group and its rows [s0, s1); P segments.
template <int G>
__device__ __forceinline__ int segment_rows(const int* off, int P, int* s0,
                                            int* s1, int* lane) {
  const int t = blockIdx.x * kBlock + threadIdx.x;
  const int seg = t / G;
  *lane = t & (G - 1);
  *s0 = *s1 = 0;
  if (seg < P) {
    *s0 = off[seg];
    *s1 = off[seg + 1];
  }
  return seg;
}

template <typename T, int G>
__global__ void __launch_bounds__(kBlock) schur_line_kernel(Args<T> a) {
  int s0, s1, lane;
  const int l = segment_rows<G>(a.off, a.L, &s0, &s1, &lane);
  T y[4] = {T(0), T(0), T(0), T(0)};
  for (int i = s0 + lane; i < s1; i += G) {
    const int o = a.perm[i];
    const int c = a.oc[o];
    if (c < 0 || c >= a.C) continue;
    const T mc = a.m[c];
    T xm[6], wb[kRow];
#pragma unroll
    for (int j = 0; j < 6; ++j) xm[j] = a.x[c * 6 + j] * mc;
    load_row(a.Wb, o, wb);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) s += wb[j * 4 + b] * xm[j];
      y[b] += s;
    }
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) y[b] = group_sum<G>(y[b]);
  if (l < a.L && lane < 4) {
    const T* B = a.Binv + static_cast<size_t>(l) * 16 + lane * 4;
    a.out[l * 4 + lane] = B[0] * y[0] + B[1] * y[1] + B[2] * y[2] +
                          B[3] * y[3];
    a.z[l * 4 + lane] = pick(y, lane);
  }
}

template <typename T, int G, bool kRhs>
__global__ void __launch_bounds__(kBlock) schur_cam_kernel(Args<T> a) {
  int s0, s1, lane;
  const int c = segment_rows<G>(a.off, a.C, &s0, &s1, &lane);
  T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int i = s0 + lane; i < s1; i += G) {
    const int o = a.perm[i];
    const T* wl = a.w + static_cast<size_t>(o / a.kL) * 4;
    const T w0 = wl[0], w1 = wl[1], w2 = wl[2], w3 = wl[3];
    T wb[kRow];
    load_row(a.Wb, o, wb);
#pragma unroll
    for (int j = 0; j < 6; ++j)
      v[j] += wb[j * 4] * w0 + wb[j * 4 + 1] * w1 + wb[j * 4 + 2] * w2 +
              wb[j * 4 + 3] * w3;
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) v[j] = group_sum<G>(v[j]);
  if (c < a.C && lane < 6) {
    const T mc = a.m[c];
    const T vj = pick(v, lane);
    T r;
    if constexpr (kRhs) {
      r = (-a.gc[c * 6 + lane] + vj) * mc;
    } else {
      const T* H = a.Hcc_d + static_cast<size_t>(c) * 36 + lane * 6;
      T hx = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) hx += H[j] * (a.x[c * 6 + j] * mc);
      r = (hx - vj) * mc + a.x[c * 6 + lane] * (T(1) - mc);
    }
    a.out[c * 6 + lane] = r;
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(kBlock) schur_jacobi_kernel(Args<T> a) {
  int s0, s1, lane;
  const int c = segment_rows<G>(a.off, a.C, &s0, &s1, &lane);
  T acc[36];
#pragma unroll
  for (int e = 0; e < 36; ++e) acc[e] = T(0);
  for (int i = s0 + lane; i < s1; i += G) {
    const int o = a.perm[i];
    const T* B = a.Binv + static_cast<size_t>(o / a.kL) * 16;
    T wb[kRow], Bl[16];
    load_row(a.Wb, o, wb);
#pragma unroll
    for (int e = 0; e < 16; ++e) Bl[e] = B[e];
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
#pragma unroll
  for (int e = 0; e < 36; ++e) acc[e] = group_sum<G>(acc[e]);
  if (c < a.C) {
    const bool free_cam = a.m[c] > T(0);
#pragma unroll
    for (int e = 0; e < 36; ++e)
      if ((e & (G - 1)) == lane)
        a.out[static_cast<size_t>(c) * 36 + e] =
            free_cam ? a.Hcc_d[static_cast<size_t>(c) * 36 + e] - acc[e]
                     : T(e / 6 == e % 6 ? 1 : 0);
  }
}

// Lanes a segment: 8 where a segment holds at most 32 rows of the layout
// (the large map's lines: kL = 32, ~8.5 of them valid), else a warp.
int group_lanes(int O, int P) { return O <= 32LL * P ? 8 : 32; }

int blocks(int P, int G) {
  return static_cast<int>((static_cast<long long>(P) * G + kBlock - 1) /
                          kBlock);
}

template <typename T>
int line_pass(const void* Wb, const void* oc, const void* x, const void* m,
              const void* Binv, const void* perm, const void* off, int C,
              int L, int O, void* w, void* z, void* stream) {
  Args<T> a = {};
  a.Wb = static_cast<const T*>(Wb);
  a.oc = static_cast<const int*>(oc);
  a.x = static_cast<const T*>(x);
  a.m = static_cast<const T*>(m);
  a.Binv = static_cast<const T*>(Binv);
  a.perm = static_cast<const int*>(perm);
  a.off = static_cast<const int*>(off);
  a.C = C;
  a.L = L;
  a.out = static_cast<T*>(w);
  a.z = static_cast<T*>(z);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group_lanes(O, L) == 8)
    schur_line_kernel<T, 8><<<blocks(L, 8), kBlock, 0, s>>>(a);
  else
    schur_line_kernel<T, 32><<<blocks(L, 32), kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cam_pass(int rhs, const void* Wb, const void* w, const void* perm,
             const void* off, const void* m, const void* Hcc_d,
             const void* x, const void* gc, int C, int kL, int O, void* out,
             void* stream) {
  Args<T> a = {};
  a.Wb = static_cast<const T*>(Wb);
  a.w = static_cast<const T*>(w);
  a.perm = static_cast<const int*>(perm);
  a.off = static_cast<const int*>(off);
  a.m = static_cast<const T*>(m);
  a.Hcc_d = static_cast<const T*>(Hcc_d);
  a.x = static_cast<const T*>(x);
  a.gc = static_cast<const T*>(gc);
  a.C = C;
  a.kL = kL;
  a.out = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = group_lanes(O, C);
  if (rhs && G == 8)
    schur_cam_kernel<T, 8, true><<<blocks(C, 8), kBlock, 0, s>>>(a);
  else if (rhs)
    schur_cam_kernel<T, 32, true><<<blocks(C, 32), kBlock, 0, s>>>(a);
  else if (G == 8)
    schur_cam_kernel<T, 8, false><<<blocks(C, 8), kBlock, 0, s>>>(a);
  else
    schur_cam_kernel<T, 32, false><<<blocks(C, 32), kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int jacobi(const void* Wb, const void* Binv, const void* perm,
           const void* off, const void* m, const void* Hcc_d, int C, int kL,
           int O, void* P, void* stream) {
  Args<T> a = {};
  a.Wb = static_cast<const T*>(Wb);
  a.Binv = static_cast<const T*>(Binv);
  a.perm = static_cast<const int*>(perm);
  a.off = static_cast<const int*>(off);
  a.m = static_cast<const T*>(m);
  a.Hcc_d = static_cast<const T*>(Hcc_d);
  a.C = C;
  a.kL = kL;
  a.out = static_cast<T*>(P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group_lanes(O, C) == 8)
    schur_jacobi_kernel<T, 8><<<blocks(C, 8), kBlock, 0, s>>>(a);
  else
    schur_jacobi_kernel<T, 32><<<blocks(C, 32), kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry takes the pointers of contiguous tensors (Wb 16-byte aligned)
// and the CUDA stream, launches one kernel and returns cudaGetLastError().
// C, L >= 1; O = L kL flat rows; perm / off: the segment plan of the flat
// rows by line (line pass, L + 1 offsets) or by camera (C + 1).

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
