// K1: segment_sum -- per-segment row sums (O, D) x idx (O,) -> (P, D), and
// the segment plan that groups the rows by index.
//
// Replaces the TPU kernel segment_sum_pallas / _seg_sum_kernel
// (slslam_tpu/ops/pallas_kernels.py:30-81), which builds a one-hot tile in
// VMEM and multiplies it on the MXU over a sequential (P-tiles, O-chunks)
// grid.  Rows whose index is outside [0, P) are padding and are dropped.
//
// The segment plan (seg_plan) is a stable sort of the rows by key: perm
// (O,) lists the rows of segment 0, then segment 1, ..., each in row
// order, then the dropped rows (key outside [0, P), negative keys too) in
// row order; offsets (P + 1,) holds where each segment starts, and
// offsets[P] counts the kept rows.  A stable sort has one answer, so the
// plan is unique and every path below gives the same bytes.  A BA solve
// builds its plans once and reuses them in every LM iteration.
//
// What bounds the plan on the H100: bytes.  It must read the key and write
// perm and offsets, 8 O + 4 (P + 1) bytes (kernel_checks.plan_work): at
// the large map's line plan (O = 3,492,704 rows, P = 109,147 lines) 28 MB,
// 8.5 us at the HBM rate.  A sort cannot reach that; the large plans are
// an LSD radix sort of (key, row) pairs, the key clamped to P (the dropped
// rows' slot), in passes of b <= 8 bits, b balanced over ceil(bits(P) / 8)
// passes (3 passes of 6 bits at P = 109,147, 2 of 7 at P = 8,192).  Each
// pass is stable and moves 8 bytes a row each way, so the map's line plan
// moves ~170 MB in three passes, from L2 in part (the scratch is 56 MB).
// The small plans are bound by the launch and the chain of barriers.
// Integer work only; no atomic's order reaches the output.
//
// Three paths, chosen by (O, P) alone, never by the data:
//
//   * one block a segment ((P + 1) O <= kSegmentBlocksWork: the window's
//     line plans, the VO polish's camera plans, most of the ~6,100 builds
//     of a replay): block p counts the rows of smaller key
//     (__syncthreads_count over tiles of the key) and writes its own rows
//     in order (warp ballots, a prefix over the warps of the tile); block
//     P takes the dropped rows.  Each block reads the whole key twice, so
//     the work is 2 (P + 1) O key reads, from L2; up to the limit the
//     blocks run side by side in a few microseconds, where the one-block
//     sort's chain of ~8 barriers a pass takes longer;
//   * one block (O <= kSmallMaxRows, P <= kSmallMaxSegments, past the
//     limit above: the window's (cam, line) pair plans, the PGO's V^2
//     plans): the rows live in shared memory, and each pass ranks them in
//     place.  Warp w owns a contiguous run of rows and walks it 32 at a
//     time; warp ballots (one a digit bit) group the lanes of one digit,
//     the group's lowest lane counts it into the warp's own (digit, warp)
//     counter, an exclusive scan over (digit, warp) gives every warp's
//     first slot for every digit, and a second walk places each row at
//     its slot plus its rank in its group.  The block ends by writing perm
//     and each offset (a binary search of the sorted keys).  One launch,
//     no scratch;
//   * tiles (every other (O, P): the refine's and the large map's plans):
//     three launches a pass over tiles of kTileRows rows -- a digit
//     histogram of each tile (plan_hist_kernel), an exclusive scan of the
//     (digit, tile) counts, one block a digit (plan_scan_kernel), and the
//     stable scatter (plan_scatter_kernel), which ranks the tile in shared
//     memory as the one-block path does and then writes each digit's run
//     to its slots in order, so that neighbouring threads write
//     neighbouring rows.  The first pass reads the key itself (row =
//     index); the last writes the rows into perm.  Then one launch writes
//     the offsets, offsets[p] = the first sorted key >= p by binary search,
//     which gives the empty segments, the trailing ones and P >> O without
//     a loop over gaps.  The double buffers of (key, row) pairs and the
//     counts are the caller's scratch (seg_plan_scratch ints), so the
//     launches can be captured in a CUDA graph.
//
// Design of the sum: one block per (segment, column tile), driven by a
// plan.  A block of kThreads threads holds D' = min(D, kThreads) columns
// and R = kThreads / D' row slots, so at D = 1 all threads take rows.  Slot
// r sums the segment's rows r, r + R, ... in plan order, and the R partials
// meet in a fixed tree in shared memory.  The result is the same from run
// to run.  Every output element is written, so the caller need not zero
// the output.  Nothing is allocated.  A caller without a plan builds one
// first (the wrapper does: segment_plan, then the sum).  The window BA
// calls it at O = 162..1600 rows, D = 1..42 lanes, P = 4..1620 segments,
// the refine's PCG at O = 29,600 rows, D = 6 or 36, P = 400 cameras: at
// most ~4.3 MB read, a few microseconds of work; it is launch-bound.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// ---------------------------------------------------------------------------
// The plan
// ---------------------------------------------------------------------------

constexpr long long kSegmentBlocksWork = 1LL << 21;  // (P + 1) O
constexpr int kSmallThreads = 1024;
constexpr int kSmallItems = 8;  // rows a thread holds in the one-block path
constexpr int kSmallMaxRows = kSmallThreads * kSmallItems;
constexpr int kSmallMaxSegments = 65535;  // two passes at most
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileItems = 16;  // rows a thread holds in a tile
constexpr int kTileRows = kTileThreads * kTileItems;
constexpr int kMaxRadix = 256;

// The passes of the radix sort: the clamped key is at most P, so it has
// bits(P) bits (one at least), split evenly into passes of <= 8 bits.
struct Digits {
  int passes;
  int bits;
};

Digits digits_of(int P) {
  int B = 1;
  while (B < 31 && (P >> B) != 0) ++B;
  const int passes = (B + 7) / 8;
  return {passes, (B + passes - 1) / passes};
}

bool segment_blocks_path(int O, int P) {
  return (static_cast<long long>(P) + 1) * O <= kSegmentBlocksWork;
}

bool small_path(int O, int P) {
  return O <= kSmallMaxRows && P <= kSmallMaxSegments;
}

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

// Block p of P + 1: segment p's start and rows (p = P: the dropped rows).
__global__ void __launch_bounds__(kThreads) plan_segments_kernel(
    const int* __restrict__ idx, int O, int P, int* __restrict__ perm,
    int* __restrict__ offsets) {
  __shared__ int rows[kThreads];
  __shared__ int warp_n[kWarps];
  const int p = blockIdx.x;
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

// Exclusive prefix sums of the n entries of a in place, in shared memory,
// entry i at a[i + i / width] (rows of width entries, a row stride of
// width + 1); every thread of the block must call it, with s_warp holding
// 33 ints.  Returns the total.  Thread t takes a contiguous run of entries.
__device__ int block_exclusive_scan(int* a, int n, int width, int* s_warp) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int nw = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, t * per);
  const int hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i + i / width];
  int x = sum;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, s);
    if (lane >= s) x += y;
  }
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  if (w == 0) {
    const int v = lane < nw ? s_warp[lane] : 0;
    int incl = v;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += y;
    }
    if (lane < nw) s_warp[lane] = incl - v;
    if (lane == 31) s_warp[32] = incl;
  }
  __syncthreads();
  int run = s_warp[w] + x - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = a[i + i / width];
    a[i + i / width] = run;
    run += c;
  }
  const int total = s_warp[32];
  __syncthreads();
  return total;
}

// The lanes of the warp whose digit equals this lane's (d < R = 2^bits;
// d = R for a lane with no row): one ballot a digit bit and one for
// having a row.
__device__ __forceinline__ unsigned digit_peers(int d, int R, int bits) {
  const bool row = d < R;
  const unsigned has = __ballot_sync(0xffffffffu, row);
  unsigned m = row ? has : ~has;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (b < bits) {
      const bool x = (d >> b) & 1;
      const unsigned v = __ballot_sync(0xffffffffu, x);
      m &= x ? v : ~v;
    }
  }
  return m;
}

// The stable rank of kItems rows a lane within their warp's run of rows.
// Warp w of nw warps holds rows first + r 32 + lane (r < rounds; none at
// or past limit) with keys key[r]; their digit is d = (key >> shift) mod
// 2^bits.  The counter of (digit d, warp w) is cnt[d (nw + 1) + w]: a row
// of nw counters a digit, padded by one so that the lanes of one warp
// touching distinct digits hit distinct banks.  count: the counter += the
// warp's rows of digit d.  place: each row goes to out[the counter + the
// rows of digit d before it in the run], and the counter moves past the
// warp's rows of digit d.  Only the lowest lane of each digit's lanes
// touches the counter, so no atomics are needed and the order is fixed.
template <int kItems, bool kPlace>
__device__ __forceinline__ void warp_rank(const int (&key)[kItems],
                                          const int (&row)[kItems], int first,
                                          int limit, int rounds, int shift,
                                          int bits, int* cnt, int nw,
                                          int* out_key, int* out_row) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int R = 1 << bits;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (r < rounds) {
      const int d = first + r * 32 + lane < limit
                        ? (key[r] >> shift) & (R - 1)
                        : R;
      const unsigned peers = digit_peers(d, R, bits);
      int* c = cnt + d * (nw + 1) + w;
      if (kPlace && d < R) {
        const int pos = *c + __popc(peers & lt);
        out_key[pos] = key[r];
        out_row[pos] = row[r];
      }
      __syncwarp();
      if ((peers & lt) == 0u && d < R) *c += __popc(peers);
      __syncwarp();
    }
  }
}

// One block sorts O <= kSmallMaxRows rows in shared memory (see the
// header).  Dynamic shared memory: keys (O), rows (O), counters
// (R (nw + 1)), 33 ints for the scans.
__global__ void __launch_bounds__(kSmallThreads) plan_small_kernel(
    const int* __restrict__ idx, int O, int P, int passes, int bits,
    int* __restrict__ perm, int* __restrict__ offsets) {
  extern __shared__ int smem[];
  const int R = 1 << bits;
  const int nw = blockDim.x >> 5;
  int* s_key = smem;
  int* s_row = s_key + O;
  int* s_cnt = s_row + O;
  int* s_warp = s_cnt + R * (nw + 1);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int rounds = (O + blockDim.x - 1) / blockDim.x;
  const int first = w * 32 * rounds;
  int key[kSmallItems], row[kSmallItems];
#pragma unroll
  for (int r = 0; r < kSmallItems; ++r) {
    const int o = first + r * 32 + lane;
    key[r] = (r < rounds && o < O) ? plan_key(idx, o, P) : 0;
    row[r] = o;
  }
  for (int p = 0; p < passes; ++p) {
    const int shift = p * bits;
#pragma unroll
    for (int r = 0; r < kSmallItems; ++r) {
      const int o = first + r * 32 + lane;
      if (p > 0 && r < rounds && o < O) {
        key[r] = s_key[o];
        row[r] = s_row[o];
      }
    }
    for (int e = t; e < R * (nw + 1); e += blockDim.x) s_cnt[e] = 0;
    __syncthreads();
    warp_rank<kSmallItems, false>(key, row, first, O, rounds, shift, bits,
                                  s_cnt, nw, s_key, s_row);
    __syncthreads();
    block_exclusive_scan(s_cnt, R * nw, nw, s_warp);
    // every row is in registers: the pass places them in place
    warp_rank<kSmallItems, true>(key, row, first, O, rounds, shift, bits,
                                 s_cnt, nw, s_key, s_row);
    __syncthreads();
  }
  for (int i = t; i < O; i += blockDim.x) perm[i] = s_row[i];
  for (int k = t; k <= P; k += blockDim.x) {
    int lo = 0, hi = O;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (s_key[mid] < k)
        lo = mid + 1;
      else
        hi = mid;
    }
    offsets[k] = lo;
  }
}

// The (key, row) pairs a pass reads: the first pass reads the key array
// (clamped; row = index), later ones the previous pass's output.
__device__ __forceinline__ void load_pair(const int* __restrict__ idx,
                                          const int* __restrict__ in_key,
                                          const int* __restrict__ in_row,
                                          int o, int P, int* key, int* row) {
  if (in_key == nullptr) {
    *key = plan_key(idx, o, P);
    *row = o;
  } else {
    *key = in_key[o];
    *row = in_row[o];
  }
}

// hist[d ntiles + tile]: the rows of digit d in each tile.  The shared
// counters are summed with atomics: a count does not depend on their order.
__global__ void __launch_bounds__(kTileThreads) plan_hist_kernel(
    const int* __restrict__ idx, const int* __restrict__ in_key, int O, int P,
    int shift, int R, int* __restrict__ hist) {
  __shared__ int h[kMaxRadix];
  const int t = threadIdx.x;
  for (int d = t; d < R; d += kTileThreads) h[d] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTileRows;
  for (int k = t; k < kTileRows; k += kTileThreads) {
    const int o = base + k;
    if (o < O) {
      const int key = in_key == nullptr ? plan_key(idx, o, P) : in_key[o];
      atomicAdd(&h[(key >> shift) & (R - 1)], 1);
    }
  }
  __syncthreads();
  for (int d = t; d < R; d += kTileThreads)
    hist[static_cast<size_t>(d) * gridDim.x + blockIdx.x] = h[d];
}

// Block d: the exclusive scan of digit d's tile counts, in place, and the
// digit's total.
__global__ void __launch_bounds__(kTileThreads) plan_scan_kernel(
    int* __restrict__ hist, int ntiles, int* __restrict__ totals) {
  __shared__ int s_a[kTileThreads * 4];
  __shared__ int s_warp[33];
  int* a = hist + static_cast<size_t>(blockIdx.x) * ntiles;
  int carry = 0;
  for (int base = 0; base < ntiles; base += kTileThreads * 4) {
    const int n = min(kTileThreads * 4, ntiles - base);
    for (int i = threadIdx.x; i < n; i += kTileThreads) s_a[i] = a[base + i];
    __syncthreads();
    const int total = block_exclusive_scan(s_a, n, n, s_warp);
    for (int i = threadIdx.x; i < n; i += kTileThreads)
      a[base + i] = carry + s_a[i];
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// One pass's stable scatter of a tile: the tile is ranked in shared memory
// (warp w owns rows w kTileRows / kTileWarps ...), then each digit's run
// is written to its slots, digit start + the earlier tiles' rows of that
// digit (hist, scanned) + the rank in the tile.
__global__ void __launch_bounds__(kTileThreads) plan_scatter_kernel(
    const int* __restrict__ idx, const int* __restrict__ in_key,
    const int* __restrict__ in_row, int O, int P, int shift, int bits,
    const int* __restrict__ hist, const int* __restrict__ totals,
    int* __restrict__ out_key, int* __restrict__ out_row) {
  const int R = 1 << bits;
  __shared__ int s_key[kTileRows];
  __shared__ int s_row[kTileRows];
  __shared__ int s_cnt[kMaxRadix * (kTileWarps + 1)];
  __shared__ int s_glob[kMaxRadix];
  __shared__ int s_warp[33];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int base = blockIdx.x * kTileRows;
  const int n = min(kTileRows, O - base);
  const int first = w * (kTileRows / kTileWarps);
  int key[kTileItems], row[kTileItems];
#pragma unroll
  for (int r = 0; r < kTileItems; ++r) {
    const int k = first + r * 32 + lane;
    key[r] = row[r] = 0;
    if (k < n) load_pair(idx, in_key, in_row, base + k, P, &key[r], &row[r]);
  }
  for (int e = t; e < R * (kTileWarps + 1); e += kTileThreads) s_cnt[e] = 0;
  for (int e = t; e < R; e += kTileThreads) s_glob[e] = totals[e];
  __syncthreads();
  warp_rank<kTileItems, false>(key, row, first, n, kTileItems, shift, bits,
                               s_cnt, kTileWarps, s_key, s_row);
  __syncthreads();
  block_exclusive_scan(s_glob, R, R, s_warp);
  block_exclusive_scan(s_cnt, R * kTileWarps, kTileWarps, s_warp);
  // s_glob[d]: the slot of the tile's row ranked 0 if it had digit d
  for (int e = t; e < R; e += kTileThreads)
    s_glob[e] += hist[static_cast<size_t>(e) * gridDim.x + blockIdx.x] -
                 s_cnt[e * (kTileWarps + 1)];
  __syncthreads();
  warp_rank<kTileItems, true>(key, row, first, n, kTileItems, shift, bits,
                              s_cnt, kTileWarps, s_key, s_row);
  __syncthreads();
  for (int k = t; k < n; k += kTileThreads) {
    const int kk = s_key[k];
    const int g = s_glob[(kk >> shift) & (R - 1)] + k;
    out_key[g] = kk;
    out_row[g] = s_row[k];
  }
}

// offsets[p] = the first i with skey[i] >= p, p in [0, P].
__global__ void __launch_bounds__(kTileThreads) plan_offsets_kernel(
    const int* __restrict__ skey, int O, int P, int* __restrict__ offsets) {
  const int k = blockIdx.x * kTileThreads + threadIdx.x;
  if (k > P) return;
  int lo = 0, hi = O;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (skey[mid] < k)
      lo = mid + 1;
    else
      hi = mid;
  }
  offsets[k] = lo;
}

int ntiles_of(int O) { return (O + kTileRows - 1) / kTileRows; }

int launch_small(const int* idx, int O, int P, int* perm, int* offsets,
                 cudaStream_t s) {
  const Digits g = digits_of(P);
  const int threads =
      O >= kSmallThreads ? kSmallThreads : 32 * ((O + 31) / 32 + (O == 0));
  const size_t smem =
      sizeof(int) * (2 * static_cast<size_t>(O) +
                     (static_cast<size_t>(1) << g.bits) * (threads / 32 + 1) +
                     33);
  // before every launch: the opt-in holds for the current device only
  const cudaError_t err = cudaFuncSetAttribute(
      plan_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_small_kernel<<<1, threads, smem, s>>>(idx, O, P, g.passes, g.bits,
                                             perm, offsets);
  return static_cast<int>(cudaGetLastError());
}

int launch_tiles(const int* idx, int O, int P, int* perm, int* offsets,
                 int* scratch, cudaStream_t s) {
  const Digits g = digits_of(P);
  const int R = 1 << g.bits;
  const int ntiles = ntiles_of(O);
  int* kbuf[2] = {scratch, scratch + 2 * static_cast<size_t>(O)};
  int* rbuf[2] = {scratch + O, scratch + 3 * static_cast<size_t>(O)};
  int* hist = scratch + 4 * static_cast<size_t>(O);
  int* totals = hist + static_cast<size_t>(kMaxRadix) * ntiles;
  const int* in_key = nullptr;
  const int* in_row = nullptr;
  const int* sorted = kbuf[0];
  for (int p = 0; p < g.passes && ntiles > 0; ++p) {
    const int shift = p * g.bits;
    int* out_key = kbuf[p & 1];
    int* out_row = p == g.passes - 1 ? perm : rbuf[p & 1];
    plan_hist_kernel<<<ntiles, kTileThreads, 0, s>>>(idx, in_key, O, P,
                                                     shift, R, hist);
    plan_scan_kernel<<<R, kTileThreads, 0, s>>>(hist, ntiles, totals);
    plan_scatter_kernel<<<ntiles, kTileThreads, 0, s>>>(
        idx, in_key, in_row, O, P, shift, g.bits, hist, totals, out_key,
        out_row);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    in_key = sorted = out_key;
    in_row = out_row;
  }
  plan_offsets_kernel<<<P / kTileThreads + 1, kTileThreads, 0, s>>>(
      sorted, O, P, offsets);
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

// The plan's path: 0 picks by (O, P), 1 is the one-block path, 2 the
// tiles, 3 one block a segment.  Returns the path a call with these
// arguments takes, or -1 if that path cannot take (O, P).
extern "C" int seg_plan_path(int O, int P, int path) {
  if (path == 0)
    return segment_blocks_path(O, P) ? 3 : small_path(O, P) ? 1 : 2;
  if (path == 1) return small_path(O, P) ? 1 : -1;
  if (path == 3) return segment_blocks_path(O, P) ? 3 : -1;
  return path == 2 ? 2 : -1;
}

// int32 scratch elements seg_plan needs on that path (0 for one block).
extern "C" long long seg_plan_scratch(int O, int P, int path) {
  if (seg_plan_path(O, P, path) != 2) return 0;
  return 4LL * O + static_cast<long long>(kMaxRadix) * (ntiles_of(O) + 1);
}

// perm (O,) and offsets (P + 1,) of the int32 keys idx (O,), O >= 0,
// P >= 0, on ``path`` (seg_plan_path) with seg_plan_scratch(O, P, path)
// ints of scratch.
extern "C" int seg_plan(const void* idx, int O, int P, void* perm,
                        void* offsets, void* scratch, int path,
                        void* stream) {
  const int which = seg_plan_path(O, P, path);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* key = static_cast<const int*>(idx);
  if (which == 1)
    return launch_small(key, O, P, static_cast<int*>(perm),
                        static_cast<int*>(offsets), s);
  if (which == 2)
    return launch_tiles(key, O, P, static_cast<int*>(perm),
                        static_cast<int*>(offsets), static_cast<int*>(scratch),
                        s);
  if (which == 3) {
    plan_segments_kernel<<<P + 1, kThreads, 0, s>>>(
        key, O, P, static_cast<int*>(perm), static_cast<int*>(offsets));
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
