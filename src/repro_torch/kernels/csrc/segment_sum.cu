// Fixed-order float64 sums for the query engine (CUDA C++ for sm_90a).
//
// Two entry points, each adding in one fixed order, so a result has the
// same bits on every run, in any batch, and on the CPU (the plain versions
// in repro_torch/kernels/ref.py add in the same order):
//
//   segment_sum_launch: out[r] = ((0 + vals[indptr[r]]) + vals[indptr[r] + 1]) + ...
//     for every row r of a CSR offset array, one left fold per row.
//   ordered_sum_launch: for each row of a contiguous [k, n] array, left folds
//     of its 1024-value segments from zero, then a left fold of those
//     partial sums from zero.
//
// Not a TPU kernel: it replaces the query engine's row reductions, which
// the reference computes as `np.add.at` over the block CSR
// (repro/core/queries.py:142 for the expected degree, :197 for a PageRank
// power step) and as row sums over the padded [S, D] layout on the TPU
// (repro/core/queries_jax.py:181 `pagerank_row_sums`). `np.add.at` adds
// each row's entries in storage order, and so does segment_sum; float
// atomics (`index_add_` on the card) add in an order that changes from run
// to run. The engine's long sums (cut mass, volumes, the dangling mass,
// wedge sums) are ordered_sum.
//
// What bounds it on this card. Each fold is one chain of dependent adds, so
// a sum costs at least (longest fold) x (DADD latency, 8 cycles on an H100)
// and at least bytes / HBM rate. The design serves both terms:
//   * Loads run ahead of the chain. A long row, and every ordered_sum
//     segment, is loaded by a whole warp, 32 consecutive doubles per load
//     instruction (coalesced), one stage ahead in registers, and staged in
//     shared memory; one lane (the row's owner) then adds the stage in
//     order, eight values a step from two register sets taken in turn. The
//     chain then costs its DADD latency per value, not a memory round trip.
//   * The longest chains start first. A CSR row longer than a warp (the
//     caller passes their list; the block summary computes it once) gets a
//     warp of its own in the first blocks of the grid; short rows (0.45
//     entries on average in the block summary) stay one per thread in the
//     blocks after them, four rows a thread with their loads in flight
//     together.
//   * ordered_sum gives each warp G consecutive segments (G in 1, 2, 4, 8):
//     lane t < G owns segment t and folds it, and a stage reads 1024 / G
//     consecutive values of each (runs of at least 1 KB). G is the fewest
//     that lets one wave of warps hold every segment (1 at [1, S], 8 at
//     [9, S]), so no second wave runs with the card half empty; 4 when even
//     8 does not. The second fold runs in the same launch: each owner
//     writes its partial sum, fences (release), and counts it in its row's
//     counter; the lane that completes a row's count has its warp fence
//     (acquire) and fold that row's partials in order, and zeroes the
//     counter for the next call. The counters are the caller's, zero on
//     entry. What this leaves exposed, after the last partial of a row: the
//     count's round trip and a chain of ceil(n / 1024) adds.
// Built with -fmad=false; the adds are written __dadd_rn all the same.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;

// segment_sum: warps a block, and values of a long row staged at a time
constexpr int kCsrWarps = 8;
constexpr int kCsrStage = 256;
constexpr int kCsrPer = kCsrStage / kWarp;  // values a lane loads per stage
constexpr int kRowsPerThread = 4;  // short rows a thread of the later blocks takes at once

// ordered_sum: the segment length, and warps a block
constexpr int kSegment = 1024;
constexpr int kOrdWarps = 4;
constexpr int kOrdPer = kSegment / kWarp;  // values a lane loads per stage

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ void load8(double2 (&v)[4], const double2* s2, int step) {
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = s2[step * 4 + j];
}

__device__ __forceinline__ double add8(const double2 (&v)[4], double acc) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc = __dadd_rn(acc, v[j].x);
    acc = __dadd_rn(acc, v[j].y);
  }
  return acc;
}

// acc + s[0] + s[1] + ... + s[n-1], left to right. s is 16-byte aligned.
// Eight values a step, in two register sets taken in turn: the next step's
// shared loads are issued before this step's adds, so the chain waits on
// its adds alone.
__device__ __forceinline__ double fold_shared(const double* s, int n, double acc) {
  const double2* s2 = reinterpret_cast<const double2*>(s);
  const int steps = n / 8;
  if (steps > 0) {
    double2 a[4], b[4];
    load8(a, s2, 0);
    int t = 0;
    for (; t + 2 <= steps; t += 2) {
      load8(b, s2, t + 1);
      acc = add8(a, acc);
      if (t + 2 < steps) load8(a, s2, t + 2);
      acc = add8(b, acc);
    }
    if (t < steps) acc = add8(a, acc);
  }
  for (int i = steps * 8; i < n; ++i) acc = __dadd_rn(acc, s[i]);
  return acc;
}

// The sum of vals[lo, hi) from zero, in order, by lane `owner` (the other
// lanes return a value of no use). The whole warp calls it with the same
// lo, hi and owner.
__device__ double fold_long_row(const double* __restrict__ vals, int64_t lo, int64_t hi,
                                double* stage, int lane, int owner) {
  double buf[kCsrPer];
#pragma unroll
  for (int q = 0; q < kCsrPer; ++q) {
    const int64_t e = lo + q * kWarp + lane;
    buf[q] = e < hi ? vals[e] : 0.0;
  }
  double acc = 0.0;
  for (int64_t base = lo; base < hi; base += kCsrStage) {
#pragma unroll
    for (int q = 0; q < kCsrPer; ++q) stage[q * kWarp + lane] = buf[q];
    __syncwarp();
    const int64_t next = base + kCsrStage;
    if (next < hi) {
#pragma unroll
      for (int q = 0; q < kCsrPer; ++q) {
        const int64_t e = next + q * kWarp + lane;
        buf[q] = e < hi ? vals[e] : 0.0;
      }
    }
    if (lane == owner) acc = fold_shared(stage, static_cast<int>(min64(kCsrStage, hi - base)), acc);
    __syncwarp();
  }
  return acc;
}

// Blocks [0, long_blocks) fold the listed long rows, a warp each; the
// blocks after them fold every row of at most long_len values, a thread
// each.
__global__ void __launch_bounds__(kCsrWarps * kWarp)
segment_sum_kernel(const int64_t* __restrict__ indptr, const double* __restrict__ vals,
                   double* __restrict__ out, int64_t n_seg,
                   const int64_t* __restrict__ long_rows, int64_t n_long, int64_t long_len,
                   int long_blocks) {
  __shared__ __align__(16) double stage[kCsrWarps][kCsrStage];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    const int64_t warps = static_cast<int64_t>(long_blocks) * kCsrWarps;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kCsrWarps + warp; i < n_long;
         i += warps) {
      const int64_t r = long_rows[i];
      const double acc = fold_long_row(vals, indptr[r], indptr[r + 1], stage[warp], lane, 0);
      if (lane == 0) out[r] = acc;
    }
    return;
  }
  // kRowsPerThread rows a thread, a grid apart, so that their offset and
  // first-value loads are in flight together (most rows hold 0 or 1 value)
  const int64_t stride = static_cast<int64_t>(gridDim.x - long_blocks) * blockDim.x;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x - long_blocks) * blockDim.x + threadIdx.x;
       r0 < n_seg; r0 += kRowsPerThread * stride) {
    int64_t lo[kRowsPerThread], hi[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int64_t r = r0 + j * stride;
      lo[j] = r < n_seg ? indptr[r] : 0;
      hi[j] = r < n_seg ? indptr[r + 1] : 0;
      if (hi[j] - lo[j] > long_len) hi[j] = lo[j] - 1;  // a warp of the first blocks has it
    }
    double first[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) first[j] = hi[j] > lo[j] ? vals[lo[j]] : 0.0;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int64_t r = r0 + j * stride;
      if (r >= n_seg || hi[j] < lo[j]) continue;
      double acc = 0.0;
      if (hi[j] > lo[j]) acc = __dadd_rn(acc, first[j]);
      for (int64_t e = lo[j] + 1; e < hi[j]; ++e) acc = __dadd_rn(acc, vals[e]);
      out[r] = acc;
    }
  }
}

// The sum of p[0, m) from zero, in order, in lane 0. The warp loads 1024
// partials at a time through L2 (other blocks wrote them), the next 1024
// while lane 0 adds these.
__device__ double fold_partials(const double* p, int64_t m, double* stage, int lane) {
  double buf[kOrdPer];
#pragma unroll
  for (int q = 0; q < kOrdPer; ++q) {
    const int64_t i = q * kWarp + lane;
    buf[q] = i < m ? __ldcg(p + i) : 0.0;
  }
  double acc = 0.0;
  for (int64_t base = 0; base < m; base += kSegment) {
#pragma unroll
    for (int q = 0; q < kOrdPer; ++q) stage[q * kWarp + lane] = buf[q];
    __syncwarp();
    const int64_t next = base + kSegment;
    if (next < m) {
#pragma unroll
      for (int q = 0; q < kOrdPer; ++q) {
        const int64_t i = next + q * kWarp + lane;
        buf[q] = i < m ? __ldcg(p + i) : 0.0;
      }
    }
    if (lane == 0) acc = fold_shared(stage, static_cast<int>(min64(kSegment, m - base)), acc);
    __syncwarp();
  }
  return acc;
}

// Release (before a count) and acquire (after one) at device scope: orders
// a warp's partial-sum stores before its counter increment, and another
// warp's reads of the partials after it saw the count complete.
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// Warp w of the grid owns segments [w*G, w*G + G) of the k*m segments (row
// r = segment / m, its j-th 1024 values). Stage s of the warp holds values
// [s*W, s*W + W) of each of its G segments, W = 1024 / G: lane l loads
// buffer slots l + 32q, slot i being value i % W of segment i / W, so each
// load instruction reads 32 consecutive values of one segment. row_count:
// k ints, zero on entry; the warp that completes a row zeroes its count.
template <int G>
__global__ void __launch_bounds__(kOrdWarps * kWarp)
ordered_sum_kernel(const double* __restrict__ x, double* __restrict__ out,
                   double* __restrict__ part, int* __restrict__ row_count, int64_t k,
                   int64_t n, int64_t m) {
  constexpr int W = kSegment / G;
  constexpr int kPitch = W + 2;  // 16-byte rows; owners' reads fall on distinct banks
  __shared__ __align__(16) double stage[kOrdWarps][G * kPitch];
  __shared__ int64_t seg_start[kOrdWarps][G];
  __shared__ int seg_len[kOrdWarps][G];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t n_seg = k * m;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kOrdWarps + warp) * G;
  if (first >= n_seg) return;  // the whole warp: nothing below syncs the block
  double* st = stage[warp];

  const int64_t seg = first + lane;
  const bool owner = lane < G && seg < n_seg;
  int64_t row = 0;
  int len = 0;
  if (lane < G) {
    int64_t start = 0;
    if (owner) {
      row = seg / m;
      const int64_t j = seg - row * m;
      start = row * n + j * kSegment;
      len = static_cast<int>(min64(kSegment, n - j * kSegment));
    }
    seg_start[warp][lane] = start;
    seg_len[warp][lane] = len;
  }
  __syncwarp();

  double buf[kOrdPer];
  auto load = [&](int s) {
#pragma unroll
    for (int q = 0; q < kOrdPer; ++q) {
      const int t = q * kWarp / W;
      const int pos = s * W + (q * kWarp) % W + lane;
      buf[q] = pos < seg_len[warp][t] ? x[seg_start[warp][t] + pos] : 0.0;
    }
  };
  load(0);
  double acc = 0.0;
  for (int s = 0; s < G; ++s) {
#pragma unroll
    for (int q = 0; q < kOrdPer; ++q) {
      const int t = q * kWarp / W;
      st[t * kPitch + (q * kWarp) % W + lane] = buf[q];
    }
    __syncwarp();
    if (s + 1 < G) load(s + 1);
    if (owner)
      acc = fold_shared(st + lane * kPitch,
                        static_cast<int>(min64(W, len > s * W ? len - s * W : 0)), acc);
    __syncwarp();
  }

  if (m == 1) {  // a row of one segment: the second fold is 0 + its sum
    if (owner) out[row] = __dadd_rn(0.0, acc);
    return;
  }
  bool last = false;
  if (owner) {
    part[seg] = acc;
    fence_acq_rel_gpu();  // the partial is visible before it is counted
    last = atomicAdd(row_count + row, 1) == static_cast<int>(m - 1);
  }
  unsigned done = __ballot_sync(kFull, last);
  if (done) fence_acq_rel_gpu();  // every partial counted before ours is read after it
  while (done) {
    const int t = __ffs(done) - 1;
    done &= done - 1;
    const int64_t r = __shfl_sync(kFull, row, t);
    const double total = fold_partials(part + r * m, m, st, lane);
    if (lane == 0) {
      out[r] = total;
      row_count[r] = 0;
    }
  }
}

// Warps of ordered_sum_kernel<G> that one SM holds at once, read once per
// device.
template <int G>
int resident_warps() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ordered_sum_kernel<G>,
                                                      kOrdWarps * kWarp, 0) != cudaSuccess ||
        blocks < 1)
      blocks = 1;
    cached[dev] = blocks * kOrdWarps;
  }
  return cached[dev];
}

template <int G>
int launch_ordered(const double* x, double* out, double* part, int* row_count, int64_t k,
                   int64_t n, int64_t m, cudaStream_t stream) {
  const int64_t warps = (k * m + G - 1) / G;
  const int64_t blocks = (warps + kOrdWarps - 1) / kOrdWarps;
  ordered_sum_kernel<G><<<static_cast<unsigned>(blocks), kOrdWarps * kWarp, 0, stream>>>(
      x, out, part, row_count, k, n, m);
  return static_cast<int>(cudaGetLastError());
}

// The current device's SM count, read once per device.
int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0;
    cached[dev] = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
                          cudaSuccess && sms > 0
                      ? sms
                      : 132;
  }
  return cached[dev];
}

}  // namespace

// long_rows: the rows with more than long_len values, n_long of them, each
// once (any order). A row longer than long_len that is not listed is not
// written.
extern "C" int segment_sum_launch(const void* indptr, const void* vals, void* out,
                                  long long n_seg, const void* long_rows, long long n_long,
                                  long long long_len, void* stream) {
  if (n_seg <= 0) return 0;
  const int threads = kCsrWarps * kWarp;
  const long long cap = static_cast<long long>(sm_count()) * 16;
  const long long long_blocks =
      n_long > 0 ? std::min<long long>((n_long + kCsrWarps - 1) / kCsrWarps, cap) : 0;
  long long blocks = (n_seg + threads * kRowsPerThread - 1) / (threads * kRowsPerThread);
  if (blocks > cap * 4) blocks = cap * 4;  // grid-stride beyond that
  segment_sum_kernel<<<static_cast<unsigned>(long_blocks + blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(indptr), static_cast<const double*>(vals),
      static_cast<double*>(out), static_cast<int64_t>(n_seg),
      static_cast<const int64_t*>(long_rows), static_cast<int64_t>(n_long),
      static_cast<int64_t>(long_len), static_cast<int>(long_blocks));
  return static_cast<int>(cudaGetLastError());
}

// x: contiguous float64 [k, n], k >= 1, n >= 1; out: [k]; part: scratch of
// k * ceil(n / segment) doubles (unused when n <= segment); row_count: k
// ints, zero on entry and on return. segment must be 1024 (returns
// cudaErrorInvalidValue otherwise).
extern "C" int ordered_sum_launch(const void* x, void* out, void* part, void* row_count,
                                  long long k, long long n, long long segment, void* stream) {
  if (segment != kSegment) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 0 || n <= 0) return 0;
  const int64_t m = (n + kSegment - 1) / kSegment;
  // G segments a warp: the fewest that let one wave of warps hold them all
  // (each warp then streams its G segments while the others stream theirs,
  // and no second wave waits), or 4 when even 8 do not
  const int64_t sms = sm_count();
  const int64_t wave[4] = {sms * resident_warps<1>(), sms * resident_warps<2>(),
                           sms * resident_warps<4>(), sms * resident_warps<8>()};
  int lg = 0;  // G = 1 << lg
  while (lg < 3 && k * m > (int64_t{1} << lg) * wave[lg]) ++lg;
  if (k * m > 8 * wave[3]) lg = 2;
  const auto* xp = static_cast<const double*>(x);
  auto* op = static_cast<double*>(out);
  auto* pp = static_cast<double*>(part);
  auto* cp = static_cast<int*>(row_count);
  auto st = static_cast<cudaStream_t>(stream);
  switch (1 << lg) {
    case 8: return launch_ordered<8>(xp, op, pp, cp, k, n, m, st);
    case 4: return launch_ordered<4>(xp, op, pp, cp, k, n, m, st);
    case 2: return launch_ordered<2>(xp, op, pp, cp, k, n, m, st);
    default: return launch_ordered<1>(xp, op, pp, cp, k, n, m, st);
  }
}
