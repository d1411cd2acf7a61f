// Merge-gain matrices for SSumM's candidate groups, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/merge_gain.py::merge_gain_pallas
// (body _merge_gain_kernel, helper _f_cost). For each candidate group and each
// member pair (i, j) it computes rel (Relative_Reduction, Eq. 20) and red
// (Reduction, Eq. 17) of merging i and j. Every term is
//     f(cnt, pi) = min(C̄ + entropy bits, 2·cnt·log2 V),  0 where cnt == 0,
// over the merged row m[i] + m[j] against (n_i + n_j)·n_u; the merged self
// cost and the exact tails come from t. Invalid entries (a member is padding,
// the diagonal, denom <= 1e-6) are -inf in rel and 0 in red.
//
// What bounds it on this card: the function needs one entropy term (an IEEE
// division and two log2) for each nonzero entry of a merged row m[i] + m[j],
// i < j, and of a member row m[i]; its bytes are G·(C·U + 3·C² + 4·C + U)·4.
// The rows are sparse: on the round-1 tables of the skitter stand-in a merged
// row has about six nonzeros out of U = 128, and the bytes bound the function
// (chip_smoke.py computes both bounds from the round's tables). Evaluating all
// U columns would issue about twenty times the terms the function needs, each
// about a hundred instructions (two inline log2f polynomials and an IEEE
// division), and the kernel would be bound by instruction issue on work that
// adds zeros. Evaluating only the nonzero terms, it is still bound by issue.
//
// What the design does about it:
//   * one thread block per group stages the group's m tile (C·U·4 B = 16 KB
//     at the defaults), n_u, w and the per-member scalars in shared memory
//     once, with asynchronous copies (cp.async, 16 bytes each for the tile)
//     that are all in flight at once;
//   * one warp per member builds its occupancy bitmap, ⌈U/32⌉ words with bit
//     u set where m[i, u] != 0, one __ballot_sync per word;
//   * the sums run over set bits only: for a member row its own bits, for an
//     unordered pair i < j the union bm[i] | bm[j]. The own columns carry
//     the plain version's weight 1 - [u == ci] - [u == cj]: their bits are
//     dropped where the weight is 0, and kept, with weight -1, where
//     ci == cj < U;
//   * the reference sums a row 32 columns at a time, in order, then adds
//     the 32-column partials in order (XLA:CPU; the plain version takes this
//     order on every device, f32math.sum_last), and the columns
//     whose bit is clear add exact zeros. So the work unit is one (row or
//     pair, 32-column word): a thread sums its set bits in ascending order
//     (walking them with __ffs), and a last pass adds each row's or pair's
//     word partials in word order. That is the reference's association,
//     term for term, and no unit walks more than 32 bits;
//   * a warp runs as long as its longest unit, and a block as long as its
//     slowest warp; R-MAT hubs make a few rows long. So the block sorts its
//     nonempty units by their bit count, most bits first (a counting sort in
//     shared memory: popcounts, a histogram of warp-aggregated shared
//     atomics, one warp's scan), and its threads take them in that order;
//   * the cross sum is the same for (i, j) and (j, i), so the thread of an
//     unordered pair finishes both ordered entries, each with its own w and in
//     the plain version's order of additions; no lane waits in the epilogue;
//   * rel and red are assembled in shared memory (over the dead m tile, rows
//     padded to C + 1 so that the transposed entries hit distinct banks) and
//     written out with 16-byte stores;
//   * log2f and IEEE division (no --use_fast_math), so that it stays within
//     the reference's tolerances; f_cost branches around a log2f whose term
//     the plain version discards (σ = 1 is common on these tables).
// C and U are runtime arguments; above 48 KB of shared memory the launcher
// opts in with cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 64;  // sort keys are bit counts of one word, 1..32
static_assert(kBins == 64, "the scan of the sort's histogram takes two bins a lane");

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Words a unit index x = item·Wp + word reserves per item: ⌈U/32⌉ rounded up
// to a power of two, so that x splits with a shift and a mask.
__host__ __device__ inline int words_pow2(int U) {
  int wp = 1;
  while (wp < (U + 31) / 32) wp *= 2;
  return wp;
}

// Offsets, in 4-byte words, of the regions of a block's shared memory; each
// region starts on a 16-byte boundary. rel and red take the m tile's place
// once the sums are done; a unit's partial sum takes its sort key's place.
// (part and pij hold a word per unit and per pair, and a block's shared
// memory at most 58,112 words, so unit indices fit the 16 bits of order and
// member ids the 8 bits each of pij.)
struct Layout {
  int m, nu, w, n, s, t, tail, cidx, bm, pij, part, order, hist, total;
  __host__ __device__ Layout(int C, int U) {
    const int W = (U + 31) / 32;
    const int P = C * (C - 1) / 2;
    const int units = (C + P) * words_pow2(U);
    const int out = 2 * round4(C * (C + 1));
    m = 0;
    nu = m + (round4(C * U) > out ? round4(C * U) : out);
    w = nu + round4(U);
    n = w + round4(C * (C + 1));
    s = n + round4(C);
    t = s + round4(C);
    tail = t + round4(C);
    cidx = tail + round4(C);
    bm = cidx + round4(C);
    pij = bm + round4(C * W);
    part = pij + round4(P);
    order = part + round4(units);
    hist = order + round4((units + 1) / 2);
    total = hist + kBins;
  }
};

// min(C̄ + entropy bits, explicit bits), 0 where cnt == 0 (Eq. 11/12);
// the same operations, in the same order, as _f_cost and pair_cost_ref.
__device__ __forceinline__ float f_cost(float cnt, float pi, float cbar,
                                        float log2v) {
  if (!(cnt > 0.0f)) return 0.0f;
  float safe_pi = fmaxf(pi, 1.0f);
  float sigma = fminf(fmaxf(cnt / safe_pi, 0.0f), 1.0f);
  float xlogx = sigma > 0.0f ? sigma * log2f(fmaxf(sigma, 1e-38f)) : 0.0f;
  float one_m = 1.0f - sigma;
  float ylogy = sigma < 1.0f ? one_m * log2f(fmaxf(one_m, 1e-38f)) : 0.0f;
  float ent = (pi > 0.0f && cnt < pi) ? -pi * (xlogx + ylogy) : 0.0f;
  return fminf(cbar + ent, 2.0f * cnt * log2v);
}

// Asynchronous copies from global to shared memory (cp.async, sm_80 and
// later): a thread issues all of its copies at once and waits once, instead
// of waiting for each load before it stores it.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies `count` floats to shared memory, 16 bytes a copy where the source
// allows it (dst is 16-byte aligned).
__device__ __forceinline__ void stage(float* dst, const float* src, int count) {
  if ((count & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int k = threadIdx.x; k < count / 4; k += blockDim.x)
      cp_async16(dst + 4 * k, src + 4 * k);
  } else {
    for (int k = threadIdx.x; k < count; k += blockDim.x) cp_async4(dst + k, src + k);
  }
}

// The unordered pair (i, j), i < j, with index p in row-major order of the
// upper triangle: row i holds p in [i(2C-i-1)/2, (i+1)(2C-i-2)/2).
__device__ __forceinline__ void pair_of(int p, int C, int& i, int& j) {
  const float b = 2.0f * C - 1.0f;
  const float d = b * b - 8.0f * p;  // >= 9
  int r = int((b - d * rsqrtf(d)) * 0.5f);
  while (r > 0 && r * (2 * C - r - 1) / 2 > p) --r;  // the estimate's rounding
  while ((r + 1) * (2 * C - r - 2) / 2 <= p) ++r;
  i = r;
  j = p - r * (2 * C - r - 1) / 2 + r + 1;
}

// Word wd of the columns that pair (i, j) sums: the union of the two rows'
// bitmaps, less each own column whose weight 1 - [u == ci] - [u == cj] is 0
// (where ci == cj < U the weight is -1 and the bit stays).
__device__ __forceinline__ uint32_t pair_word(const uint32_t* bm_s, int W, int i,
                                              int j, int ci, int cj, int wd) {
  uint32_t bits = bm_s[i * W + wd] | bm_s[j * W + wd];
  if (ci != cj) {
    if ((ci >> 5) == wd) bits &= ~(1u << (ci & 31));
    if ((cj >> 5) == wd) bits &= ~(1u << (cj & 31));
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
merge_gain_kernel(const float* __restrict__ m, const float* __restrict__ n,
                  const float* __restrict__ s, const float* __restrict__ t,
                  const float* __restrict__ n_u, const int32_t* __restrict__ cidx,
                  const float* __restrict__ w, const float* __restrict__ scal,
                  float* __restrict__ rel, float* __restrict__ red, int C, int U) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(C, U);
  const int W = (U + 31) >> 5;
  const int ld = C + 1;  // row stride of w, rel and red in shared memory
  const int P = C * (C - 1) / 2;
  float* m_s = smem + L.m;  // [C, U]
  float* nu_s = smem + L.nu;  // [U]
  float* w_s = smem + L.w;  // [C, ld]
  float* n_s = smem + L.n;  // [C]
  float* s_s = smem + L.s;
  float* t_s = smem + L.t;
  float* tail_s = smem + L.tail;
  int* cidx_s = reinterpret_cast<int*>(smem + L.cidx);
  uint32_t* bm_s = reinterpret_cast<uint32_t*>(smem + L.bm);  // [C, W]
  int* pij_s = reinterpret_cast<int*>(smem + L.pij);  // [P]: i << 8 | j
  // [items · Wp]: a unit's sort key (bits << 16 | rank; 0 if it has no bits),
  // then its partial sum (0.0f, all bits 0, where it has no bits)
  float* part_s = smem + L.part;
  int* slot_s = reinterpret_cast<int*>(part_s);
  uint16_t* order_s = reinterpret_cast<uint16_t*>(smem + L.order);  // units, most bits first
  int* hist_s = reinterpret_cast<int*>(smem + L.hist);  // [kBins]
  const int Wp = words_pow2(U);
  const int wshift = __ffs(Wp) - 1;
  const int64_t g = blockIdx.x;
  const int tid = threadIdx.x;
  const float cbar = scal[0];
  const float log2v = scal[1];

  // ---- stage the group's operands -----------------------------------------
  stage(m_s, m + g * C * U, C * U);
  stage(nu_s, n_u + g * U, U);
  const float* w_g = w + g * C * C;
  for (int k = tid; k < C * C; k += blockDim.x) {
    const int r = k / C;
    cp_async4(w_s + r * ld + (k - r * C), w_g + k);
  }
  for (int k = tid; k < C; k += blockDim.x) {
    cp_async4(n_s + k, n + g * C + k);
    cp_async4(s_s + k, s + g * C + k);
    cp_async4(t_s + k, t + g * C + k);
    cp_async4(cidx_s + k, cidx + g * C + k);
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- occupancy bitmaps: a warp per member, a ballot per 32-column word;
  // the pairs' member ids ------------------------------------------------
  const int lane = tid & 31;
  const int items = C + P;  // [0, C): member rows; [C, C + P): pairs i < j
  for (int k = tid; k < kBins; k += blockDim.x) hist_s[k] = 0;
  for (int i = tid >> 5; i < C; i += blockDim.x >> 5) {
    for (int wd = 0; wd < W; ++wd) {
      const int u = wd * 32 + lane;
      const uint32_t bits = __ballot_sync(0xffffffffu, u < U && m_s[i * U + u] != 0.0f);
      if (lane == 0) bm_s[i * W + wd] = bits;
    }
  }
  for (int p = tid; p < P; p += blockDim.x) {
    int i, j;
    pair_of(p, C, i, j);
    pij_s[p] = i << 8 | j;
  }
  __syncthreads();

  // ---- counting sort of the (item, word) units by their set bits ---------
  // Unit x is word x & (Wp - 1) of item x >> wshift. Every lane runs every
  // round (the bound is rounded up to the block), so that a warp can
  // aggregate its atomics per key.
  const int units = items << wshift;
  for (int x0 = 0; x0 < units; x0 += blockDim.x) {
    const int x = x0 + tid;
    const int k = x >> wshift;
    const int wd = x & (Wp - 1);
    int key = 0;  // 0: nothing to sum (a dead item, an empty word, a word >= W)
    if (x < units && wd < W) {
      const bool row = k < C;
      const int ij = row ? (k << 8 | k) : pij_s[k - C];
      const int i = ij >> 8;
      const int j = ij & 255;
      if (n_s[i] > 0.0f && n_s[j] > 0.0f)
        key = __popc(pair_word(bm_s, W, i, j, row ? -1 : cidx_s[i], row ? -1 : cidx_s[j], wd));
    }
    const uint32_t peers = __match_any_sync(0xffffffffu, key);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (key != 0 && lane == leader) base = atomicAdd(&hist_s[key], __popc(peers));
    base = __shfl_sync(0xffffffffu, base, leader);
    const int rank = base + __popc(peers & ((1u << lane) - 1u));
    if (x < units) slot_s[x] = key != 0 ? (key << 16 | rank) : 0;
  }
  __syncthreads();
  if (tid < 32) {  // hist -> first position of each key, the largest key first
    const int a = hist_s[kBins - 1 - 2 * lane];
    const int b = hist_s[kBins - 2 - 2 * lane];
    int incl = a + b;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    hist_s[kBins - 1 - 2 * lane] = incl - a - b;
    hist_s[kBins - 2 - 2 * lane] = incl - b;
  }
  __syncthreads();
  const int n_units = hist_s[0];  // no unit has key 0: its bin starts at the end
  for (int x = tid; x < units; x += blockDim.x) {
    const int v = slot_s[x];
    if (v != 0) order_s[hist_s[v >> 16] + (v & 0xffff)] = uint16_t(x);
  }
  __syncthreads();

  // ---- each unit's sum over its set bits, ascending; most bits first ------
  for (int q = tid; q < n_units; q += blockDim.x) {
    const int x = order_s[q];
    const int k = x >> wshift;
    const int wd = x & (Wp - 1);
    const bool row = k < C;
    const int ij = row ? (k << 8 | k) : pij_s[k - C];
    const int i = ij >> 8;
    const int j = ij & 255;
    const int ci = row ? -1 : cidx_s[i];
    const int cj = row ? -1 : cidx_s[j];
    const float nsum = row ? n_s[i] : n_s[i] + n_s[j];
    const float* mi = m_s + i * U;
    const float* mj = m_s + j * U;
    uint32_t bits = pair_word(bm_s, W, i, j, ci, cj, wd);
    float part = 0.0f;
    while (bits) {
      const int u = wd * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      const float cnt = row ? mi[u] : mi[u] + mj[u];
      const float mask = 1.0f - (u == ci ? 1.0f : 0.0f) - (u == cj ? 1.0f : 0.0f);
      part += f_cost(cnt, nsum * nu_s[u], cbar, log2v) * mask;
    }
    part_s[x] = part;
  }
  __syncthreads();

  // ---- each member's row cost (its word partials in order) and exact tail --
  for (int k = tid; k < C; k += blockDim.x) {
    const float nk = n_s[k];
    float tail = 0.0f;
    if (nk > 0.0f) {
      float acc = 0.0f;
      for (int wd = 0; wd < W; ++wd) acc += part_s[(k << wshift) + wd];
      const float self_cost = f_cost(s_s[k], nk * (nk - 1.0f) * 0.5f, cbar, log2v);
      tail = fmaxf(t_s[k] - acc - self_cost, 0.0f);
    }
    tail_s[k] = tail;
  }
  __syncthreads();

  // ---- epilogue: both ordered entries of each pair, into shared memory -----
  float* rel_s = m_s;  // [C, ld], over the m tile, which is no longer read
  float* red_s = m_s + round4(C * ld);
  for (int k = tid; k < C + P; k += blockDim.x) {
    if (k < C) {
      rel_s[k * ld + k] = -CUDART_INF_F;
      red_s[k * ld + k] = 0.0f;
      continue;
    }
    const int i = pij_s[k - C] >> 8;
    const int j = pij_s[k - C] & 255;
    const float ni = n_s[i];
    const float nj = n_s[j];
    if (!(ni > 0.0f) || !(nj > 0.0f)) {
      rel_s[i * ld + j] = rel_s[j * ld + i] = -CUDART_INF_F;
      red_s[i * ld + j] = red_s[j * ld + i] = 0.0f;
      continue;
    }
    float cross = 0.0f;  // the pair's word partials, in order
    for (int wd = 0; wd < W; ++wd) cross += part_s[(k << wshift) + wd];
    const float npair = ni + nj;
    const float pi_self = npair * (npair - 1.0f) * 0.5f;
#pragma unroll
    for (int side = 0; side < 2; ++side) {  // (i, j), then (j, i)
      const int a = side == 0 ? i : j;
      const int b = side == 0 ? j : i;
      const float wab = w_s[a * ld + b];
      const float s_m = s_s[a] + s_s[b] + wab;
      const float merged = cross + f_cost(s_m, pi_self, cbar, log2v) + tail_s[a] + tail_s[b];
      const float denom = t_s[a] + t_s[b] - f_cost(wab, n_s[a] * n_s[b], cbar, log2v);
      const bool valid = denom > 1e-6f;
      rel_s[a * ld + b] = valid ? 1.0f - merged / fmaxf(denom, 1e-6f) : -CUDART_INF_F;
      red_s[a * ld + b] = valid ? denom - merged : 0.0f;
    }
  }
  __syncthreads();

  // ---- write rel and red out, 16 bytes a thread where C allows it ----------
  float* rel_g = rel + g * C * C;
  float* red_g = red + g * C * C;
  if ((C & 3) == 0) {
    for (int k = tid; k < C * C / 4; k += blockDim.x) {
      const int r = 4 * k / C;
      const int c = 4 * k - r * C;
      const float* a = rel_s + r * ld + c;
      const float* b = red_s + r * ld + c;
      reinterpret_cast<float4*>(rel_g)[k] = make_float4(a[0], a[1], a[2], a[3]);
      reinterpret_cast<float4*>(red_g)[k] = make_float4(b[0], b[1], b[2], b[3]);
    }
  } else {
    for (int k = tid; k < C * C; k += blockDim.x) {
      const int r = k / C;
      rel_g[k] = rel_s[r * ld + k - r * C];
      red_g[k] = red_s[r * ld + k - r * C];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for a (C, U) group, in bytes (mirrored by
// smem_bytes in merge_gain.py, which checks it before the launch).
size_t merge_gain_smem_bytes(int C, int U) { return size_t(Layout(C, U).total) * 4; }

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError().
int merge_gain_launch(const float* m, const float* n, const float* s,
                      const float* t, const float* n_u, const int32_t* cidx,
                      const float* w, const float* scal, float* rel, float* red,
                      int G, int C, int U, void* stream) {
  const size_t smem = merge_gain_smem_bytes(C, U);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        merge_gain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  merge_gain_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      m, n, s, t, n_u, cidx, w, scal, rel, red, C, U);
  return int(cudaGetLastError());
}

}  // extern "C"
