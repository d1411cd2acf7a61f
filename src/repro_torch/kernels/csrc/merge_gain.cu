// Merge-gain matrices for SSumM's candidate groups, by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/merge_gain.py::merge_gain_pallas
// (body _merge_gain_kernel, helper _f_cost). For each candidate group and each
// member pair (i, j) it computes rel (Relative_Reduction, Eq. 20) and red
// (Reduction, Eq. 17) of merging i and j. Every term is
//     f(cnt, pi) = min(C̄ + entropy bits, 2·cnt·log2 V)
// over the merged row m[i] + m[j] against (n_i + n_j)·n_u; the merged self
// cost and the exact tails come from t. Invalid entries (a member is padding,
// the diagonal, denom <= 1e-6) are -inf in rel and 0 in red.
//
// What bounds it on this card: the function needs one entropy term (two
// log2 and one IEEE division, on the special-function units, 16 per SM per
// clock) for each nonzero entry of a merged row m[i] + m[j], i < j, and of a
// member row m[i]; its bytes are G·(C·U + 3·C² + 4·C + U)·4. On the round-1
// tables of the skitter stand-in a merged row has about six nonzeros out of
// U = 128, and the bytes bound it (chip_smoke.py computes both bounds from
// the round's tables). This kernel takes every one of the U columns, zero or
// not: about twenty times the terms the function needs there.
//
// What the design does about it:
//   * one thread block per group; the group's m tile (C·U·4 B = 16 KB at the
//     defaults), n_u and the per-member scalars are staged in shared memory
//     once, so the C² pairs read m from shared memory, never from HBM again;
//   * row_cost, self_cost and tail are computed once per member into shared
//     memory, as in the Pallas body, not once per pair;
//   * each warp takes a set of pairs (i, j); its lanes stride over U (the
//     shared-memory reads of one warp are consecutive: no bank conflicts) and
//     reduce with __shfl_xor_sync;
//   * the cross sum is symmetric in (i, j), so it is taken once per unordered
//     pair, which halves the special-function work; each ordered entry still
//     gets its own epilogue;
//   * pairs with a padding member or on the diagonal skip the U loop: their
//     outputs are fixed (-inf, 0), and the trailing groups of dead ids cost
//     almost nothing;
//   * log2f and IEEE division (no --use_fast_math), so that it stays within
//     the reference's tolerances.
// C and U are runtime arguments; above 48 KB of shared memory the launcher
// opts in with cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// min(C̄ + entropy bits, explicit bits), 0 where cnt == 0 (Eq. 11/12);
// the same operations, in the same order, as _f_cost and pair_cost_ref.
__device__ __forceinline__ float f_cost(float cnt, float pi, float cbar,
                                        float log2v) {
  float safe_pi = fmaxf(pi, 1.0f);
  float sigma = fminf(fmaxf(cnt / safe_pi, 0.0f), 1.0f);
  float xlogx = sigma > 0.0f ? sigma * log2f(fmaxf(sigma, 1e-38f)) : 0.0f;
  float one_m = 1.0f - sigma;
  float ylogy = sigma < 1.0f ? one_m * log2f(fmaxf(one_m, 1e-38f)) : 0.0f;
  float ent = (pi > 0.0f && cnt > 0.0f && cnt < pi) ? -pi * (xlogx + ylogy)
                                                     : 0.0f;
  float c1 = cbar + ent;
  float c2 = 2.0f * cnt * log2v;
  return cnt > 0.0f ? fminf(c1, c2) : 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
merge_gain_kernel(const float* __restrict__ m, const float* __restrict__ n,
                  const float* __restrict__ s, const float* __restrict__ t,
                  const float* __restrict__ n_u, const int32_t* __restrict__ cidx,
                  const float* __restrict__ w, const float* __restrict__ scal,
                  float* __restrict__ rel, float* __restrict__ red, int C, int U) {
  extern __shared__ float smem[];
  float* m_s = smem;            // [C, U]
  float* nu_s = m_s + C * U;    // [U]
  float* n_s = nu_s + U;        // [C]
  float* s_s = n_s + C;         // [C]
  float* t_s = s_s + C;         // [C]
  float* tail_s = t_s + C;      // [C]
  int* cidx_s = reinterpret_cast<int*>(tail_s + C);  // [C]

  const int64_t g = blockIdx.x;
  const float cbar = scal[0];
  const float log2v = scal[1];
  const float* m_g = m + g * C * U;
  for (int k = threadIdx.x; k < C * U; k += blockDim.x) m_s[k] = m_g[k];
  for (int k = threadIdx.x; k < U; k += blockDim.x) nu_s[k] = n_u[g * U + k];
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    n_s[k] = n[g * C + k];
    s_s[k] = s[g * C + k];
    t_s[k] = t[g * C + k];
    cidx_s[k] = cidx[g * C + k];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // exact-tail bookkeeping, once per member
  for (int i = warp; i < C; i += nwarps) {
    const float ni = n_s[i];
    float acc = 0.0f;
    if (ni > 0.0f) {
      for (int u = lane; u < U; u += 32)
        acc += f_cost(m_s[i * U + u], ni * nu_s[u], cbar, log2v);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const float self_cost = f_cost(s_s[i], ni * (ni - 1.0f) * 0.5f, cbar, log2v);
      tail_s[i] = fmaxf(t_s[i] - acc - self_cost, 0.0f);
    }
  }
  __syncthreads();

  float* rel_g = rel + g * C * C;
  float* red_g = red + g * C * C;
  const float* w_g = w + g * C * C;
  // The cross sum over m[i] + m[j] is the same, bit for bit, for (i, j) and
  // (j, i) (same operands, same lane order, same shuffle tree), so a warp
  // takes each unordered pair i <= j once; lane 0 finishes (i, j) and lane 1
  // finishes (j, i), each with its own w entry and in the plain version's
  // order of additions (its tails are added row member first).
  for (int p = warp; p < C * C; p += nwarps) {
    const int i = p / C;
    const int j = p - i * C;
    if (j < i) continue;
    const int a = lane == 0 ? i : j;  // the row lane 0 or 1 writes
    const int b = lane == 0 ? j : i;
    const int q = a * C + b;
    const bool writer = lane < (i == j ? 1 : 2);
    const float ni = n_s[i];
    const float nj = n_s[j];
    if (i == j || !(ni > 0.0f) || !(nj > 0.0f)) {
      if (writer) {
        rel_g[q] = -CUDART_INF_F;
        red_g[q] = 0.0f;
      }
      continue;
    }
    const float npair = ni + nj;
    const int ci = cidx_s[i];
    const int cj = cidx_s[j];
    const float* mi = m_s + i * U;
    const float* mj = m_s + j * U;
    float acc = 0.0f;
    for (int u = lane; u < U; u += 32) {
      const float mask = 1.0f - (u == ci ? 1.0f : 0.0f) - (u == cj ? 1.0f : 0.0f);
      acc += f_cost(mi[u] + mj[u], npair * nu_s[u], cbar, log2v) * mask;
    }
    const float cross = warp_sum(acc);
    if (writer) {
      const float wab = w_g[q];
      const float s_m = s_s[a] + s_s[b] + wab;
      const float self_m = f_cost(s_m, npair * (npair - 1.0f) * 0.5f, cbar, log2v);
      const float merged = cross + self_m + tail_s[a] + tail_s[b];
      const float denom = t_s[a] + t_s[b] - f_cost(wab, n_s[a] * n_s[b], cbar, log2v);
      const bool valid = denom > 1e-6f;
      rel_g[q] = valid ? 1.0f - merged / fmaxf(denom, 1e-6f) : -CUDART_INF_F;
      red_g[q] = valid ? denom - merged : 0.0f;
    }
  }
}

// Shared memory one block needs for a (C, U) group, in bytes (mirrored by
// smem_bytes in merge_gain.py, which checks it before the launch).
size_t merge_gain_smem_bytes(int C, int U) {
  return (size_t(C) * U + U + 4 * size_t(C)) * sizeof(float) + size_t(C) * sizeof(int32_t);
}

}  // namespace

extern "C" {

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
