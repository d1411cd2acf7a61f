// Union-space group tables for SSumM's candidate groups, by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference builds these tables with XLA ops, the
// sort and the .at[] scatter chain of repro/core/tables.py::assemble_group_tables,
// which the port first wrote as about thirty PyTorch passes over a [G, C·D]
// array (a segmented sort of int64 ids along the last axis, gathers,
// scatter_reduce_ amin and scatter_add_ onto a sentinel column, cumsum, where).
// For each candidate group of C members it computes, from the members' top-D
// neighbor rows:
//   * uid [U]: the U smallest distinct neighbor ids of the members' union,
//     ascending (V where fewer than U exist); n_u [U] = sizes[uid] (0 at V);
//   * m [C, U]: m[i, col] = member i's subedge count to uid[col];
//   * cidx [C]: a live member's own column in uid, U where it has none;
//   * w [C, C]: max(m[i, cidx[j]], m[j, cidx[i]]), 0 where a column is absent.
// The outputs equal the plain version (kernels/ref.py::group_tables_ref) bit
// for bit: a member row holds an id at most once, so each (member, column)
// cell gets one count, and the counts are integers below 2^24, so a float sum
// in any order is exact.
//
// What bounds it on this card: bytes. The function needs a group's C member
// rows of ids (int64) and counts (float32), C·D·12 B = 24 KB at C 32, D 64,
// their rows, ids and liveness, and U sizes; it writes m, w, n_u and cidx,
// 21 KB: about 46 KB a group, 3.1 GB a round at G = 65,536 (0.92 ms at
// 3.35 TB/s). The PyTorch chain moved about fifteen times those bytes through
// int64 temporaries of G·C·D entries and a segmented sort of 2,048 keys a row.
//
// What the design does about it:
//   * one thread block of 256 threads per group; every intermediate lives in
//     shared memory (the m tile, 4·C·U B; the keys; uid), so device memory
//     sees each input byte once and each output byte once;
//   * the member rows are read striped (thread t takes entries t, t + 256,
//     ...), so a warp reads 32 neighbouring entries of one row; a dead member's
//     row is not read, and a count only where its slot holds an id;
//   * the ids are 32-bit keys (the launcher refuses V >= 2^31). Only the live
//     entries are sorted: a block scan packs them, and a bitonic network sorts
//     the next power of two above their count, with all-ones keys as padding.
//     Most groups hold a few hundred live entries of the 2,048 slots;
//   * a group with no live entry (dead supernodes, ids without an edge) skips
//     the sort and writes its zeros and sentinels;
//   * distinct ids: the first of each run of equal keys, ranked by a block
//     scan; the first U go to uid. Each live entry then finds its column by a
//     binary search of uid and adds its count into the m tile (a shared float
//     atomic: one add a cell, exact in any order); the tile leaves with 16-byte
//     stores, with no sentinel column to cut off;
//   * cidx is a binary search of uid for the member's id; w is read from the
//     tile.
// What the card shows: the kernel is bound by latency, not bytes (a third of
// the bytes bound at round 1); the sort takes about half of its time.
// C, D, U and V are runtime arguments; the shared memory is sized from them
// (above 48 KB the launcher opts in with cudaFuncSetAttribute), and C·D may
// not pass kThreads·kPerThread entries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;  // entries a thread holds: C·D <= 2,048
constexpr uint32_t kPad = 0xffffffffu;  // sorts after every id

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Offsets, in 4-byte words, of the regions of a block's shared memory; each
// starts on a 16-byte boundary.
struct Layout {
  int m, keys, uid, cidx, alive, rows, ids, scan, total;
  __host__ __device__ Layout(int C, int D, int U) {
    m = 0;                                   // float [C, U]
    keys = m + round4(C * U);                // uint32 [pow2 >= C·D]
    uid = keys + round4(pow2_at_least(C * D));  // int32 [U]
    cidx = uid + round4(U);                  // int32 [C]
    alive = cidx + round4(C);                // int32 [C]
    rows = alive + round4(C);                // int64 [C]
    ids = rows + round4(2 * C);              // int64 [C]
    scan = ids + round4(2 * C);              // int32 [kWarps + 1]
    total = scan + round4(kWarps + 1);
  }
};

// Exclusive prefix sum of x over the block; *total gets the sum of all.
// Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_sum(int x, int* scan_s, int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) scan_s[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int s = lane < kWarps ? scan_s[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    if (lane < kWarps) scan_s[lane] = s;  // inclusive over the warps
  }
  __syncthreads();
  const int before = wid > 0 ? scan_s[wid - 1] : 0;
  *total = scan_s[kWarps - 1];
  __syncthreads();  // scan_s may be reused at the next call
  return before + incl - x;
}

// First position p in [0, n) with a[p] >= key (n if none).
__device__ __forceinline__ int lower_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Eight blocks an SM (32 registers a thread): a block waits on its loads and
// on the barriers of its sort most of the time, so the more blocks in flight,
// the better (measured: 2.74 -> 2.44 ms on skitter's round-1 tables, from
// five blocks at 48 registers).
__global__ void __launch_bounds__(kThreads, 8)
group_tables_kernel(const int64_t* __restrict__ nbr_id, const float* __restrict__ nbr_cnt,
                    const int64_t* __restrict__ rows, const int64_t* __restrict__ midx,
                    const uint8_t* __restrict__ alive, const int64_t* __restrict__ sizes,
                    float* __restrict__ m, float* __restrict__ n_u,
                    int32_t* __restrict__ cidx, float* __restrict__ w,
                    int C, int D, int U, int V) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(C, D, U);
  float* m_s = smem + L.m;                                           // [C, U]
  uint32_t* keys_s = reinterpret_cast<uint32_t*>(smem + L.keys);
  int* uid_s = reinterpret_cast<int*>(smem + L.uid);                 // [U]
  int* cidx_s = reinterpret_cast<int*>(smem + L.cidx);               // [C]
  int* alive_s = reinterpret_cast<int*>(smem + L.alive);             // [C]
  int64_t* rows_s = reinterpret_cast<int64_t*>(smem + L.rows);       // [C]
  int64_t* ids_s = reinterpret_cast<int64_t*>(smem + L.ids);         // [C]
  int* scan_s = reinterpret_cast<int*>(smem + L.scan);
  const int64_t g = blockIdx.x;
  const int tid = threadIdx.x;
  const int CD = C * D;
  const int CU = C * U;
  const bool vec = (CU & 3) == 0;  // the m tile as 16-byte words

  // ---- the members, and a zero m tile -------------------------------------
  for (int i = tid; i < C; i += kThreads) {
    alive_s[i] = alive[g * C + i] != 0;
    rows_s[i] = rows[g * C + i];
    ids_s[i] = midx[g * C + i];
  }
  if (vec) {
    for (int k = tid; k < CU / 4; k += kThreads)
      reinterpret_cast<float4*>(m_s)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int k = tid; k < CU; k += kThreads) m_s[k] = 0.f;
  }
  __syncthreads();

  // ---- load: entry e = t + r·kThreads is slot e % D of member e / D -------
  int id[kPerThread];
  float cnt[kPerThread];
  int mine = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int e = tid + r * kThreads;
    id[r] = V;
    cnt[r] = 0.f;
    if (e < CD) {
      const int i = e / D;
      if (alive_s[i]) {
        const int64_t at = rows_s[i] * D + (e - i * D);
        const int64_t x = nbr_id[at];
        if (x < V) {
          id[r] = int(x);
          cnt[r] = nbr_cnt[at];
          ++mine;
        }
      }
    }
  }
  int n;
  int pos = block_exclusive_sum(mine, scan_s, &n);
  const int64_t out_u = g * U;

  if (n == 0) {  // no live entry: zeros and sentinels
    for (int k = tid; k < U; k += kThreads) n_u[out_u + k] = 0.f;
    for (int k = tid; k < C; k += kThreads) cidx[g * C + k] = U;
    float* m_g = m + g * CU;
    if (vec) {
      for (int k = tid; k < CU / 4; k += kThreads)
        reinterpret_cast<float4*>(m_g)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int k = tid; k < CU; k += kThreads) m_g[k] = 0.f;
    }
    for (int k = tid; k < C * C; k += kThreads) w[g * C * C + k] = 0.f;
    return;
  }

  // ---- pack the live ids, pad to a power of two, bitonic sort -------------
#pragma unroll
  for (int r = 0; r < kPerThread; ++r)
    if (id[r] < V) keys_s[pos++] = uint32_t(id[r]);
  const int np2 = pow2_at_least(n);
  for (int k = n + tid; k < np2; k += kThreads) keys_s[k] = kPad;
  __syncthreads();
  for (int k = 2; k <= np2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < np2 / 2; p += kThreads) {
        const int a = 2 * j * (p / j) + (p & (j - 1));  // partner a + j
        const uint32_t x = keys_s[a], y = keys_s[a + j];
        if ((x > y) == ((a & k) == 0)) {
          keys_s[a] = y;
          keys_s[a + j] = x;
        }
      }
      __syncthreads();
    }
  }

  // ---- distinct ids: heads of runs, ranked; the first U are uid -----------
  const int per = (n + kThreads - 1) / kThreads;
  const int p0 = tid * per;
  const int p1 = min(p0 + per, n);
  int heads = 0;
  for (int p = p0; p < p1; ++p) heads += (p == 0 || keys_s[p] != keys_s[p - 1]);
  int nd;
  int rank = block_exclusive_sum(heads, scan_s, &nd);
  for (int p = p0; p < p1 && rank < U; ++p) {
    if (p == 0 || keys_s[p] != keys_s[p - 1]) uid_s[rank++] = int(keys_s[p]);
  }
  const int nu = min(nd, U);
  for (int k = nu + tid; k < U; k += kThreads) uid_s[k] = V;
  __syncthreads();

  // ---- m: each live entry's count into its column -------------------------
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    if (id[r] < V) {
      const int col = lower_bound(uid_s, nu, id[r]);
      if (col < nu) {  // then uid_s[col] == id: every live id is in the union
        const int i = (tid + r * kThreads) / D;
        atomicAdd(&m_s[i * U + col], cnt[r]);
      }
    }
  }
  // ---- n_u and cidx ---------------------------------------------------------
  for (int k = tid; k < U; k += kThreads)
    n_u[out_u + k] = k < nu ? __ll2float_rn(sizes[uid_s[k]]) : 0.f;
  for (int i = tid; i < C; i += kThreads) {
    int c = U;
    if (alive_s[i]) {
      const int me = int(ids_s[i]);
      const int col = lower_bound(uid_s, nu, me);
      if (col < nu && uid_s[col] == me) c = col;
    }
    cidx_s[i] = c;
    cidx[g * C + i] = c;
  }
  __syncthreads();

  // ---- the m tile out, and w from it ----------------------------------------
  float* m_g = m + g * CU;
  if (vec) {
    for (int k = tid; k < CU / 4; k += kThreads)
      reinterpret_cast<float4*>(m_g)[k] = reinterpret_cast<const float4*>(m_s)[k];
  } else {
    for (int k = tid; k < CU; k += kThreads) m_g[k] = m_s[k];
  }
  for (int k = tid; k < C * C; k += kThreads) {
    const int i = k / C;
    const int j = k - i * C;
    const int ci = cidx_s[i], cj = cidx_s[j];
    const float a = cj < U ? m_s[i * U + cj] : 0.f;
    const float b = ci < U ? m_s[j * U + ci] : 0.f;
    w[g * C * C + k] = fmaxf(a, b);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for a (C, D, U) group, in bytes (mirrored by
// smem_bytes in group_tables.py, which checks it before the launch).
size_t group_tables_smem_bytes(int C, int D, int U) {
  return size_t(Layout(C, D, U).total) * 4;
}

// Entries one block holds at most: C·D may not pass it.
int group_tables_max_entries() { return kThreads * kPerThread; }

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError().
int group_tables_launch(const int64_t* nbr_id, const float* nbr_cnt, const int64_t* rows,
                        const int64_t* midx, const uint8_t* alive, const int64_t* sizes,
                        float* m, float* n_u, int32_t* cidx, float* w,
                        int G, int C, int D, int U, int V, void* stream) {
  const size_t smem = group_tables_smem_bytes(C, D, U);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        group_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  group_tables_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      nbr_id, nbr_cnt, rows, midx, alive, sizes, m, n_u, cidx, w, C, D, U, V);
  return int(cudaGetLastError());
}

}  // extern "C"
