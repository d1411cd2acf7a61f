// Segment sums in storage order (CUDA C++ for sm_90a).
//
// out[r] = ((0 + vals[indptr[r]]) + vals[indptr[r] + 1]) + ... for every
// segment r of a CSR-style offset array, one left fold per segment.
//
// Not a TPU kernel: it replaces the query engine's row reductions, which
// the reference computes as `np.add.at` over the block CSR
// (repro/core/queries.py:142 for the expected degree, :197 for a PageRank
// power step) and as row sums over the padded [S, D] layout on the TPU
// (repro/core/queries_jax.py:181 `pagerank_row_sums`). `np.add.at` adds
// each row's entries in storage order; float atomics (`index_add_` on the
// card) add them in an order that changes from run to run. One thread per
// segment walks its entries in order, so the result is numpy's to the last
// bit, the same on every run, and the same as the plain version
// (`index_add_` on a CPU tensor, which adds in order too). The query
// engine's long sums (cut, volumes, dangling mass, wedge sums) use the
// same kernel twice: fixed segments of 1024 values, then one segment over
// their partial sums, an order that does not depend on the device.
//
// What bounds it on the card: bytes. Each value is read once, each offset
// once, each sum written once; a row of the block summary has 0.45
// entries on average (a few hub rows have thousands), so most threads read
// two offsets and write a zero. A thread's loads follow one another in
// memory; the adds form one dependent chain per segment, which only a hub
// row makes long. Nothing is staged in shared memory: there is no reuse.
// Built with -fmad=false; the adds are written __dadd_rn all the same.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void segment_sum_kernel(const int64_t* __restrict__ indptr,
                                   const double* __restrict__ vals,
                                   double* __restrict__ out, int64_t n_seg) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n_seg; r += stride) {
    const int64_t end = indptr[r + 1];
    double acc = 0.0;
    for (int64_t e = indptr[r]; e < end; ++e) acc = __dadd_rn(acc, vals[e]);
    out[r] = acc;
  }
}

}  // namespace

extern "C" int segment_sum_launch(const void* indptr, const void* vals, void* out,
                                  long long n_seg, void* stream) {
  if (n_seg <= 0) return 0;
  const int threads = 256;
  long long blocks = (n_seg + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks an SM
  segment_sum_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(indptr), static_cast<const double*>(vals),
      static_cast<double*>(out), static_cast<int64_t>(n_seg));
  return static_cast<int>(cudaGetLastError());
}
