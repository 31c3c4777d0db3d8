// Digram pair counts, the pair stage of the paper's Count step, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `digram_pair_counts`
// (src/repro/kernels/digram_count.py).
//
// Input: per-node incidence-type histograms its, cnts of shape (N, K), int32,
// padded with -1 / 0. For every node and each of the P = K(K+1)/2 unordered
// slot pairs (i <= j, in triu_indices(K) order) it writes
//   lo  = min(its[i], its[j]),  hi = max(its[i], its[j]),
//   cnt = floor(cnts[i] / 2) if i == j else min(cnts[i], cnts[j]),
//         and 0 where either side is padding (its < 0).
//
// What bounds it: the writes, 12 B * N * P, against 8 B * N * K of reads; the
// arithmetic is a handful of integer instructions per pair. The design is
// one thread per (node, pair) in a grid-stride loop: neighbouring threads
// write neighbouring outputs (coalesced stores), and recover (i, j) from the
// pair index in closed form. The reads of a node's row hit L1/L2 after the
// first thread of the row. Any N is accepted; the ragged edge is masked by
// the loop bound rather than by a block-multiple requirement.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// First pair index of row i in triu order: i*K - i*(i-1)/2.
__device__ __forceinline__ int64_t row_start(int64_t i, int64_t k) {
  return i * k - (i * (i - 1)) / 2;
}

__device__ __forceinline__ int32_t floor_half(int32_t c) {
  return (c - (c < 0 ? 1 : 0)) / 2;  // floor division by 2, also for c < 0
}

__global__ void digram_pair_counts_kernel(const int32_t* __restrict__ its,
                                          const int32_t* __restrict__ cnts,
                                          int32_t* __restrict__ lo,
                                          int32_t* __restrict__ hi,
                                          int32_t* __restrict__ cnt, int64_t n,
                                          int64_t k) {
  const int64_t p = k * (k + 1) / 2;
  const int64_t total = n * p;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const double b = 2.0 * (double)k + 1.0;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t node = t / p;
    const int64_t r = t - node * p;
    // largest i with row_start(i) <= r, then a fix-up for rounding
    int64_t i = (int64_t)floor((b - sqrt(b * b - 8.0 * (double)r)) / 2.0);
    if (i < 0) i = 0;
    if (i > k - 1) i = k - 1;
    while (i > 0 && row_start(i, k) > r) --i;
    while (i + 1 < k && row_start(i + 1, k) <= r) ++i;
    const int64_t j = i + (r - row_start(i, k));
    const int32_t it1 = its[node * k + i];
    const int32_t it2 = its[node * k + j];
    const int32_t c1 = cnts[node * k + i];
    const int32_t c2 = cnts[node * k + j];
    int32_t cv = (i == j) ? floor_half(c1) : (c1 < c2 ? c1 : c2);
    if (it1 < 0 || it2 < 0) cv = 0;
    lo[t] = it1 < it2 ? it1 : it2;
    hi[t] = it1 < it2 ? it2 : it1;
    cnt[t] = cv;
  }
}

}  // namespace

extern "C" int digram_pair_counts_launch(const void* its, const void* cnts,
                                         void* lo, void* hi, void* cnt,
                                         int64_t n, int64_t k, void* stream) {
  if (n <= 0 || k <= 0) return 0;
  const int64_t total = n * (k * (k + 1) / 2);
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // 32 blocks per SM, then stride
  digram_pair_counts_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)its, (const int32_t*)cnts, (int32_t*)lo, (int32_t*)hi,
      (int32_t*)cnt, n, k);
  return (int)cudaGetLastError();
}
