// Digram counting for Hopper (sm_90a): the paper's Count and Update Count
// steps. Three kernels.
//
// Each replaces, or redesigns, the Pallas kernel `digram_pair_counts`
// (src/repro/kernels/digram_count.py), whose per-node formula is
//   count_v(i1, i2) = min(c(v,i1), c(v,i2))  if i1 != i2,
//                     c(v,i1) // 2           if i1 == i2.
//
// 1. digram_pair_counts: the Pallas kernel's own interface, dense. Input:
//    per-node histograms its, cnts of shape (N, K), int32, padded with
//    -1 / 0. For every node and each of the P = K(K+1)/2 unordered slot
//    pairs (i <= j, in triu_indices(K) order) it writes
//      lo = min(its[i], its[j]), hi = max(its[i], its[j]),
//      cnt = floor(cnts[i] / 2) if i == j else min(cnts[i], cnts[j]),
//            and 0 where either side is padding (its < 0).
//    Bound by its writes, 12 B * N * P; one thread per (node, pair) in a
//    grid-stride loop, (i, j) from the pair index in closed form. The
//    build no longer calls it: the two kernels below take its place there.
//
// 2. digram_pair_accum: the Count and Update Count into a digram table
//    that stays on the card. Input: a ragged CSR of histograms (row_ptr
//    int64, its and cnts int32) and a sign (+1 / -1, int32) a row. For
//    every slot pair i <= j of every row it adds sign * count_v to the key
//    min(it_i, it_j) << 32 | max(...) of an open-addressing table (int64
//    keys, -1 free; int64 counts; capacity a power of two; linear probing),
//    and only where count_v != 0: no zero is written anywhere. A slot is
//    claimed with a 64-bit atomicCAS and counted in `used`; the value goes
//    in with a 64-bit atomicAdd. Integer atomics give the same counts in
//    any order. Keys are never deleted (a count may fall to 0), so a key
//    found once stays in its slot. The wrapper keeps `used` under half the
//    capacity; a probe that finds the table full adds more than the
//    capacity to `used`, which the next selection reads back and the host
//    raises on.
//    Work: a warp a row. A row of at most 64 items is staged in shared
//    memory and its P pairs walked by the lanes; a longer row (no cap) is
//    walked in tiles of 32 pairs with its items read from L1/L2. What
//    bounds it: the atomics on the table (one per nonzero pair, hot keys
//    serialise in L2); the CSR is a few bytes a pair.
//
// 3. digram_select: the most frequent digram. Reduces the table's slots
//    with flag 0 and count > 0 to the lexicographic maximum of
//    (count, -key), one partial a block, then the last block to finish
//    reduces the partials (a ticket in device memory, reset by that
//    block). It writes (key, count, slot, used), with key -1 when no slot
//    qualifies, so one 32-byte read gives the host the selection and the
//    table's occupancy. Bound by reading the table: 8 B a slot (the
//    count), and the key and flag of the slots whose count is above 0.
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr u64 kEmpty = ~0ULL;      // a free slot's key (-1 as int64)
constexpr int kWarps = 8;          // rows in flight a block
constexpr int kStage = 64;         // items a warp stages in shared memory
constexpr int kSelectThreads = 256;
constexpr int kSelectBlocks = 264; // partials the wrapper's scratch holds
constexpr unsigned kFull = 0xffffffffu;

// First pair index of row i in triu order: i*K - i*(i-1)/2.
__device__ __forceinline__ int64_t row_start(int64_t i, int64_t k) {
  return i * k - (i * (i - 1)) / 2;
}

// The slot pair (i, j), i <= j, of triu pair index r in a row of k.
__device__ __forceinline__ void pair_of(int64_t r, int64_t k, int64_t* pi, int64_t* pj) {
  const double b = 2.0 * (double)k + 1.0;
  // largest i with row_start(i) <= r, then a fix-up for rounding
  int64_t i = (int64_t)floor((b - sqrt(b * b - 8.0 * (double)r)) / 2.0);
  if (i < 0) i = 0;
  if (i > k - 1) i = k - 1;
  while (i > 0 && row_start(i, k) > r) --i;
  while (i + 1 < k && row_start(i + 1, k) <= r) ++i;
  *pi = i;
  *pj = i + (r - row_start(i, k));
}

__device__ __forceinline__ int32_t floor_half(int32_t c) {
  return (c - (c < 0 ? 1 : 0)) / 2;  // floor division by 2, also for c < 0
}

__device__ __forceinline__ int32_t pair_value(int64_t i, int64_t j, int32_t c1, int32_t c2) {
  return i == j ? floor_half(c1) : (c1 < c2 ? c1 : c2);
}

__device__ __forceinline__ u64 mix(u64 k) {  // splitmix64's finaliser
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return k;
}

__device__ void table_add(u64* keys, u64* counts, u64* used, u64 mask, int32_t it1,
                          int32_t it2, int64_t val) {
  const u64 lo = (u64)(it1 < it2 ? it1 : it2), hi = (u64)(it1 < it2 ? it2 : it1);
  const u64 key = (lo << 32) | hi;
  u64 s = mix(key) & mask;
  for (u64 n = 0; n <= mask; ++n) {
    u64 cur = keys[s];  // a key once written never changes: a stale kEmpty only costs a CAS
    if (cur == kEmpty) {
      cur = atomicCAS(keys + s, kEmpty, key);
      if (cur == kEmpty) {
        atomicAdd(used, 1ULL);
        cur = key;
      }
    }
    if (cur == key) {
      atomicAdd(counts + s, (u64)val);  // two's complement: a signed add
      return;
    }
    s = (s + 1) & mask;
  }
  atomicAdd(used, mask + 2);  // the table is full: push `used` past the capacity
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
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t node = t / p;
    int64_t i, j;
    pair_of(t - node * p, k, &i, &j);
    const int32_t it1 = its[node * k + i];
    const int32_t it2 = its[node * k + j];
    int32_t cv = pair_value(i, j, cnts[node * k + i], cnts[node * k + j]);
    if (it1 < 0 || it2 < 0) cv = 0;
    lo[t] = it1 < it2 ? it1 : it2;
    hi[t] = it1 < it2 ? it2 : it1;
    cnt[t] = cv;
  }
}

__global__ void __launch_bounds__(32 * kWarps)
digram_pair_accum_kernel(u64* __restrict__ keys, u64* __restrict__ counts,
                         u64* __restrict__ used, u64 mask,
                         const int64_t* __restrict__ row_ptr,
                         const int32_t* __restrict__ its,
                         const int32_t* __restrict__ cnts,
                         const int32_t* __restrict__ sign, int64_t n_rows) {
  __shared__ int32_t s_it[kWarps][kStage];
  __shared__ int32_t s_cnt[kWarps][kStage];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + w; row < n_rows;
       row += (int64_t)gridDim.x * kWarps) {
    const int64_t start = row_ptr[row];
    const int64_t k = row_ptr[row + 1] - start;
    const int64_t p = k * (k + 1) / 2;
    const int64_t sg = sign[row];
    if (k <= kStage) {
      for (int64_t i = lane; i < k; i += 32) {
        s_it[w][i] = its[start + i];
        s_cnt[w][i] = cnts[start + i];
      }
      __syncwarp(kFull);
      for (int64_t r = lane; r < p; r += 32) {
        int64_t i, j;
        pair_of(r, k, &i, &j);
        const int32_t cv = pair_value(i, j, s_cnt[w][i], s_cnt[w][j]);
        if (cv != 0) table_add(keys, counts, used, mask, s_it[w][i], s_it[w][j], sg * cv);
      }
      __syncwarp(kFull);  // the next row overwrites the stage
    } else {
      for (int64_t r = lane; r < p; r += 32) {
        int64_t i, j;
        pair_of(r, k, &i, &j);
        const int32_t cv = pair_value(i, j, __ldg(cnts + start + i), __ldg(cnts + start + j));
        if (cv != 0)
          table_add(keys, counts, used, mask, __ldg(its + start + i), __ldg(its + start + j),
                    sg * cv);
      }
    }
  }
}

struct Best {
  long long count, key, slot;
};

__device__ __forceinline__ bool better(const Best& a, const Best& b) {
  return a.count > b.count || (a.count == b.count && a.key < b.key);
}

__device__ __forceinline__ Best warp_best(Best b) {
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.count = __shfl_down_sync(kFull, b.count, off);
    o.key = __shfl_down_sync(kFull, b.key, off);
    o.slot = __shfl_down_sync(kFull, b.slot, off);
    if (better(o, b)) b = o;
  }
  return b;
}

// The block's best of each thread's `b`; valid in thread 0.
__device__ Best block_best(Best b, Best* s_warp) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  b = warp_best(b);
  if (lane == 0) s_warp[w] = b;
  __syncthreads();
  if (w == 0) {
    b = lane < (int)(blockDim.x >> 5) ? s_warp[lane] : Best{0, LLONG_MAX, -1};
    b = warp_best(b);
  }
  __syncthreads();
  return b;
}

__global__ void __launch_bounds__(kSelectThreads)
digram_select_kernel(const long long* __restrict__ keys,
                     const long long* __restrict__ counts,
                     const uint8_t* __restrict__ flags,
                     const long long* __restrict__ used, long long* __restrict__ scratch,
                     long long* __restrict__ out, int64_t capacity) {
  __shared__ Best s_warp[kSelectThreads / 32];
  __shared__ bool s_last;
  Best b{0, LLONG_MAX, -1};
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < capacity;
       s += (int64_t)gridDim.x * blockDim.x) {
    const long long c = counts[s];
    if (c > 0 && flags[s] == 0) {
      const Best o{c, keys[s], s};
      if (better(o, b)) b = o;
    }
  }
  b = block_best(b, s_warp);
  u64* ticket = (u64*)(scratch + 3 * kSelectBlocks);
  if (threadIdx.x == 0) {
    scratch[3 * blockIdx.x] = b.count;
    scratch[3 * blockIdx.x + 1] = b.key;
    scratch[3 * blockIdx.x + 2] = b.slot;
    __threadfence();
    s_last = atomicAdd(ticket, 1ULL) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  b = Best{0, LLONG_MAX, -1};
  for (int64_t g = threadIdx.x; g < gridDim.x; g += blockDim.x) {
    const Best o{__ldcg(scratch + 3 * g), __ldcg(scratch + 3 * g + 1),
                 __ldcg(scratch + 3 * g + 2)};
    if (better(o, b)) b = o;
  }
  b = block_best(b, s_warp);
  if (threadIdx.x == 0) {
    const bool found = b.count > 0;
    out[0] = found ? b.key : -1;
    out[1] = found ? b.count : 0;
    out[2] = found ? b.slot : -1;
    out[3] = used[0];
    *ticket = 0;  // ready for the next launch on the same scratch
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

extern "C" int digram_pair_accum_launch(void* keys, void* counts, void* used, int64_t capacity,
                                        const void* row_ptr, const void* its, const void* cnts,
                                        const void* sign, int64_t n_rows, void* stream) {
  if (n_rows <= 0) return 0;
  if (capacity < 1 || (capacity & (capacity - 1)) != 0) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n_rows + kWarps - 1) / kWarps;
  if (blocks > 132 * 16) blocks = 132 * 16;  // then the rows stride
  digram_pair_accum_kernel<<<(unsigned)blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (u64*)keys, (u64*)counts, (u64*)used, (u64)(capacity - 1), (const int64_t*)row_ptr,
      (const int32_t*)its, (const int32_t*)cnts, (const int32_t*)sign, n_rows);
  return (int)cudaGetLastError();
}

extern "C" int digram_select_launch(const void* keys, const void* counts, const void* flags,
                                    const void* used, void* scratch, void* out,
                                    int64_t capacity, void* stream) {
  if (capacity < 1) return (int)cudaErrorInvalidValue;
  int64_t blocks = (capacity + kSelectThreads - 1) / kSelectThreads;
  if (blocks > kSelectBlocks) blocks = kSelectBlocks;  // two blocks an SM, then stride
  digram_select_kernel<<<(unsigned)blocks, kSelectThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (const long long*)counts, (const uint8_t*)flags,
      (const long long*)used, (long long*)scratch, (long long*)out, capacity);
  return (int)cudaGetLastError();
}
