// Bitvector rank1 and the fused k^2-tree row/column descent, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `bitvec_rank` (src/repro/kernels/bitvec_rank.py),
// which the reference's k^2-tree calls once per tree level.
//
//   rank1(pos) = word_ranks[pos >> 5] + popc(words[pos >> 5] & ((1 << (pos & 31)) - 1))
//
// 1. bitvec_rank: rank1 of a batch of positions over one bitvector. words
//    holds W+1 uint32 words (the last one is a zero pad, so pos == n stays in
//    bounds); word_ranks holds the W+1 exclusive prefix popcounts as int64.
//    One thread per position in a grid-stride loop. It serves BitVector.rank1
//    (the scalar K2Tree.access); the batched seed below no longer calls it.
//
// 2. k2_lines (count and write passes): K2Tree.rows_many / cols_many in one
//    launch a pass instead of one rank launch, a dozen tensor ops and one host
//    sync per tree level. The tree is one flat layout: every level's words
//    (int32 bit patterns, each level followed by its zero pad word) and int64
//    word ranks, int64 per-level word offsets and bit lengths.
//
//    What bounds it: neither bytes nor operations. The tree is small (about
//    45k words, half a megabyte with the ranks, at the main path's shapes)
//    and stays in L2; each bit test is a few instructions. What costs is the
//    walk's dependency chain: a node's children are known only after its
//    word is read. So many walks run at once, one warp per query, and a
//    query's heavy row gets 32 lanes instead of one thread, so no launch
//    waits on one thread walking the heaviest row.
//
//    The walk: a stack in shared memory holds (level, block, coordinate
//    prefix) nodes, smallest coordinate on top; levels never increase from
//    the top down. Each step pops the top nodes of the deepest level, up to
//    32, one per lane, in coordinate order. A lane tests its node's k
//    candidate bits (one word and its rank, read together through __ldg,
//    serve the bits and the children's ranks). At the last level the lanes
//    emit their coordinates, which are then the smallest left, so each
//    query's output comes out sorted with no sort. Above it the lanes push
//    their children back in coordinate order, placed by a warp scan of the
//    lanes' child counts. Popping one level at a time bounds the stack: a
//    level below the deepest keeps at most 32 (k - 1) nodes, the deepest
//    32 k, so 32 (k - 1) h + 32 entries in all (544 at k = 2, h = 16); the
//    launch sizes shared memory for that, and a push past it stops the
//    query with a negative count, which the wrapper raises on.
//
//    The count pass writes each query's result count; the wrapper's
//    cumulative sum and one host read size the output; the write pass walks
//    again and writes each query's (query, coordinate) pairs into its slot.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kEntryBytes = 13;  // a stack entry: int64 prefix, int32 block, uint8 level
constexpr int kMaxWarps = 8;     // warps (queries in flight) a block
constexpr int kStaticSmem = 48 * 1024;
constexpr long long kOverflow = -(1LL << 62);

__device__ __forceinline__ int64_t rank1(uint32_t word, int64_t word_rank, uint32_t rem) {
  return word_rank + (int64_t)__popc(word & ((1u << rem) - 1u));  // rem < 32: rem == 0 gives 0
}

__global__ void bitvec_rank_kernel(const uint32_t* __restrict__ words,
                                   const int64_t* __restrict__ word_ranks,
                                   const int64_t* __restrict__ positions,
                                   int64_t* __restrict__ out, int64_t q) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < q;
       i += stride) {
    const int64_t pos = positions[i];
    const int64_t w = pos >> 5;
    out[i] = rank1(__ldg(words + w), word_ranks[w], (uint32_t)(pos & 31));
  }
}

struct Tree {
  const uint32_t* words;
  const int64_t* ranks;
  const int64_t* word_off;  // (h + 1,)
  const int64_t* nbits;     // (h,)
  int k, h, axis;
  int64_t limit_fixed, limit_free;
};

// The word a lane read last and its rank, both loaded together: one L2 round
// trip serves a node's bit tests and its children's ranks (at k = 2 and 4 a
// block's k^2 bits lie in one word).
struct Word {
  int64_t at = -1;
  uint32_t bits = 0;
  int64_t rank = 0;
  __device__ __forceinline__ void fetch(const Tree& tr, int64_t w) {
    if (w != at) {
      at = w;
      bits = __ldg(tr.words + w);
      rank = __ldg(tr.ranks + w);
    }
  }
};

__device__ __forceinline__ int warp_exclusive_scan(int v, int lane, int* total) {
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  *total = __shfl_sync(kFull, incl, 31);
  return incl - v;
}

// One query's walk by one warp. WRITE = false: returns the result count
// (kOverflow if the stack would overflow). WRITE = true: also writes the
// results from out[base].
template <bool WRITE>
__device__ int64_t walk(const Tree& tr, int64_t qi, int64_t f, int cap, int64_t* s_prefix,
                        int32_t* s_block, uint8_t* s_level, int64_t base,
                        int64_t* __restrict__ out_idx, int64_t* __restrict__ out_coord) {
  const int lane = threadIdx.x & 31;
  const int k = tr.k, k2 = tr.k * tr.k, h = tr.h;
  // digits of f: lane l holds the fixed-axis digit of levels l and l + 32
  int dig_lo = 0, dig_hi = 0;
  int64_t rest = f;
  for (int t = h - 1; t >= 0; --t) {  // from the leaves up: level t's digit is f / k^(h-1-t) % k
    const int d = (int)(rest % k);
    rest /= k;
    if (t == lane) dig_lo = d;
    if (t == lane + 32) dig_hi = d;
  }
  int size = 1;
  if (lane == 0) {
    s_prefix[0] = 0;
    s_block[0] = 0;
    s_level[0] = 0;
  }
  int64_t n_out = 0;
  __syncwarp();
  while (size > 0) {
    const int t = s_level[size - 1];
    const bool same = lane < size && s_level[size - 1 - lane] == t;
    const unsigned run = __ballot_sync(kFull, same);  // the deepest level's run from the top
    const int m = run == kFull ? 32 : __ffs(~run) - 1;
    const bool active = lane < m;
    int64_t p = 0, b = 0;
    if (active) {
      p = s_prefix[size - 1 - lane];
      b = s_block[size - 1 - lane];
    }
    size -= m;
    const int fd = t < 32 ? __shfl_sync(kFull, dig_lo, t) : __shfl_sync(kFull, dig_hi, t - 32);
    const int64_t off = __ldg(tr.word_off + t), nb = __ldg(tr.nbits + t);
    const bool leaf = t == h - 1;
    // this lane's set children, as a bit mask over j = 0..k-1 (k <= 32)
    unsigned set = 0;
    Word word;
    if (active) {
      for (int j = 0; j < k; ++j) {
        const int64_t pos = b * k2 + (tr.axis == 0 ? fd * k + j : j * k + fd);
        if (pos < nb) {
          word.fetch(tr, off + (pos >> 5));
          if ((word.bits >> (pos & 31)) & 1u) {
            if (!leaf || p * k + j < tr.limit_free) set |= 1u << j;
          }
        }
      }
    }
    int total;
    const int first = warp_exclusive_scan(__popc(set), lane, &total);
    __syncwarp();  // every lane has read its node before the stack is written
    if (leaf) {
      if (WRITE) {
        int i = 0;
        for (unsigned s = set; s; s &= s - 1, ++i) {
          const int j = __ffs(s) - 1;
          out_idx[base + n_out + first + i] = qi;
          out_coord[base + n_out + first + i] = p * k + j;
        }
      }
      n_out += total;
    } else {
      if (size + total > cap) return kOverflow;  // warp-uniform
      int i = 0;
      for (unsigned s = set; s; s &= s - 1, ++i) {
        const int j = __ffs(s) - 1;
        const int64_t pos = b * k2 + (tr.axis == 0 ? fd * k + j : j * k + fd);
        word.fetch(tr, off + (pos >> 5));
        const int slot = size + total - 1 - (first + i);  // smallest coordinate on top
        s_prefix[slot] = p * k + j;
        s_block[slot] = (int32_t)rank1(word.bits, word.rank, (uint32_t)(pos & 31));
        s_level[slot] = (uint8_t)(t + 1);
      }
      size += total;
    }
    __syncwarp();
  }
  return n_out;
}

struct Stack {
  int64_t* prefix;
  int32_t* block;
  uint8_t* level;
};

__device__ __forceinline__ Stack warp_stack(int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, wpb = blockDim.x >> 5;
  int64_t* prefix = reinterpret_cast<int64_t*>(smem);
  int32_t* block = reinterpret_cast<int32_t*>(prefix + (size_t)wpb * cap);
  uint8_t* level = reinterpret_cast<uint8_t*>(block + (size_t)wpb * cap);
  return {prefix + (size_t)warp * cap, block + (size_t)warp * cap, level + (size_t)warp * cap};
}

__global__ void k2_count_kernel(Tree tr, const int64_t* __restrict__ fixed, int64_t q, int cap,
                                int64_t* __restrict__ counts) {
  const Stack st = warp_stack(cap);
  const int wpb = blockDim.x >> 5;
  const int64_t qi = (int64_t)blockIdx.x * wpb + (threadIdx.x >> 5);
  if (qi >= q) return;  // warp-uniform
  const int64_t f = fixed[qi];
  int64_t n = 0;
  if (f >= 0 && f < tr.limit_fixed)
    n = walk<false>(tr, qi, f, cap, st.prefix, st.block, st.level, 0, nullptr, nullptr);
  if ((threadIdx.x & 31) == 0) counts[qi] = n;
}

__global__ void k2_write_kernel(Tree tr, const int64_t* __restrict__ fixed, int64_t q, int cap,
                                const int64_t* __restrict__ starts,
                                int64_t* __restrict__ out_idx,
                                int64_t* __restrict__ out_coord) {
  const Stack st = warp_stack(cap);
  const int wpb = blockDim.x >> 5;
  const int64_t qi = (int64_t)blockIdx.x * wpb + (threadIdx.x >> 5);
  if (qi >= q) return;
  const int64_t f = fixed[qi];
  if (f >= 0 && f < tr.limit_fixed)
    walk<true>(tr, qi, f, cap, st.prefix, st.block, st.level, starts[qi], out_idx, out_coord);
}

// Blocks of up to kMaxWarps warps, as many as fit 48 KB of stacks; a stack
// of more than 48 KB takes one warp a block and the opt-in limit.
template <typename K>
int plan(K kernel, int cap, int64_t q, int* warps, size_t* smem) {
  const size_t per_warp = (size_t)cap * kEntryBytes;
  int wpb = (int)(kStaticSmem / per_warp);
  if (wpb > kMaxWarps) wpb = kMaxWarps;
  if (wpb < 1) wpb = 1;
  if ((int64_t)wpb > q) wpb = (int)q;
  *warps = wpb;
  *smem = per_warp * wpb;
  if (*smem > (size_t)kStaticSmem)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)*smem);
  return 0;
}

Tree make_tree(const void* words, const void* ranks, const void* word_off, const void* nbits,
               int64_t k, int64_t h, int64_t axis, int64_t limit_fixed, int64_t limit_free) {
  return {(const uint32_t*)words, (const int64_t*)ranks, (const int64_t*)word_off,
          (const int64_t*)nbits, (int)k, (int)h, (int)axis, limit_fixed, limit_free};
}

}  // namespace

extern "C" int bitvec_rank_launch(const void* words, const void* word_ranks,
                                  const void* positions, void* out, int64_t q,
                                  void* stream) {
  if (q <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (q + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // 32 blocks per SM, then stride
  bitvec_rank_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int64_t*)word_ranks,
      (const int64_t*)positions, (int64_t*)out, q);
  return (int)cudaGetLastError();
}

// fixed (q,) int64 -> counts (q,) int64; cap is the stack's entries a warp.
extern "C" int k2_lines_count_launch(const void* words, const void* ranks, const void* word_off,
                                     const void* nbits, const void* fixed, void* counts,
                                     int64_t q, int64_t k, int64_t h, int64_t axis,
                                     int64_t limit_fixed, int64_t limit_free, int64_t cap,
                                     void* stream) {
  if (q <= 0) return 0;
  if (k < 2 || k > 32 || h < 1 || h > 64 || cap < 1) return (int)cudaErrorInvalidValue;
  int wpb;
  size_t smem;
  const int err = plan(k2_count_kernel, (int)cap, q, &wpb, &smem);
  if (err) return err;
  const Tree tr = make_tree(words, ranks, word_off, nbits, k, h, axis, limit_fixed, limit_free);
  k2_count_kernel<<<(unsigned)((q + wpb - 1) / wpb), 32 * wpb, smem, (cudaStream_t)stream>>>(
      tr, (const int64_t*)fixed, q, (int)cap, (int64_t*)counts);
  return (int)cudaGetLastError();
}

// starts (q,) int64: where each query's results begin in out_idx / out_coord.
extern "C" int k2_lines_write_launch(const void* words, const void* ranks, const void* word_off,
                                     const void* nbits, const void* fixed, const void* starts,
                                     void* out_idx, void* out_coord, int64_t q, int64_t k,
                                     int64_t h, int64_t axis, int64_t limit_fixed,
                                     int64_t limit_free, int64_t cap, void* stream) {
  if (q <= 0) return 0;
  if (k < 2 || k > 32 || h < 1 || h > 64 || cap < 1) return (int)cudaErrorInvalidValue;
  int wpb;
  size_t smem;
  const int err = plan(k2_write_kernel, (int)cap, q, &wpb, &smem);
  if (err) return err;
  const Tree tr = make_tree(words, ranks, word_off, nbits, k, h, axis, limit_fixed, limit_free);
  k2_write_kernel<<<(unsigned)((q + wpb - 1) / wpb), 32 * wpb, smem, (cudaStream_t)stream>>>(
      tr, (const int64_t*)fixed, q, (int)cap, (const int64_t*)starts, (int64_t*)out_idx,
      (int64_t*)out_coord);
  return (int)cudaGetLastError();
}
