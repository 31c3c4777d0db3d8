// Batched bitvector rank1 for the k^2-tree level loop, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `bitvec_rank` (src/repro/kernels/bitvec_rank.py).
//
//   rank1(pos) = word_ranks[pos >> 5] + popc(words[pos >> 5] & ((1 << (pos & 31)) - 1))
//
// words holds W+1 uint32 words (the last one is a zero pad, so pos == n stays
// in bounds); word_ranks holds the W+1 exclusive prefix popcounts as int64.
//
// What bounds it: memory. Each query reads its position (8 B), gathers one
// word and one prefix rank from places no neighbour shares, and writes 8 B.
// A random gather costs at least one 32-byte sector, so the least traffic is
// about Q * (8 + 32 + 32 + 8) B at 3.35 TB/s; the popcount is one
// instruction. The design is one thread per position in a grid-stride loop,
// with the position and the output coalesced and the two gathers left to
// L2 (a level's words are small and stay resident across the batch). A later
// change may fuse the level's `access` bit test into the same pass, which
// reads the same word, and so drop one launch and one gather per level.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void bitvec_rank_kernel(const uint32_t* __restrict__ words,
                                   const int64_t* __restrict__ word_ranks,
                                   const int64_t* __restrict__ positions,
                                   int64_t* __restrict__ out, int64_t q) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < q;
       i += stride) {
    const int64_t pos = positions[i];
    const int64_t w = pos >> 5;
    const uint32_t rem = (uint32_t)(pos & 31);
    const uint32_t mask = (1u << rem) - 1u;  // rem < 32: rem == 0 gives 0
    out[i] = word_ranks[w] + (int64_t)__popc(__ldg(words + w) & mask);
  }
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
