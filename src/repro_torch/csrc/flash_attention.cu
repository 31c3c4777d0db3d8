// Flash attention: blocked online-softmax attention with grouped-query heads,
// for Hopper (sm_90a).
//
// Replaces the Pallas kernel `flash_attention`
// (src/repro/kernels/flash_attention.py).
//
//   q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), float32 or bfloat16, each
//   addressed through (batch, head, position) strides with D contiguous;
//   q head h reads kv head h / (Hq / Hkv).
//   s[i, j]  = (q_i . k_j) * sm_scale, then softcap * tanh(s / softcap)
//   visible  = (!causal || i + q_offset >= j) && (!window || j > i + q_offset - window)
//   o_i      = sum_j p_ij v_j / sum_j p_ij over visible j, 0 for a row that
//              sees no key, in q's type.
//
// The numerics are the Pallas kernel's: scores are products of the inputs
// summed in float32, the running max m, sum l and output accumulator are
// float32; p = exp(s - m) is rounded to v's type before the PV product;
// masked scores are -1e30 and masked p is forced to 0. q_offset puts query
// row i at absolute position i + q_offset (the Pallas kernel fixes
// Sk - Sq): prefill attends positions 0..S-1 against a longer cache,
// decode one position against the cache. Any Sq, Sk >= 0; D a multiple of
// 8 up to 256.
//
// Rows. A block owns rows of one (batch, kv head): the rows are the (query
// position, head in the group) pairs r = i * group + g, so the heads that
// share a kv head share every K/V tile the block stages (qwen2's six query
// heads read the cache once, not six times). A block walks only the key
// tiles that some row of it can see (the Pallas kernel's
// `pl.when(block_visible)`) and masks per element only in tiles that some
// row cannot see whole (the diagonal, the window's edge, the ragged end).
//
// Three kernels:
//
// - bf16, `tc_kernel`: both products on the tensor cores, mma.sync
//   m16n8k16 (bf16 in, float32 accumulate), FlashAttention-2 style. Q, K
//   and V tiles come to shared memory by cp.async through a ring of two
//   stages, one barrier a tile; rows are padded by 16 bytes, so each
//   ldmatrix phase hits 32 distinct banks. Operands reach the mma through
//   ldmatrix (.trans for V, whose depth is keys). The softmax stays in
//   registers: a row's max is reduced over the four lanes of a quad with
//   shuffles; p = 2^(s c - m c) (sm_scale folded into c) is rounded to bf16
//   in registers and is the A fragment of the PV product as it stands (the
//   m16n8 accumulator layout is the A layout). The accumulator is rescaled
//   only when some row's max rose. D below the instance's width is
//   zero-filled in shared memory and its k-steps are skipped.
//   * Prefill (more than 8 rows of a (batch, kv head)), bound by the
//     tensor cores (989 TFLOP/s): 128-row blocks of 4 warps, each warp two
//     16-row m-tiles over the whole 64-key tile, so every K and V fragment
//     feeds two products. The heaviest row tiles (the last, under a causal
//     mask) launch first.
//   * Decode (at most 8 rows), bound by bytes (the visible cache is read
//     once: qwen2-1.5b at 32k tokens x 64 sequences moves 2.1 GB a layer):
//     one 16-row tile, the 4 warps each a quarter of every 64-key tile with
//     its own m, l and accumulator, merged through shared memory at the
//     end. The visible keys are split over n_splits blocks a (batch, kv
//     head): block (split, kv head, batch) walks its contiguous share of
//     whole 64-key chunks and writes float32 partials (m, l, unnormalised
//     acc), which `combine_kernel` merges (m* = max m_s, l* = sum l_s
//     e^(m_s - m*), o = sum acc_s e^(m_s - m*) / l*). One split writes o
//     directly. The wrapper plans n_splits from the visible range, so the
//     card gets a few blocks per SM even at 16 (batch, kv head) pairs.
// - float32, `simt_kernel`: float32 FMAs, never TF32; 64-row tiles (32 at
//   D = 256) at prefill, one 8-row tile split as above at decode.
//
// With a non-null `lse` the forward also writes each row's log-sum-exp,
// lse = m + log l in the kernel's score units (after sm_scale and the
// soft-cap; +inf for a row that sees no key), float32 (B, Hq, Sq): what the
// backward needs to form p = exp(s - lse) again. Serving passes null.
//
// Backward (training; the Pallas kernel has none, the reference
// differentiates its plain attention with jax.grad). Three launches:
//
// - `bwd_delta_kernel`: delta_i = sum_d dO_id O_id, one warp a row;
// - dK and dV of a tile of keys, from s = q.k sm_scale (soft-capped to
//   s_c), p = exp(s_c - lse) (0 where masked), dP = dO V^T and dS = p (dP -
//   delta) (times 1 - (s_c / cap)^2 under a soft-cap): dV = sum p^T dO,
//   dK = sm_scale sum dS^T Q over the GQA group's query heads;
// - dQ = sm_scale dS K of a tile of query rows, recomputing s, p, dP, dS.
//
// bf16 (`bwd_dkdv_mma_kernel`, `bwd_dq_mma_kernel`): FlashAttention-2's
// backward on the tensor cores, mma.sync m16n8k16 with the forward's tile
// helpers, kept deterministic. p is rounded to bf16 for dV (the forward's
// rounding point) and dS to bf16 for dK and dQ; every sum is float32.
//
// - dK/dV: a block keeps a tile of K and V in shared memory (rows padded by
//   16 bytes, as in TcSmem), each warp 16 keys and their dK and dV as
//   float32 mma accumulators: 4 warps (64 keys) at D <= 128, 8 warps (128
//   keys) at D = 256. Tiles of BM query rows (Q, dO, lse, delta; 16 rows
//   at D = 128, where 3 blocks an SM leave 168 registers a thread) stream
//   through a cp.async ring of two stages, one barrier a tile. Keys are
//   the M dimension: S^T = K Q^T and dP^T = V dO^T, whose accumulators are
//   the A fragments of the next products as they stand (the m16n8
//   accumulator layout is the A layout): P^T feeds dV += P^T dO, dS^T
//   feeds dK += dS^T Q (dO and Q through ldmatrix.trans, their depth being
//   rows). Only the operands go through shared memory. A block walks the
//   query tiles that can see its keys and masks per element only where a
//   tile crosses the diagonal, the window's edge or a ragged end. At D =
//   256 dK and dV of 16 keys would be 256 registers a thread, so the block
//   walks its query tiles twice, dV first (S and the dV product: 5
//   products instead of 4, no spill).
//   The grid: with the whole GQA group summed in the block, qwen2's micro-batch
//   of 2 has 4 (batch, kv head) pairs and the first key tiles carry all 6 heads'
//   query tiles under a causal mask, more than a share of the card's slots: the
//   heaviest blocks set the time (2.1x slower, PERF.md). So the group is split
//   over a thread block cluster: the c blocks of a cluster (c the largest
//   divisor of the group up to 8, the portable cluster size) share a key tile,
//   each walks group / c heads, and at the end each stages its float32 sums in
//   its shared memory and sums a slice of the tile's rows over the cluster's
//   blocks in rank order through distributed shared memory: no atomics, no
//   scratch in device memory, no second launch, bit-identical from run to run.
//   The first key tiles (the heaviest under a causal mask) launch first.
// - dQ: a block owns 16 rows a warp of one (batch, kv head), the (position, head
//   in the group) pairs as in the forward, so the group's heads share every K
//   and V tile: 4 warps over 32-key tiles, 3 blocks an SM, at D = 128 (64-key
//   tiles at D <= 64; 8 warps, 1 block at D = 256). Q, dO, lse and delta stay
//   resident, K and V come through a cp.async ring over the visible key tiles.
//   S = Q K^T and dP = dO V^T on the tensor cores, dS formed in registers and
//   rounded to bf16 as the A fragment of dQ += dS K (K through ldmatrix.trans),
//   dQ a float32 accumulator written once. The last row tile (the heaviest under
//   a causal mask) launches first.
//
// Both are bound by their operations: 2 D FLOPs a visible (query, key) pair
// a query head for each product, 4 products in dK/dV and 3 in dQ, at 989
// TFLOP/s; the bytes they must move are the inputs a few times over. What
// mma.sync leaves: every warp reads its B operands from shared memory
// itself for one m-tile (0.75 ldmatrix.x4 a product in dK/dV, 0.67 in
// dQ), so by count shared memory caps them at a third to a half of the
// tensor cores' rate (they reach 13-22% of the bound, PERF.md), and the
// accumulators leave no registers to pipeline the loads. wgmma with TMA
// and a producer warp is the next step, as for the forward.
//
// float32 (`bwd_dkdv_kernel`, `bwd_dq_kernel`): float32 FMAs, never TF32.
// dK/dV a block a (batch, kv head, tile of BN keys) summing the group in the
// block; dQ a block a (batch, query head, tile of BM rows); tiles staged in
// shared memory, every thread computes a 2-4 x 2-8 patch of s and dP from
// float4 reads, each accumulator patch is 4 keys (or rows) x 8 columns.
// dS stays float32 on this route. Bound at 67 TFLOP/s.
//
// In the forward nothing carries over between blocks. The next step for the prefill is
// wgmma fed by TMA, with a producer warp (warp specialisation): mma.sync
// stays under a third of the card's bf16 rate even at prefill_32k
// (PERF.md), and wgmma is the only path to the full rate.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSplitKeys = 64;  // a split covers whole chunks of this many keys
constexpr int kDecodeRows = 8;  // rows of a (batch, kv head) up to which decode splits
// lse of a row with running max m (scaled units) and sum l: m + log l, +inf
// for a row that saw no key (so exp(s - lse) is 0 there)
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.0f ? m + logf(l) : __int_as_float(0x7f800000);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;  // split partials: acc (S, B, Hkv, R, D), then m and l (S, B, Hkv, R)
  float* lse;   // null, or the rows' log-sum-exp (B, Hq, Sq); only with one split
  int64_t B, Hkv, Sq, Sk, D, group, n_splits;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int64_t q_offset, window;  // window <= 0: no window
  int causal;
  float softcap;  // <= 0: no soft-cap
  float sm_scale;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The keys [begin, end) that some row in [r0, r_last] can see, cut to this
// block's split: whole kSplitKeys chunks, split s taking chunks
// [s * per, (s + 1) * per) of the ceil(visible / kSplitKeys) (per =
// ceil(chunks / n_splits)). A split past the last chunk is empty. The
// wrapper's planner computes the same bounds.
__device__ __forceinline__ void key_range(const Params& p, int64_t r0, int64_t r_last,
                                          int64_t split, int64_t& begin, int64_t& end) {
  const int64_t pos_lo = r0 / p.group + p.q_offset;
  const int64_t pos_hi = r_last / p.group + p.q_offset;
  begin = 0;
  end = p.Sk;
  if (p.causal && pos_hi + 1 < end) end = pos_hi + 1;
  if (p.window > 0 && pos_lo - p.window + 1 > begin) begin = pos_lo - p.window + 1;
  if (p.n_splits > 1) {
    const int64_t chunks = end > begin ? (end - begin + kSplitKeys - 1) / kSplitKeys : 0;
    const int64_t per = (chunks + p.n_splits - 1) / p.n_splits;
    const int64_t lo = begin + split * per * kSplitKeys;
    const int64_t hi = lo + per * kSplitKeys;
    begin = lo;
    if (hi < end) end = hi;
  }
}

__device__ __forceinline__ bool visible(const Params& p, int64_t pos, int64_t key) {
  return pos != INT64_MIN && key < p.Sk && (!p.causal || pos >= key) &&
         (p.window <= 0 || key > pos - p.window);
}

// ------------------------------------------------------- float32 SIMT kernel

__device__ __forceinline__ void load4(const unsigned char* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

// Shared memory of one SIMT block: the Q tile, two stages of K and V tiles
// (rows of DMAX elements padded by 16 bytes, so the rows that a warp reads
// at one column fall in different banks), the BM x BN score tile, and m,
// l, alpha.
template <int BM, int BN, int DMAX>
struct Smem {
  static constexpr int kRow = DMAX * 4 + 16;
  static constexpr int kSRow = BN + 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + BM * kRow;
  static constexpr int kV = kK + 2 * BN * kRow;
  static constexpr int kS = kV + 2 * BN * kRow;
  static constexpr int kStats = kS + BM * kSRow * 4;
  static constexpr int kBytes = kStats + 3 * BM * 4;
};

// RG row groups x CG column groups of threads: in the score phase a thread
// holds TM rows x TN keys (keys cg, cg + CG, ...), in the PV phase TM rows x
// DMAX / CG output columns (4 at a time: cg * 4 + 4 * CG * j). blockIdx.x is
// row tile * n_splits + split; n_splits > 1 only with one row tile.
template <int BM, int BN, int DMAX, int RG>
__global__ void __launch_bounds__(kThreads)
simt_kernel(const Params p) {
  using SM = Smem<BM, BN, DMAX>;
  constexpr int CG = kThreads / RG;
  constexpr int TM = BM / RG;
  constexpr int TN = BN / CG;
  constexpr int DC = DMAX / CG;
  constexpr int VEC = 4;  // floats in 16 bytes
  constexpr int TPR = kThreads / BM;  // threads per row in the softmax phase
  static_assert(RG * CG == kThreads && TM * RG == BM && TN * CG == BN, "tile shape");
  static_assert(DC % 4 == 0 && TPR >= 1 && TPR <= 32, "tile shape");
  static_assert(kSplitKeys % BN == 0, "a split is whole tiles");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_s = smem + SM::kQ;
  unsigned char* k_s = smem + SM::kK;
  unsigned char* v_s = smem + SM::kV;
  float* s_s = reinterpret_cast<float*>(smem + SM::kS);
  float* m_s = reinterpret_cast<float*>(smem + SM::kStats);
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;

  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const int64_t b = blockIdx.z, kvh = blockIdx.y;
  const int64_t group = p.group;
  const int64_t R = p.Sq * group;
  const int64_t split = blockIdx.x % p.n_splits;
  const int64_t r0 = (int64_t)(blockIdx.x / p.n_splits) * BM;
  const int D = (int)p.D;
  const int chunks = D / VEC;

  const int64_t r_last = (r0 + BM < R ? r0 + BM : R) - 1;
  int64_t k_begin, k_end;
  key_range(p, r0, r_last, split, k_begin, k_end);
  const int64_t n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  const unsigned char* qb = static_cast<const unsigned char*>(p.q);
  const unsigned char* kb =
      static_cast<const unsigned char*>(p.k) + (b * p.k_sb + kvh * p.k_sh) * 4;
  const unsigned char* vb =
      static_cast<const unsigned char*>(p.v) + (b * p.v_sb + kvh * p.v_sh) * 4;

  // stage the Q tile (rows past R are zeros)
  for (int c = tid; c < BM * chunks; c += kThreads) {
    const int row = c / chunks, ch = c % chunks;
    const int64_t r = r0 + row;
    const bool valid = r < R;
    const unsigned char* src = qb;
    if (valid) {
      const int64_t i = r / group, h = kvh * group + r % group;
      src += (b * p.q_sb + h * p.q_sh + i * p.q_ss + (int64_t)ch * VEC) * 4;
    }
    cp_async16(q_s + row * SM::kRow + ch * 16, src, valid);
  }
  auto load_kv = [&](int stage, int64_t t0) {
    for (int c = tid; c < BN * chunks; c += kThreads) {
      const int row = c / chunks, ch = c % chunks;
      const int64_t key = t0 + row;
      const bool valid = key < p.Sk;  // past Sk: zeros, so 0 * v stays 0
      const int64_t off = (int64_t)ch * VEC * 4;
      const unsigned char* ks = valid ? kb + key * p.k_ss * 4 + off : kb;
      const unsigned char* vs = valid ? vb + key * p.v_ss * 4 + off : vb;
      const int dst = (stage * BN + row) * SM::kRow + ch * 16;
      cp_async16(k_s + dst, ks, valid);
      cp_async16(v_s + dst, vs, valid);
    }
  };
  if (n_tiles > 0) load_kv(0, k_begin);
  cp_async_commit();

  for (int row = tid; row < BM; row += kThreads) {
    m_s[row] = kNegInf;
    l_s[row] = 0.0f;
  }
  // absolute position of each of this thread's rows; INT64_MIN for a row past R
  int64_t my_pos[TM];
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int64_t r = r0 + rg * TM + a;
    my_pos[a] = r < R ? r / group + p.q_offset : INT64_MIN;
  }
  float acc[TM][DC];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int e = 0; e < DC; ++e) acc[a][e] = 0.0f;

  // softmax phase: TPR consecutive lanes per row
  const int sm_row = tid / TPR, sm_part = tid % TPR;
  const int64_t sm_r = r0 + sm_row;
  const int64_t sm_pos = sm_r < R ? sm_r / group + p.q_offset : INT64_MIN;

  for (int64_t t = 0; t < n_tiles; ++t) {
    const int stage = (int)(t & 1);
    const int64_t t0 = k_begin + t * BN;
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1
    if (t + 1 < n_tiles) load_kv(stage ^ 1, t0 + BN);
    cp_async_commit();

    // scores: s = (q . k) * sm_scale, soft-capped, masked
    const unsigned char* kt = k_s + stage * BN * SM::kRow;
    float sacc[TM][TN];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int c = 0; c < TN; ++c) sacc[a][c] = 0.0f;
    for (int ch = 0; ch < chunks; ++ch) {
      float qv[TM][VEC];
#pragma unroll
      for (int a = 0; a < TM; ++a) load4(q_s + (rg * TM + a) * SM::kRow + ch * 16, qv[a]);
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        float kv[VEC];
        load4(kt + (cg + CG * c) * SM::kRow + ch * 16, kv);
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int e = 0; e < VEC; ++e) sacc[a][c] = fmaf(qv[a][e], kv[e], sacc[a][c]);
      }
    }
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int n = cg + CG * c;
        float s = sacc[a][c] * p.sm_scale;
        if (p.softcap > 0.0f) s = p.softcap * tanhf(s / p.softcap);
        if (!visible(p, my_pos[a], t0 + n)) s = kNegInf;
        s_s[(rg * TM + a) * SM::kSRow + n] = s;
      }
    __syncthreads();

    // online softmax of each row over this tile; p is rounded to v's type
    {
      float* srow = s_s + sm_row * SM::kSRow;
      float mx = kNegInf;
      for (int n = sm_part; n < BN; n += TPR) mx = fmaxf(mx, srow[n]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[sm_row];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int n = sm_part; n < BN; n += TPR) {
        const float pv = visible(p, sm_pos, t0 + n) ? expf(srow[n] - m_cur) : 0.0f;
        sum += pv;
        srow[n] = pv;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (sm_part == 0) {
        const float alpha = expf(m_prev - m_cur);
        l_s[sm_row] = l_s[sm_row] * alpha + sum;
        m_s[sm_row] = m_cur;
        a_s[sm_row] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
    const unsigned char* vt = v_s + stage * BN * SM::kRow;
    const int nk = (int)(k_end - t0 < BN ? k_end - t0 : BN);  // p is 0 past k_end
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const float alpha = a_s[rg * TM + a];
#pragma unroll
      for (int e = 0; e < DC; ++e) acc[a][e] *= alpha;
    }
    for (int n = 0; n < nk; ++n) {
      float pr[TM];
#pragma unroll
      for (int a = 0; a < TM; ++a) pr[a] = s_s[(rg * TM + a) * SM::kSRow + n];
#pragma unroll
      for (int j = 0; j < DC / 4; ++j) {
        const int d0 = cg * 4 + 4 * CG * j;
        if (d0 < D) {
          float v4[4];
          load4(vt + n * SM::kRow + d0 * 4, v4);
#pragma unroll
          for (int a = 0; a < TM; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][j * 4 + e] = fmaf(pr[a], v4[e], acc[a][j * 4 + e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  if (p.n_splits > 1) {  // float32 partials of this split; the combine kernel merges them
    const int64_t slots = p.n_splits * p.B * p.Hkv * R;
    const int64_t slot0 = ((split * p.B + b) * p.Hkv + kvh) * R;
    float* pm = p.part + slots * D;
    float* pl = pm + slots;
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const int row = rg * TM + a;
      const int64_t r = r0 + row;
      if (r >= R) continue;
      float* dst = p.part + (slot0 + r) * D;
      if (cg == 0) {
        pm[slot0 + r] = m_s[row];
        pl[slot0 + r] = l_s[row];
      }
#pragma unroll
      for (int j = 0; j < DC / 4; ++j) {
        const int d0 = cg * 4 + 4 * CG * j;
        if (d0 < D)
          *reinterpret_cast<float4*>(dst + d0) =
              make_float4(acc[a][j * 4], acc[a][j * 4 + 1], acc[a][j * 4 + 2], acc[a][j * 4 + 3]);
      }
    }
    return;
  }

  // o = acc / l, 0 for a row that saw no key
  float* ob = static_cast<float*>(p.o);
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int row = rg * TM + a;
    const int64_t r = r0 + row;
    if (r >= R) continue;
    const float l = l_s[row];
    const float denom = l == 0.0f ? 1.0f : l;
    const int64_t i = r / group, h = kvh * group + r % group;
    if (p.lse != nullptr && cg == 0) p.lse[(b * p.Hkv * group + h) * p.Sq + i] = row_lse(m_s[row], l);
    float* dst = ob + b * p.o_sb + h * p.o_sh + i * p.o_ss;
#pragma unroll
    for (int j = 0; j < DC / 4; ++j) {
      const int d0 = cg * 4 + 4 * CG * j;
      if (d0 < D) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = acc[a][j * 4 + e] / denom;
        *reinterpret_cast<float4*>(dst + d0) = make_float4(x[0], x[1], x[2], x[3]);
      }
    }
  }
}

// ------------------------------------------------------- combine (split merge)

// One block per (batch, kv head, row): its first warp reduces m* = max m_s
// and l* = sum l_s e^(m_s - m*) over the splits, then each thread merges
// its columns, o = sum acc_s e^(m_s - m*) / l*, 0 where l* = 0. A split
// that saw no key has m = -1e30, l = 0 and acc = 0, so it adds nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* part, T* o, int64_t B, int64_t Hkv, int64_t group, int64_t R,
               int64_t D, int64_t n_splits, int64_t o_sb, int64_t o_sh, int64_t o_ss) {
  __shared__ float ml[2];
  const int64_t slot = blockIdx.x;  // (b * Hkv + kvh) * R + r
  const int64_t per_split = B * Hkv * R;
  const float* pm = part + n_splits * per_split * D + slot;
  const float* pl = pm + n_splits * per_split;
  if (threadIdx.x < 32) {
    float m = kNegInf, l = 0.0f;
    for (int64_t s = threadIdx.x; s < n_splits; s += 32) m = fmaxf(m, pm[s * per_split]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    for (int64_t s = threadIdx.x; s < n_splits; s += 32)
      l += pl[s * per_split] * expf(pm[s * per_split] - m);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (threadIdx.x == 0) {
      ml[0] = m;
      ml[1] = l;
    }
  }
  __syncthreads();
  const float m = ml[0], inv = 1.0f / (ml[1] == 0.0f ? 1.0f : ml[1]);
  const int64_t r = slot % R, bh = slot / R;
  const int64_t kvh = bh % Hkv, b = bh / Hkv;
  const int64_t i = r / group, h = kvh * group + r % group;
  T* dst = o + b * o_sb + h * o_sh + i * o_ss;
  for (int64_t d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.0f;
#pragma unroll 4
    for (int64_t s = 0; s < n_splits; ++s)
      acc += part[(s * per_split + slot) * D + d] * expf(pm[s * per_split] - m);
    if constexpr (sizeof(T) == 4) dst[d] = acc * inv;
    else dst[d] = __float2bfloat16_rn(acc * inv);
  }
}

// --------------------------------------------------- bf16 tensor-core kernel

// Q tile of BM rows, then a ring of STAGES (K, V) tiles of BN keys; rows
// of DMAX bf16 padded by 16 bytes: a row is then 4 banks (mod 32) past the
// one before, so the 8 rows of one ldmatrix phase cover all 32 banks once.
template <int DMAX, int BM, int BN, int STAGES>
struct TcSmem {
  static constexpr int kRow = DMAX * 2 + 16;
  static constexpr int kQ = 0;
  static constexpr int kKV = kQ + BM * kRow;      // stage s: K at kKV + s * kStage, then V
  static constexpr int kStage = 2 * BN * kRow;
  static constexpr int kBytes = kKV + STAGES * kStage;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU; -1e30 and below give 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// Writes row r's float32 partials of split `split` (m, l, unnormalised acc)
// or, with one split, o = acc / l (0 where l = 0) in bf16. acc(d) gives
// column d.
template <typename Acc>
__device__ __forceinline__ void tc_store_row(const Params& p, int64_t b, int64_t kvh,
                                             int64_t split, int64_t r, float m, float l,
                                             int d0, int d_step, Acc acc) {
  const int64_t R = p.Sq * p.group;
  if (p.n_splits > 1) {
    const int64_t slots = p.n_splits * p.B * p.Hkv * R;
    const int64_t slot = ((split * p.B + b) * p.Hkv + kvh) * R + r;
    if (d0 == 0) {
      p.part[slots * p.D + slot] = m;
      p.part[slots * p.D + slots + slot] = l;
    }
    for (int d = d0; d < p.D; d += d_step) p.part[slot * p.D + d] = acc(d);
    return;
  }
  const float inv = 1.0f / (l == 0.0f ? 1.0f : l);
  const int64_t i = r / p.group, h = kvh * p.group + r % p.group;
  if (p.lse != nullptr && d0 == 0) p.lse[(b * p.Hkv * p.group + h) * p.Sq + i] = row_lse(m, l);
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh + i * p.o_ss;
  for (int d = d0; d < p.D; d += d_step) dst[d] = __float2bfloat16_rn(acc(d) * inv);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * gid + tig. A holds
// rows gid and gid + 8, columns 2 tig, 2 tig + 1 (a0, a1) and the same + 8
// (a2, a3); B holds column gid, rows 2 tig, 2 tig + 1 (b0) and + 8 (b1); the
// accumulator holds rows gid (c0, c1) and gid + 8 (c2, c3), columns 2 tig,
// 2 tig + 1.
//
// WM warps along the rows, MT m-tiles of 16 rows each, x WN warps along
// the keys of a tile (BN / WN each). Prefill: WN = 1, every warp over the
// whole tile; each K and V fragment feeds MT products. Decode: WM = MT =
// 1, WN = 4, one 16-row tile (at most 8 rows are real), each warp a
// quarter of the keys with its own m, l and accumulator, merged through
// shared memory at the end. K and V tiles come through a ring of STAGES,
// STAGES - 1 tiles ahead, one barrier a tile. The grid is one-dimensional,
// (batch, kv head) pair fastest, then split, then row tile, last row tile
// first: the heaviest blocks under a causal mask start first on every
// pair, and the grid's tail is light.
template <int DMAX, int BN, int WM, int WN, int MT, int STAGES>
__global__ void __launch_bounds__(32 * WM * WN)
tc_kernel(const Params p) {
  constexpr int NT = 32 * WM * WN;
  constexpr int BM = 16 * MT * WM;
  constexpr int WK = BN / WN;    // keys of a tile for one warp
  constexpr int KD = DMAX / 16;  // k-steps of S = Q K^T
  constexpr int NS = WK / 8;     // n-tiles of S
  constexpr int KP = WK / 16;    // k-steps of O += P V
  constexpr int ND = DMAX / 8;   // n-tiles of O
  constexpr int CH = DMAX / 8;   // 16-byte chunks of a row
  constexpr bool kQInRegs = MT * DMAX <= 128;  // else ldmatrix Q at every k-step
  using SM = TcSmem<DMAX, BM, BN, STAGES>;
  static_assert(WK % 16 == 0 && ND % 2 == 0 && NS * 4 <= 32 && (BN * CH) % NT == 0,
                "tile shape");
  static_assert(kSplitKeys % BN == 0 && STAGES >= 2, "a split is whole tiles");

  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t pairs = p.B * p.Hkv;
  const int64_t b = blockIdx.x % pairs / p.Hkv, kvh = blockIdx.x % p.Hkv;
  const int64_t group = p.group;
  const int64_t R = p.Sq * group;
  const int64_t row_tiles = (R + BM - 1) / BM;
  const int64_t split = blockIdx.x / pairs % p.n_splits;
  const int64_t r0 = (row_tiles - 1 - (int64_t)blockIdx.x / pairs / p.n_splits) * BM;
  const int D = (int)p.D;

  const int64_t r_last = (r0 + BM < R ? r0 + BM : R) - 1;
  int64_t k_begin, k_end;
  key_range(p, r0, r_last, split, k_begin, k_end);
  const int64_t n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;
  const int64_t pos_lo = r0 / group + p.q_offset;
  const int64_t pos_hi = r_last / group + p.q_offset;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  unsigned char* q_s = smem + SM::kQ;
  unsigned char* kv_s = smem + SM::kKV;

  // Q rows past R and columns past D are zeros
  for (int c = tid; c < BM * CH; c += NT) {
    const int row = c / CH, ch = c % CH;
    const int64_t r = r0 + row;
    const bool valid = r < R && ch * 8 < D;
    const __nv_bfloat16* src = qb;
    if (valid) {
      const int64_t i = r / group, h = kvh * group + r % group;
      src += b * p.q_sb + h * p.q_sh + i * p.q_ss + ch * 8;
    }
    cp_async16(q_s + row * SM::kRow + ch * 16, src, valid);
  }
  // A thread copies the same chunk of rows ld_row, ld_row + NT / CH, ...
  // of every K and V tile. Rows past k_end and columns past D are zeros: a
  // cache holds unwritten positions past the causal end, and 0 * NaN would
  // reach O.
  constexpr int kLdRows = NT / CH;  // rows one pass of the block copies
  const int ld_row = tid / CH, ld_ch = tid % CH;
  const bool ld_col = ld_ch * 8 < D;
  auto load_tile = [&](int stage, int64_t t0) {  // K and V of keys t0.. into a stage
    unsigned char* dst = kv_s + stage * SM::kStage + ld_row * SM::kRow + ld_ch * 16;
    const __nv_bfloat16* ks = kb + (t0 + ld_row) * p.k_ss + ld_ch * 8;
    const __nv_bfloat16* vs = vb + (t0 + ld_row) * p.v_ss + ld_ch * 8;
#pragma unroll
    for (int i = 0; i < BN / kLdRows; ++i) {
      const bool valid = ld_col && t0 + ld_row + i * kLdRows < k_end;
      const int at = i * kLdRows * SM::kRow;
      cp_async16(dst + at, valid ? ks + i * kLdRows * p.k_ss : kb, valid);
      cp_async16(dst + BN * SM::kRow + at, valid ? vs + i * kLdRows * p.v_ss : vb, valid);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {  // one group a tile; the first also holds Q
    if (st < n_tiles) load_tile(st, k_begin + st * BN);
    cp_async_commit();
  }

  float o_acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < ND; ++j)
      o_acc[mt][j][0] = o_acc[mt][j][1] = o_acc[mt][j][2] = o_acc[mt][j][3] = 0.0f;
  float m_row[MT][2], l_row[MT][2];  // l: this thread's share of the row
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_row[mt][0] = m_row[mt][1] = kNegInf;
    l_row[mt][0] = l_row[mt][1] = 0.0f;
  }
  uint32_t q_frag[kQInRegs ? MT : 1][kQInRegs ? KD : 1][4];
  int rel[MT][2];  // position of this thread's rows - pos_lo; -1 past R
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = r0 + (wm * MT + mt) * 16 + gid + 8 * h;
      rel[mt][h] = r < R ? (int)(r / group - r0 / group) : -1;
    }
  const float c = (p.softcap > 0.0f ? 1.0f : p.sm_scale) * kLog2e;

  // this lane's ldmatrix row addresses: matrix lane >> 3, its row lane & 7
  const int mi = lane >> 3, mr = lane & 7;
  const uint32_t q_addr =
      smem_u32(q_s) + (wm * MT * 16 + (mi & 1) * 8 + mr) * SM::kRow + (mi >> 1) * 16;
  const uint32_t k_addr =
      smem_u32(kv_s) + (wn * WK + (mi >> 1) * 8 + mr) * SM::kRow + (mi & 1) * 16;
  const uint32_t v_addr =
      smem_u32(kv_s) + (BN + wn * WK + (mi & 1) * 8 + mr) * SM::kRow + (mi >> 1) * 16;

  int stage = 0;
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t t0 = k_begin + t * BN;
    cp_async_wait<STAGES - 2>();  // tile t's group landed (later ones may be in flight)
    __syncthreads();  // ... for every thread, and every thread is done with tile t - 1
    {  // tile t + STAGES - 1 into the stage that tile t - 1 used
      const int64_t ahead = t + STAGES - 1;
      if (ahead < n_tiles)
        load_tile(stage == 0 ? STAGES - 1 : stage - 1, k_begin + ahead * BN);
      cp_async_commit();
    }
    if (kQInRegs && t == 0) {
#pragma unroll
      for (int mt = 0; mt < (kQInRegs ? MT : 1); ++mt)
#pragma unroll
        for (int kk = 0; kk < (kQInRegs ? KD : 1); ++kk)
          ldmatrix_x4(q_frag[mt][kk], q_addr + mt * 16 * SM::kRow + kk * 32);
    }

    // S = Q K^T over the k-steps that hold some of D
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.0f;
    const uint32_t kt = k_addr + stage * SM::kStage;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (kk * 16 >= D) break;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (kQInRegs) {
          a[mt][0] = q_frag[mt][kk][0]; a[mt][1] = q_frag[mt][kk][1];
          a[mt][2] = q_frag[mt][kk][2]; a[mt][3] = q_frag[mt][kk][3];
        } else {
          ldmatrix_x4(a[mt], q_addr + mt * 16 * SM::kRow + kk * 32);
        }
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + np * 16 * SM::kRow + kk * 32);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
        }
      }
    }

    // Scores stay in units u: q.k, or softcap * tanh(q.k * sm_scale /
    // softcap) with a soft-cap; p = 2^(u c - m c) with c = log2(e) times
    // sm_scale (or 1), one FFMA and one MUFU an element.
    if (p.softcap > 0.0f) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][j][e] = p.softcap * tanhf(s[mt][j][e] * p.sm_scale / p.softcap);
    }
    // mask only in a tile that some row does not see whole (uniform over the block)
    const bool whole = t0 + BN <= k_end && (!p.causal || t0 + BN - 1 <= pos_lo) &&
                       (p.window <= 0 || t0 > pos_hi - p.window);
    uint32_t seen[MT];  // bit 4 j + e: element e of n-tile j is visible
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) seen[mt] = 0xffffffffu;
    if (!whole) {
      // element (j, e) holds key key0 + o, o = 8 j + (e & 1); a row sees
      // o_lo < o < o_hi
      const int64_t key0 = t0 + wn * WK + 2 * tig;
      const int64_t base = pos_lo - key0;  // a row's position - key0, less its rel
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int64_t hi = p.Sk - key0, lo = -1;
          if (p.causal && base + rel[mt][h] + 1 < hi) hi = base + rel[mt][h] + 1;
          if (p.window > 0) lo = base + rel[mt][h] - p.window;
          if (rel[mt][h] < 0) hi = -1;
          const int o_hi = (int)(hi < -1 ? -1 : hi > WK ? WK : hi);
          const int o_lo = (int)(lo < -1 ? -1 : lo > WK ? WK : lo);
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              const int o = 8 * j + (e & 1);
              if (o >= o_hi || o <= o_lo) {
                seen[mt] &= ~(1u << (4 * j + e));
                s[mt][j][e] = kNegInf;
              }
            }
        }
    }
    bool moved = false;  // some row's max rose
    float alpha[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
      }
      float m_c[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the row's max over the quad that holds it
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_row[mt][h], mx[h]);
        moved |= m_new != m_row[mt][h];
        alpha[mt][h] = ex2((m_row[mt][h] - m_new) * c);
        m_row[mt][h] = m_new;
        m_c[h] = m_new * c;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = ex2(fmaf(s[mt][j][e], c, -m_c[e >> 1]));
      if (!whole) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!(seen[mt] >> (4 * j + e) & 1u)) s[mt][j][e] = 0.0f;
      }
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        rs[0] += s[mt][j][0] + s[mt][j][1];
        rs[1] += s[mt][j][2] + s[mt][j][3];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_row[mt][h] = l_row[mt][h] * alpha[mt][h] + rs[h];
    }
    if (__any_sync(0xffffffffu, moved)) {  // else every alpha is 1
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          o_acc[mt][j][0] *= alpha[mt][0]; o_acc[mt][j][1] *= alpha[mt][0];
          o_acc[mt][j][2] *= alpha[mt][1]; o_acc[mt][j][3] *= alpha[mt][1];
        }
    }

    // O += P V, p rounded to bf16: S's n-tiles 2 kk and 2 kk + 1 are the A
    // fragment of k-step kk
    const uint32_t vt = v_addr + stage * SM::kStage;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        if (dp * 16 >= D) break;
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + kk * 16 * SM::kRow + dp * 32);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o_acc[mt][2 * dp], a[mt], bv[0], bv[1]);
          mma_bf16(o_acc[mt][2 * dp + 1], a[mt], bv[2], bv[3]);
        }
      }
    }
    stage = stage == STAGES - 1 ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  // l summed over the quad that holds the row
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_row[mt][h] += __shfl_xor_sync(0xffffffffu, l_row[mt][h], 1);
      l_row[mt][h] += __shfl_xor_sync(0xffffffffu, l_row[mt][h], 2);
    }
  if constexpr (WN == 1) {  // prefill, one split: each row is one warp's, written from registers
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = r0 + (wm * MT + mt) * 16 + gid + 8 * h;
        if (r >= R) continue;
        const float inv = 1.0f / (l_row[mt][h] == 0.0f ? 1.0f : l_row[mt][h]);
        const int64_t i = r / group, hq = kvh * group + r % group;
        if (p.lse != nullptr && tig == 0) {
          const float m = p.softcap > 0.0f ? m_row[mt][h] : m_row[mt][h] * p.sm_scale;
          p.lse[(b * p.Hkv * group + hq) * p.Sq + i] = row_lse(m, l_row[mt][h]);
        }
        __nv_bfloat16* dst =
            static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + hq * p.o_sh + i * p.o_ss + 2 * tig;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          if (j * 8 + 2 * tig < D)
            *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(
                o_acc[mt][j][2 * h] * inv, o_acc[mt][j][2 * h + 1] * inv);
        }
      }
  } else {  // merge the WN warps' shares of each row through the freed K/V stages
    static_assert(MT == 1 && WN * BM * (DMAX + 2) * 4 <= STAGES * SM::kStage, "merge scratch");
    float* red_o = reinterpret_cast<float*>(kv_s);  // (WN, BM, DMAX)
    float* red_m = red_o + WN * BM * DMAX;                    // (WN, BM)
    float* red_l = red_m + WN * BM;
    __syncthreads();  // every warp is done with the K/V stages
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 16 + gid + 8 * h;
      float* dst = red_o + (wn * BM + row) * DMAX + 2 * tig;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        dst[j * 8] = o_acc[0][j][2 * h];
        dst[j * 8 + 1] = o_acc[0][j][2 * h + 1];
      }
      if (tig == 0) {
        red_m[wn * BM + row] = m_row[0][h];
        red_l[wn * BM + row] = l_row[0][h];
      }
    }
    __syncthreads();
    const int rows = (int)(R - r0 < BM ? R - r0 : BM);
    constexpr int kPerRow = NT / BM;  // threads per row, each every kPerRow-th column
    const int row = tid / kPerRow;
    if (row < rows) {
      float m = kNegInf;
#pragma unroll
      for (int w = 0; w < WN; ++w) m = fmaxf(m, red_m[w * BM + row]);
      float wt[WN], l = 0.0f;
#pragma unroll
      for (int w = 0; w < WN; ++w) {
        wt[w] = ex2((red_m[w * BM + row] - m) * c);
        l += red_l[w * BM + row] * wt[w];
      }
      // the partial's max in scaled scores, as the combine kernel reads it
      const float m_scaled = m == kNegInf || p.softcap > 0.0f ? m : m * p.sm_scale;
      tc_store_row(p, b, kvh, split, r0 + row, m_scaled, l, tid % kPerRow, kPerRow, [&](int d) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < WN; ++w) acc += red_o[(w * BM + row) * DMAX + d] * wt[w];
        return acc;
      });
    }
  }
}

// ------------------------------------------------------------------ launches

template <typename K>
int configure(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool aligned(const void* ptr, int64_t sb, int64_t sh, int64_t ss, int64_t vec) {
  return (uintptr_t)ptr % 16 == 0 && sb % vec == 0 && sh % vec == 0 && ss % vec == 0;
}

template <int BM, int DMAX, int RG>
int launch_simt(const Params& p, cudaStream_t stream) {
  constexpr int BN = DMAX <= 64 ? 64 : 32;
  constexpr int bytes = Smem<BM, BN, DMAX>::kBytes;
  auto kernel = simt_kernel<BM, BN, DMAX, RG>;
  static const int configured = configure(kernel, bytes);
  if (configured != 0) return configured;
  const int64_t blocks = (p.Sq * p.group + BM - 1) / BM * p.n_splits;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)p.Hkv, (unsigned)p.B);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DMAX, int BN, int WM, int WN, int MT, int STAGES>
int launch_tc(const Params& p, cudaStream_t stream) {
  constexpr int BM = 16 * MT * WM;
  constexpr int bytes = TcSmem<DMAX, BM, BN, STAGES>::kBytes;
  auto kernel = tc_kernel<DMAX, BN, WM, WN, MT, STAGES>;
  static const int configured = configure(kernel, bytes);
  if (configured != 0) return configured;
  const int64_t blocks = (p.Sq * p.group + BM - 1) / BM * p.n_splits * p.B * p.Hkv;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * WM * WN, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_d(const Params& p, cudaStream_t stream) {
  const bool decode = p.Sq * p.group <= kDecodeRows;
  if constexpr (sizeof(T) == 2) {  // bf16: tensor cores, one 16-row tile at decode
    if (decode) return launch_tc<DMAX, 64, 1, 4, 1, 2>(p, stream);
    // 128 rows x 64 keys; at D = 256, where the accumulator is 128 registers, 64 x 32
    if constexpr (DMAX == 256) return launch_tc<DMAX, 32, 4, 1, 1, 2>(p, stream);
    else return launch_tc<DMAX, 64, 4, 1, 2, 2>(p, stream);
  } else {
    if (decode) return launch_simt<kDecodeRows, DMAX, 8>(p, stream);
    if constexpr (DMAX == 256) return launch_simt<32, DMAX, 16>(p, stream);
    else return launch_simt<64, DMAX, 16>(p, stream);
  }
}

template <typename T>
int launch_t(const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch_d<T, 64>(p, stream);
  if (p.D <= 128) return launch_d<T, 128>(p, stream);
  return launch_d<T, 256>(p, stream);
}

// ------------------------------------------------------------------ backward

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, Hq, Sq), the forward's
  const float* delta;  // (B, Hq, Sq), rowsum(dO * O)
  void* dq;
  void* dk;
  void* dv;
  int64_t B, Hkv, Sq, Sk, D, group;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int64_t q_offset, window;  // window <= 0: no window
  int causal;
  float softcap;  // <= 0: no soft-cap
  float sm_scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ float4 load4f(const float* p) {  // four consecutive floats
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// Tiles of the backward at DMAX: BN keys x BM query rows, staged as float32
// rows of DMAX padded by 16 bytes (RS floats). The score phase gives thread
// (rg, cg) rows rg * TM + a and keys cg + CG * c; the accumulation phase
// gives it 4 keys (dkdv) or TR rows (dq) times the 8 columns c4 .. c4 + 3
// and c4 + DMAX / 2 .. + 3, c4 = 4 * (tid % (DMAX / 8)).
template <int DMAX>
struct Bwd {
  static constexpr int BN = 4096 / DMAX;           // 64, 32, 16
  static constexpr int BM = DMAX == 64 ? 64 : 32;
  static constexpr int RS = DMAX + 4;
  static constexpr int PS = BN + 1;
  static constexpr int RG = 16, CG = kThreads / RG;
  static constexpr int TM = BM / RG, TN = BN / CG;
  static constexpr int CGD = DMAX / 8;             // column groups of the accumulation
  static constexpr int OG = kThreads / CGD;        // key (or row) groups of it
  static constexpr int TK = BN / OG;               // keys a thread in dkdv
  static constexpr int TR = BM / OG;               // rows a thread in dq
  static constexpr int kK = 0, kV = BN * RS, kQ = 2 * BN * RS, kDO = kQ + BM * RS;
  static constexpr int kP = kDO + BM * RS, kDS = kP + BM * PS;
  static constexpr int kLse = kDS + BM * PS, kDelta = kLse + BM;
  static constexpr int kBytes = (kDelta + BM) * 4;
  static_assert(TM * RG == BM && TN * CG == BN && TK * OG == BN && TR * OG == BM, "tile shape");
};

// rows [r0, r0 + n) of a (position-major) operand into shared rows of RS
// floats; rows at or past `valid` and columns past D are zeros
template <int DMAX, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* base, int64_t stride, int64_t r0,
                                           int n, int64_t valid, int D) {
  constexpr int RS = DMAX + 4, C4 = DMAX / 4;
  for (int c = threadIdx.x; c < n * C4; c += kThreads) {
    const int row = c / C4, col = (c % C4) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + row < valid && col < D) x = load4f(base + (r0 + row) * stride + col);
    *reinterpret_cast<float4*>(dst + row * RS + col) = x;
  }
}

__device__ __forceinline__ bool bwd_visible(const BwdParams& p, int64_t i, int64_t key) {
  const int64_t pos = i + p.q_offset;
  return i < p.Sq && key < p.Sk && (!p.causal || pos >= key) &&
         (p.window <= 0 || key > pos - p.window);
}

// The score phase over the staged tiles (query rows i0.., keys k0..): s = Q
// K^T and dP = dO V^T for this thread's patch, then p = exp(s_c - lse) and
// dS = p (dP - delta) (times the soft-cap's derivative), written to shared
// memory: dS always, p when P is set (dkdv).
template <int DMAX, typename T, bool P>
__device__ __forceinline__ void bwd_scores(const BwdParams& p, float* sm, int64_t i0, int64_t k0) {
  using C = Bwd<DMAX>;
  const int rg = threadIdx.x / C::CG, cg = threadIdx.x % C::CG;
  const int D = (int)p.D;
  float s[C::TM][C::TN], dp[C::TM][C::TN];
#pragma unroll
  for (int a = 0; a < C::TM; ++a)
#pragma unroll
    for (int c = 0; c < C::TN; ++c) s[a][c] = dp[a][c] = 0.0f;
  for (int c4 = 0; c4 < D; c4 += 4) {
    float4 qv[C::TM], dov[C::TM];
#pragma unroll
    for (int a = 0; a < C::TM; ++a) {
      qv[a] = *reinterpret_cast<const float4*>(sm + C::kQ + (rg * C::TM + a) * C::RS + c4);
      dov[a] = *reinterpret_cast<const float4*>(sm + C::kDO + (rg * C::TM + a) * C::RS + c4);
    }
#pragma unroll
    for (int c = 0; c < C::TN; ++c) {
      const float4 kv = *reinterpret_cast<const float4*>(sm + C::kK + (cg + C::CG * c) * C::RS + c4);
      const float4 vv = *reinterpret_cast<const float4*>(sm + C::kV + (cg + C::CG * c) * C::RS + c4);
#pragma unroll
      for (int a = 0; a < C::TM; ++a) {
        s[a][c] = dot4(qv[a], kv, s[a][c]);
        dp[a][c] = dot4(dov[a], vv, dp[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < C::TM; ++a) {
    const int row = rg * C::TM + a;
    const float lse = sm[C::kLse + row], delta = sm[C::kDelta + row];
#pragma unroll
    for (int c = 0; c < C::TN; ++c) {
      const int n = cg + C::CG * c;
      float sc = s[a][c] * p.sm_scale;
      float dcap = 1.0f;
      if (p.softcap > 0.0f) {
        sc = p.softcap * tanhf(sc / p.softcap);
        const float t = sc / p.softcap;
        dcap = 1.0f - t * t;
      }
      const float pr = bwd_visible(p, i0 + row, k0 + n) ? expf(sc - lse) : 0.0f;
      if constexpr (P) sm[C::kP + row * C::PS + n] = pr;
      sm[C::kDS + row * C::PS + n] = pr * (dp[a][c] - delta) * dcap;
    }
  }
}

// lse and delta of query rows i0 .. i0 + BM of head h (+inf and 0 past Sq)
template <int DMAX>
__device__ __forceinline__ void stage_stats(const BwdParams& p, float* sm, int64_t b, int64_t h,
                                            int64_t i0) {
  using C = Bwd<DMAX>;
  const int64_t hq = p.Hkv * p.group;
  for (int r = threadIdx.x; r < C::BM; r += kThreads) {
    const int64_t i = i0 + r;
    const bool valid = i < p.Sq;
    sm[C::kLse + r] = valid ? p.lse[(b * hq + h) * p.Sq + i] : __int_as_float(0x7f800000);
    sm[C::kDelta + r] = valid ? p.delta[(b * hq + h) * p.Sq + i] : 0.0f;
  }
}

// Block (key tile, kv head, batch): dK and dV of keys k0 .. k0 + BN.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(const BwdParams p) {
  using C = Bwd<DMAX>;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.z, kvh = blockIdx.y, k0 = (int64_t)blockIdx.x * C::BN;
  const int D = (int)p.D;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb;
  stage_rows<DMAX>(sm + C::kK, static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_ss,
                   k0, C::BN, p.Sk, D);
  stage_rows<DMAX>(sm + C::kV, static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_ss,
                   k0, C::BN, p.Sk, D);

  // the query rows that can see some key of the tile
  const int64_t k_last = (k0 + C::BN < p.Sk ? k0 + C::BN : p.Sk) - 1;
  int64_t i_lo = 0, i_hi = p.Sq;
  if (p.causal && k0 - p.q_offset > i_lo) i_lo = k0 - p.q_offset;
  if (p.window > 0 && k_last + p.window - p.q_offset < i_hi) i_hi = k_last + p.window - p.q_offset;

  const int og = tid / C::CGD, c4 = 4 * (tid % C::CGD);
  constexpr int H = DMAX / 2;
  float dk[C::TK][8], dv[C::TK][8];
#pragma unroll
  for (int a = 0; a < C::TK; ++a)
#pragma unroll
    for (int e = 0; e < 8; ++e) dk[a][e] = dv[a][e] = 0.0f;

  for (int64_t g = 0; g < p.group; ++g) {
    const int64_t h = kvh * p.group + g;
    for (int64_t i0 = i_lo; i0 < i_hi; i0 += C::BM) {
      __syncthreads();  // every thread is done with the last tile
      stage_rows<DMAX>(sm + C::kQ, qb + h * p.q_sh, p.q_ss, i0, C::BM, p.Sq, D);
      stage_rows<DMAX>(sm + C::kDO, dob + h * p.do_sh, p.do_ss, i0, C::BM, p.Sq, D);
      stage_stats<DMAX>(p, sm, b, h, i0);
      __syncthreads();
      bwd_scores<DMAX, T, true>(p, sm, i0, k0);
      __syncthreads();
      if (c4 >= D) continue;  // no column of this thread's (the barriers above still meet)
      for (int m = 0; m < C::BM; ++m) {
        const float4 do0 = *reinterpret_cast<const float4*>(sm + C::kDO + m * C::RS + c4);
        const float4 do1 = *reinterpret_cast<const float4*>(sm + C::kDO + m * C::RS + c4 + H);
        const float4 q0 = *reinterpret_cast<const float4*>(sm + C::kQ + m * C::RS + c4);
        const float4 q1 = *reinterpret_cast<const float4*>(sm + C::kQ + m * C::RS + c4 + H);
        const float dof[8] = {do0.x, do0.y, do0.z, do0.w, do1.x, do1.y, do1.z, do1.w};
        const float qf[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
        for (int a = 0; a < C::TK; ++a) {
          const int n = og + C::OG * a;
          const float pr = sm[C::kP + m * C::PS + n], ds = sm[C::kDS + m * C::PS + n];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            dv[a][e] = fmaf(pr, dof[e], dv[a][e]);
            dk[a][e] = fmaf(ds, qf[e], dk[a][e]);
          }
        }
      }
    }
  }
  T* dkb = static_cast<T*>(p.dk) + b * p.dk_sb + kvh * p.dk_sh;
  T* dvb = static_cast<T*>(p.dv) + b * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int a = 0; a < C::TK; ++a) {
    const int64_t key = k0 + og + C::OG * a;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = c4 + (e < 4 ? e : H + e - 4);
      if (col < D) {
        store_f(dkb + key * p.dk_ss + col, dk[a][e] * p.sm_scale);
        store_f(dvb + key * p.dv_ss + col, dv[a][e]);
      }
    }
  }
}

// Block (query tile, query head, batch): dQ of rows i0 .. i0 + BM, the
// last row tile first (the heaviest under a causal mask).
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(const BwdParams p) {
  using C = Bwd<DMAX>;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.z, h = blockIdx.y, kvh = h / p.group;
  const int64_t i0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * C::BM;
  const int D = (int)p.D;
  stage_rows<DMAX>(sm + C::kQ, static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss, i0,
                   C::BM, p.Sq, D);
  stage_rows<DMAX>(sm + C::kDO, static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh,
                   p.do_ss, i0, C::BM, p.Sq, D);
  stage_stats<DMAX>(p, sm, b, h, i0);
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // the keys some row of the tile can see
  const int64_t pos_lo = i0 + p.q_offset;
  const int64_t pos_hi = (i0 + C::BM < p.Sq ? i0 + C::BM : p.Sq) - 1 + p.q_offset;
  int64_t k_lo = 0, k_hi = p.Sk;
  if (p.causal && pos_hi + 1 < k_hi) k_hi = pos_hi + 1;
  if (p.window > 0 && pos_lo - p.window + 1 > k_lo) k_lo = pos_lo - p.window + 1;

  const int og = tid / C::CGD, c4 = 4 * (tid % C::CGD);
  constexpr int H = DMAX / 2;
  float dq[C::TR][8];
#pragma unroll
  for (int a = 0; a < C::TR; ++a)
#pragma unroll
    for (int e = 0; e < 8; ++e) dq[a][e] = 0.0f;

  for (int64_t k0 = k_lo; k0 < k_hi; k0 += C::BN) {
    __syncthreads();  // every thread is done with the last key tile
    stage_rows<DMAX>(sm + C::kK, kb, p.k_ss, k0, C::BN, k_hi, D);
    stage_rows<DMAX>(sm + C::kV, vb, p.v_ss, k0, C::BN, k_hi, D);
    __syncthreads();
    bwd_scores<DMAX, T, false>(p, sm, i0, k0);
    __syncthreads();
    if (c4 >= D) continue;
    for (int n = 0; n < C::BN; ++n) {
      const float4 k0v = *reinterpret_cast<const float4*>(sm + C::kK + n * C::RS + c4);
      const float4 k1v = *reinterpret_cast<const float4*>(sm + C::kK + n * C::RS + c4 + H);
      const float kf[8] = {k0v.x, k0v.y, k0v.z, k0v.w, k1v.x, k1v.y, k1v.z, k1v.w};
#pragma unroll
      for (int a = 0; a < C::TR; ++a) {
        const float ds = sm[C::kDS + (og + C::OG * a) * C::PS + n];
#pragma unroll
        for (int e = 0; e < 8; ++e) dq[a][e] = fmaf(ds, kf[e], dq[a][e]);
      }
    }
  }
  T* dqb = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int a = 0; a < C::TR; ++a) {
    const int64_t i = i0 + og + C::OG * a;
    if (i >= p.Sq) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = c4 + (e < 4 ? e : H + e - 4);
      if (col < D) store_f(dqb + i * p.dq_ss + col, dq[a][e] * p.sm_scale);
    }
  }
}

// delta of each row (b, h, i): sum_d dO O in float32, one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* o, const T* dout, float* delta, int64_t Hq, int64_t Sq, int64_t D,
                 int64_t rows, int64_t o_sb, int64_t o_sh, int64_t o_ss, int64_t d_sb,
                 int64_t d_sh, int64_t d_ss) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t i = row % Sq, bh = row / Sq, h = bh % Hq, b = bh / Hq;
  const T* orow = o + b * o_sb + h * o_sh + i * o_ss;
  const T* drow = dout + b * d_sb + h * d_sh + i * d_ss;
  float acc = 0.0f;
  for (int64_t d = lane; d < D; d += 32) acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ------------------------------------------ bf16 backward on the tensor cores

// tanh(x) = 1 - 2 / (e^2x + 1) from one MUFU ex2 and a fast reciprocal: the
// soft-capped score cap * tanh(s / cap) to about 1e-6 of cap, against
// tanhf's tens of instructions (it ran as long as the products at D = 256)
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.0f - __fdividef(2.0f, ex2(x * (2.0f * kLog2e)) + 1.0f);
}

// x clamped to [lo, hi], as int
__device__ __forceinline__ int clamp_to(int64_t x, int lo, int hi) {
  return x < lo ? lo : x > hi ? hi : (int)x;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(valid ? 4 : 0));
}

constexpr int kBwdStages = 2;  // the backward's cp.async rings

// Shared memory of a dK/dV block of WARPS warps: K and V of its BN keys,
// then a ring of kBwdStages query tiles (Q and dO rows of BM, then BM lse and
// BM delta); rows of DMAX bf16 padded by 16 bytes. At the end of a walk
// the float32 sums are staged from 0 in rows of kAccRow floats for the
// cluster's reduction: dK then dV (one pass), or the pass's one (two
// passes: K and V are copied again for the second).
template <int DMAX, int WARPS, int BM, bool SPLIT>
struct DkdvSmem {
  static constexpr int NT = 32 * WARPS;
  static constexpr int BN = 16 * WARPS;  // keys: 16 a warp
  static constexpr int kRow = DMAX * 2 + 16;
  static constexpr int kK = 0, kV = BN * kRow, kRing = 2 * BN * kRow;
  static constexpr int kStats = 2 * BM * kRow;  // within a stage
  static constexpr int kStage = kStats + 2 * BM * 4;
  static constexpr int kAccRow = DMAX + 8;
  static constexpr int kAcc = BN * kAccRow * 4;
  static constexpr int kTiles = kRing + kBwdStages * kStage;
  static constexpr int kRedEnd = (SPLIT ? 1 : 2) * kAcc;
  static constexpr int kBytes = kTiles > kRedEnd ? kTiles : kRedEnd;
  static_assert(2 * BM <= NT && BM % 16 == 0, "tile shape");
  static_assert((BN * DMAX / 8) % NT == 0 && (BM * DMAX / 8) % NT == 0, "copies");
};

// What a dK/dV block walks: batch, kv head, first key; the query tiles of
// each of its heads (from i_lo, q_tiles of them) times its heads (from the
// group's g0).
struct DkdvWork {
  int64_t b, kvh, k0, i_lo, q_tiles, n_items, g0;
};

// The item of head h, query rows i0.. into a ring stage: Q and dO rows
// (zeros past Sq and D), lse and delta (zeros past Sq: those rows are
// masked).
template <int DMAX, int WARPS, int BM, bool SPLIT>
__device__ __forceinline__ void dkdv_load(const BwdParams& p, const DkdvWork& w,
                                          unsigned char* smem, int stage, int64_t h,
                                          int64_t i0) {
  using SM = DkdvSmem<DMAX, WARPS, BM, SPLIT>;
  constexpr int CH = DMAX / 8;
  const int D = (int)p.D;
  unsigned char* st = smem + SM::kRing + stage * SM::kStage;
  const __nv_bfloat16* qh = static_cast<const __nv_bfloat16*>(p.q) + w.b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dh =
      static_cast<const __nv_bfloat16*>(p.dout) + w.b * p.do_sb + h * p.do_sh;
#pragma unroll
  for (int u = 0; u < BM * CH / SM::NT; ++u) {
    const int c = threadIdx.x + u * SM::NT, row = c / CH, ch = c % CH;
    const bool valid = i0 + row < p.Sq && ch * 8 < D;
    cp_async16(st + row * SM::kRow + ch * 16, valid ? qh + (i0 + row) * p.q_ss + ch * 8 : qh,
               valid);
    cp_async16(st + (BM + row) * SM::kRow + ch * 16,
               valid ? dh + (i0 + row) * p.do_ss + ch * 8 : dh, valid);
  }
  if (threadIdx.x < 2 * BM) {
    const int row = threadIdx.x % BM;
    const bool valid = i0 + row < p.Sq;
    const float* src = (threadIdx.x < BM ? p.lse : p.delta) +
                       (w.b * p.Hkv * p.group + h) * p.Sq + (valid ? i0 + row : 0);
    cp_async4(st + SM::kStats + threadIdx.x * 4, src, valid);
  }
}

// The block's walk over its items, adding this warp's 16 keys' dV (DV)
// and dK (DK, without sm_scale) into the accumulators. K and V must be in
// flight (or in place) before; every copy has landed and every warp is
// done with shared memory when it returns.
template <int DMAX, int WARPS, int BM, bool SPLIT, bool DV, bool DK>
__device__ __forceinline__ void dkdv_walk(const BwdParams& p, const DkdvWork& w,
                                          unsigned char* smem, float (&dv)[DMAX / 8][4],
                                          float (&dk)[DMAX / 8][4]) {
  using SM = DkdvSmem<DMAX, WARPS, BM, SPLIT>;
  constexpr int BN = SM::BN;
  constexpr int KD = DMAX / 16;  // k-steps of S^T and dP^T
  constexpr int NQ = BM / 8;     // their n-tiles (queries)
  constexpr int KQ = BM / 16;    // k-steps of the dV and dK products
  constexpr int ND = DMAX / 8;   // their n-tiles
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int D = (int)p.D;
  const float cap = p.softcap, inv_cap = cap > 0.0f ? 1.0f / cap : 0.0f;
  // this lane's ldmatrix rows: the warp's 16 K (V) rows as A; a stage's Q
  // (dO) rows as B, as they are (S^T, dP^T) or transposed (dV, dK)
  const uint32_t base = smem_u32(smem);
  const uint32_t a_addr = base + (warp * 16 + (mi & 1) * 8 + mr) * SM::kRow + (mi >> 1) * 16;
  const uint32_t b_addr = base + SM::kRing + ((mi >> 1) * 8 + mr) * SM::kRow + (mi & 1) * 16;
  const uint32_t t_addr = base + SM::kRing + ((mi & 1) * 8 + mr) * SM::kRow + (mi >> 1) * 16;
  const int k_row = warp * 16 + gid;  // this thread's keys: k0 + k_row (+ 8)

  // items in order: the query tiles of head g0, then of g0 + 1, ...
  int64_t ld_h = w.kvh * p.group + w.g0, ld_i0 = w.i_lo, i0 = w.i_lo;
  const int64_t i_end = w.i_lo + w.q_tiles * BM;
  auto load_next = [&](int stage) {
    dkdv_load<DMAX, WARPS, BM, SPLIT>(p, w, smem, stage, ld_h, ld_i0);
    ld_i0 += BM;
    if (ld_i0 == i_end) {
      ld_i0 = w.i_lo;
      ++ld_h;
    }
  };
#pragma unroll
  for (int st = 0; st < kBwdStages - 1; ++st) {  // one group an item; the first also holds K, V
    if (st < w.n_items) load_next(st);
    cp_async_commit();
  }
  int stage = 0;
  for (int64_t t = 0; t < w.n_items; ++t) {
    cp_async_wait<kBwdStages - 2>();
    __syncthreads();  // item t landed for every thread; every warp is done with item t - 1
    if (t + kBwdStages - 1 < w.n_items) load_next(stage == 0 ? kBwdStages - 1 : stage - 1);
    cp_async_commit();
    const uint32_t so = stage * SM::kStage;
    const float* stats = reinterpret_cast<const float*>(smem + SM::kRing + so + SM::kStats);

    // S^T = K Q^T (and dP^T = V dO^T, interleaved: twice the independent
    // products in flight) over the k-steps that hold some of D
    float s[NQ][4];
    [[maybe_unused]] float dp[DK ? NQ : 1][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      if constexpr (DK) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (kk * 16 >= D) break;
      uint32_t a[4], av[4];
      ldmatrix_x4(a, a_addr + SM::kK + kk * 32);
      if constexpr (DK) ldmatrix_x4(av, a_addr + SM::kV + kk * 32);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t bq[4];
        ldmatrix_x4(bq, b_addr + so + np * 16 * SM::kRow + kk * 32);
        mma_bf16(s[2 * np], a, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], a, bq[2], bq[3]);
        if constexpr (DK) {
          uint32_t bd[4];
          ldmatrix_x4(bd, b_addr + so + (BM + np * 16) * SM::kRow + kk * 32);
          mma_bf16(dp[2 * np], av, bd[0], bd[1]);
          mma_bf16(dp[2 * np + 1], av, bd[2], bd[3]);
        }
      }
    }

    // P^T = exp(s_c - lse), 0 where masked (per element only in a tile that
    // some pair cannot see: uniform over the block); dS^T = P^T (dP^T -
    // delta), times 1 - (s_c / cap)^2 under a soft-cap. Element (j, e) is
    // key k0 + k_row + 8 (e >> 1), query i0 + 8 j + 2 tig + (e & 1).
    const int64_t pos0 = i0 + p.q_offset;
    const bool whole = w.k0 + BN <= p.Sk && i0 + BM <= p.Sq &&
                       (!p.causal || pos0 >= w.k0 + BN - 1) &&
                       (p.window <= 0 || w.k0 > pos0 + BM - 1 - p.window);
    // else a pair (key row kr, query column qc) of the tile is visible iff
    // qc < lim_q, kr < lim_k and lo < kr - qc <= hi (bounds clamped to the
    // tile's range, so int suffices)
    int lim_q = BM, lim_k = BN, hi = BN, lo = -BM - 1;
    if (!whole) {
      lim_q = clamp_to(p.Sq - i0, 0, BM);
      lim_k = clamp_to(p.Sk - w.k0, 0, BN);
      const int64_t diag = pos0 - w.k0;  // causal: key <= position, kr - qc <= diag
      if (p.causal) hi = clamp_to(diag, -BM - 1, BN);
      if (p.window > 0) lo = clamp_to(diag - p.window, -BM - 1, BN);  // key > position - window
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 lse = *reinterpret_cast<const float2*>(stats + 8 * j + 2 * tig);
      const float2 dl = *reinterpret_cast<const float2*>(stats + BM + 8 * j + 2 * tig);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float u = s[j][e] * p.sm_scale, dcap = 1.0f;
        if (cap > 0.0f) {
          const float th = tanh_fast(u * inv_cap);
          u = cap * th;
          dcap = 1.0f - th * th;
        }
        float pr = ex2(fmaf(u, kLog2e, -(e & 1 ? lse.y : lse.x) * kLog2e));
        if (!whole) {
          const int qc = 8 * j + 2 * tig + (e & 1), kr = k_row + 8 * (e >> 1);
          if (!(qc < lim_q && kr < lim_k && kr - qc <= hi && kr - qc > lo)) pr = 0.0f;
        }
        s[j][e] = pr;
        if constexpr (DK) dp[j][e] = pr * (dp[j][e] - (e & 1 ? dl.y : dl.x)) * dcap;
      }
    }

    // dV += P^T dO (p rounded to bf16), dK += dS^T Q (dS rounded to bf16):
    // n-tiles 2 kq and 2 kq + 1 of the accumulator are the A fragment of
    // k-step kq
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      if constexpr (DV) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kq][0], s[2 * kq][1]);
        a[1] = pack_bf16(s[2 * kq][2], s[2 * kq][3]);
        a[2] = pack_bf16(s[2 * kq + 1][0], s[2 * kq + 1][1]);
        a[3] = pack_bf16(s[2 * kq + 1][2], s[2 * kq + 1][3]);
#pragma unroll
        for (int dp2 = 0; dp2 < ND / 2; ++dp2) {
          if (dp2 * 16 >= D) break;
          uint32_t bt[4];
          ldmatrix_x4_trans(bt, t_addr + so + (BM + kq * 16) * SM::kRow + dp2 * 32);
          mma_bf16(dv[2 * dp2], a, bt[0], bt[1]);
          mma_bf16(dv[2 * dp2 + 1], a, bt[2], bt[3]);
        }
      }
      if constexpr (DK) {
        uint32_t a[4];
        a[0] = pack_bf16(dp[2 * kq][0], dp[2 * kq][1]);
        a[1] = pack_bf16(dp[2 * kq][2], dp[2 * kq][3]);
        a[2] = pack_bf16(dp[2 * kq + 1][0], dp[2 * kq + 1][1]);
        a[3] = pack_bf16(dp[2 * kq + 1][2], dp[2 * kq + 1][3]);
#pragma unroll
        for (int dp2 = 0; dp2 < ND / 2; ++dp2) {
          if (dp2 * 16 >= D) break;
          uint32_t bt[4];
          ldmatrix_x4_trans(bt, t_addr + so + kq * 16 * SM::kRow + dp2 * 32);
          mma_bf16(dk[2 * dp2], a, bt[0], bt[1]);
          mma_bf16(dk[2 * dp2 + 1], a, bt[2], bt[3]);
        }
      }
    }
    stage = stage == kBwdStages - 1 ? 0 : stage + 1;
    i0 = i0 + BM == i_end ? w.i_lo : i0 + BM;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// This warp's accumulator (16 keys x DMAX) into staged rows of ACC floats.
template <int DMAX, int ACC>
__device__ __forceinline__ void stage_acc(float* red, const float (&acc)[DMAX / 8][4]) {
  const int lane = threadIdx.x & 31;
  float* row = red + ((threadIdx.x >> 5) * 16 + (lane >> 2)) * ACC + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    *reinterpret_cast<float2*>(row + 8 * j) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(row + 8 * ACC + 8 * j) = make_float2(acc[j][2], acc[j][3]);
  }
}

// The cluster's staged sums (one per block, at `red` in each) added in rank
// order; this block writes its slice of the tile's BN rows, times scale,
// as bf16 to out (key rows of stride ss, D contiguous).
template <int DMAX, int ACC, int BN, int NT>
__device__ __forceinline__ void reduce_rows(cg::cluster_group& cluster, float* red,
                                            int64_t k0, int64_t Sk, int D,
                                            __nv_bfloat16* out, int64_t ss, float scale) {
  constexpr int C4 = DMAX / 4;
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int per = (BN + c - 1) / c, lo = rank * per, hi = lo + per < BN ? lo + per : BN;
  for (int u = threadIdx.x; u < (hi - lo) * C4; u += NT) {
    const int row = lo + u / C4, col = u % C4 * 4;
    if (k0 + row >= Sk || col >= D) continue;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = 0; q < c; ++q) {
      const float4 x =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) + row * ACC + col);
      acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
    }
    const __nv_bfloat162 lo2 = __floats2bfloat162_rn(acc.x * scale, acc.y * scale);
    const __nv_bfloat162 hi2 = __floats2bfloat162_rn(acc.z * scale, acc.w * scale);
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo2);
    v.y = *reinterpret_cast<const uint32_t*>(&hi2);
    *reinterpret_cast<uint2*>(out + (k0 + row) * ss + col) = v;
  }
}

// Block (rank in the cluster, (batch, kv head), key tile): dK and dV of
// keys k0 .. k0 + BN over heads_per_block heads of the group from rank *
// heads_per_block; the cluster's blocks share the tile and sum the group.
template <int DMAX, int WARPS, int BM, bool SPLIT, int MIN_BLOCKS>
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS)
bwd_dkdv_mma_kernel(const BwdParams p, int heads_per_block) {
  using SM = DkdvSmem<DMAX, WARPS, BM, SPLIT>;
  constexpr int BN = SM::BN, NT = SM::NT, CH = DMAX / 8, ND = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int D = (int)p.D;
  DkdvWork w;
  w.b = blockIdx.y / p.Hkv;
  w.kvh = blockIdx.y % p.Hkv;
  w.k0 = (int64_t)blockIdx.z * BN;
  w.g0 = (int64_t)cluster.block_rank() * heads_per_block;

  // K and V of the tile (zeros past Sk and D), in the ring's first group
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + w.b * p.k_sb + w.kvh * p.k_sh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + w.b * p.v_sb + w.kvh * p.v_sh;
  auto load_kv = [&]() {
#pragma unroll
    for (int u = 0; u < BN * CH / NT; ++u) {
      const int c = threadIdx.x + u * NT, row = c / CH, ch = c % CH;
      const bool valid = w.k0 + row < p.Sk && ch * 8 < D;
      const int at = row * SM::kRow + ch * 16;
      cp_async16(smem + SM::kK + at, valid ? kb + (w.k0 + row) * p.k_ss + ch * 8 : kb, valid);
      cp_async16(smem + SM::kV + at, valid ? vb + (w.k0 + row) * p.v_ss + ch * 8 : vb, valid);
    }
  };
  load_kv();

  // the query rows that can see some key of the tile
  const int64_t k_last = (w.k0 + BN < p.Sk ? w.k0 + BN : p.Sk) - 1;
  int64_t i_lo = 0, i_hi = p.Sq;
  if (p.causal && w.k0 - p.q_offset > i_lo) i_lo = w.k0 - p.q_offset;
  if (p.window > 0 && k_last + p.window - p.q_offset < i_hi) i_hi = k_last + p.window - p.q_offset;
  w.i_lo = i_lo;
  w.q_tiles = i_hi > i_lo ? (i_hi - i_lo + BM - 1) / BM : 0;
  w.n_items = w.q_tiles * heads_per_block;

  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(p.dk) + w.b * p.dk_sb + w.kvh * p.dk_sh;
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(p.dv) + w.b * p.dv_sb + w.kvh * p.dv_sh;
  float* red = reinterpret_cast<float*>(smem);
  if constexpr (SPLIT) {  // dV, then dK: one accumulator at a time
    {
      float acc[ND][4];
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      dkdv_walk<DMAX, WARPS, BM, SPLIT, true, false>(p, w, smem, acc, acc);
      stage_acc<DMAX, SM::kAccRow>(red, acc);
    }
    cluster.sync();
    reduce_rows<DMAX, SM::kAccRow, BN, NT>(cluster, red, w.k0, p.Sk, D, dvb, p.dv_ss, 1.0f);
    cluster.sync();  // every block is done reading what K and V overwrite
    load_kv();
    {
      float acc[ND][4];
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
      dkdv_walk<DMAX, WARPS, BM, SPLIT, false, true>(p, w, smem, acc, acc);
      stage_acc<DMAX, SM::kAccRow>(red, acc);
    }
    cluster.sync();
    reduce_rows<DMAX, SM::kAccRow, BN, NT>(cluster, red, w.k0, p.Sk, D, dkb, p.dk_ss,
                                           p.sm_scale);
  } else {
    float dv[ND][4], dk[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.0f;
      dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.0f;
    }
    dkdv_walk<DMAX, WARPS, BM, SPLIT, true, true>(p, w, smem, dv, dk);
    stage_acc<DMAX, SM::kAccRow>(red, dk);
    stage_acc<DMAX, SM::kAccRow>(red + SM::kAcc / 4, dv);
    cluster.sync();
    reduce_rows<DMAX, SM::kAccRow, BN, NT>(cluster, red, w.k0, p.Sk, D, dkb, p.dk_ss,
                                           p.sm_scale);
    reduce_rows<DMAX, SM::kAccRow, BN, NT>(cluster, red + SM::kAcc / 4, w.k0, p.Sk, D, dvb,
                                           p.dv_ss, 1.0f);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// Shared memory of a dQ block of WARPS warps: Q and dO of its BM rows, then
// a ring of kBwdStages key tiles (K and V rows of BN); rows of DMAX bf16
// padded by 16 bytes.
template <int DMAX, int WARPS, int BN>
struct DqSmem {
  static constexpr int NT = 32 * WARPS;
  static constexpr int BM = 16 * WARPS;  // rows: 16 a warp
  static constexpr int kRow = DMAX * 2 + 16;
  static constexpr int kQ = 0, kDO = BM * kRow, kRing = 2 * BM * kRow;
  static constexpr int kStage = 2 * BN * kRow;
  static constexpr int kBytes = kRing + kBwdStages * kStage;
  static_assert(BN % 16 == 0, "tile shape");
  static_assert((BN * DMAX / 8) % NT == 0 && (BM * DMAX / 8) % NT == 0, "copies");
};

// Block ((batch, kv head) pair fastest, then row tile, the last first): dQ
// of the BM rows r0.. of (batch, kv head), rows r = i * group + g as in the
// forward.
template <int DMAX, int WARPS, int BN, int MIN_BLOCKS>
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS)
bwd_dq_mma_kernel(const BwdParams p) {
  using SM = DqSmem<DMAX, WARPS, BN>;
  constexpr int BM = SM::BM, NT = SM::NT;
  constexpr int KD = DMAX / 16;  // k-steps of S and dP
  constexpr int NS = BN / 8;     // their n-tiles (keys)
  constexpr int KP = BN / 16;    // k-steps of dQ += dS K
  constexpr int ND = DMAX / 8;   // its n-tiles
  constexpr int CH = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int64_t pairs = p.B * p.Hkv;
  const int64_t b = blockIdx.x % pairs / p.Hkv, kvh = blockIdx.x % p.Hkv;
  const int64_t group = p.group, R = p.Sq * group, hq = p.Hkv * group;
  const int64_t row_tiles = (R + BM - 1) / BM;
  const int64_t r0 = (row_tiles - 1 - (int64_t)blockIdx.x / pairs) * BM;
  const int64_t r_last = (r0 + BM < R ? r0 + BM : R) - 1;
  const int64_t pos_lo = r0 / group + p.q_offset, pos_hi = r_last / group + p.q_offset;
  int64_t k_begin = 0, k_end = p.Sk;
  if (p.causal && pos_hi + 1 < k_end) k_end = pos_hi + 1;
  if (p.window > 0 && pos_lo - p.window + 1 > k_begin) k_begin = pos_lo - p.window + 1;
  const int n_tiles = k_end > k_begin ? (int)((k_end - k_begin + BN - 1) / BN) : 0;
  const int D = (int)p.D;
  const float cap = p.softcap, inv_cap = cap > 0.0f ? 1.0f / cap : 0.0f;
  // The loop keeps keys relative to k_begin, as int (Sk < 2^30): a tile's
  // first key is k_begin + t BN, and every row sees the whole tile iff
  // w_lo < t BN <= w_hi (bounds clamped to [-1, k_end_rel], exact there)
  const int k_end_rel = (int)(k_end - k_begin);
  const int64_t c_hi = p.causal && pos_lo + 1 < k_end ? pos_lo + 1 - BN : k_end - BN;
  const int w_hi = clamp_to(c_hi - k_begin, -1, k_end_rel);
  const int w_lo = p.window > 0 ? clamp_to(pos_hi - p.window - k_begin, -1, k_end_rel) : -1;

  // Q and dO of the rows (zeros past R and D), in the ring's first group
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb;
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb;
#pragma unroll
  for (int u = 0; u < BM * CH / NT; ++u) {
    const int c = tid + u * NT, row = c / CH, ch = c % CH;
    const int64_t r = r0 + row;
    const bool valid = r < R && ch * 8 < D;
    int64_t oq = 0, od = 0;
    if (valid) {
      const int64_t i = r / group, h = kvh * group + r % group;
      oq = h * p.q_sh + i * p.q_ss + ch * 8;
      od = h * p.do_sh + i * p.do_ss + ch * 8;
    }
    cp_async16(smem + SM::kQ + row * SM::kRow + ch * 16, qb + oq, valid);
    cp_async16(smem + SM::kDO + row * SM::kRow + ch * 16, dob + od, valid);
  }
  // K and V from key k_begin on
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh + k_begin * p.k_ss;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh + k_begin * p.v_ss;
  auto load_tile = [&](int stage, int t0) {  // keys k_begin + t0.. (zeros past k_end, D)
    unsigned char* st = smem + SM::kRing + stage * SM::kStage;
#pragma unroll
    for (int u = 0; u < BN * CH / NT; ++u) {
      const int c = tid + u * NT, row = c / CH, ch = c % CH;
      const bool valid = t0 + row < k_end_rel && ch * 8 < D;
      const int64_t key = t0 + row;
      cp_async16(st + row * SM::kRow + ch * 16, valid ? kb + key * p.k_ss + ch * 8 : kb, valid);
      cp_async16(st + (BN + row) * SM::kRow + ch * 16, valid ? vb + key * p.v_ss + ch * 8 : vb,
                 valid);
    }
  };
#pragma unroll
  for (int st = 0; st < kBwdStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st * BN);
    cp_async_commit();
  }

  // this thread's rows r0 + 16 warp + gid (+ 8): the keys each sees, k_begin
  // + (r_lo, r_hi] (bounds clamped to [-1, k_end_rel], which keeps them
  // exact there), lse (log2 units), delta
  int r_hi[2], r_lo[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t r = r0 + warp * 16 + gid + 8 * hh;
    const bool valid = r < R;
    const int64_t i = valid ? r / group : 0, h = kvh * group + (valid ? r % group : 0);
    const int64_t rel = i + p.q_offset - k_begin;  // the row's position less k_begin
    r_hi[hh] = clamp_to(!valid ? -1 : p.causal ? rel : k_end_rel, -1, k_end_rel);
    r_lo[hh] = clamp_to(p.window > 0 ? rel - p.window : -1, -1, k_end_rel);
    lse2[hh] = valid ? p.lse[(b * hq + h) * p.Sq + i] * kLog2e : 0.0f;
    dlt[hh] = valid ? p.delta[(b * hq + h) * p.Sq + i] : 0.0f;
  }
  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.0f;
  const uint32_t base = smem_u32(smem);
  const uint32_t a_addr = base + (warp * 16 + (mi & 1) * 8 + mr) * SM::kRow + (mi >> 1) * 16;
  const uint32_t b_addr = base + SM::kRing + ((mi >> 1) * 8 + mr) * SM::kRow + (mi & 1) * 16;
  const uint32_t t_addr = base + SM::kRing + ((mi & 1) * 8 + mr) * SM::kRow + (mi >> 1) * 16;

  int stage = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * BN;  // relative to k_begin
    cp_async_wait<kBwdStages - 2>();
    __syncthreads();  // tile t (and Q, dO) landed; every warp is done with tile t - 1
    if (t + kBwdStages - 1 < n_tiles)
      load_tile(stage == 0 ? kBwdStages - 1 : stage - 1, t0 + (kBwdStages - 1) * BN);
    cp_async_commit();
    const uint32_t so = stage * SM::kStage;

    // S = Q K^T and dP = dO V^T, interleaved, over the k-steps that hold
    // some of D
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (kk * 16 >= D) break;
      uint32_t a[4], ad[4];
      ldmatrix_x4(a, a_addr + SM::kQ + kk * 32);
      ldmatrix_x4(ad, a_addr + SM::kDO + kk * 32);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, b_addr + so + np * 16 * SM::kRow + kk * 32);
        ldmatrix_x4(bv, b_addr + so + (BN + np * 16) * SM::kRow + kk * 32);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        mma_bf16(dp[2 * np], ad, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ad, bv[2], bv[3]);
      }
    }

    // dS = p (dP - delta) (times the cap's derivative), p = exp(s_c - lse)
    // and 0 where masked; element (j, e) is row gid + 8 (e >> 1), key
    // k_begin + t0 + kc, kc = 8 j + 2 tig + (e & 1)
    const bool whole = t0 > w_lo && t0 <= w_hi;
    // else row hh sees kc iff kc < lim_k and lo[hh] < kc <= hi[hh] (bounds
    // clamped to the tile's range)
    int lim_k = BN, hi[2] = {BN, BN}, lo[2] = {-1, -1};
    if (!whole) {
      lim_k = k_end_rel - t0 < BN ? k_end_rel - t0 : BN;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        hi[hh] = clamp_to(r_hi[hh] - t0, -1, BN);
        lo[hh] = clamp_to(r_lo[hh] - t0, -1, BN);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float u = s[j][e] * p.sm_scale, dcap = 1.0f;
        if (cap > 0.0f) {
          const float th = tanh_fast(u * inv_cap);
          u = cap * th;
          dcap = 1.0f - th * th;
        }
        float pr = ex2(fmaf(u, kLog2e, -lse2[hh]));
        if (!whole) {
          const int kc = 8 * j + 2 * tig + (e & 1);
          if (!(kc < lim_k && kc <= hi[hh] && kc > lo[hh])) pr = 0.0f;
        }
        dp[j][e] = pr * (dp[j][e] - dlt[hh]) * dcap;
      }

    // dQ += dS K, dS rounded to bf16: S's n-tiles 2 kk and 2 kk + 1 are the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      a[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      a[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      a[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int dp2 = 0; dp2 < ND / 2; ++dp2) {
        if (dp2 * 16 >= D) break;
        uint32_t bt[4];
        ldmatrix_x4_trans(bt, t_addr + so + kk * 16 * SM::kRow + dp2 * 32);
        mma_bf16(dq[2 * dp2], a, bt[0], bt[1]);
        mma_bf16(dq[2 * dp2 + 1], a, bt[2], bt[3]);
      }
    }
    stage = stage == kBwdStages - 1 ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t r = r0 + warp * 16 + gid + 8 * hh;
    if (r >= R) continue;
    const int64_t i = r / group, h = kvh * group + r % group;
    __nv_bfloat16* dst = dqb + h * p.dq_sh + i * p.dq_ss + 2 * tig;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      if (j * 8 + 2 * tig < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(
            dq[j][2 * hh] * p.sm_scale, dq[j][2 * hh + 1] * p.sm_scale);
  }
}

// The dK/dV kernel's launch: a cluster of c blocks shares each key tile;
// grid (c, B * Hkv, key tiles), the first key tiles first.
template <int DMAX, int WARPS, int BM, bool SPLIT, int MIN_BLOCKS>
int launch_dkdv_mma(const BwdParams& p, cudaStream_t stream) {
  using SM = DkdvSmem<DMAX, WARPS, BM, SPLIT>;
  auto kernel = bwd_dkdv_mma_kernel<DMAX, WARPS, BM, SPLIT, MIN_BLOCKS>;
  static const int configured = configure(kernel, SM::kBytes);
  if (configured != 0) return configured;
  const int64_t tiles = (p.Sk + SM::BN - 1) / SM::BN;
  if (tiles > 65535 || p.B * p.Hkv > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(SM::NT);
  cfg.dynamicSmemBytes = SM::kBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int c = 8;  // the largest divisor of the group up to 8, the portable cluster size
  while (p.group % c != 0) --c;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(c, (unsigned)(p.B * p.Hkv), (unsigned)tiles);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p, (int)(p.group / c));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <int DMAX, int WARPS, int BN, int MIN_BLOCKS>
int launch_dq_mma(const BwdParams& p, cudaStream_t stream) {
  using SM = DqSmem<DMAX, WARPS, BN>;
  auto kernel = bwd_dq_mma_kernel<DMAX, WARPS, BN, MIN_BLOCKS>;
  static const int configured = configure(kernel, SM::kBytes);
  if (configured != 0) return configured;
  if (p.Sk >= (int64_t)1 << 30) return (int)cudaErrorInvalidValue;  // keys kept as int
  const int64_t blocks = (p.Sq * p.group + SM::BM - 1) / SM::BM * p.B * p.Hkv;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, SM::NT, SM::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// Launches of one backward kernel at the instance for the type and D: bf16
// on the tensor cores (dK/dV in two passes at D = 256; dQ over 32-key tiles
// there), float32 on the SIMT kernels (dK/dV over key tiles, dQ over query
// tiles).
struct LaunchDkdv {
  template <typename T, int DMAX>
  static int run(const BwdParams& p, cudaStream_t stream) {
    if constexpr (sizeof(T) == 2) {
      if constexpr (DMAX == 256) return launch_dkdv_mma<DMAX, 8, 32, true, 1>(p, stream);
      else if constexpr (DMAX == 128) return launch_dkdv_mma<DMAX, 4, 16, false, 3>(p, stream);
      else return launch_dkdv_mma<DMAX, 4, 64, false, 2>(p, stream);
    } else {
      using C = Bwd<DMAX>;
      static const int configured = configure(bwd_dkdv_kernel<T, DMAX>, C::kBytes);
      if (configured != 0) return configured;
      const int64_t tiles = (p.Sk + C::BN - 1) / C::BN;
      if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
      dim3 grid((unsigned)tiles, (unsigned)p.Hkv, (unsigned)p.B);
      bwd_dkdv_kernel<T, DMAX><<<grid, kThreads, C::kBytes, stream>>>(p);
      return (int)cudaGetLastError();
    }
  }
};
struct LaunchDq {
  template <typename T, int DMAX>
  static int run(const BwdParams& p, cudaStream_t stream) {
    if constexpr (sizeof(T) == 2) {
      if constexpr (DMAX == 256) return launch_dq_mma<DMAX, 8, 32, 1>(p, stream);
      else if constexpr (DMAX == 128) return launch_dq_mma<DMAX, 4, 32, 3>(p, stream);
      else return launch_dq_mma<DMAX, 4, 64, 2>(p, stream);
    } else {
      using C = Bwd<DMAX>;
      static const int configured = configure(bwd_dq_kernel<T, DMAX>, C::kBytes);
      if (configured != 0) return configured;
      const int64_t tiles = (p.Sq + C::BM - 1) / C::BM;
      if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
      dim3 grid((unsigned)tiles, (unsigned)(p.Hkv * p.group), (unsigned)p.B);
      bwd_dq_kernel<T, DMAX><<<grid, kThreads, C::kBytes, stream>>>(p);
      return (int)cudaGetLastError();
    }
  }
};

template <typename L, typename T>
int launch_bwd_t(const BwdParams& p, cudaStream_t stream) {
  if (p.D <= 64) return L::template run<T, 64>(p, stream);
  if (p.D <= 128) return L::template run<T, 128>(p, stream);
  return L::template run<T, 256>(p, stream);
}

template <typename L>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int64_t B, int64_t Hq,
               int64_t Hkv, int64_t Sq, int64_t Sk, int64_t D, const int64_t* st, int64_t causal,
               int64_t window, int64_t q_offset, float softcap, float sm_scale, int64_t dtype,
               void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > 256 || D % 8 != 0 || B > 65535 ||
      Hq > 65535 || (dtype != 0 && dtype != 1) || lse == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  const int64_t vec = dtype == 0 ? 4 : 8;
  if (!aligned(q, st[0], st[1], st[2], vec) || !aligned(k, st[3], st[4], st[5], vec) ||
      !aligned(v, st[6], st[7], st[8], vec) || !aligned(dout, st[9], st[10], st[11], vec) ||
      !aligned(dq, st[12], st[13], st[14], vec) || !aligned(dk, st[15], st[16], st[17], vec) ||
      !aligned(dv, st[18], st[19], st[20], vec))
    return (int)cudaErrorInvalidValue;
  BwdParams p{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
              dq, dk, dv, B, Hkv, Sq, Sk, D, Hq / Hkv,
              st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
              st[12], st[13], st[14], st[15], st[16], st[17], st[18], st[19], st[20],
              q_offset, window, causal != 0 ? 1 : 0, softcap, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd_t<L, float>(p, s);
  return launch_bwd_t<L, __nv_bfloat16>(p, s);
}

}  // namespace

// q, k, v, o: device pointers; strides in elements, (batch, head, position)
// each, D contiguous. window <= 0: none; softcap <= 0: none. dtype: 0
// float32, 1 bfloat16. n_splits > 1 (decode only: Sq * Hq / Hkv <= 8)
// writes float32 partials to part, n_splits * B * Hkv * Sq * (Hq / Hkv) *
// (D + 2) of them, for flash_attention_combine_launch to merge into o.
// lse: null, or float32 (B, Hq, Sq) contiguous for the rows' log-sum-exp
// (one split only). Returns a cudaError_t; Sq == 0 launches nothing.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* part, void* lse, int64_t B,
    int64_t Hq, int64_t Hkv, int64_t Sq, int64_t Sk, int64_t D, int64_t q_sb, int64_t q_sh,
    int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t o_sb, int64_t o_sh, int64_t o_ss, int64_t causal, int64_t window,
    int64_t q_offset, int64_t n_splits, float softcap, float sm_scale, int64_t dtype,
    void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk < 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      B > 65535 || Hkv > 65535 || (dtype != 0 && dtype != 1) || n_splits < 1 ||
      (n_splits > 1 && (Sq * (Hq / Hkv) > kDecodeRows || part == nullptr || lse != nullptr)))
    return (int)cudaErrorInvalidValue;
  const int64_t vec = dtype == 0 ? 4 : 8;
  if (!aligned(q, q_sb, q_sh, q_ss, vec) || !aligned(k, k_sb, k_sh, k_ss, vec) ||
      !aligned(v, v_sb, v_sh, v_ss, vec) || !aligned(o, o_sb, o_sh, o_ss, 4) ||
      (uintptr_t)part % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, static_cast<float*>(part), static_cast<float*>(lse), B, Hkv, Sq, Sk, D,
           Hq / Hkv, n_splits,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           q_offset, window, causal != 0 ? 1 : 0, softcap, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float>(p, s);
  return launch_t<__nv_bfloat16>(p, s);
}

// Merges the n_splits partials that flash_attention_launch wrote to part
// into o (strides in elements, D contiguous), in o's dtype (0 float32, 1
// bfloat16). Returns a cudaError_t.
extern "C" int flash_attention_combine_launch(const void* part, void* o, int64_t B, int64_t Hq,
                                              int64_t Hkv, int64_t Sq, int64_t D,
                                              int64_t n_splits, int64_t o_sb, int64_t o_sh,
                                              int64_t o_ss, int64_t dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || n_splits < 2 || part == nullptr ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int64_t group = Hq / Hkv, R = Sq * group;
  const int64_t blocks = B * Hkv * R;  // one a row
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(part);
  if (dtype == 0)
    combine_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        pf, static_cast<float*>(o), B, Hkv, group, R, D, n_splits, o_sb, o_sh, o_ss);
  else
    combine_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        pf, static_cast<__nv_bfloat16*>(o), B, Hkv, group, R, D, n_splits, o_sb, o_sh, o_ss);
  return (int)cudaGetLastError();
}

#define FA_BWD_ARGS                                                                              \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,               \
      const void *delta, void *dq, void *dk, void *dv, int64_t B, int64_t Hq, int64_t Hkv,      \
      int64_t Sq, int64_t Sk, int64_t D, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, \
      int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t do_sb,       \
      int64_t do_sh, int64_t do_ss, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss, int64_t dk_sb,  \
      int64_t dk_sh, int64_t dk_ss, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss, int64_t causal, \
      int64_t window, int64_t q_offset, float softcap, float sm_scale, int64_t dtype, void *stream
#define FA_BWD_STRIDES                                                                         \
  {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss,                  \
   dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss}

// The backward's two big launches. Both take the same arguments: q, k, v
// and dout as the forward took q, k, v (dout like q), the forward's lse and
// the delta of flash_attention_bwd_delta_launch (float32 (B, Hq, Sq)
// contiguous), and dq (like q), dk and dv (like k); strides in elements, D
// contiguous, rows 16-byte aligned. dkdv writes dk and dv, dq writes dq:
// bf16 (dtype 1) on the tensor cores, float32 (dtype 0) with float32 FMAs;
// neither falls back to the other. Sq == 0 or Sk == 0 launches nothing.
// Returns a cudaError_t.
extern "C" int flash_attention_bwd_dkdv_launch(FA_BWD_ARGS) {
  const int64_t st[21] = FA_BWD_STRIDES;
  return launch_bwd<LaunchDkdv>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk, D, st,
                                causal, window, q_offset, softcap, sm_scale, dtype, stream);
}

extern "C" int flash_attention_bwd_dq_launch(FA_BWD_ARGS) {
  const int64_t st[21] = FA_BWD_STRIDES;
  return launch_bwd<LaunchDq>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, Sq, Sk, D, st,
                              causal, window, q_offset, softcap, sm_scale, dtype, stream);
}

// delta (B, Hq, Sq) float32 contiguous = rowsum(dout * o) of the forward's
// output o and its gradient dout (strides in elements, D contiguous; dtype 0
// float32, 1 bfloat16). Returns a cudaError_t; Sq == 0 launches nothing.
extern "C" int flash_attention_bwd_delta_launch(const void* o, const void* dout, void* delta,
                                                int64_t B, int64_t Hq, int64_t Sq, int64_t D,
                                                int64_t o_sb, int64_t o_sh, int64_t o_ss,
                                                int64_t d_sb, int64_t d_sh, int64_t d_ss,
                                                int64_t dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (D <= 0 || (dtype != 0 && dtype != 1) || delta == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t rows = B * Hq * Sq;
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    bwd_delta_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), dl, Hq, Sq, D, rows, o_sb,
        o_sh, o_ss, d_sb, d_sh, d_ss);
  else
    bwd_delta_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), dl, Hq, Sq,
        D, rows, o_sb, o_sh, o_ss, d_sb, d_sh, d_ss);
  return (int)cudaGetLastError();
}
