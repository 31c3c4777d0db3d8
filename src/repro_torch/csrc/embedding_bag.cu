// Embedding bag: the sum or mean of the table rows of each bag, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `embedding_bag` (src/repro/kernels/embedding_bag.py).
//
//   out[b, :] = sum over l with idx[b, l] >= 0 of table[idx[b, l], :]
//               (divided by max(#valid, 1) for the mean)
//
// table (V, D) float32 or bfloat16, idx (B, L) int32 or int64 (a negative
// index is padding), out (B, D) in the table's type. Rows are summed in
// float32, in the order l = 0..L-1, and rounded once to the output type.
// DLRM's single-hot lookup is this with L = 1: one launch over the B * 26
// bags of a batch, against the 26 tables concatenated into one.
//
// What bounds it: bytes. Each valid row is read once (D * 2 B in bfloat16)
// and each output row written once; the arithmetic is one add per element.
// The design gives each bag a group of `group` threads (a power of two up
// to a warp) along D, each thread moving 16 bytes at a time where D and the
// pointers allow it, so a bfloat16 row of 128 is one 256-byte sweep by 16
// threads and a warp serves two bags. Row offsets are int64: one Criteo
// table holds 48.9M rows * 128 = 6.3e9 elements, past 2^31. Any B and D
// are accepted (no block multiple); B == 0 launches nothing. An index >= V
// stops the kernel with an error instead of reading out of bounds.
//
// The same source holds DLRM training's two table kernels (the Pallas
// kernel has no backward; these are the gradient of its function and the
// SGD of the reference's table leaf, src/repro/train/optimizer.py:93):
//
// - `embedding_bag_backward_kernel`: the float32 gradient of every distinct
//   row of a batch's bags,
//     grads[s, :] = sum over (b, l) with idx[b, l] == rows[s] of grad_out[b, :]
//                   (each term divided by max(#valid_b, 1) for the mean),
//   in ascending row order, one slot a distinct row, in one launch after
//   the wrapper's stable sort of the flattened ids. What bounds it: bytes
//   (each gradient row read once, each slot written once; 794 MB a
//   train_batch step, 0.237 ms at 3.35 TB/s). What is hard: skew, and
//   latency. Criteo's small tables (3, 4, 10 rows) put 16,000-22,000 of a
//   65,536 batch's ids on one row, so a warp a distinct row would wait on
//   the longest run; instead each warp takes fixed chunks of sorted
//   positions and sums each run's piece in a chunk in sorted order, and a
//   run cut by chunk bounds is completed by the chunk that brings its last
//   piece, in chunk order. The design (kernel below): persistent warps
//   claiming chunks by a ticket; each chunk's ids and order staged by
//   cp.async one chunk ahead; run heads and slots found in the kernel
//   (ballots, and a decoupled look-back over the chunks' head counts, so
//   the host prepares no slot array); the rows gathered whole by bulk
//   copies of the tensor memory accelerator into a ring of 4 stages a
//   warp; each stage's rows loaded from the ring before any is added, and
//   its run bounds read from ballots, so a row costs one warp-wide load and
//   add. Its times at train_batch shapes, beside the first design's, are
//   launch/emb_bwd_sweep.py's and chip_smoke.py's (PERF.md). Every sum has
//   one fixed order, so the result is deterministic.
//   Padding (negative ids) sorts first and is skipped.
//   `embedding_bag_backward_two_pass_kernel` + `embedding_bag_backward_combine_kernel`
//   are the first design, kept to be timed beside it.
// - `sgd_rows_kernel`: for each slot s < n_unique, in float32,
//     master[rows[s]] -= lr * (clip * grads[s]);  table[rows[s]] = round(master[rows[s]])
//   in the reference's order of operations, each rounded (no fused
//   multiply-add), with round-to-nearest-even to the table's type as
//   `.to(bfloat16)` does. lr, clip and n_unique are read from device
//   memory, so the step needs no host read. `master` is float32 host memory
//   registered with the card (`cudaHostRegister`; under unified addressing
//   pinned and mapped at its host address), 2 MB-aligned and advised for
//   huge pages (kernels/embedding_bag.py, host_empty); every live row is
//   read and written back over PCIe, the master and the table, whatever its
//   update. What bounds it is not the bytes at the link's rate (318.6 MB
//   each way a train_batch step, 4.98 ms at 64 GB/s) but how fast the host
//   serves the card's own loads of its memory, which differs from host to
//   host: on an H100 80GB HBM3 at 700 W the read of a row took 11-12 ns
//   when rows lie 512 B apart on the fastest host measured and 17-23 ns on
//   the others, more the farther apart they lie (26-35 ns at 2 MB; the page
//   probe of launch/sgd_sweep.py); a step's rows lie about 146 KB apart in
//   the large tables. The read alone over the step's rows takes 84-94% of
//   the update's time, the write alone 66-81%; the update is held by the
//   reads. What the sweep found on the slower hosts: no launch plan (1-8
//   rows a warp with all their loads issued before any is used, up to 128
//   rows in flight an SM; a grid of every slot or a persistent one) more
//   than 4% ahead of one row a warp over every slot, none more than 9%
//   behind it; at 2-8 rows a warp a persistent grid whose blocks are all
//   resident at or below the grid of every slot; neither a cp.async.bulk
//   copy of whole rows into shared memory nor a 256-byte L2 fetch hint
//   beat plain loads, so neither is kept. On the fastest host 4 rows a warp on a persistent
//   grid took 10.9 ms against 13.2 for one row a warp over every slot. The
//   2 MB-aligned backing was 5-21% faster than torch.empty's in every
//   comparison on one host. The design: 4 rows a warp (SGD_R) on a
//   persistent grid of 4 blocks an SM, all resident (launch bounds:
//   sgd_blocks_an_sm), walking the slots below n_unique read on the card;
//   offsets in int64 (row 177,948,194 x 128 is past 2^31 elements); a row
//   outside [0, V) traps. The sweep's other counts of rows a warp and its
//   read and write halves are instances of the same kernel on a bfloat16
//   table (SGD_READ, SGD_WRITE).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

template <typename T, typename I, int VEC>
__global__ void embedding_bag_kernel(const T* __restrict__ table,
                                     const I* __restrict__ indices,
                                     T* __restrict__ out, int64_t n_bags,
                                     int64_t n_rows, int L, int D, int group,
                                     int mean) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t bag = t / group;
  if (bag >= n_bags) return;
  const int lane = (int)(t % group);
  const I* idx = indices + bag * L;
  const int chunks = D / VEC;
  for (int c = lane; c < chunks; c += group) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    int valid = 0;
    for (int l = 0; l < L; ++l) {
      const int64_t r = (int64_t)idx[l];
      if (r < 0) continue;
      if (r >= n_rows) __trap();
      ++valid;
      const Pack<T, VEC> p =
          *reinterpret_cast<const Pack<T, VEC>*>(table + r * D + (int64_t)c * VEC);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += to_f32(p.v[k]);
    }
    const float denom = (float)(valid > 1 ? valid : 1);
    Pack<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) from_f32(mean ? acc[k] / denom : acc[k], &o.v[k]);
    *reinterpret_cast<Pack<T, VEC>*>(out + bag * D + (int64_t)c * VEC) = o;
  }
}

template <typename T, typename I, int VEC>
int launch(const void* table, const void* indices, void* out, int64_t n_bags,
           int64_t n_rows, int64_t L, int64_t D, int64_t mean,
           cudaStream_t stream) {
  const int64_t chunks = D / VEC;
  int group = 1;
  while (group < chunks && group < 32) group *= 2;
  const int threads = 256;
  const int64_t blocks = (n_bags * group + threads - 1) / threads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  embedding_bag_kernel<T, I, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)table, (const I*)indices, (T*)out, n_bags, n_rows, (int)L,
      (int)D, group, (int)mean);
  return (int)cudaGetLastError();
}

template <typename T, typename I>
int launch_vec(const void* table, const void* indices, void* out,
               int64_t n_bags, int64_t n_rows, int64_t L, int64_t D,
               int64_t mean, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)table % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (aligned && D % VEC == 0)
    return launch<T, I, VEC>(table, indices, out, n_bags, n_rows, L, D, mean, stream);
  return launch<T, I, 1>(table, indices, out, n_bags, n_rows, L, D, mean, stream);
}

// ------------------------------------------------------------ backward, two passes

// The first design, kept to be timed beside the one-pass kernel (the
// wrapper's two_pass=True): the wrapper sorts the ids and gives every
// sorted position its slot (kernels/ref.py, bag_runs); then this kernel and
// the combine.


constexpr int CHUNK = 256;  // sorted positions a warp (BACKWARD_CHUNK)
constexpr int U = 8;        // gradient rows in flight a warp

template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float* v) {
  const Pack<T, VEC> q = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = to_f32(q.v[k]);
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  Pack<float, VEC> q;
#pragma unroll
  for (int k = 0; k < VEC; ++k) q.v[k] = v[k];
  *reinterpret_cast<Pack<float, VEC>*>(p) = q;
}

// One warp a chunk of CHUNK sorted positions; lane l holds columns
// col0 + l * VEC .. + VEC - 1 of each row, for col0 = 0, 32 VEC, ...
// first_kind[k]: 0 if chunk k's first piece begins a run, 1 if it continues
// a run that ends in chunk k, 2 if the whole chunk lies inside a run that
// goes on. last_slot[k]: the slot of a run that begins in chunk k and goes
// on past it (its piece is in part_last[k]), else -1.
template <typename G, typename I, int VEC>
__global__ void embedding_bag_backward_two_pass_kernel(
    const I* __restrict__ ids, const int64_t* __restrict__ perm,
    const int64_t* __restrict__ slot, const G* __restrict__ grad,
    const float* __restrict__ denom, int64_t* __restrict__ rows_out,
    float* __restrict__ grads_out, float* __restrict__ part_first,
    float* __restrict__ part_last, int64_t* __restrict__ last_slot,
    int32_t* __restrict__ first_kind, int64_t n, int64_t n_rows, int L, int D) {
  const int64_t k = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t n_chunks = (n + CHUNK - 1) / CHUNK;
  if (k >= n_chunks) return;
  const int64_t c0 = k * CHUNK;
  const int64_t c1 = c0 + CHUNK < n ? c0 + CHUNK : n;
  const bool cont_in = c0 > 0 && ids[c0] >= 0 && ids[c0 - 1] == ids[c0];
  const bool cont_out = c1 < n && ids[c1 - 1] >= 0 && ids[c1] == ids[c1 - 1];
  if (lane == 0) {
    first_kind[k] = cont_in ? ((cont_out && ids[c0] == ids[c1 - 1]) ? 2 : 1) : 0;
    last_slot[k] = -1;
  }
  for (int col0 = 0; col0 < D; col0 += 32 * VEC) {
    const int d = col0 + lane * VEC;
    const bool active = d < D;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    int64_t seg = -1;  // first position of the piece being summed
    for (int64_t q0 = c0; q0 < c1; q0 += U) {
      I id[U + 1];
      int64_t bag[U];
#pragma unroll
      for (int u = 0; u <= U; ++u) id[u] = q0 + u < c1 ? ids[q0 + u] : (I)-1;
#pragma unroll
      for (int u = 0; u < U; ++u) bag[u] = id[u] >= 0 ? perm[q0 + u] / L : -1;
      float val[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (bag[u] >= 0 && active) {
          load_row<G, VEC>(grad + bag[u] * D + d, val[u]);
          if (denom != nullptr) {
            const float den = denom[bag[u]];
#pragma unroll
            for (int v = 0; v < VEC; ++v) val[u][v] = val[u][v] / den;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t q = q0 + u;
        if (q >= c1 || id[u] < 0) continue;
        if ((int64_t)id[u] >= n_rows) __trap();
        if (seg < 0) seg = q;
        if (active) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] += val[u][v];
        }
        if (q + 1 < c1 && id[u + 1] == id[u]) continue;
        // the piece [seg, q] ends here
        float* dst;
        if (seg == c0 && cont_in) {
          dst = part_first + k * D;
        } else {
          const int64_t s = slot[seg];
          if (lane == 0) rows_out[s] = (int64_t)id[u];
          if (q + 1 == c1 && cont_out) {
            dst = part_last + k * D;
            if (lane == 0) last_slot[k] = s;
          } else {
            dst = grads_out + s * D;
          }
        }
        if (active) store_f32<VEC>(dst + d, acc);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
        seg = -1;
      }
    }
  }
}

// One warp a chunk with a run that goes on past it: its piece, then the
// first piece of each following chunk the run reaches, in chunk order.
template <int VEC>
__global__ void embedding_bag_backward_combine_kernel(
    const float* __restrict__ part_first, const float* __restrict__ part_last,
    const int64_t* __restrict__ last_slot, const int32_t* __restrict__ first_kind,
    float* __restrict__ grads_out, int64_t n_chunks, int D) {
  const int64_t k = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (k >= n_chunks) return;
  const int64_t s = last_slot[k];
  if (s < 0) return;
  for (int d = lane * VEC; d < D; d += 32 * VEC) {
    float acc[VEC];
    const Pack<float, VEC> p = *reinterpret_cast<const Pack<float, VEC>*>(part_last + k * D + d);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = p.v[v];
    for (int64_t j = k + 1; j < n_chunks; ++j) {
      const Pack<float, VEC> f =
          *reinterpret_cast<const Pack<float, VEC>*>(part_first + j * D + d);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += f.v[v];
      if (first_kind[j] != 2) break;
    }
    store_f32<VEC>(grads_out + s * D + d, acc);
  }
}

template <typename G, typename I, int VEC>
int launch_backward(const void* ids, const void* perm, const void* slot, const void* grad,
                    const void* denom, void* rows_out, void* grads_out, void* part_first,
                    void* part_last, void* last_slot, void* first_kind, int64_t n,
                    int64_t n_rows, int64_t L, int64_t D, cudaStream_t stream) {
  const int64_t n_chunks = (n + CHUNK - 1) / CHUNK;
  const int64_t blocks = (n_chunks + 7) / 8;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  embedding_bag_backward_two_pass_kernel<G, I, VEC><<<(unsigned)blocks, 256, 0, stream>>>(
      (const I*)ids, (const int64_t*)perm, (const int64_t*)slot, (const G*)grad,
      (const float*)denom, (int64_t*)rows_out, (float*)grads_out, (float*)part_first,
      (float*)part_last, (int64_t*)last_slot, (int32_t*)first_kind, n, n_rows, (int)L,
      (int)D);
  return (int)cudaGetLastError();
}

template <typename G, typename I>
int backward_vec(const void* ids, const void* perm, const void* slot, const void* grad,
                 const void* denom, void* rows_out, void* grads_out, void* part_first,
                 void* part_last, void* last_slot, void* first_kind, int64_t n,
                 int64_t n_rows, int64_t L, int64_t D, cudaStream_t s) {
  const bool aligned = (uintptr_t)grad % (4 * sizeof(G)) == 0 &&
                       (uintptr_t)grads_out % 16 == 0 && (uintptr_t)part_first % 16 == 0 &&
                       (uintptr_t)part_last % 16 == 0;
  if (aligned && D % 4 == 0)
    return launch_backward<G, I, 4>(ids, perm, slot, grad, denom, rows_out, grads_out,
                                    part_first, part_last, last_slot, first_kind, n, n_rows,
                                    L, D, s);
  return launch_backward<G, I, 1>(ids, perm, slot, grad, denom, rows_out, grads_out,
                                  part_first, part_last, last_slot, first_kind, n, n_rows, L,
                                  D, s);
}

// The two-pass kernel's instance for (dtype, index type, vectorised), for
// its occupancy.
const void* two_pass_instance(int64_t dtype, int64_t idx64, int64_t vec) {
#define EBB_TWO(G, I)                                                                   \
  return vec ? (const void*)embedding_bag_backward_two_pass_kernel<G, I, 4>            \
             : (const void*)embedding_bag_backward_two_pass_kernel<G, I, 1>
  if (dtype == 0 && idx64 == 0) EBB_TWO(float, int32_t);
  if (dtype == 0) EBB_TWO(float, int64_t);
  if (idx64 == 0) EBB_TWO(__nv_bfloat16, int32_t);
  EBB_TWO(__nv_bfloat16, int64_t);
#undef EBB_TWO
}

// ------------------------------------------------------------ backward, one pass

// Warps a block of the one-pass backward and stages of its ring of rows.
constexpr int EBB_WARPS = 4;
constexpr int EBB_STAGES = 4;
// The largest chunk: at 1,024 positions every instance's block (int64 ids, a
// ring of 32 float32 or 64 bfloat16 rows) stays under the 227 KB of shared
// memory a block may have.
constexpr int EBB_MAX_CHUNK = 1024;
// What a cut run's count reaches once every chunk it spans has arrived: the
// chunk where it begins adds EBB_DONE + ks + 1, each later chunk 1, and the
// chunk where it ends -(ke + 1) more; no partial sum equals EBB_DONE.
constexpr unsigned long long EBB_DONE = 1ull << 40;
// A chunk's word in the scan: flag (bits 62-63: 1 its own heads, 2 the heads
// up to and including it), 1 + the last chunk up to it that holds a head
// (bits 32-61, 0 for none), the head count (bits 0-31).
constexpr unsigned long long EBB_AGG = 1ull << 62, EBB_INC = 2ull << 62;

__host__ __device__ constexpr size_t ebb_round16(size_t b) { return (b + 15) & ~(size_t)15; }

// Shared memory of one warp: a barrier for each stage of the ring, the
// metadata of two chunks (perm, then ids), the denominators of the ring's
// rows, the ring (EBB_STAGES x rs rows of one slab of slab_bytes).
__host__ __device__ inline size_t ebb_warp_bytes(int chunk, int rs, int id_bytes, int slab_bytes) {
  return 8 * EBB_STAGES + 16 * (size_t)chunk + ebb_round16(2 * (size_t)chunk * id_bytes) +
         ebb_round16(4 * (size_t)EBB_STAGES * rs) + (size_t)EBB_STAGES * rs * slab_bytes;
}

struct EbbArgs {
  const void* ids;              // (n,) sorted, int32 or int64
  const int64_t* perm;          // (n,) each sorted position's place in the flattening
  const void* grad;             // (n_bags, D)
  const float* denom;           // (n_bags,) for the mean, else null
  int64_t* rows_out;            // (n,)
  float* grads_out;             // (n, D)
  float* part;                  // (2, n_chunks, D): first pieces, then last pieces
  unsigned long long* work;     // ticket, n_unique, status (n_chunks), counts (n_chunks),
                                // zeroed; then run ends (n_chunks)
  int64_t n, n_rows, L;
  int D, chunk;
};

__device__ __forceinline__ unsigned ebb_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One piece of BYTES of a row into shared memory: cp.async where the piece
// is 4, 8 or 16 bytes, a load and a store below that.
template <int BYTES>
__device__ __forceinline__ void ebb_copy(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(ebb_smem(dst)), "l"(src));
  } else if constexpr (BYTES == 8 || BYTES == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(ebb_smem(dst)), "l"(src),
                 "n"(BYTES));
  } else {
    *reinterpret_cast<__nv_bfloat16*>(dst) = *reinterpret_cast<const __nv_bfloat16*>(src);
  }
}

// 16 bytes of metadata, the first `bytes` of them read (the rest zeroed).
__device__ __forceinline__ void ebb_copy_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(ebb_smem(dst)), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void ebb_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// A stage's barrier: armed for `bytes` by one lane, completed by the bulk
// copies of its rows (the tensor memory accelerator), waited on by parity.
__device__ __forceinline__ void ebb_bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(ebb_smem(bar)));
}
__device__ __forceinline__ void ebb_bar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(ebb_smem(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void ebb_bar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "EBB_WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra EBB_WAIT;\n}\n" ::"r"(ebb_smem(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void ebb_bulk(void* dst, const void* src, unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(ebb_smem(dst)), "l"(src), "r"(bytes), "r"(ebb_smem(bar)) : "memory");
}
template <int N>
__device__ __forceinline__ void ebb_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ unsigned long long ebb_load(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void ebb_store(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ebb_word(unsigned long long flag, int64_t heads,
                                                       int64_t run_chunk) {
  return flag | ((unsigned long long)(run_chunk + 1) << 32) | (unsigned long long)heads;
}

// The next chunk in ticket order, for the whole warp.
__device__ __forceinline__ int64_t ebb_claim(unsigned long long* ticket, int lane) {
  unsigned long long k = 0;
  if (lane == 0) k = atomicAdd(ticket, 1ull);
  return (int64_t)__shfl_sync(0xffffffffu, k, 0);
}

// Decoupled look-back over the chunks before k, a window of 32 at a time,
// one chunk a lane: (the heads before chunk k, the last chunk before k that
// holds a head, or -1). Chunks are claimed in order and each publishes its
// own heads before it waits on anything, so the wait always ends.
__device__ void ebb_look_back(const unsigned long long* status, int64_t k, int lane,
                              int64_t& heads, int64_t& run_chunk) {
  heads = 0;
  run_chunk = -1;
  for (int64_t j = k - 1; j >= 0; j -= 32) {
    const int64_t c = j - lane;
    unsigned long long w;
    for (;;) {
      w = c >= 0 ? ebb_load(status + c) : EBB_INC;
      if (!__any_sync(0xffffffffu, (w >> 62) == 0)) break;
      __nanosleep(32);
    }
    const unsigned inc = __ballot_sync(0xffffffffu, (w >> 62) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    int64_t h = lane <= stop ? (int64_t)(w & 0xffffffffu) : 0;
    const int64_t rc = lane <= stop ? (int64_t)((w >> 32) & 0x3fffffffu) - 1 : -1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) h += __shfl_xor_sync(0xffffffffu, h, o);
    heads += h;
    const unsigned has = __ballot_sync(0xffffffffu, rc >= 0);
    if (run_chunk < 0 && has) run_chunk = __shfl_sync(0xffffffffu, rc, __ffs(has) - 1);
    if (inc) break;
  }
}

// The chunk where the cut run begun in chunk ks ends (written before its
// arrival).
__device__ __forceinline__ int64_t ebb_end(const int64_t* run_end, int64_t ks) {
  return (int64_t)__ldcg(reinterpret_cast<const long long*>(run_end + ks));
}

// A chunk's arrival at a cut run's count: true for the chunk that completes
// it, which then sees every piece the others wrote (the warp's stores are
// ordered before lane 0's acquire-release atomic by the warp barrier).
__device__ __forceinline__ bool ebb_arrive(unsigned long long* count, unsigned long long add,
                                           int lane) {
  __syncwarp();
  unsigned long long old = 0;
  if (lane == 0)
    asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;\n"
                 : "=l"(old) : "l"(count), "l"(add) : "memory");
  old = __shfl_sync(0xffffffffu, old, 0);
  __syncwarp();
  return old + add == EBB_DONE;
}

// The sum of a cut run's pieces in chunk order: its last piece in chunk ks,
// then the first piece of each chunk ks + 1 .. ke, into its slot.
template <int VEC>
__device__ void ebb_combine(const EbbArgs& a, int64_t n_chunks, int64_t ks, int64_t ke,
                            int64_t slot, int lane) {
  const float* first = a.part;
  const float* last = a.part + n_chunks * a.D;
  for (int d = lane * VEC; d < a.D; d += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = __ldcg(last + ks * a.D + d + v);
    for (int64_t j0 = ks + 1; j0 <= ke; j0 += 8) {
      float x[8][VEC];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u <= ke) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) x[u][v] = __ldcg(first + (j0 + u) * a.D + d + v);
        }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u <= ke) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] += x[u][v];
        }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) a.grads_out[slot * a.D + d + v] = acc[v];
  }
}

// The one-pass backward. Persistent blocks of EBB_WARPS warps; each warp
// claims chunks of `chunk` sorted positions in order (an atomic ticket),
// each one chunk ahead of its use, and for each:
//  1. its ids and perm, staged by cp.async into the spare of two buffers,
//     give its run heads (a ballot over each 32 positions), published as
//     soon as they land; when the chunk's turn comes, the warp starts the
//     rows of its first stages, finds its first slot by the look-back over
//     the chunks before it (the last chunk of all writes n_unique), and
//     writes the id of each head to its slot;
//  2. it walks its positions in sorted order, a slab of 32 VEC columns at a
//     time, the gradient rows gathered into a ring of EBB_STAGES x RS rows
//     (EBB_STAGES - 1 stages in flight while one is summed): whole, by one
//     bulk copy a row, where a slab is 16-byte pieces, else PIECE bytes a
//     copy; each lane sums its VEC columns of each run's piece from zero; a
//     run inside the chunk goes to its slot, a run cut by the chunk's
//     bounds leaves its piece in part (its first piece, or its last);
//  3. it arrives at the count of each cut run it holds a piece of; the chunk
//     that completes a run adds its pieces in chunk order into its slot.
template <typename G, typename I, int VEC, int PIECE, int RS>
__global__ void __launch_bounds__(EBB_WARPS * 32)
embedding_bag_backward_kernel(EbbArgs a) {
  constexpr int SLAB = 32 * VEC;
  constexpr int SLAB_BYTES = SLAB * (int)sizeof(G);
  constexpr int PPR = SLAB_BYTES / PIECE;  // pieces a row of a slab
  constexpr int EPP = PIECE / (int)sizeof(G);
  // 16-byte rows go whole, one bulk copy a row, onto the stage's barrier
  constexpr bool BULK = PIECE == 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int chunk = a.chunk, D = a.D;
  const int64_t n = a.n;
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  unsigned char* base =
      smem + (threadIdx.x >> 5) * ebb_warp_bytes(chunk, RS, (int)sizeof(I), SLAB_BYTES);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(base);
  base += 8 * EBB_STAGES;
  int64_t* perm_s = reinterpret_cast<int64_t*>(base);
  I* ids_s = reinterpret_cast<I*>(base + 16 * (size_t)chunk);
  float* den_s = reinterpret_cast<float*>(base + 16 * (size_t)chunk +
                                          ebb_round16(2 * (size_t)chunk * sizeof(I)));
  unsigned char* ring = reinterpret_cast<unsigned char*>(den_s) +
                        ebb_round16(4 * (size_t)EBB_STAGES * RS);
  const I* ids = static_cast<const I*>(a.ids);
  const G* grad = static_cast<const G*>(a.grad);
  unsigned long long* ticket = a.work;
  unsigned long long* status = a.work + 2;
  unsigned long long* count = status + n_chunks;
  int64_t* run_end = reinterpret_cast<int64_t*>(count + n_chunks);

  // stage chunk c's perm and ids into buffer b; its neighbours' ids by plain loads
  auto stage = [&](int64_t c, int b, I& before, I& after) {
    const int64_t c0 = c * chunk;
    const int m = (int)(n - c0 < chunk ? n - c0 : chunk);
    const char* src = reinterpret_cast<const char*>(a.perm + c0);
    char* dst = reinterpret_cast<char*>(perm_s + (size_t)b * chunk);
    for (int o = lane * 16; o < m * 8; o += 32 * 16) ebb_copy_n(dst + o, src + o, min(16, m * 8 - o));
    src = reinterpret_cast<const char*>(ids + c0);
    dst = reinterpret_cast<char*>(ids_s + (size_t)b * chunk);
    const int ib = m * (int)sizeof(I);
    for (int o = lane * 16; o < ib; o += 32 * 16) ebb_copy_n(dst + o, src + o, min(16, ib - o));
    before = c0 > 0 ? ids[c0 - 1] : (I)-1;
    after = c0 + m < n ? ids[c0 + m] : (I)-1;
  };

  // chunk c's run heads (a valid id unlike the one before it), from its
  // staged ids; an id past the table stops the kernel
  auto count_heads = [&](int64_t c, const I* id_c, I before) {
    const int m = (int)(n - c * chunk < chunk ? n - c * chunk : chunk);
    int64_t heads = 0;
#pragma unroll 1
    for (int g = 0; g < m; g += 32) {
      const int i = g + lane;
      bool head = false;
      if (i < m) {
        const I id = id_c[i];
        if ((int64_t)id >= a.n_rows) __trap();
        head = id >= 0 && id != (i ? id_c[i - 1] : before);
      }
      heads += __popc(__ballot_sync(0xffffffffu, head));
    }
    return heads;
  };

  if constexpr (BULK) {
    if (lane == 0)
      for (int st = 0; st < EBB_STAGES; ++st) ebb_bar_init(bar + st);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncwarp();
  }
  unsigned parity = 0;  // bit st: the parity of stage st's next completion

  int64_t k = ebb_claim(ticket, lane);
  if (k >= n_chunks) return;
  I before_next, after_next;
  stage(k, 0, before_next, after_next);
  ebb_commit();
  ebb_wait<0>();
  __syncwarp();
  int64_t own_next = count_heads(k, ids_s, before_next);
  if (lane == 0) ebb_store(status + k, ebb_word(k ? EBB_AGG : EBB_INC, own_next,
                                                own_next ? k : -1));
  int b = 0;
  while (k < n_chunks) {
    const I before = before_next, after = after_next;
    const int64_t own = own_next;
    const int64_t c0 = k * chunk;
    const int m = (int)(n - c0 < chunk ? n - c0 : chunk);
    const I* id_c = ids_s + (size_t)b * chunk;
    // claim the next chunk and stage it: its heads are published as soon as
    // it lands, below, so that no look-back waits on a chunk held in reserve
    const int64_t k_next = ebb_claim(ticket, lane);
    if (k_next < n_chunks) stage(k_next, b ^ 1, before_next, after_next);
    ebb_commit();
    const bool cont_in = id_c[0] >= 0 && before == id_c[0];
    const bool cont_out = id_c[m - 1] >= 0 && after == id_c[m - 1];
    const bool whole = cont_in && cont_out && id_c[0] == id_c[m - 1];

    // the bag of each sorted position, in place of perm (-1 for padding,
    // which sorts first, so only a chunk that begins with it holds any)
    int64_t* bag_c = perm_s + (size_t)b * chunk;
    if (a.L != 1 || id_c[0] < 0) {
#pragma unroll 1
      for (int i = lane; i < m; i += 32)
        bag_c[i] = id_c[i] < 0 ? -1 : (int64_t)((uint32_t)bag_c[i] / (uint32_t)a.L);
      __syncwarp();
    }

    const int n_st = (m + RS - 1) / RS;
    // lane r's row of stage s: its bag, or -1 (padding, or past the chunk)
    auto bag_of = [&](int s) {
      const int i = s * RS + lane;
      return lane < RS && s < n_st && i < m ? bag_c[i] : (int64_t)-1;
    };
    // start the copies of stage s's rows (slab col0), lane r's row at bag:
    // a bulk copy a row onto the stage's barrier, or pieces of PIECE bytes
    auto issue = [&](int s, int col0, int64_t bag) {
      if (s >= n_st || col0 >= D) return;
      const int st = s % EBB_STAGES;
      unsigned char* dst = ring + (size_t)st * RS * SLAB_BYTES;
      if (a.denom != nullptr && bag >= 0) {
        if constexpr (PIECE >= 4)
          ebb_copy<4>(den_s + st * RS + lane, a.denom + bag);
        else
          den_s[st * RS + lane] = a.denom[bag];
      }
      if constexpr (BULK) {
        const unsigned bytes = (unsigned)(min(SLAB, D - col0) * (int)sizeof(G));
        const unsigned live = __ballot_sync(0xffffffffu, bag >= 0);
        if (lane == 0) ebb_bar_expect(bar + st, __popc(live) * bytes);
        __syncwarp();
        if (bag >= 0)
          ebb_bulk(dst + (size_t)lane * SLAB_BYTES, grad + bag * D + col0, bytes, bar + st);
      } else {
#pragma unroll
        for (int t0 = 0; t0 < RS * PPR; t0 += 32) {
          const int t = t0 + lane, r = t / PPR, p = t % PPR;
          const int64_t bag_r = __shfl_sync(0xffffffffu, bag, r);
          const int e = col0 + p * EPP;
          if (bag_r >= 0 && e < D)
            ebb_copy<PIECE>(dst + (size_t)r * SLAB_BYTES + p * PIECE, grad + bag_r * D + e);
        }
      }
    };
#pragma unroll 1
    for (int s = 0; s < EBB_STAGES - 1; ++s) {
      issue(s, 0, bag_of(s));
      ebb_commit();
    }
    ebb_wait<EBB_STAGES - 1>();  // the next chunk's metadata, older than these stages
    __syncwarp();
    if (k_next < n_chunks) {
      own_next = count_heads(k_next, ids_s + (size_t)(b ^ 1) * chunk, before_next);
      if (lane == 0)
        ebb_store(status + k_next, ebb_word(EBB_AGG, own_next, own_next ? k_next : -1));
    }

    int64_t first_slot = 0, run_chunk = -1;
    if (k > 0) {
      ebb_look_back(status, k, lane, first_slot, run_chunk);
      if (lane == 0)
        ebb_store(status + k, ebb_word(EBB_INC, first_slot + own, own ? k : run_chunk));
    }
    if (k == n_chunks - 1 && lane == 0) *reinterpret_cast<int64_t*>(a.work + 1) = first_slot + own;
    {
      int64_t pre = first_slot;
      const unsigned below = (1u << lane) - 1;
#pragma unroll 1
      for (int g = 0; g < m; g += 32) {
        const int i = g + lane;
        bool head = false;
        I id = -1;
        if (i < m) {
          id = id_c[i];
          head = id >= 0 && id != (i ? id_c[i - 1] : before);
        }
        const unsigned hm = __ballot_sync(0xffffffffu, head);
        if (head) a.rows_out[pre + __popc(hm & below)] = (int64_t)id;
        pre += __popc(hm);
      }
    }

    // 2. the walk, a slab at a time
    int64_t slot_out = -1;  // the slot of the run that begins here and goes on
#pragma unroll 1
    for (int col0 = 0; col0 < D; col0 += SLAB) {
      if (col0 > 0) {
#pragma unroll 1
        for (int s = 0; s < EBB_STAGES - 1; ++s) {
          issue(s, col0, bag_of(s));
          ebb_commit();
        }
      }
      const int d = col0 + lane * VEC;
      const bool active = d < D;
      float acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
      int64_t heads = 0;  // the chunk's heads before this stage
      int64_t bag_next = bag_of(EBB_STAGES - 1);
#pragma unroll 1
      for (int s = 0; s < n_st; ++s) {
        issue(s + EBB_STAGES - 1, col0, bag_next);
        ebb_commit();
        bag_next = bag_of(s + EBB_STAGES);
        // lane r reads row r of the stage: whether it holds an id, begins a
        // run (a head) or ends the piece being summed
        const int st = s % EBB_STAGES, r0 = s * RS;
        const int i = r0 + lane;
        const bool in = lane < RS && i < m;
        const I id = in ? id_c[i] : (I)-1;
        const I prv = in ? (i ? id_c[i - 1] : before) : (I)-1;
        const I nxt = in && i + 1 < m ? id_c[i + 1] : (I)-1;
        const unsigned valid = __ballot_sync(0xffffffffu, id >= 0);
        const unsigned head = __ballot_sync(0xffffffffu, id >= 0 && id != prv);
        const unsigned end = __ballot_sync(0xffffffffu, id >= 0 && (i + 1 >= m || nxt != id));
        ebb_wait<EBB_STAGES - 1>();
        if constexpr (BULK) {
          ebb_bar_wait(bar + st, (parity >> st) & 1u);
          parity ^= 1u << st;
        }
        __syncwarp();
        // the stage's rows of this lane's columns, all loaded before any is
        // added, then summed in order; a piece that ends is stored, into
        // the slot of its run's head (none before it in the chunk: the run
        // that continues into it)
        const unsigned char* src = ring + (size_t)st * RS * SLAB_BYTES + lane * VEC * sizeof(G);
        Pack<G, VEC> q[RS];
        float den[RS];
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          if (active && ((valid >> r) & 1u))
            q[r] = *reinterpret_cast<const Pack<G, VEC>*>(src + (size_t)r * SLAB_BYTES);
          if (a.denom != nullptr && ((valid >> r) & 1u)) den[r] = den_s[st * RS + r];
        }
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          if (!((valid >> r) & 1u)) continue;
          if (active) {
            if (a.denom != nullptr) {
#pragma unroll
              for (int v = 0; v < VEC; ++v) acc[v] += to_f32(q[r].v[v]) / den[r];
            } else {
#pragma unroll
              for (int v = 0; v < VEC; ++v) acc[v] += to_f32(q[r].v[v]);
            }
          }
          if (!((end >> r) & 1u)) continue;
          const int64_t h = heads + __popc(head & (0xffffffffu >> (31 - r)));
          float* dst;
          if (h == 0) {
            dst = a.part + k * D;
          } else if (r0 + r == m - 1 && cont_out) {
            dst = a.part + (n_chunks + k) * D;
            slot_out = first_slot + h - 1;
          } else {
            dst = a.grads_out + (first_slot + h - 1) * D;
          }
          if (active) store_f32<VEC>(dst + d, acc);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
        }
        heads += __popc(head);
        __syncwarp();
      }
    }

    // 3. the cut runs
    if (D > 0 && cont_in) {  // the run that began in run_chunk and reaches here
      if (!whole && lane == 0) run_end[run_chunk] = k;
      const unsigned long long add = whole ? 1ull : (unsigned long long)(-k);
      if (ebb_arrive(count + run_chunk, add, lane))
        ebb_combine<VEC>(a, n_chunks, run_chunk, whole ? ebb_end(run_end, run_chunk) : k,
                         first_slot - 1, lane);
    }
    if (D > 0 && slot_out >= 0) {  // the run that begins here and goes on
      if (ebb_arrive(count + k, EBB_DONE + (unsigned long long)k + 1ull, lane))
        ebb_combine<VEC>(a, n_chunks, k, ebb_end(run_end, k), slot_out, lane);
    }
    k = k_next;
    b ^= 1;
  }
}

// The instance for (dtype, index type, path, rows a stage): path 0 scalar
// pieces, 1 16-byte pieces, 2 8-byte pieces (bfloat16 only); its bytes a
// slab of a row. Every path has stages of EBB_RS rows; bfloat16 rows in
// 16-byte pieces also 4 and 16, for the sweep. nullptr where there is none.
constexpr int EBB_RS = 8;
const void* ebb_instance(int64_t dtype, int64_t idx64, int64_t path, int64_t rs,
                         int* slab_bytes) {
#define EBB_PICK(G, VEC, PIECE, RS)                                                             \
  do {                                                                                          \
    *slab_bytes = 32 * VEC * (int)sizeof(G);                                                    \
    return idx64 ? (const void*)embedding_bag_backward_kernel<G, int64_t, VEC, PIECE, RS>       \
                 : (const void*)embedding_bag_backward_kernel<G, int32_t, VEC, PIECE, RS>;      \
  } while (0)
  if (dtype == 1 && path == 1) {
    if (rs == 4) EBB_PICK(__nv_bfloat16, 4, 16, 4);
    if (rs == 16) EBB_PICK(__nv_bfloat16, 4, 16, 16);
  }
  if (rs != EBB_RS) return nullptr;
  if (dtype == 0) {
    if (path == 1) EBB_PICK(float, 4, 16, EBB_RS);
    if (path == 0) EBB_PICK(float, 1, 4, EBB_RS);
  } else {
    if (path == 1) EBB_PICK(__nv_bfloat16, 4, 16, EBB_RS);
    if (path == 2) EBB_PICK(__nv_bfloat16, 4, 8, EBB_RS);
    if (path == 0) EBB_PICK(__nv_bfloat16, 1, 2, EBB_RS);
  }
#undef EBB_PICK
  return nullptr;
}

// The path a gradient takes: 16-byte pieces where D and the pointer allow
// them, 8-byte pieces of a bfloat16 row of D % 4 == 0, scalar pieces else.
int64_t ebb_path(const void* grad, int64_t D, int64_t dtype) {
  const int64_t es = dtype == 0 ? 4 : 2;
  if (D % 4 == 0 && (D * es) % 16 == 0 && (uintptr_t)grad % 16 == 0) return 1;
  if (dtype == 1 && D % 4 == 0 && (uintptr_t)grad % 8 == 0) return 2;
  return 0;
}

size_t ebb_block_bytes(int64_t chunk, int64_t rs, int64_t idx64, int slab_bytes) {
  return EBB_WARPS * ebb_warp_bytes((int)chunk, (int)rs, idx64 ? 8 : 4, slab_bytes);
}

// The instance's blocks an SM at `bytes` of shared memory a block (its limit
// raised to that first), its registers a thread and local bytes a thread.
cudaError_t ebb_fit(const void* fn, size_t bytes, int* blocks, cudaFuncAttributes* attr) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, EBB_WARPS * 32, bytes);
  if (e == cudaSuccess && attr != nullptr) e = cudaFuncGetAttributes(attr, fn);
  return e;
}

// ------------------------------------------------------------ SGD of rows

// What a launch of sgd_rows does to each live slot: the update (read the
// master row over the link, write it and the table row back), or one of
// the two halves the sweep times on their own (launch/sgd_sweep.py): a
// read (the master row read, its rounding written to the table, which
// leaves a consistent master and table as they were) and a write (the
// gradient row written over the master row).
enum { SGD_UPDATE = 0, SGD_READ = 1, SGD_WRITE = 2 };

// Rows a warp of the update on every table (kernels/embedding_bag.py,
// SGD_R); the other counts, and the read and write halves, are instanced
// for the sweep on a bfloat16 table in 16-byte pieces only.
constexpr int SGD_R = 4;

// Blocks of 256 threads an SM that each count of rows a warp is compiled
// to fit (its registers capped to match): 64, 96, 128 and 128 rows in
// flight an SM.
__host__ __device__ constexpr int sgd_blocks_an_sm(int R) {
  return R == 1 ? 8 : R == 2 ? 6 : R == 4 ? 4 : 2;
}

__device__ __forceinline__ float sgd_step(float m, float g, float l, float c) {
  return __fsub_rn(m, __fmul_rn(l, __fmul_rn(g, c)));
}

// Warp w of the grid takes groups w, w + warps, ... of R consecutive slots
// below n = min(*n_unique, cap) (kernels/embedding_bag.py, SgdPlan), and
// issues the loads of all its live rows before it uses any.
template <typename T, int VEC, int R, int MODE>
__global__ void __launch_bounds__(256, sgd_blocks_an_sm(R))
sgd_rows_kernel(float* __restrict__ master, T* __restrict__ table,
                const int64_t* __restrict__ rows, const float* __restrict__ grads,
                const int64_t* __restrict__ n_unique, const float* __restrict__ lr,
                const float* __restrict__ clip, int64_t cap, int64_t n_rows, int D) {
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t nu = *n_unique;
  const int64_t n = nu < cap ? nu : cap;
  const float l = *lr, c = *clip;
  for (int64_t g = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5; g * R < n;
       g += warps) {
    int64_t r[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int64_t s = g * R + u;
      r[u] = s < n ? rows[s] : -1;
      if (s < n && (r[u] < 0 || r[u] >= n_rows)) __trap();
    }
    for (int d = lane * VEC; d < D; d += 32 * VEC) {
      Pack<float, VEC> m[R], gr[R];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (r[u] < 0) continue;
        if (MODE != SGD_WRITE)
          m[u] = *reinterpret_cast<const Pack<float, VEC>*>(master + r[u] * D + d);
        if (MODE != SGD_READ)
          gr[u] = *reinterpret_cast<const Pack<float, VEC>*>(grads + (g * R + u) * D + d);
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (r[u] < 0) continue;
        Pack<T, VEC> t;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          if (MODE == SGD_UPDATE) m[u].v[v] = sgd_step(m[u].v[v], gr[u].v[v], l, c);
          if (MODE == SGD_WRITE) m[u].v[v] = gr[u].v[v];
          from_f32(m[u].v[v], &t.v[v]);
        }
        if (MODE != SGD_READ)
          *reinterpret_cast<Pack<float, VEC>*>(master + r[u] * D + d) = m[u];
        if (MODE != SGD_WRITE) *reinterpret_cast<Pack<T, VEC>*>(table + r[u] * D + d) = t;
      }
    }
  }
}

// The instance of sgd_rows_kernel for (R, mode) on a bfloat16 table in
// 16-byte pieces, the sweep's; nullptr where the source has none.
template <int MODE>
const void* sgd_sweep_instance(int64_t R) {
  switch (R) {
    case 1: return (const void*)sgd_rows_kernel<__nv_bfloat16, 4, 1, MODE>;
    case 2: return (const void*)sgd_rows_kernel<__nv_bfloat16, 4, 2, MODE>;
    case 4: return (const void*)sgd_rows_kernel<__nv_bfloat16, 4, 4, MODE>;
    case 8: return (const void*)sgd_rows_kernel<__nv_bfloat16, 4, 8, MODE>;
    default: return nullptr;
  }
}

const void* sgd_instance(int64_t dtype, bool vec4, int64_t R, int64_t mode) {
  if (dtype == 1 && vec4) {
    if (mode == SGD_UPDATE) return sgd_sweep_instance<SGD_UPDATE>(R);
    if (mode == SGD_READ) return sgd_sweep_instance<SGD_READ>(R);
    if (mode == SGD_WRITE) return sgd_sweep_instance<SGD_WRITE>(R);
    return nullptr;
  }
  if (R != SGD_R || mode != SGD_UPDATE) return nullptr;
  if (dtype == 1) return (const void*)sgd_rows_kernel<__nv_bfloat16, 1, SGD_R, SGD_UPDATE>;
  return vec4 ? (const void*)sgd_rows_kernel<float, 4, SGD_R, SGD_UPDATE>
              : (const void*)sgd_rows_kernel<float, 1, SGD_R, SGD_UPDATE>;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; idx64: 0 int32 indices, 1 int64; mean: 0/1.
extern "C" int embedding_bag_launch(const void* table, const void* indices,
                                    void* out, int64_t n_bags, int64_t n_rows,
                                    int64_t L, int64_t D, int64_t dtype,
                                    int64_t idx64, int64_t mean, void* stream) {
  if (n_bags <= 0 || D <= 0) return 0;
  if (L < 0 || D > (1 << 30) || L > (1 << 30)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && idx64 == 0)
    return launch_vec<float, int32_t>(table, indices, out, n_bags, n_rows, L, D, mean, s);
  if (dtype == 0)
    return launch_vec<float, int64_t>(table, indices, out, n_bags, n_rows, L, D, mean, s);
  if (idx64 == 0)
    return launch_vec<__nv_bfloat16, int32_t>(table, indices, out, n_bags, n_rows, L, D, mean, s);
  return launch_vec<__nv_bfloat16, int64_t>(table, indices, out, n_bags, n_rows, L, D, mean, s);
}

// ids (n,) sorted, int32 (idx64 0) or int64; perm, slot (n,) int64; grad
// (n_bags, D), dtype 0 float32 or 1 bfloat16; denom (n_bags,) float32 for
// the mean, null for the sum; rows_out (cap,) int64 and grads_out (cap, D)
// float32; part_first, part_last (n_chunks, D) float32 and last_slot
// (n_chunks,) int64, first_kind (n_chunks,) int32, n_chunks = ceil(n / 256).
extern "C" int embedding_bag_backward_two_pass_launch(
    const void* ids, const void* perm, const void* slot, const void* grad, const void* denom,
    void* rows_out, void* grads_out, void* part_first, void* part_last, void* last_slot,
    void* first_kind, int64_t n, int64_t n_rows, int64_t L, int64_t D, int64_t dtype,
    int64_t idx64, void* stream) {
  if (n <= 0 || D <= 0) return 0;
  if (L <= 0 || D > (1 << 30) || L > (1 << 30)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define EBB_ARGS ids, perm, slot, grad, denom, rows_out, grads_out, part_first, part_last, \
                 last_slot, first_kind, n, n_rows, L, D, s
  if (dtype == 0 && idx64 == 0) return backward_vec<float, int32_t>(EBB_ARGS);
  if (dtype == 0) return backward_vec<float, int64_t>(EBB_ARGS);
  if (idx64 == 0) return backward_vec<__nv_bfloat16, int32_t>(EBB_ARGS);
  return backward_vec<__nv_bfloat16, int64_t>(EBB_ARGS);
#undef EBB_ARGS
}

extern "C" int embedding_bag_backward_combine_launch(const void* part_first,
                                                     const void* part_last,
                                                     const void* last_slot,
                                                     const void* first_kind, void* grads_out,
                                                     int64_t n_chunks, int64_t D,
                                                     void* stream) {
  if (n_chunks <= 0 || D <= 0) return 0;
  const int64_t blocks = (n_chunks + 7) / 8;
  if (blocks > 0x7fffffff || D > (1 << 30)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (uintptr_t)part_first % 16 == 0 && (uintptr_t)part_last % 16 == 0 &&
                       (uintptr_t)grads_out % 16 == 0;
  if (aligned && D % 4 == 0)
    embedding_bag_backward_combine_kernel<4><<<(unsigned)blocks, 256, 0, s>>>(
        (const float*)part_first, (const float*)part_last, (const int64_t*)last_slot,
        (const int32_t*)first_kind, (float*)grads_out, n_chunks, (int)D);
  else
    embedding_bag_backward_combine_kernel<1><<<(unsigned)blocks, 256, 0, s>>>(
        (const float*)part_first, (const float*)part_last, (const int64_t*)last_slot,
        (const int32_t*)first_kind, (float*)grads_out, n_chunks, (int)D);
  return (int)cudaGetLastError();
}

// ids (n,) sorted, int32 (idx64 0) or int64, 16-byte aligned; perm (n,)
// int64, 16-byte aligned; grad (n_bags, D), dtype 0 float32 or 1 bfloat16;
// denom (n_bags,) float32 for the mean, null for the sum; rows_out (n,)
// int64 and grads_out (n, D) float32; part (2, n_chunks, D) float32, 16-byte
// aligned; work (2 + 3 n_chunks) 64-bit words, the first 2 + 2 n_chunks zero;
// n_chunks = ceil(n / chunk), chunk a multiple of 32 up to EBB_MAX_CHUNK, rs (1 to 32) rows a
// stage of the ring. n < 2^32. The grid: every block the card fits (ebb_fit), at most one
// warp a chunk.
extern "C" int embedding_bag_backward_launch(
    const void* ids, const void* perm, const void* grad, const void* denom, void* rows_out,
    void* grads_out, void* part, void* work, int64_t n, int64_t n_rows, int64_t L, int64_t D,
    int64_t dtype, int64_t idx64, int64_t chunk, int64_t rs, void* stream) {
  if (n <= 0) return 0;
  if (L <= 0 || D < 0 || D > (1 << 30) || n >= (1ll << 32) || chunk < 32 || chunk % 32 ||
      chunk > EBB_MAX_CHUNK || rs < 1 || rs > 32)
    return (int)cudaErrorInvalidValue;
  int slab_bytes = 0;
  const void* fn = ebb_instance(dtype, idx64, ebb_path(grad, D, dtype), rs, &slab_bytes);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t bytes = ebb_block_bytes(chunk, rs, idx64, slab_bytes);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = ebb_fit(fn, bytes, &per_sm, nullptr);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  int64_t blocks = (int64_t)sms * per_sm;
  if (blocks > (n_chunks + EBB_WARPS - 1) / EBB_WARPS) blocks = (n_chunks + EBB_WARPS - 1) / EBB_WARPS;
  EbbArgs a{ids, (const int64_t*)perm, grad, (const float*)denom, (int64_t*)rows_out,
            (float*)grads_out, (float*)part, (unsigned long long*)work, n, n_rows, L,
            (int)D, (int)chunk};
  void* args[] = {&a};
  e = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(EBB_WARPS * 32), args, bytes,
                       (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// What the card fits of a backward instance, launching nothing: route 0 the
// one-pass kernel (path as ebb_path: 0 scalar, 1 16-byte, 2 8-byte pieces,
// at `chunk` and `rs`), route 1 the two-pass kernel (path 0 scalar, 1
// vectorised). out[0] blocks an SM, out[1] registers a thread, out[2] local
// (spilled) bytes a thread, out[3] shared bytes a block, out[4] threads a
// block.
extern "C" int embedding_bag_backward_occupancy(int64_t route, int64_t dtype, int64_t idx64,
                                                int64_t path, int64_t chunk, int64_t rs,
                                                int64_t* out) {
  const void* fn = nullptr;
  size_t bytes = 0;
  int threads = 256;
  if (route == 0) {
    if (chunk < 32 || chunk % 32 || chunk > EBB_MAX_CHUNK || rs < 1 || rs > 32)
      return (int)cudaErrorInvalidValue;
    int slab_bytes = 0;
    fn = ebb_instance(dtype, idx64, path, rs, &slab_bytes);
    bytes = ebb_block_bytes(chunk, rs, idx64, slab_bytes);
    threads = EBB_WARPS * 32;
  } else if (route == 1) {
    fn = two_pass_instance(dtype, idx64, path);
  }
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaFuncAttributes attr;
  cudaError_t e = route == 0 ? ebb_fit(fn, bytes, &blocks, &attr)
                             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0);
  if (e == cudaSuccess && route == 1) e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int64_t)attr.localSizeBytes;
  out[3] = (int64_t)bytes;
  out[4] = threads;
  return 0;
}

// master (n_rows, D) float32 in registered host memory, at its host address
// (refused where the card cannot use that address for registered memory);
// table (n_rows, D), dtype 0 float32 or 1 bfloat16; rows (cap,) int64,
// grads (cap, D) float32; n_unique int64, lr and clip float32, each one
// value in device memory. R rows a warp on `blocks` blocks of 256 threads
// (kernels/embedding_bag.py, sgd_rows_plan); mode SGD_UPDATE for the SGD,
// the others for the sweep. A pair of R and mode without an instance for
// this table is refused.
extern "C" int sgd_rows_launch(void* master, void* table, const void* rows, const void* grads,
                               const void* n_unique, const void* lr, const void* clip,
                               int64_t cap, int64_t n_rows, int64_t D, int64_t dtype,
                               int64_t R, int64_t blocks, int64_t mode, void* stream) {
  if (cap <= 0 || D <= 0) return 0;
  if (D > (1 << 30) || blocks <= 0 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int dev = 0, host_ptr_ok = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&host_ptr_ok, cudaDevAttrCanUseHostPointerForRegisteredMem, dev);
  if (e != cudaSuccess) return (int)e;
  if (!host_ptr_ok) return (int)cudaErrorNotSupported;
  const size_t tsize = dtype == 0 ? 4 : 2;
  const bool vec4 = (uintptr_t)master % 16 == 0 && (uintptr_t)grads % 16 == 0 &&
                    (uintptr_t)table % (4 * tsize) == 0 && D % 4 == 0;
  const void* fn = sgd_instance(dtype, vec4, R, mode);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int d32 = (int)D;
  void* args[] = {&master, &table, (void*)&rows, (void*)&grads, (void*)&n_unique, (void*)&lr,
                  (void*)&clip, &cap, &n_rows, &d32};
  e = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3(256), args, 0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// What the card fits of the sweep's instance (R, mode) (a bfloat16 table in
// 16-byte pieces): out[0] its blocks of 256 threads an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] its registers a
// thread. Nothing is launched.
extern "C" int sgd_rows_occupancy(int64_t R, int64_t mode, int64_t* out) {
  const void* fn = sgd_instance(1, true, R, mode);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 256, 0);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = attr.numRegs;
  return 0;
}
