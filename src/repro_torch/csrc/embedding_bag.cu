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
// - `embedding_bag_backward_kernel` + `embedding_bag_backward_combine_kernel`:
//   the float32 gradient of every distinct row of a batch's bags,
//     grads[s, :] = sum over (b, l) with idx[b, l] == rows[s] of grad_out[b, :]
//                   (each term divided by max(#valid_b, 1) for the mean),
//   in ascending row order, one slot a distinct row. The wrapper sorts the
//   flattened ids (stable), flags the head of each run of equal ids and
//   gives each head its slot by a prefix sum, all on the card. What bounds
//   it: bytes (each gradient row read once, each slot written once). What
//   is hard: skew. Criteo's small tables (3, 4, 10 rows) put 16,000-22,000
//   of a 65,536 batch's ids on one row, so a warp a distinct row would wait
//   on the longest run. Instead each warp takes a fixed chunk of CHUNK
//   sorted positions and sums each run's piece in it in sorted order, with
//   U rows in flight; a run inside one chunk is written out directly, a
//   run cut by chunk boundaries leaves its pieces in two small arrays (the
//   chunk's first and last piece), and the combine kernel adds a cut run's
//   pieces in chunk order. Every sum has one fixed order, so the result
//   is deterministic. Padding (negative ids) sorts first and is skipped.
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

// ------------------------------------------------------------ backward

constexpr int CHUNK = 256;  // sorted positions a warp
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
__global__ void embedding_bag_backward_kernel(
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
  embedding_bag_backward_kernel<G, I, VEC><<<(unsigned)blocks, 256, 0, stream>>>(
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
extern "C" int embedding_bag_backward_launch(
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
