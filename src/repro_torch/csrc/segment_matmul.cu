// CSR sparse-dense product, the GNN's message aggregation, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `csr_spmm` (src/repro/kernels/segment_matmul.py).
//
//   out[r, :] = sum over k in [row_ptr[r], row_ptr[r + 1]) of x[col[k], :]
//
// x (n_x, D) float32 or bfloat16, row_ptr (n_rows + 1) int64, col (nnz)
// int32 with values in [0, n_x), out (n_rows, D) in x's type. Each row is
// summed in float32, compensated, and rounded once to the output type. The
// GCN forward launches it on the CSR sorted by receiver (col names
// senders); its backward launches it on the transposed CSR (rows are
// senders, col names receivers), so one kernel serves both directions.
//
// What bounds it: bytes. Each output row is written once, row_ptr and col
// are read once, and each x row is read once per edge that names it; the
// least the card must move is x once, the indices once and out once, one
// add per edge and feature. Every edge gathers an x row from a random
// place, so the card reaches its rate only with many gathers in flight on
// every SM until the launch ends. The TPU kernel pads every 128-row block
// of destinations to the largest block's edge count and scatters with a
// one-hot matmul on the MXU; on a heavy-tailed graph that padding alone
// outweighs the graph, so this kernel takes a plain CSR instead.
//
// The work split (the plan, made once per CSR where the wrapper's `CSR` is
// made, from row_ptr alone, on the device): rows of more than C edges (C =
// the plan's chunk, 256 by default) are cut into chunks of C edges, the
// last one shorter; the other rows are walked whole. A work item is one
// chunk or one short row, so no group of lanes walks more than C edges,
// whatever the heaviest row holds. The chunks come first in the grid, then
// the short rows by length, longest first (a stable sort): the longest
// items start first and each warp holds items of about one length. Cutting
// rows into chunks was chosen over a merge-path split of the edges (each
// warp a fixed edge count, its rows found by binary search) because a short
// row stays one item with one plain write, nothing is searched, and
// partials exist only for the rows that need them (5,991 of ogb_products'
// 2.4 million rows at C = 256), not at every item's two ends.
//
// Each item belongs to a group of `g` lanes of one warp (g divides 32, so a
// warp serves 32 / g items). A lane covers NF units of the row, a unit being
// 16 bytes (a float4, or 8 bfloat16) where the row's size and x's address
// allow it, else one element. D = 16 float32 rows are 64 bytes: 4 lanes a
// row, 8 rows a warp. D = 47 float32 rows are 188 bytes, not 16-byte
// aligned, so they take 4-byte loads, 16 lanes of 3 a row, 2 rows a warp (48
// slots for 47 features, where 32 lanes of 2 would leave 17 of 64 idle and
// issue a third more load instructions an edge). D wider than g * NF units
// is cut into column tiles along blockIdx.y. The group walks its item's
// edges in CSR order, DEPTH at a time: it loads DEPTH col indices, issues
// all DEPTH x-row loads (each into its own registers) before the first add,
// and loads the next DEPTH indices while those are in flight; then it adds
// the DEPTH rows in CSR order. At D = 16 a warp keeps 8 x 8 = 64 row gathers
// in flight.
//
// Sums: every add is Knuth's TwoSum in float32, carrying the error of the
// sum beside it, so each row's sum is rounded once (s + c at the end, but
// for about n * 2**-48 of the sum of |terms|), where a plain float32 sum of
// n terms may be off by n * 2**-24 of it (about 1e-3 at a 20,000-edge row);
// the GCN's gradients read that error where a ReLU input is near 0. The five
// extra adds a term run while the next batch's gathers are in flight. A
// short row is written once. A chunk writes its rounded sum to the partials
// (one row of D floats a chunk, in plan order); the second kernel,
// csr_spmm_combine_kernel, adds each long row's chunk partials in chunk
// order, the same way, and rounds once. No atomics: the order of every sum
// is fixed by the plan, so every launch is deterministic, bit for bit. Rows
// with no edges write zeros; n_rows == 0 launches nothing.
//
// Indices: the wrapper's CSR proves col in [0, n_cols) where it is made, and
// the wrapper that x has n_cols rows. The kernel keeps one guard: each batch
// of DEPTH indices is checked once it is loaded, before its gathers are
// issued (one branch a batch, none between the gathers); an index outside
// [0, n_x) stops the kernel with an error instead of reading out of bounds.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// A unit is what one lane loads at once from an x row: one element (W = 1)
// or 16 bytes (W = 4 float32, 8 bfloat16). `Raw` holds it as loaded, so
// the loads of a batch are issued before any conversion or add.
template <typename T, bool VEC>
struct Unit;

// s + c holds a float32 sum and the error of its additions (Knuth's
// TwoSum: each step's rounding error exactly, in float32 arithmetic; no
// multiply, so nothing contracts into an FMA).
__device__ __forceinline__ void add2(float& s, float& c, float x) {
  const float t = __fadd_rn(s, x);
  const float z = __fsub_rn(t, s);
  c = __fadd_rn(c, __fadd_rn(__fsub_rn(s, __fsub_rn(t, z)), __fsub_rn(x, z)));
  s = t;
}

template <>
struct Unit<float, false> {
  static constexpr int W = 1;
  using Raw = float;
  __device__ static Raw load(const float* p) { return __ldg(p); }
  __device__ static void add(float* s, float* c, Raw r) { add2(s[0], c[0], r); }
  __device__ static void store(const float* acc, float* out) { out[0] = acc[0]; }
};

template <>
struct Unit<__nv_bfloat16, false> {
  static constexpr int W = 1;
  using Raw = unsigned short;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void add(float* s, float* c, Raw r) {
    add2(s[0], c[0], __uint_as_float((unsigned)r << 16));
  }
  __device__ static void store(const float* acc, __nv_bfloat16* out) {
    out[0] = __float2bfloat16_rn(acc[0]);
  }
};

template <>
struct Unit<float, true> {
  static constexpr int W = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static void add(float* s, float* c, Raw r) {
    add2(s[0], c[0], r.x);
    add2(s[1], c[1], r.y);
    add2(s[2], c[2], r.z);
    add2(s[3], c[3], r.w);
  }
  __device__ static void store(const float* acc, float* out) {
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <>
struct Unit<__nv_bfloat16, true> {
  static constexpr int W = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void add(float* s, float* c, Raw r) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
      add2(s[2 * i], c[2 * i], __uint_as_float(w[i] << 16));
      add2(s[2 * i + 1], c[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u));
    }
  }
  __device__ static void store(const float* acc, __nv_bfloat16* out) {
    *reinterpret_cast<uint4*>(out) =
        make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                   pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
  }
};

// Work item `item`: chunk `item` of the plan's long rows for item <
// n_chunks (its float32 sum goes to part[item]), else the short row
// short_rows[item - n_chunks] (its sum goes to out).
template <typename T, bool VEC, int NF>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const T* __restrict__ x, const int64_t* __restrict__ row_ptr,
                const int32_t* __restrict__ col, T* __restrict__ out, float* __restrict__ part,
                const int64_t* __restrict__ chunk_start, const int64_t* __restrict__ chunk_end,
                const int32_t* __restrict__ short_rows, int64_t n_chunks, int64_t n_items,
                int64_t n_x, int D, int g) {
  using U = Unit<T, VEC>;
  constexpr int W = U::W;
  constexpr int DEPTH = (VEC ? 8 : 16) / NF > 1 ? (VEC ? 8 : 16) / NF : 1;  // gathers in flight
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t item = t / g;
  if (item >= n_items) return;
  const int lane = (int)(t % g);
  const int n_units = D / W;  // W divides D on the 16-byte path
  const int u0 = (int)blockIdx.y * g * NF + lane;

  int64_t start, end, row = 0;
  if (item < n_chunks) {
    start = chunk_start[item];
    end = chunk_end[item];
  } else {
    row = short_rows[item - n_chunks];
    start = row_ptr[row];
    end = row_ptr[row + 1];
  }

  float acc[NF * W], err[NF * W];  // each feature's sum, s + c as in add2
#pragma unroll
  for (int i = 0; i < NF * W; ++i) acc[i] = err[i] = 0.0f;

  int32_t j[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) j[d] = start + d < end ? col[start + d] : 0;
  for (int64_t k0 = start; k0 < end; k0 += DEPTH) {
    bool bad = false;
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) bad |= (uint64_t)(int64_t)j[d] >= (uint64_t)n_x;
    if (bad) __trap();
    typename U::Raw v[DEPTH][NF];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const T* xr = x + (int64_t)j[d] * D;
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int u = u0 + i * g;
        v[d][i] = k0 + d < end && u < n_units ? U::load(xr + u * W) : typename U::Raw{};
      }
    }
    const int64_t k1 = k0 + DEPTH;  // the next batch's indices, loaded while these rows fly
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) j[d] = k1 + d < end ? col[k1 + d] : 0;
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      if (k0 + d < end) {
#pragma unroll
        for (int i = 0; i < NF; ++i) U::add(acc + i * W, err + i * W, v[d][i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NF * W; ++i) acc[i] = __fadd_rn(acc[i], err[i]);
  if (item < n_chunks) {
    float* prow = part + item * D;
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int u = u0 + i * g;
      if (u < n_units) {
#pragma unroll
        for (int w = 0; w < W; ++w) prow[u * W + w] = acc[i * W + w];
      }
    }
  } else {
    T* orow = out + row * D;
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int u = u0 + i * g;
      if (u < n_units) U::store(acc + i * W, orow + u * W);
    }
  }
}

__device__ __forceinline__ void store1(float v, float* out) { *out = v; }
__device__ __forceinline__ void store1(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// out[long_rows[l], c] = the sum of part[chunk_ptr[l] .. chunk_ptr[l + 1]), c]
// in chunk order, one thread per (long row, feature); 8 partials in flight.
template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_spmm_combine_kernel(const float* __restrict__ part, const int32_t* __restrict__ long_rows,
                        const int64_t* __restrict__ chunk_ptr, T* __restrict__ out,
                        int64_t n_long, int D) {
  constexpr int DEPTH = 8;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_long * D) return;
  const int64_t l = t / D;
  const int c = (int)(t % D);
  const int64_t lo = chunk_ptr[l], hi = chunk_ptr[l + 1];
  float acc = 0.0f, err = 0.0f;
  for (int64_t k0 = lo; k0 < hi; k0 += DEPTH) {
    float v[DEPTH];
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) v[d] = k0 + d < hi ? part[(k0 + d) * D + c] : 0.0f;
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      if (k0 + d < hi) add2(acc, err, v[d]);
    }
  }
  store1(__fadd_rn(acc, err), out + (int64_t)long_rows[l] * D + c);
}

template <typename T, bool VEC, int NF>
int launch(const void* x, const void* row_ptr, const void* col, void* out, void* part,
           const void* chunk_start, const void* chunk_end, const void* short_rows,
           int64_t n_chunks, int64_t n_items, int64_t n_x, int D, int g, int n_units,
           cudaStream_t stream) {
  const int64_t items_per_block = kThreads / g;
  const int64_t blocks = (n_items + items_per_block - 1) / items_per_block;
  const int64_t tiles = (n_units + (int64_t)g * NF - 1) / ((int64_t)g * NF);
  if (blocks > 0x7fffffff || tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)tiles);
  csr_spmm_kernel<T, VEC, NF><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const int64_t*)row_ptr, (const int32_t*)col, (T*)out, (float*)part,
      (const int64_t*)chunk_start, (const int64_t*)chunk_end, (const int32_t*)short_rows,
      n_chunks, n_items, n_x, D, g);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_nf(const void* x, const void* row_ptr, const void* col, void* out, void* part,
              const void* chunk_start, const void* chunk_end, const void* short_rows,
              int64_t n_chunks, int64_t n_items, int64_t n_x, int D, cudaStream_t stream) {
  const int n_units = VEC ? D / Unit<T, VEC>::W : D;
  // a group covers a row with the fewest idle lanes: at most 16 lanes on the
  // 4-byte path (D = 47: 16 x 3 = 48 units, two rows a warp, against 32 x 2
  // = 64 for one), at most 32 on the 16-byte path
  int g = 1;
  while (g < n_units && g < (VEC ? 32 : 16)) g *= 2;
  const int per_lane = (n_units + g - 1) / g;  // units each lane must cover
#define CSR_SPMM_LAUNCH(NF)                                                                  \
  launch<T, VEC, NF>(x, row_ptr, col, out, part, chunk_start, chunk_end, short_rows,         \
                     n_chunks, n_items, n_x, D, g, n_units, stream)
  if (per_lane <= 1) return CSR_SPMM_LAUNCH(1);
  if (per_lane <= 2) return CSR_SPMM_LAUNCH(2);
  if (per_lane <= 3) return CSR_SPMM_LAUNCH(3);
  if (per_lane <= 4) return CSR_SPMM_LAUNCH(4);
  return CSR_SPMM_LAUNCH(8);
#undef CSR_SPMM_LAUNCH
}

template <typename T>
int launch_t(const void* x, const void* row_ptr, const void* col, void* out, void* part,
             const void* chunk_start, const void* chunk_end, const void* short_rows,
             int64_t n_chunks, int64_t n_items, int64_t n_x, int D, cudaStream_t stream) {
  // 16-byte units where every x row and out row starts on 16 bytes
  const bool vec = ((int64_t)D * (int64_t)sizeof(T)) % 16 == 0 &&
                   (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec)
    return launch_nf<T, true>(x, row_ptr, col, out, part, chunk_start, chunk_end, short_rows,
                              n_chunks, n_items, n_x, D, stream);
  return launch_nf<T, false>(x, row_ptr, col, out, part, chunk_start, chunk_end, short_rows,
                             n_chunks, n_items, n_x, D, stream);
}

}  // namespace

// The plan's work: n_chunks chunks (chunk_start, chunk_end; their float32
// sums go to part, (n_chunks, D)) and then n_items - n_chunks short rows
// (short_rows, int32; their sums go to out). dtype: 0 float32, 1 bfloat16.
extern "C" int csr_spmm_launch(const void* x, const void* row_ptr, const void* col, void* out,
                               void* part, const void* chunk_start, const void* chunk_end,
                               const void* short_rows, int64_t n_chunks, int64_t n_items,
                               int64_t n_x, int64_t D, int64_t dtype, void* stream) {
  if (n_items <= 0 || D <= 0) return 0;
  if (D > (1 << 30) || n_x < 0 || n_chunks < 0 || n_chunks > n_items)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_t<float>(x, row_ptr, col, out, part, chunk_start, chunk_end, short_rows,
                           n_chunks, n_items, n_x, (int)D, s);
  return launch_t<__nv_bfloat16>(x, row_ptr, col, out, part, chunk_start, chunk_end, short_rows,
                                 n_chunks, n_items, n_x, (int)D, s);
}

// The long rows' outputs from their chunk partials: part (n_chunks, D)
// float32, long_rows (n_long) int32, chunk_ptr (n_long + 1) int64.
extern "C" int csr_spmm_combine_launch(const void* part, const void* long_rows,
                                       const void* chunk_ptr, void* out, int64_t n_long,
                                       int64_t D, int64_t dtype, void* stream) {
  if (n_long <= 0 || D <= 0) return 0;
  if (D > (1 << 30)) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n_long * D + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    csr_spmm_combine_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)part, (const int32_t*)long_rows, (const int64_t*)chunk_ptr, (float*)out,
        n_long, (int)D);
  else
    csr_spmm_combine_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)part, (const int32_t*)long_rows, (const int64_t*)chunk_ptr,
        (__nv_bfloat16*)out, n_long, (int)D);
  return (int)cudaGetLastError();
}
