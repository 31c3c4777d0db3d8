// CSR sparse-dense product, the GNN's message aggregation, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel `csr_spmm` (src/repro/kernels/segment_matmul.py).
//
//   out[r, :] = sum over k in [row_ptr[r], row_ptr[r + 1]) of x[col[k], :]
//
// x (n_x, D) float32 or bfloat16, row_ptr (n_rows + 1) int64, col (nnz)
// int32 with values in [0, n_x), out (n_rows, D) in x's type. Each row is
// summed in float32, in CSR order, and rounded once to the output type.
// The GCN forward launches it on the CSR sorted by receiver (col names
// senders); its backward launches it on the transposed CSR (rows are
// senders, col names receivers), so one kernel serves both directions.
//
// What bounds it: bytes. Each output row is written once, row_ptr and col
// are read once, and each x row is read once per edge that names it; the
// least the card must move is x once, the indices once and out once, one
// add per edge and feature. The TPU kernel pads every 128-row block of
// destinations to the largest block's edge count and scatters with a
// one-hot matmul on the MXU; on a heavy-tailed graph that padding alone
// outweighs the graph, so this kernel takes a plain CSR instead.
//
// Design, the simple first one: each output row belongs to a group of
// `g` = min(32, next power of two >= D) lanes of one warp, so a warp serves
// 32 / g rows. The group walks its row's edges in CSR order, `g` at a time:
// each lane loads one col index and the group shares them by shuffles, then
// every lane adds x[col, c] for its features c = lane + i * g (i < NF) into
// float32 registers. The row is written once. No atomics: every launch is
// deterministic, bit for bit. Loads are scalar, so any D and any row stride
// work (D = 47 rows are 188 bytes, not 16-byte aligned); D wider than
// g * NF (NF at most 8) is cut into column tiles along blockIdx.y. Rows with
// no edges write zeros; n_rows == 0 launches nothing. A col index outside
// [0, n_x) stops the kernel with an error instead of reading out of bounds.
// Skew is left alone: a group waits on its own row, so the heaviest rows of
// a heavy-tailed graph set the tail of the launch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float x, float* out) { *out = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

constexpr int kThreads = 256;

template <typename T, int NF>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const T* __restrict__ x, const int64_t* __restrict__ row_ptr,
                const int32_t* __restrict__ col, T* __restrict__ out,
                int64_t n_rows, int64_t n_x, int D, int g) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t row = t / g;
  if (row >= n_rows) return;  // whole groups leave together: g divides 32
  const int lane = (int)(t % g);
  const int warp_lane = threadIdx.x & 31;
  const unsigned mask =
      g == 32 ? 0xffffffffu : (((1u << g) - 1u) << (warp_lane - lane));
  const int c0 = (int)blockIdx.y * g * NF + lane;

  float acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) acc[i] = 0.0f;

  const int64_t start = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  for (int64_t k0 = start; k0 < end; k0 += g) {
    const int64_t k = k0 + lane;
    const int32_t mine = k < end ? col[k] : 0;
    const int n = (int)(end - k0 < g ? end - k0 : g);
#pragma unroll 4
    for (int e = 0; e < n; ++e) {
      const int32_t j = __shfl_sync(mask, mine, e, g);
      if ((uint64_t)(int64_t)j >= (uint64_t)n_x) __trap();
      const T* xr = x + (int64_t)j * D;
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int c = c0 + i * g;
        if (c < D) acc[i] += to_f32(xr[c]);
      }
    }
  }
  T* orow = out + row * D;
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int c = c0 + i * g;
    if (c < D) store(acc[i], orow + c);
  }
}

template <typename T, int NF>
int launch(const void* x, const void* row_ptr, const void* col, void* out,
           int64_t n_rows, int64_t n_x, int D, int g, cudaStream_t stream) {
  const int64_t rows_per_block = kThreads / g;
  const int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  const int64_t tiles = (D + (int64_t)g * NF - 1) / ((int64_t)g * NF);
  if (blocks > 0x7fffffff || tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)tiles);
  csr_spmm_kernel<T, NF><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const int64_t*)row_ptr, (const int32_t*)col, (T*)out, n_rows,
      n_x, D, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nf(const void* x, const void* row_ptr, const void* col, void* out,
              int64_t n_rows, int64_t n_x, int D, cudaStream_t stream) {
  int g = 1;
  while (g < D && g < 32) g *= 2;
  const int per_lane = (D + g - 1) / g;  // features each lane must cover
  if (per_lane <= 1) return launch<T, 1>(x, row_ptr, col, out, n_rows, n_x, D, g, stream);
  if (per_lane <= 2) return launch<T, 2>(x, row_ptr, col, out, n_rows, n_x, D, g, stream);
  if (per_lane <= 4) return launch<T, 4>(x, row_ptr, col, out, n_rows, n_x, D, g, stream);
  return launch<T, 8>(x, row_ptr, col, out, n_rows, n_x, D, g, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.
extern "C" int csr_spmm_launch(const void* x, const void* row_ptr, const void* col,
                               void* out, int64_t n_rows, int64_t n_x, int64_t D,
                               int64_t dtype, void* stream) {
  if (n_rows <= 0 || D <= 0) return 0;
  if (D > (1 << 30) || n_x < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_nf<float>(x, row_ptr, col, out, n_rows, n_x, (int)D, s);
  return launch_nf<__nv_bfloat16>(x, row_ptr, col, out, n_rows, n_x, (int)D, s);
}
