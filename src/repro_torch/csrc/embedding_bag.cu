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
