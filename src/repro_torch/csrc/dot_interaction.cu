// DLRM dot interaction: the strictly lower triangle of X X^T per sample, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `dot_interaction`
// (src/repro/kernels/dot_interaction.py).
//
//   out[b, i*(i-1)/2 + j] = sum_d x[b, i, d] * x[b, j, d]   for F > i > j >= 0
//
// x (B, F, D) float32 or bfloat16, out (B, F(F-1)/2) float32, in
// tril_indices(F, -1) order. Inputs are upcast to float32 and every pair is
// summed in float32 in the order d = 0..D-1. The Pallas kernel casts its
// float32 sums back to x's type; this kernel keeps float32, which is what
// DLRM's interaction (`_interact` in src/repro/models/dlrm.py) computes.
//
// What bounds it: bytes. At DLRM's shape (F = 27, D = 128, bfloat16) a
// sample reads 6.9 KB and writes 351 * 4 B, against 351 * 128 float32
// multiply-adds: 2 * 351 * 128 / 8,316 B = 10.8 operations per byte, below
// the card's float32 balance (67e12 / 3.35e12 = 20). The design stages a few
// samples of X per block in shared memory as float32, each row padded to
// a stride of 4 (mod 32) words so that rows r and r + 1 start in
// neighbouring 16-byte bank groups, and has each thread compute a 4 x 4
// tile of the F x F product: four rows of X against four rows, 64
// multiply-adds per eight shared-memory loads of 16 bytes, so that shared
// memory bandwidth, not HBM, is what the tile size trades against
// registers. Each thread starts its sweep over D at a column rotated by its
// tile column, which spreads the threads that read the same rows over the
// bank groups. Only tiles that touch the strict lower triangle are
// computed. Any B is accepted; B == 0 launches nothing.
#include <cmath>
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float z) {
  z = fmaf(a.x, b.x, z);
  z = fmaf(a.y, b.y, z);
  z = fmaf(a.z, b.z, z);
  return fmaf(a.w, b.w, z);
}

constexpr int TILE = 4;  // rows of X per side of a thread's tile

// xs holds spb samples of Fp rows (F rounded up to a multiple of TILE, the
// pad rows zero) of Dp floats; only the first Dq = round_up(D, 4) floats of
// a row are read.
template <typename T, int VEC>
__global__ void dot_interaction_kernel(const T* __restrict__ x,
                                       float* __restrict__ out, int64_t B,
                                       int F, int D, int Fp, int Dq, int Dp,
                                       int spb, int ntiles) {
  extern __shared__ float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);
  const int64_t b0 = (int64_t)blockIdx.x * spb;
  const int nb = (int)((B - b0) < spb ? (B - b0) : spb);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;

  for (int r = warp; r < nb * Fp; r += nwarps) {
    const int s = r / Fp, f = r - s * Fp;
    float* dst = xs + (int64_t)r * Dp;
    if (f >= F) {
      for (int d = lane; d < Dq; d += 32) dst[d] = 0.0f;
      continue;
    }
    const T* src = x + ((b0 + s) * F + f) * (int64_t)D;
    if constexpr (VEC > 1) {  // D % VEC == 0, so Dq == D
      for (int c = lane; c < D / VEC; c += 32) {
        const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(src + c * VEC);
#pragma unroll
        for (int k = 0; k < VEC; k += 4)  // VEC is 4 (float32) or 8 (bfloat16)
          *reinterpret_cast<float4*>(dst + c * VEC + k) =
              make_float4(to_f32(p.v[k]), to_f32(p.v[k + 1]), to_f32(p.v[k + 2]),
                          to_f32(p.v[k + 3]));
      }
    } else {
      for (int d = lane; d < Dq; d += 32) dst[d] = d < D ? to_f32(src[d]) : 0.0f;
    }
  }
  __syncthreads();

  const int64_t P = (int64_t)F * (F - 1) / 2;
  const int row4 = Dp / 4, k4 = Dq / 4;
  for (int w = threadIdx.x; w < nb * ntiles; w += blockDim.x) {
    const int s = w / ntiles, t = w - s * ntiles;
    // tile (ti, tj), tj <= ti, in row-major lower-triangle order
    int ti = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
    while (ti > 0 && ti * (ti + 1) / 2 > t) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    const int tj = t - ti * (ti + 1) / 2;
    const int i0 = TILE * ti, j0 = TILE * tj;
    const float4* a = reinterpret_cast<const float4*>(xs + ((int64_t)s * Fp + i0) * Dp);
    const float4* c = reinterpret_cast<const float4*>(xs + ((int64_t)s * Fp + j0) * Dp);
    float z[TILE][TILE];
#pragma unroll
    for (int m = 0; m < TILE; ++m)
#pragma unroll
      for (int n = 0; n < TILE; ++n) z[m][n] = 0.0f;
    int k = k4 > 0 ? tj % k4 : 0;
    for (int step = 0; step < k4; ++step) {
      float4 A[TILE], C[TILE];
#pragma unroll
      for (int m = 0; m < TILE; ++m) {
        A[m] = a[m * row4 + k];
        C[m] = c[m * row4 + k];
      }
#pragma unroll
      for (int m = 0; m < TILE; ++m)
#pragma unroll
        for (int n = 0; n < TILE; ++n) z[m][n] = dot4(A[m], C[n], z[m][n]);
      if (++k == k4) k = 0;
    }
    float* o = out + (b0 + s) * P;
#pragma unroll
    for (int m = 0; m < TILE; ++m) {
      const int i = i0 + m;
#pragma unroll
      for (int n = 0; n < TILE; ++n) {
        const int j = j0 + n;
        if (i < F && j < i) o[i * (i - 1) / 2 + j] = z[m][n];
      }
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, void* out, int64_t B, int64_t F, int64_t D,
           cudaStream_t stream) {
  const int Fp = (int)((F + TILE - 1) / TILE * TILE);
  const int Dq = (int)((D + 3) / 4 * 4);
  const int Dp = (Dq + 31) / 32 * 32 + 4;
  const int64_t per = (int64_t)Fp * Dp * sizeof(float);
  const int64_t smem_cap = 232448;  // what one block may use on sm_90
  if (per > smem_cap) return (int)cudaErrorInvalidValue;
  int64_t spb = 49152 / per;
  if (spb < 1) spb = 1;
  if (spb > 8) spb = 8;
  const int64_t smem = spb * per;
  if (smem > 49152) {
    const cudaError_t e = cudaFuncSetAttribute(
        dot_interaction_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_side = Fp / TILE;
  const int ntiles = tiles_side * (tiles_side + 1) / 2;
  // one thread per tile of the block's samples, in whole warps, up to 256
  int64_t threads = (spb * ntiles + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  const int64_t blocks = (B + spb - 1) / spb;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dot_interaction_kernel<T, VEC><<<(unsigned)blocks, (unsigned)threads, (size_t)smem, stream>>>(
      (const T*)x, (float*)out, B, (int)F, (int)D, Fp, Dq, Dp, (int)spb, ntiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(const void* x, void* out, int64_t B, int64_t F, int64_t D,
               cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if ((uintptr_t)x % 16 == 0 && D % VEC == 0)
    return launch<T, VEC>(x, out, B, F, D, stream);
  return launch<T, 1>(x, out, B, F, D, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.
extern "C" int dot_interaction_launch(const void* x, void* out, int64_t B,
                                      int64_t F, int64_t D, int64_t dtype,
                                      void* stream) {
  if (B <= 0 || F < 2) return 0;
  if (D < 0 || F > 4096 || D > (1 << 20)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_vec<float>(x, out, B, F, D, s);
  return launch_vec<__nv_bfloat16>(x, out, B, F, D, s);
}
