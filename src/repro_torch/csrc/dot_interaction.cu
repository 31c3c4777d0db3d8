// DLRM dot interaction: the strictly lower triangle of X X^T per sample, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `dot_interaction`
// (src/repro/kernels/dot_interaction.py).
//
//   out[b, i*(i-1)/2 + j] = sum_d x[b, i, d] * x[b, j, d]   for F > i > j >= 0
//
// x (B, F, D) float32 or bfloat16, out (B, F(F-1)/2) float32, in
// tril_indices(F, -1) order. Products are summed in float32. The Pallas
// kernel casts its float32 sums back to x's type; this kernel keeps float32,
// which is what DLRM's interaction (`_interact` in src/repro/models/dlrm.py)
// computes. Any B is accepted; B == 0 launches nothing.
//
// Two kernels; the caller picks one by the input's type and shape and says
// which through `spg` (0: SIMT), so that each path is counted on its own.
//
// - bfloat16 with D % 16 == 0, `dot_interaction_tc_kernel`: the tensor
//   cores. What bounds it: bytes. At DLRM's shape (F = 27, D = 128) a sample
//   reads 6,912 B and writes 351 * 4 B against 2 * 351 * 128 operations, 10.8
//   a byte, far below the tensor cores' balance (989e12 / 3.35e12 = 295), so
//   the design keeps loads in flight and spends little on the rest:
//   * Persistent blocks walk groups of `spg` consecutive samples (one
//     contiguous span of spg * F * D * 2 bytes), blockIdx.x, + gridDim.x,
//     ... A ring of `stages` groups in shared memory is filled by 16-byte
//     cp.async.cg from every lane; the copies of group i + stages - 1 are
//     issued before group i is computed, so stages - 1 groups are in flight
//     while one is multiplied (110 KB an SM at DLRM's shape and plan).
//   * Rows are padded to 2 D + 16 bytes, an odd number of 16-byte units, so
//     the 8 rows of one ldmatrix phase cover all 32 banks once (unpadded 256
//     B rows would be an 8-way conflict). A group's rows follow each other
//     as in x; a sample's rows past F (F rounded up to 16) are the next
//     sample's rows, or zeroed tail rows after the group: they feed only
//     outputs that are thrown away, and the ring is zeroed once at the
//     start, so no uninitialised shared memory is ever read.
//   * One warp a sample: Z = X X^T by mma.sync m16n8k16 (bf16 in, float32
//     accumulate, the contract of `_interact`), operands from ldmatrix.x4.
//     Only the m16 x n8 tiles that touch the strict lower triangle are
//     computed (6 of 8 at F = 27: 48 mma over D = 128). The B fragment of
//     n-tiles 2p and 2p + 1 is the A fragment of m-tile p (X^T's columns are
//     X's rows), so a k-step loads one ldmatrix.x4 per 16 rows and no more.
//   * The product must also cost few instructions: with loads in flight the
//     time is the larger of the stream and the warps' issue. So the kernel
//     is instantiated for 1-4 m-tiles (F <= 64; a generic instance takes
//     any F), which unrolls the tiles, keeps every accumulator in registers,
//     and reduces the scatter to one compare and one store an entry. (With
//     runtime tile loops, the warps' issue alone took longer than DLRM's
//     stream on an H100; unrolled, it hides under the loads.)
//   * Each accumulator entry j < i < F goes to the sample's output row at
//     i(i-1)/2 + j in shared memory (the map of `ref.tc_store_map`); the
//     group's spg * P floats then leave as one contiguous span in 16-byte
//     stores (a lead of 0-3 floats aligns the span to 16 bytes).
//   The wrapper plans spg, stages and the grid (kernels/dot_interaction.py,
//   `tc_plan`): spg from B, so that a small batch (serve_p99's 512) still
//   spreads over every SM, and the largest ring that fits.
//
// - float32, or bfloat16 with D % 16 != 0, `dot_interaction_kernel`: SIMT.
//   Inputs are upcast to float32 and every pair is summed in float32 in the
//   order d = 0..D-1. What bounds it: at DLRM's shape in float32, bytes too
//   (2 * 351 * 128 / 15,228 B = 5.9 operations a byte, below the card's
//   float32 balance of 67e12 / 3.35e12 = 20); the design stages a few
//   samples of X per block in shared memory as float32, each row padded to a
//   stride of 4 (mod 32) words so that rows r and r + 1 start in neighbouring
//   16-byte bank groups, and has each thread compute a 4 x 4 tile of the F x
//   F product: four rows of X against four rows, 64 multiply-adds per eight
//   shared-memory loads of 16 bytes. Each thread starts its sweep over D at a
//   column rotated by its tile column, which spreads the threads that read
//   the same rows over the bank groups. Only tiles that touch the strict
//   lower triangle are computed. It loads each row before it converts and
//   stores it, so few loads are in flight (3.2 ms for DLRM's bfloat16 batch
//   on an H100, 20% of its byte bound): it serves only what the
//   tensor-core kernel does not take.
//
// - `dot_interaction_backward`: the gradient of the interaction (the Pallas
//   kernel has none; this is the vjp of DLRM's `_interact`). Per sample,
//   dX = S X with S = G + G^T, G (F, F) holding dZ at tril_indices(F, -1)
//   and zero elsewhere: dX[i] = sum over j != i of dZ[pair(i, j)] X[j],
//   rounded once to X's type. Two kernels, chosen like the forward's:
//
//   * bfloat16 with D % 16 == 0, `dot_interaction_backward_tc_kernel`: the
//     tensor cores. What bounds it: bytes. At DLRM's shape (F = 27, D = 128)
//     a sample reads 6,912 B of X and 1,404 B of dZ and writes 6,912 B of
//     dX against 2 * 27 * 26 * 128 operations (3 x that with the split
//     below), 19.5 a byte, far below the tensor cores' balance of 295. So
//     it is built like the forward: persistent blocks walk groups of `spg`
//     samples through a ring of `stages` slots filled by 16-byte
//     cp.async.cg, stages - 1 groups in flight while one is multiplied; a
//     slot holds the group's X rows (padded to 2 D + 16 bytes, so ldmatrix
//     phases are conflict-free) and its dZ span (after a lead of 0-3
//     floats that aligns it to 16 bytes; the last piece zero-filled past
//     the span). One warp a sample: A = S (F padded to 16-row tiles: 2 x 2
//     tiles at F = 27), each lane's fragment built straight from the staged
//     dZ, 0 on the diagonal and past F; B = X (k = field row, n = d) by
//     ldmatrix.x4.trans, the last k-step's rows past F (the next sample's)
//     masked to 0; mma.sync m16n8k16, bf16 in, float32 accumulate, over
//     chunks of 32 columns of dX (all of a sample's 2 x 16 accumulators
//     would take 128 registers a lane). wgmma's 64-row tile would pad a
//     27-row sample to 64.
//     dZ is float32, S exactly three bf16 terms: hi = bf16_rn(S), mid =
//     bf16_rn(S - hi), lo = bf16_rn(S - hi - mid). Both subtractions are
//     exact, and three 8-bit significands hold float32's 24 bits, so hi +
//     mid + lo = S for every finite S whose lo is normal (|S| above about
//     2^-110); a non-finite hi keeps mid = lo = 0. Each term times bf16 X
//     is exact in float32, so a tile takes three mma into one float32
//     accumulator and dX differs from the plain twin only by the order of
//     its float32 sums, before the same one rounding to bf16
//     (`ref.dot_interaction_backward_tc_ref` repeats the arithmetic). 192
//     mma a sample at F = 27, D = 128.
//     On an H100 80GB HBM3 at 700 W, at DLRM's train_batch shapes (B =
//     65,536): 0.355-0.362 ms against a byte bound of 0.298 ms (82-84%),
//     the SIMT kernel 1.302-1.303 ms in the same runs (chip_smoke.py).
//     A chunk's B fragments of every k-step are loaded before any of its
//     results is stored, so the warp writes its rounded dX over its own X
//     rows in the slot (rows below F only; another warp reads them only as
//     its masked pad rows), then writes the sample's dX out as one
//     contiguous span in 16-byte stores while the other warps compute, so
//     a group costs one barrier. The instances for 1-4 m-tiles
//     (F <= 64) unroll the tiles (at 1-2 m-tiles every A fragment is built
//     once a sample and held); the generic one (any F) rebuilds them a
//     tile at a time and stores dX straight from the fragments. The wrapper
//     plans spg, stages and the grid (`tc_backward_plan`).
//   * float32, or bfloat16 with another D or misaligned,
//     `dot_interaction_backward_kernel`: SIMT, a block a sample at a time
//     (a grid-stride loop), X upcast to float32 in shared memory and S
//     stored beside it with rows padded to a multiple of 4, so that a
//     thread reads S[j][i..i+3] as one 16-byte broadcast; a thread owns one
//     column d and computes four output rows per sweep over j = 0..F-1,
//     summed in float32. It loads each sample before it computes it, so few
//     loads are in flight: 1.30 ms for DLRM's bf16 train_batch step on an
//     H100 (23% of its byte bound).
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

// --------------------------------------------------- bf16 tensor-core kernel

constexpr int TC_PAIRS = 4;     // n-tile pairs a warp accumulates at once (32 floats a lane)
constexpr int TC_MAX_WARPS = 8;  // one warp a sample of the group, at most 8

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// One sample on one warp, F <= 16 MT: xs is the shared address of the
// sample's row 0 (rows of rb bytes, 16 MT of them readable), lane_off this
// lane's ldmatrix.x4 offset inside a 16 x 16 tile, o the sample's output row
// in shared memory. m-tile mt is rows [16 mt, 16 mt + 16), n-tile nt columns
// [8 nt, 8 nt + 8); every tile nt <= 2 mt + 1 is computed, except, in the
// last m-tile, those with 8 nt >= F - 1 (no column below a real row): the
// tiles with 8 nt < min(16 mt + 15, F - 1). Each k-step loads the A fragment
// of every m-tile once; the B fragments of n-tiles 2p and 2p + 1 are m-tile
// p's A fragment (b0 = a0, b1 = a2 and b0 = a1, b1 = a3), since Z = X X^T.
template <int MT>
__device__ __forceinline__ void tc_sample(uint32_t xs, float* o, int F, int K, int rb,
                                          uint32_t lane_off, int lane) {
  const int n_last = (F - 1 + 7) / 8;  // computed n-tiles of the last m-tile
  float acc[MT][2 * MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2 * MT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], xs + mt * 16 * rb + lane_off + k * 32);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int p = 0; p <= mt; ++p) {
        if (mt < MT - 1 || 2 * p < n_last) mma_bf16(acc[mt][2 * p], a[mt], a[p][0], a[p][2]);
        if (mt < MT - 1 || 2 * p + 1 < n_last)
          mma_bf16(acc[mt][2 * p + 1], a[mt], a[p][1], a[p][3]);
      }
  }
  // accumulator entry 2h + c of tile (mt, nt): row i = 16 mt + g + 8 h,
  // column j = 8 nt + 2 t + c (g = lane / 4, t = lane % 4); it is kept
  // where j < i < F, at i (i - 1) / 2 + j
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * mt + g + 8 * h;
      if (i >= F) continue;
      float* row = o + i * (i - 1) / 2 + 2 * t;
      const int lim = i - 2 * t;  // j < i: 8 nt + c < lim
#pragma unroll
      for (int nt = 0; nt < 2 * mt + 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (8 * nt + c < lim) row[8 * nt + c] = acc[mt][nt][2 * h + c];
    }
}

// The same for any F (MT = ceil(F / 16) above 4): a warp takes the m-tiles
// one at a time and their n-tiles TC_PAIRS pairs at a time, so its
// accumulators stay at 32 floats a lane.
__device__ __forceinline__ void tc_sample_any(uint32_t xs, float* o, int F, int K, int rb,
                                              uint32_t lane_off, int lane) {
  const int MT = (F + 15) / 16;
  const int g = lane >> 2, t = lane & 3;
  for (int mt = 0; mt < MT; ++mt) {
    const int i_hi = min(16 * mt + 15, F - 1);  // the m-tile's last real row
    const int n_nt = (i_hi + 7) / 8;            // its computed n-tiles
    const int n_pairs = (n_nt + 1) / 2;
    const uint32_t a_addr = xs + mt * 16 * rb + lane_off;
    for (int p0 = 0; p0 < n_pairs; p0 += TC_PAIRS) {
      float acc[TC_PAIRS][2][4];
#pragma unroll
      for (int q = 0; q < TC_PAIRS; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[q][h][r] = 0.0f;
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        uint32_t a[4];
        ldmatrix_x4(a, a_addr + k * 32);
        uint32_t b[TC_PAIRS][4];
#pragma unroll
        for (int q = 0; q < TC_PAIRS; ++q) {
          const int p = p0 + q;
#pragma unroll
          for (int r = 0; r < 4; ++r) b[q][r] = a[r];
          if (p < n_pairs && p != mt) ldmatrix_x4(b[q], xs + p * 16 * rb + lane_off + k * 32);
        }
#pragma unroll
        for (int q = 0; q < TC_PAIRS; ++q) {
          const int p = p0 + q;
          if (p < n_pairs) {
            mma_bf16(acc[q][0], a, b[q][0], b[q][2]);
            if (2 * p + 1 < n_nt) mma_bf16(acc[q][1], a, b[q][1], b[q][3]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < TC_PAIRS; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nt = 2 * (p0 + q) + h;
          if (nt >= n_nt) continue;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 16 * mt + g + 8 * (r >> 1), j = 8 * nt + 2 * t + (r & 1);
            if (j < i && i < F) o[i * (i - 1) / 2 + j] = acc[q][h][r];
          }
        }
    }
  }
}

// Shared memory: the output staging of a group (spg * P floats after a lead
// of 0-3, rounded up to 16 bytes), then `stages` ring slots of spg * F rows
// plus 16 * ceil(F / 16) - F tail rows, each row 2 D + 16 bytes.
__host__ __device__ __forceinline__ int64_t tc_staging_bytes(int64_t F, int64_t spg) {
  return (spg * (F * (F - 1) / 2) + 3 + 3) / 4 * 16;
}
__host__ __device__ __forceinline__ int64_t tc_slot_bytes(int64_t F, int64_t D, int64_t spg) {
  return (spg * F + (F + 15) / 16 * 16 - F) * (2 * D + 16);
}

// MT: ceil(F / 16) for F <= 64, 0 for any F.
template <int MT>
__global__ void __launch_bounds__(32 * TC_MAX_WARPS)
    dot_interaction_tc_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ out,
                              int64_t B, int F, int D, int spg, int stages, int64_t n_groups) {
  extern __shared__ float4 smem_tc[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_tc);
  float* stg = reinterpret_cast<float*>(base);
  unsigned char* ring = base + tc_staging_bytes(F, spg);
  const int rb = 2 * D + 16, chunks = D / 8, P = F * (F - 1) / 2;
  const int slot_bytes = (int)tc_slot_bytes(F, D, spg);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  // c / chunks = umulhi(c, magic) for c < 2^32 / chunks, which every index
  // of a group that fits in shared memory is
  const uint32_t magic = (uint32_t)((0x100000000ull + chunks - 1) / chunks);
  // ldmatrix.x4 address of this lane inside a 16 x 16 tile: matrices (rows
  // 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15),
  // which is the A fragment a0..a3 of m16n8k16
  const uint32_t lane_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * rb + (lane >> 4) * 16;

  for (int off = tid * 16; off < stages * slot_bytes; off += blockDim.x * 16)
    *reinterpret_cast<uint4*>(ring + off) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // this block's groups: blockIdx.x + i * gridDim.x for i < mine
  const int64_t mine = (n_groups - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto load = [&](int64_t i) {
    const int64_t s0 = (blockIdx.x + i * gridDim.x) * (int64_t)spg;
    const int n = (int)(B - s0 < spg ? B - s0 : spg) * F * chunks;
    const char* src = reinterpret_cast<const char*>(x + s0 * F * D);
    const uint32_t dst = smem_u32(ring + (int)(i % stages) * slot_bytes);
    for (int c = tid; c < n; c += blockDim.x) {
      const int r = (int)__umulhi((uint32_t)c, magic);  // c / chunks
      cp_async16(dst + r * rb + (c - r * chunks) * 16, src + (int64_t)c * 16);
    }
  };
  for (int i = 0; i < stages - 1; ++i) {
    if (i < mine) load(i);
    cp_async_commit();
  }
  for (int64_t i = 0; i < mine; ++i) {
    // the slot of group i + stages - 1 held group i - 1, which every warp
    // finished before the last barrier
    if (i + stages - 1 < mine) load(i + stages - 1);
    cp_async_commit();
    if (stages >= 3) cp_async_wait<2>();
    else if (stages == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // group i is in the ring

    const int64_t s0 = (blockIdx.x + i * gridDim.x) * (int64_t)spg;
    const int nb = (int)(B - s0 < spg ? B - s0 : spg);
    const int lead = (int)((s0 * P) & 3);
    const unsigned char* slot = ring + (int)(i % stages) * slot_bytes;
    for (int s = warp; s < nb; s += nwarps) {
      const uint32_t xs = smem_u32(slot + s * F * rb);
      if constexpr (MT > 0) tc_sample<MT>(xs, stg + lead + s * P, F, D / 16, rb, lane_off, lane);
      else tc_sample_any(xs, stg + lead + s * P, F, D / 16, rb, lane_off, lane);
    }
    __syncthreads();  // the group's outputs are staged

    // out + s0 * P - lead is 16-byte aligned: out is, and s0 * P - lead = 0 mod 4
    float* dst = out + s0 * P - lead;
    const int end = lead + nb * P, nv = (end + 3) / 4;
    for (int v = tid; v < nv; v += blockDim.x) {
      const int e = 4 * v;
      if (e >= lead && e + 4 <= end) {
        *reinterpret_cast<float4*>(dst + e) = *reinterpret_cast<const float4*>(stg + e);
      } else {
        for (int k = max(e, lead); k < min(e + 4, end); ++k) dst[k] = stg[k];
      }
    }
  }
  cp_async_wait<0>();
}

template <int MT>
int launch_tc_mt(const void* x, void* out, int64_t B, int64_t F, int64_t D, int64_t spg,
                 int64_t stages, int64_t grid, int64_t n_groups, int64_t smem,
                 cudaStream_t stream) {
  if (smem > 49152) {
    const cudaError_t e = cudaFuncSetAttribute(
        dot_interaction_tc_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = 32 * (int)(spg < TC_MAX_WARPS ? spg : TC_MAX_WARPS);
  dot_interaction_tc_kernel<MT><<<(unsigned)grid, threads, (size_t)smem, stream>>>(
      (const __nv_bfloat16*)x, (float*)out, B, (int)F, (int)D, (int)spg, (int)stages,
      n_groups);
  return (int)cudaGetLastError();
}

int launch_tc(const void* x, void* out, int64_t B, int64_t F, int64_t D, int64_t spg,
              int64_t stages, int64_t grid, cudaStream_t stream) {
  if (D <= 0 || D % 16 != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)out % 16 != 0 ||
      spg < 1 || spg > 1024 || stages < 1 || stages > 3 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = tc_staging_bytes(F, spg) + stages * tc_slot_bytes(F, D, spg);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // what one block may use on sm_90
  const int64_t n_groups = (B + spg - 1) / spg;
  if (grid > n_groups) grid = n_groups;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  switch ((F + 15) / 16) {
    case 1: return launch_tc_mt<1>(x, out, B, F, D, spg, stages, grid, n_groups, smem, stream);
    case 2: return launch_tc_mt<2>(x, out, B, F, D, spg, stages, grid, n_groups, smem, stream);
    case 3: return launch_tc_mt<3>(x, out, B, F, D, spg, stages, grid, n_groups, smem, stream);
    case 4: return launch_tc_mt<4>(x, out, B, F, D, spg, stages, grid, n_groups, smem, stream);
    default: return launch_tc_mt<0>(x, out, B, F, D, spg, stages, grid, n_groups, smem, stream);
  }
}

// ------------------------------------------------------------ backward

__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void dot_interaction_backward_kernel(const T* __restrict__ x,
                                                const float* __restrict__ dz,
                                                T* __restrict__ dx, int64_t B, int F,
                                                int D, int F4) {
  extern __shared__ float4 smem_bwd[];
  float* sym = reinterpret_cast<float*>(smem_bwd);  // (F, F4): S[j][i] = S[i][j]
  float* xs = sym + F * F4;                          // (F, D) float32
  const int P = F * (F - 1) / 2;
  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    __syncthreads();  // the previous sample's reads are done
    const T* xb = x + b * F * D;
    for (int e = threadIdx.x; e < F * D; e += blockDim.x) xs[e] = to_f32(xb[e]);
    const float* dzb = dz + b * P;
    for (int e = threadIdx.x; e < F * F4; e += blockDim.x) {
      const int j = e / F4, i = e % F4;
      float v = 0.0f;
      if (i < F && i != j) {
        const int hi = i > j ? i : j, lo = i > j ? j : i;
        v = dzb[hi * (hi - 1) / 2 + lo];
      }
      sym[e] = v;
    }
    __syncthreads();
    T* dxb = dx + b * F * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      for (int i0 = 0; i0 < F; i0 += 4) {
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        for (int j = 0; j < F; ++j) {
          const float xv = xs[j * D + d];
          const float4 sv = *reinterpret_cast<const float4*>(sym + j * F4 + i0);
          a0 += sv.x * xv;
          a1 += sv.y * xv;
          a2 += sv.z * xv;
          a3 += sv.w * xv;
        }
        const float a[4] = {a0, a1, a2, a3};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (i0 + r < F) from_f32(a[r], &dxb[(int64_t)(i0 + r) * D + d]);
        }
      }
    }
  }
}

template <typename T>
int launch_backward(const void* x, const void* dz, void* dx, int64_t B, int64_t F,
                    int64_t D, int64_t grid, cudaStream_t stream) {
  const int F4 = (int)((F + 3) / 4 * 4);
  const int64_t smem = ((int64_t)F * F4 + F * D) * (int64_t)sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 49152) {
    const cudaError_t e = cudaFuncSetAttribute(dot_interaction_backward_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int64_t threads = (D + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  if (grid > B) grid = B;
  if (grid < 1 || grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dot_interaction_backward_kernel<T><<<(unsigned)grid, (unsigned)threads, (size_t)smem,
                                       stream>>>((const T*)x, (const float*)dz, (T*)dx, B,
                                                 (int)F, (int)D, F4);
  return (int)cudaGetLastError();
}

// --------------------------------------------------- bf16 tensor-core backward

constexpr int BWD_PAIRS = 2;  // n-tile pairs (32 columns of dX) a chunk accumulates

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// the first `bytes` (0-16) of 16 from src, the rest zero-filled
__device__ __forceinline__ void cp_async16_n(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// S[r][c] of a sample whose dZ row is dzs: dZ[pair(max, min)] off the
// diagonal inside F x F, else 0
__device__ __forceinline__ float sym_at(const float* dzs, int r, int c, int F) {
  if (r >= F || c >= F || r == c) return 0.0f;
  const int h = r > c ? r : c, l = r > c ? c : r;
  return dzs[h * (h - 1) / 2 + l];
}

// Two entries of S (v0 in the low half) as three bf16 pairs, hi + mid + lo
// = v exactly: hi = bf16_rn(v), mid = bf16_rn(v - hi), lo = bf16_rn(v - hi -
// mid), both subtractions exact; a non-finite hi keeps mid = lo = 0.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  const float r0 = (hi & 0x7f80u) != 0x7f80u ? v0 - hf.x : 0.0f;  // hi's exponent not all ones
  const float r1 = (hi & 0x7f800000u) != 0x7f800000u ? v1 - hf.y : 0.0f;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// a[term][q]: the m16n8k16 A fragment of S's tile (rows 16 mt.., columns
// 16 kt..) for each term (hi, mid, lo): a0 (row g, columns 2t, 2t + 1), a1
// (row g + 8), a2 (columns + 8), a3 (both)
__device__ __forceinline__ void sym_frag(uint32_t (&a)[3][4], const float* dzs, int F, int mt,
                                         int kt, int g, int t) {
  const int r0 = 16 * mt + g, c0 = 16 * kt + 2 * t;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + 8 * (q & 1), c = c0 + 8 * (q >> 1);
    split3(sym_at(dzs, r, c, F), sym_at(dzs, r, c + 1, F), a[0][q], a[1][q], a[2][q]);
  }
}

// ldmatrix.x4.trans of X's 16 rows from k-step kt at columns n..n + 15: the
// B fragments (b0, b1) of n-tiles n / 8 (r[0], r[1]) and n / 8 + 1 (r[2],
// r[3]), lane holding rows 16 kt + 2t, + 1 (r[0], r[2]) and + 8, + 9 (r[1],
// r[3]) at column g; in the last k-step the rows past F are masked to 0
// (m_lo, m_hi: the lane's halves below F).
__device__ __forceinline__ void x_frag(uint32_t (&b)[4], uint32_t addr, bool last,
                                       uint32_t m_lo, uint32_t m_hi) {
  ldmatrix_x4_trans(b, addr);
  if (last) {
    b[0] &= m_lo;
    b[1] &= m_hi;
    b[2] &= m_lo;
    b[3] &= m_hi;
  }
}

// c (+)= a_term b for the three terms, hi first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a)[3][4], uint32_t b0,
                                     uint32_t b1) {
#pragma unroll
  for (int term = 0; term < 3; ++term) mma_bf16(c, a[term], b0, b1);
}

// accumulator entries (2h, 2h + 1) of n-tile q of the chunk at column n0:
// row 16 mt + g + 8h, columns n0 + 8q + 2t, + 1, rounded to bf16 as a pair
// and stored at row stride rs (elements) from `out`
__device__ __forceinline__ void store_tile(__nv_bfloat16* out, int rs, const float (&c)[4],
                                           int mt, int q, int n0, int F, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 16 * mt + g + 8 * h;
    if (i < F)
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)i * rs + n0 + 8 * q + 2 * t) =
          __floats2bfloat162_rn(c[2 * h], c[2 * h + 1]);
  }
}

// One sample on one warp, F <= 16 MT: xs its row 0 in the slot (rows of rb
// bytes, 16 MT of them readable), dzs its dZ row, lane_off this lane's
// ldmatrix offset inside a 16 x 16 tile. dX overwrites the sample's rows
// below F in place, chunk by chunk: a chunk's B fragments of every k-step
// are in registers before any of its results is stored.
template <int MT>
__device__ __forceinline__ void bwd_tc_sample(unsigned char* xs, const float* dzs, int F, int D,
                                              int rb, uint32_t lane_off, int lane) {
  constexpr bool HOLD = MT <= 2;  // every A fragment built once and held (12 MT^2 registers)
  const int g = lane >> 2, t = lane & 3;
  const uint32_t xa = smem_u32(xs) + lane_off;
  const int kl = 16 * (MT - 1) + 2 * t;
  const uint32_t m_lo = (kl < F ? 0xffffu : 0u) | (kl + 1 < F ? 0xffff0000u : 0u);
  const uint32_t m_hi = (kl + 8 < F ? 0xffffu : 0u) | (kl + 9 < F ? 0xffff0000u : 0u);
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(xs);
  const int rs = rb / 2;
  uint32_t ah[HOLD ? MT : 1][HOLD ? MT : 1][3][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kt = 0; kt < MT; ++kt) sym_frag(ah[mt][kt], dzs, F, mt, kt, g, t);
  }
  for (int n0 = 0; n0 < D; n0 += 16 * BWD_PAIRS) {
    const bool two = n0 + 16 < D;  // D % 32 == 16 leaves one pair in the last chunk
    uint32_t b[MT][BWD_PAIRS][4];
#pragma unroll
    for (int kt = 0; kt < MT; ++kt)
#pragma unroll
      for (int p = 0; p < BWD_PAIRS; ++p) {
        if (p == 0 || two) {
          x_frag(b[kt][p], xa + kt * 16 * rb + (n0 + 16 * p) * 2, kt == MT - 1, m_lo, m_hi);
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) b[kt][p][r] = 0u;
        }
      }
    __syncwarp();  // the chunk's columns are read: its results may overwrite them
    if constexpr (HOLD) {
      float acc[MT][2 * BWD_PAIRS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 2 * BWD_PAIRS; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][q][r] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < MT; ++kt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int p = 0; p < BWD_PAIRS; ++p)
            if (p == 0 || two) {
              mma3(acc[mt][2 * p], ah[mt][kt], b[kt][p][0], b[kt][p][1]);
              mma3(acc[mt][2 * p + 1], ah[mt][kt], b[kt][p][2], b[kt][p][3]);
            }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 2 * BWD_PAIRS; ++q)
          if (q < 2 || two) store_tile(out, rs, acc[mt][q], mt, q, n0, F, g, t);
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float acc[2 * BWD_PAIRS][4];
#pragma unroll
        for (int q = 0; q < 2 * BWD_PAIRS; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[q][r] = 0.0f;
#pragma unroll
        for (int kt = 0; kt < MT; ++kt) {
          uint32_t a[3][4];
          sym_frag(a, dzs, F, mt, kt, g, t);
#pragma unroll
          for (int p = 0; p < BWD_PAIRS; ++p)
            if (p == 0 || two) {
              mma3(acc[2 * p], a, b[kt][p][0], b[kt][p][1]);
              mma3(acc[2 * p + 1], a, b[kt][p][2], b[kt][p][3]);
            }
        }
#pragma unroll
        for (int q = 0; q < 2 * BWD_PAIRS; ++q)
          if (q < 2 || two) store_tile(out, rs, acc[q], mt, q, n0, F, g, t);
      }
    }
  }
}

// The same for any F, a 16-column pair and an m-tile at a time, every
// fragment built when it is used; dX goes straight to dxs (the sample's
// rows in device memory) and the slot is left as it was.
__device__ __forceinline__ void bwd_tc_sample_any(uint32_t xa, const float* dzs,
                                                  __nv_bfloat16* dxs, int F, int D, int rb,
                                                  uint32_t lane_off, int lane) {
  const int MT = (F + 15) / 16;
  const int g = lane >> 2, t = lane & 3;
  const int kl = 16 * (MT - 1) + 2 * t;
  const uint32_t m_lo = (kl < F ? 0xffffu : 0u) | (kl + 1 < F ? 0xffff0000u : 0u);
  const uint32_t m_hi = (kl + 8 < F ? 0xffffu : 0u) | (kl + 9 < F ? 0xffff0000u : 0u);
  for (int mt = 0; mt < MT; ++mt)
    for (int n0 = 0; n0 < D; n0 += 16) {
      float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      for (int kt = 0; kt < MT; ++kt) {
        uint32_t b[4], a[3][4];
        x_frag(b, xa + lane_off + kt * 16 * rb + n0 * 2, kt == MT - 1, m_lo, m_hi);
        sym_frag(a, dzs, F, mt, kt, g, t);
        mma3(acc[0], a, b[0], b[1]);
        mma3(acc[1], a, b[2], b[3]);
      }
      store_tile(dxs, D, acc[0], mt, 0, n0, F, g, t);
      store_tile(dxs, D, acc[1], mt, 1, n0, F, g, t);
    }
}

// A ring slot of the backward: the group's X rows as in the forward
// (tc_slot_bytes), then its dZ span after a lead of 0-3 floats, rounded up
// to 16 bytes.
__host__ __device__ __forceinline__ int64_t bwd_dz_bytes(int64_t F, int64_t spg) {
  return (spg * (F * (F - 1) / 2) + 3 + 3) / 4 * 16;
}
__host__ __device__ __forceinline__ int64_t bwd_slot_bytes(int64_t F, int64_t D, int64_t spg) {
  return tc_slot_bytes(F, D, spg) + bwd_dz_bytes(F, spg);
}

// MT: ceil(F / 16) for F <= 64, 0 for any F.
template <int MT>
__global__ void __launch_bounds__(32 * TC_MAX_WARPS)
    dot_interaction_backward_tc_kernel(const __nv_bfloat16* __restrict__ x,
                                       const float* __restrict__ dz,
                                       __nv_bfloat16* __restrict__ dx, int64_t B, int F, int D,
                                       int spg, int stages, int64_t n_groups) {
  extern __shared__ float4 smem_bwd_tc[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem_bwd_tc);
  const int rb = 2 * D + 16, chunks = D / 8, P = F * (F - 1) / 2;
  const int x_bytes = (int)tc_slot_bytes(F, D, spg), slot_bytes = (int)bwd_slot_bytes(F, D, spg);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  // c / chunks = umulhi(c, magic) for every index of a group that fits in
  // shared memory
  const uint32_t magic = (uint32_t)((0x100000000ull + chunks - 1) / chunks);
  // ldmatrix.x4 address of this lane inside a 16 x 16 tile: matrices (rows
  // 0-7, columns 0-7), (rows 8-15, 0-7), (rows 0-7, 8-15), (rows 8-15, 8-15)
  const uint32_t lane_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * rb + (lane >> 4) * 16;

  // this block's groups: blockIdx.x + i * gridDim.x for i < mine
  const int64_t mine = (n_groups - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto load = [&](int64_t i) {
    const int64_t s0 = (blockIdx.x + i * gridDim.x) * (int64_t)spg;
    const int nb = (int)(B - s0 < spg ? B - s0 : spg);
    const uint32_t dst = smem_u32(ring + (int)(i % stages) * slot_bytes);
    const char* src = reinterpret_cast<const char*>(x + s0 * F * D);
    const int n = nb * F * chunks;
    for (int c = tid; c < n; c += blockDim.x) {
      const int r = (int)__umulhi((uint32_t)c, magic);  // c / chunks
      cp_async16(dst + r * rb + (c - r * chunks) * 16, src + (int64_t)c * 16);
    }
    // dZ floats [s0 P - lead, (s0 + nb) P), 16-byte aligned at its start
    const int lead = (int)((s0 * P) & 3), nf = lead + nb * P;
    const float* zsrc = dz + (s0 * P - lead);
    for (int q = tid; 4 * q < nf; q += blockDim.x) {
      const int left = nf - 4 * q;
      cp_async16_n(dst + x_bytes + q * 16, zsrc + 4 * q, left >= 4 ? 16 : 4 * left);
    }
  };
  for (int i = 0; i < stages - 1; ++i) {
    if (i < mine) load(i);
    cp_async_commit();
  }
  for (int64_t i = 0; i < mine; ++i) {
    if (stages == 1) {
      __syncthreads();  // the slot's last copy-out is done
      load(i);
      cp_async_commit();
    }
    if (stages >= 3) cp_async_wait<1>();
    else cp_async_wait<0>();
    // group i is in its slot; every warp is done with group i - 1, whose
    // slot takes group i + stages - 1
    __syncthreads();
    if (stages > 1) {
      if (i + stages - 1 < mine) load(i + stages - 1);
      cp_async_commit();
    }

    const int64_t s0 = (blockIdx.x + i * gridDim.x) * (int64_t)spg;
    const int nb = (int)(B - s0 < spg ? B - s0 : spg);
    unsigned char* slot = ring + (int)(i % stages) * slot_bytes;
    const float* dzg = reinterpret_cast<const float*>(slot + x_bytes) + ((s0 * P) & 3);
    for (int s = warp; s < nb; s += nwarps) {
      unsigned char* xs = slot + s * F * rb;
      __nv_bfloat16* dxs = dx + (s0 + s) * F * D;
      if constexpr (MT > 0) {
        bwd_tc_sample<MT>(xs, dzg + s * P, F, D, rb, lane_off, lane);
        __syncwarp();  // the sample's dX is in its rows
        // ... and leaves as one contiguous span of F D values in 16-byte
        // stores while the other warps compute
        uint4* out = reinterpret_cast<uint4*>(dxs);
        for (int c = lane; c < F * chunks; c += 32) {
          const int r = (int)__umulhi((uint32_t)c, magic);
          out[c] = *reinterpret_cast<const uint4*>(xs + r * rb + (c - r * chunks) * 16);
        }
      } else {
        bwd_tc_sample_any(smem_u32(xs), dzg + s * P, dxs, F, D, rb, lane_off, lane);
      }
    }
  }
  cp_async_wait<0>();
}

const void* bwd_tc_instance(int64_t F) {
  switch ((F + 15) / 16) {
    case 1: return (const void*)dot_interaction_backward_tc_kernel<1>;
    case 2: return (const void*)dot_interaction_backward_tc_kernel<2>;
    case 3: return (const void*)dot_interaction_backward_tc_kernel<3>;
    case 4: return (const void*)dot_interaction_backward_tc_kernel<4>;
    default: return (const void*)dot_interaction_backward_tc_kernel<0>;
  }
}

int launch_backward_tc(const void* x, const void* dz, void* dx, int64_t B, int64_t F,
                       int64_t D, int64_t spg, int64_t stages, int64_t grid,
                       cudaStream_t stream) {
  if (D <= 0 || D % 16 != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)dz % 16 != 0 ||
      (uintptr_t)dx % 16 != 0 || spg < 1 || spg > 1024 || stages < 1 || stages > 3 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = stages * bwd_slot_bytes(F, D, spg);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // what one block may use on sm_90
  const int64_t n_groups = (B + spg - 1) / spg;
  if (grid > n_groups) grid = n_groups;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const void* fn = bwd_tc_instance(F);
  if (smem > 49152) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const __nv_bfloat16* xp = (const __nv_bfloat16*)x;
  const float* dzp = (const float*)dz;
  __nv_bfloat16* dxp = (__nv_bfloat16*)dx;
  int Fi = (int)F, Di = (int)D, spgi = (int)spg, st = (int)stages;
  void* args[] = {&xp, &dzp, &dxp, &B, &Fi, &Di, &spgi, &st, (void*)&n_groups};
  const unsigned threads = 32 * (unsigned)(spg < TC_MAX_WARPS ? spg : TC_MAX_WARPS);
  const cudaError_t e =
      cudaLaunchKernel(fn, dim3((unsigned)grid), dim3(threads), args, (size_t)smem, stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. spg > 0 asks for the tensor-core kernel
// (bfloat16, D % 16 == 0) with groups of spg samples, a ring of `stages`
// and `grid` persistent blocks; spg == 0 for the SIMT kernel, which
// ignores stages and grid.
extern "C" int dot_interaction_launch(const void* x, void* out, int64_t B,
                                      int64_t F, int64_t D, int64_t dtype, int64_t spg,
                                      int64_t stages, int64_t grid, void* stream) {
  if (B <= 0 || F < 2) return 0;
  if (D < 0 || F > 4096 || D > (1 << 20) || spg < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (spg > 0) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_tc(x, out, B, F, D, spg, stages, grid, s);
  }
  if (dtype == 0) return launch_vec<float>(x, out, B, F, D, s);
  return launch_vec<__nv_bfloat16>(x, out, B, F, D, s);
}

// x (B, F, D), dtype 0 float32 or 1 bfloat16; dz (B, F(F-1)/2) float32 in
// tril_indices(F, -1) order; dx (B, F, D) in x's type. spg > 0 asks for the
// tensor-core kernel (bfloat16, D % 16 == 0, x, dz and dx 16-byte aligned)
// with groups of spg samples, a ring of `stages` and `grid` persistent
// blocks; spg == 0 for the SIMT kernel on `grid` blocks, each taking samples
// blockIdx.x, + grid, ..., which ignores stages.
extern "C" int dot_interaction_backward_launch(const void* x, const void* dz, void* dx,
                                               int64_t B, int64_t F, int64_t D, int64_t dtype,
                                               int64_t spg, int64_t stages, int64_t grid,
                                               void* stream) {
  if (B <= 0 || F <= 0 || D <= 0) return 0;
  if (F > 4096 || D > (1 << 20) || spg < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (spg > 0) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_backward_tc(x, dz, dx, B, F, D, spg, stages, grid, s);
  }
  if (dtype == 0) return launch_backward<float>(x, dz, dx, B, F, D, grid, s);
  return launch_backward<__nv_bfloat16>(x, dz, dx, B, F, D, grid, s);
}

// What the card fits of the tensor-core backward's instance for F at
// `threads` threads and `smem` bytes of shared memory a block: out[0] its
// blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] its
// registers a thread, out[2] its local memory a thread (spills). Nothing is
// launched.
extern "C" int dot_interaction_backward_occupancy(int64_t F, int64_t threads, int64_t smem,
                                                  int64_t* out) {
  if (F <= 0 || F > 4096 || threads < 32 || threads > 32 * TC_MAX_WARPS || smem < 0 ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  const void* fn = bwd_tc_instance(F);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)(smem > 49152 ? smem : 49152));
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, (int)threads, (size_t)smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int64_t)attr.localSizeBytes;
  return 0;
}
