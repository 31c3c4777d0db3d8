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
// The numerics are the Pallas kernel's: scores and the running max m, sum l
// and output accumulator in float32; p = exp(s - m) rounded to v's type
// before the PV product; masked scores at -1e30 and masked p forced to 0.
// q_offset puts query row i at absolute position i + q_offset (the Pallas
// kernel fixes Sk - Sq): prefill attends positions 0..S-1 against a longer
// cache, decode one position against the cache. Any Sq, Sk >= 0; D a
// multiple of 8 up to 256.
//
// Design. A block owns BM rows of one (batch, kv head): the rows are the
// (query position, head in the group) pairs r = i * group + g, so the heads
// that share a kv head share every K/V tile the block stages. At decode
// (Sq = 1) the six query heads of qwen2's group read the cache once, not
// six times. The block walks only the K/V tiles that some row of it can
// see (the Pallas kernel's `pl.when(block_visible)`): causal decode stops
// at cur_index, prefill at the tile's last position. Tiles of BN keys are
// copied to shared memory with cp.async, double-buffered, so the next
// tile's copy runs under this tile's arithmetic. Scores and the PV product
// are float32 FMAs out of shared memory (no tensor cores, so no TF32 for a
// float32 input); m and l live in shared memory, the accumulator in
// registers. Nothing carries over between blocks.
//
// What bounds it on this card: at decode, bytes (each step reads the whole
// visible cache once; qwen2-1.5b at 32k tokens x 64 sequences moves
// 60.1 GB); at prefill, the float32 FMA rate (67 TFLOP/s outside the
// tensor cores), far under the bf16 tensor-core rate (989 TFLOP/s) that
// the bound counts. A tensor-core redesign is later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t Sq, Sk, D, group;
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
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;  // elements in 16 bytes
  __device__ static void load16(const unsigned char* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
  __device__ static void load4(const unsigned char* p, float* out) { load16(p, out); }
  __device__ static void store4(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
  __device__ static float round(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load16(const unsigned char* p, float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    out[0] = bf16_lo(x.x); out[1] = bf16_hi(x.x); out[2] = bf16_lo(x.y); out[3] = bf16_hi(x.y);
    out[4] = bf16_lo(x.z); out[5] = bf16_hi(x.z); out[6] = bf16_lo(x.w); out[7] = bf16_hi(x.w);
  }
  __device__ static void load4(const unsigned char* p, float* out) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    out[0] = bf16_lo(x.x); out[1] = bf16_hi(x.x); out[2] = bf16_lo(x.y); out[3] = bf16_hi(x.y);
  }
  __device__ static void store4(__nv_bfloat16* p, const float* x) {
    __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&a);
    w.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = w;
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

// Shared memory of one block: the Q tile, two stages of K and V tiles (rows
// of DMAX elements padded by 16 bytes, so the rows that a warp reads at one
// column fall in different banks), the BM x BN score tile, and m, l, alpha.
template <typename T, int BM, int BN, int DMAX>
struct Smem {
  static constexpr int kRow = DMAX * (int)sizeof(T) + 16;
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
// DMAX / CG output columns (4 at a time: cg * 4 + 4 * CG * j).
template <typename T, int BM, int BN, int DMAX, int RG>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  using IO = Io<T>;
  using SM = Smem<T, BM, BN, DMAX>;
  constexpr int CG = kThreads / RG;
  constexpr int TM = BM / RG;
  constexpr int TN = BN / CG;
  constexpr int DC = DMAX / CG;
  constexpr int VEC = IO::kVec;
  constexpr int TPR = kThreads / BM;  // threads per row in the softmax phase
  static_assert(RG * CG == kThreads && TM * RG == BM && TN * CG == BN, "tile shape");
  static_assert(DC % 4 == 0 && TPR >= 1 && TPR <= 32, "tile shape");

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
  const int64_t r0 = (int64_t)blockIdx.x * BM;
  const int D = (int)p.D;
  const int chunks = D / VEC;

  // keys that some row of this tile can see
  const int64_t r_last = (r0 + BM < R ? r0 + BM : R) - 1;
  const int64_t pos_lo = r0 / group + p.q_offset;
  const int64_t pos_hi = r_last / group + p.q_offset;
  int64_t k_begin = 0, k_end = p.Sk;
  if (p.causal && pos_hi + 1 < k_end) k_end = pos_hi + 1;
  if (p.window > 0 && pos_lo - p.window + 1 > k_begin) k_begin = pos_lo - p.window + 1;
  const int64_t n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  const unsigned char* qb = static_cast<const unsigned char*>(p.q);
  const unsigned char* kb =
      static_cast<const unsigned char*>(p.k) + (b * p.k_sb + kvh * p.k_sh) * (int64_t)sizeof(T);
  const unsigned char* vb =
      static_cast<const unsigned char*>(p.v) + (b * p.v_sb + kvh * p.v_sh) * (int64_t)sizeof(T);

  // stage the Q tile (rows past R are zeros)
  for (int c = tid; c < BM * chunks; c += kThreads) {
    const int row = c / chunks, ch = c % chunks;
    const int64_t r = r0 + row;
    const bool valid = r < R;
    const unsigned char* src = qb;
    if (valid) {
      const int64_t i = r / group, h = kvh * group + r % group;
      src += (b * p.q_sb + h * p.q_sh + i * p.q_ss + (int64_t)ch * VEC) * (int64_t)sizeof(T);
    }
    cp_async16(q_s + row * SM::kRow + ch * 16, src, valid);
  }
  auto load_kv = [&](int stage, int64_t t0) {
    for (int c = tid; c < BN * chunks; c += kThreads) {
      const int row = c / chunks, ch = c % chunks;
      const int64_t key = t0 + row;
      const bool valid = key < p.Sk;  // past Sk: zeros, so 0 * v stays 0
      const int64_t off = (int64_t)ch * VEC * (int64_t)sizeof(T);
      const unsigned char* ks = valid ? kb + key * p.k_ss * (int64_t)sizeof(T) + off : kb;
      const unsigned char* vs = valid ? vb + key * p.v_ss * (int64_t)sizeof(T) + off : vb;
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

  auto visible = [&](int64_t pos, int64_t key) {
    return pos != INT64_MIN && key < p.Sk && (!p.causal || pos >= key) &&
           (p.window <= 0 || key > pos - p.window);
  };

  // softmax phase: TPR consecutive lanes per row
  const int sm_row = tid / TPR, sm_part = tid % TPR;
  const int64_t sm_r = r0 + sm_row;
  const int64_t sm_pos = sm_r < R ? sm_r / group + p.q_offset : INT64_MIN;

  for (int64_t t = 0; t < n_tiles; ++t) {
    const int stage = (int)(t & 1);
    const int64_t t0 = k_begin + t * BN;
    cp_async_wait_all();
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
      for (int a = 0; a < TM; ++a) IO::load16(q_s + (rg * TM + a) * SM::kRow + ch * 16, qv[a]);
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        float kv[VEC];
        IO::load16(kt + (cg + CG * c) * SM::kRow + ch * 16, kv);
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
        if (!visible(my_pos[a], t0 + n)) s = kNegInf;
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
        const float pv = visible(sm_pos, t0 + n) ? expf(srow[n] - m_cur) : 0.0f;
        sum += pv;
        srow[n] = IO::round(pv);
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
          IO::load4(vt + n * SM::kRow + d0 * (int)sizeof(T), v4);
#pragma unroll
          for (int a = 0; a < TM; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][j * 4 + e] = fmaf(pr[a], v4[e], acc[a][j * 4 + e]);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // o = acc / l, 0 for a row that saw no key
  T* ob = static_cast<T*>(p.o);
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int row = rg * TM + a;
    const int64_t r = r0 + row;
    if (r >= R) continue;
    const float l = l_s[row];
    const float denom = l == 0.0f ? 1.0f : l;
    const int64_t i = r / group, h = kvh * group + r % group;
    T* dst = ob + b * p.o_sb + h * p.o_sh + i * p.o_ss;
#pragma unroll
    for (int j = 0; j < DC / 4; ++j) {
      const int d0 = cg * 4 + 4 * CG * j;
      if (d0 < D) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = acc[a][j * 4 + e] / denom;
        IO::store4(dst + d0, x);
      }
    }
  }
}

template <typename T, int BM, int DMAX, int RG>
int launch(const Params& p, int64_t B, int64_t Hkv, cudaStream_t stream) {
  constexpr int BN = DMAX * (int)sizeof(T) <= 256 ? 64 : 32;
  constexpr int bytes = Smem<T, BM, BN, DMAX>::kBytes;
  auto kernel = flash_attention_kernel<T, BM, BN, DMAX, RG>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int64_t row_tiles = (p.Sq * p.group + BM - 1) / BM;
  if (row_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)row_tiles, (unsigned)Hkv, (unsigned)B);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_d(const Params& p, int64_t B, int64_t Hkv, cudaStream_t stream) {
  if (p.Sq * p.group <= 8) return launch<T, 8, DMAX, 8>(p, B, Hkv, stream);  // decode
  if constexpr (DMAX == 256) return launch<T, 32, DMAX, 16>(p, B, Hkv, stream);
  else return launch<T, 64, DMAX, 16>(p, B, Hkv, stream);
}

template <typename T>
int launch_t(const Params& p, int64_t B, int64_t Hkv, cudaStream_t stream) {
  if (p.D <= 64) return launch_d<T, 64>(p, B, Hkv, stream);
  if (p.D <= 128) return launch_d<T, 128>(p, B, Hkv, stream);
  return launch_d<T, 256>(p, B, Hkv, stream);
}

bool aligned(const void* ptr, int64_t sb, int64_t sh, int64_t ss, int64_t vec) {
  return (uintptr_t)ptr % 16 == 0 && sb % vec == 0 && sh % vec == 0 && ss % vec == 0;
}

}  // namespace

// q, k, v, o: device pointers; strides in elements, (batch, head, position)
// each, D contiguous. window <= 0: none; softcap <= 0: none. dtype: 0
// float32, 1 bfloat16. Returns a cudaError_t; Sq == 0 launches nothing.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Hq, int64_t Hkv,
    int64_t Sq, int64_t Sk, int64_t D, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, int64_t causal, int64_t window, int64_t q_offset,
    float softcap, float sm_scale, int64_t dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk < 0 || D <= 0 || D > 256 || D % 8 != 0 ||
      B > 65535 || Hkv > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int64_t vec = dtype == 0 ? 4 : 8;
  if (!aligned(q, q_sb, q_sh, q_ss, vec) || !aligned(k, k_sb, k_sh, k_ss, vec) ||
      !aligned(v, v_sb, v_sh, v_ss, vec) || !aligned(o, o_sb, o_sh, o_ss, 4))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, Sq, Sk, D, Hq / Hkv,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
           q_offset, window, causal != 0 ? 1 : 0, softcap, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_t<float>(p, B, Hkv, s);
  return launch_t<__nv_bfloat16>(p, B, Hkv, s);
}
