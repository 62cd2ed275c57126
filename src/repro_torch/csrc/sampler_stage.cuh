// ThundeRiNG arithmetic and sampler output stages, in registers.
//
// Shared by the block kernels of thundering_block.cu.  Every function here
// is the device form of a function in repro_torch/core (lcg, splitmix,
// xorshift, sampler) and must agree with it: bit for bit on the integer
// and threshold stages, within a few ULP where logf / sinf / cosf enter
// (CUDA's logf is within 1 ULP, sinf / cosf within 2 ULP of the true
// value).  The sources build with -fmad=false, so a product that feeds an
// add is rounded on its own, as in eager PyTorch and as the reference's
// fma_guard enforces under XLA; the bytes are then the same at every
// batch shape and tiling.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

#define TB_LCG_A 6364136223846793005ULL
#define TB_LCG_C 1442695040888963407ULL
#define TB_GAMMA 0x9E3779B97F4A7C15ULL
#define TB_MIX1 0xBF58476D1CE4E5B9ULL
#define TB_MIX2 0x94D049BB133111EBULL
#define TB_CTR_KEY 0xD1B54A32D192ED03ULL

#define TB_TINY_F32 0x1p-126f          /* smallest normal float32 */
#define TB_TWO_PI_F32 0x1.921fb6p+2f   /* float32(2 pi) */

// Stage numbers: repro_torch.core.sampler.STAGE_IDS.
enum StageKind {
  STAGE_BITS = 0, STAGE_UNIFORM = 1, STAGE_NORMAL = 2, STAGE_BERNOULLI = 3,
  STAGE_EXPONENTIAL = 4, STAGE_POISSON = 5, STAGE_GAMMA = 6,
  STAGE_GUMBEL = 7, STAGE_CATEGORICAL = 8
};
// Output types: repro_torch.core.sampler.OUT_TYPE_IDS.
enum OutType { OUT_U32 = 0, OUT_F32 = 1, OUT_BF16 = 2, OUT_BOOL = 3 };

// One sampler stage, built on the host by sampler.stage_params.
//   bernoulli:   thresh = round(p 2^32); flag = 1 for the constant True mask
//   exponential: f0 = float32(1 / rate)
//   poisson:     table_f = CDF ladder (n_table rungs, non-decreasing)
//   gamma:       f0 = d, f1 = c (Marsaglia-Tsang), f2 = scale; flag = 1 for
//                shape 1 (exact Exp(1))
//   categorical: table_f = alias thresholds, table_i = aliases
struct Stage {
  int kind;
  int out_type;
  float f0, f1, f2;
  u32 thresh;
  int flag;
  int n_table;
  const float* table_f;
  const int* table_i;
};

// ---- integer cores ---------------------------------------------------------

// Brown's jump-ahead: x_{k+n} = A x_k + C (mod 2^64).
__host__ __device__ __forceinline__ void tb_lcg_skip(u64 n, u64* A, u64* C) {
  u64 acc_a = 1, acc_c = 0, cur_a = TB_LCG_A, cur_c = TB_LCG_C;
  while (n) {
    if (n & 1ULL) {
      acc_a = acc_a * cur_a;
      acc_c = acc_c * cur_a + cur_c;
    }
    cur_c = (cur_a + 1ULL) * cur_c;
    cur_a = cur_a * cur_a;
    n >>= 1;
  }
  *A = acc_a;
  *C = acc_c;
}

__device__ __forceinline__ u32 tb_xsh_rr(u64 s) {
  u32 xorshifted = (u32)(((s >> 18) ^ s) >> 27);
  u32 rot = (u32)(s >> 59);
  return (xorshifted >> rot) | (xorshifted << ((32u - rot) & 31u));
}

__device__ __forceinline__ u64 tb_mix64(u64 z) {
  z ^= z >> 30;
  z *= TB_MIX1;
  z ^= z >> 27;
  z *= TB_MIX2;
  z ^= z >> 31;
  return z;
}

__device__ __forceinline__ u32 tb_fmix32(u32 x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// splitmix64(h ^ K, counter), both halves folded.
__device__ __forceinline__ u32 tb_deco_splitmix(u64 h, u64 counter) {
  u64 z = tb_mix64((h ^ TB_CTR_KEY) + (counter + 1ULL) * TB_GAMMA);
  return (u32)(z >> 32) ^ (u32)z;
}

__device__ __forceinline__ u32 tb_deco_fmix32(u64 h, u64 counter) {
  u32 hh = (u32)(h >> 32), hl = (u32)h;
  u32 seed = hl ^ ((hh << 16) | (hh >> 16));
  u32 x = seed + (u32)counter * 0x9E3779B9u + (u32)(counter >> 32) * 0x85EBCA77u;
  return tb_fmix32(x);
}

// ThundeRiNG ctr-mode bits of one element: XSH_RR(root + h) ^ deco(h, counter),
// root = x_{counter + 1} of the shared LCG; deco 0 = splitmix64, 1 = fmix32.
// The one definition of the ctr pipeline: the block generator, the
// Monte-Carlo kernels and fused dropout all draw through it.
__device__ __forceinline__ u32 tb_ctr_bits(u64 root, u64 h, u64 counter, int deco) {
  u32 perm = tb_xsh_rr(root + h);
  return perm ^ (deco == 0 ? tb_deco_splitmix(h, counter) : tb_deco_fmix32(h, counter));
}

// One xorshift128 step; returns the new w.
__device__ __forceinline__ u32 tb_xs_step(u32& x, u32& y, u32& z, u32& w) {
  u32 t = x ^ (x << 11);
  x = y;
  y = z;
  z = w;
  w = (w ^ (w >> 19)) ^ (t ^ (t >> 8));
  return w;
}

// Block of `threads` threads for a (rows, S) grid: x across stream columns
// (the next power of two >= S, at most `threads`), y across rows.
static inline dim3 tb_block_shape(int S, int threads = 256) {
  int bx = 1;
  while (bx < S && bx < threads) bx <<= 1;
  return dim3(bx, threads / bx);
}

// ---- float stages ----------------------------------------------------------

__device__ __forceinline__ float tb_uniform(u32 b) {
  return (float)(b >> 8) * 0x1p-24f;
}

__device__ __forceinline__ u32 tb_remix(u32 b, u32 salt) {
  return tb_fmix32(b + salt * 0x9E3779B9u);
}

__device__ __forceinline__ float tb_box_muller(float u1, float u2) {
  float r = sqrtf(-2.0f * logf(fmaxf(u1, TB_TINY_F32)));
  return r * cosf(TB_TWO_PI_F32 * u2);
}

__device__ __forceinline__ float tb_gamma(u32 b, float d, float c) {
  for (u32 r = 0; r < 6; ++r) {
    float u1 = tb_uniform(tb_remix(b, 3u * r + 1u));
    float u2 = tb_uniform(tb_remix(b, 3u * r + 2u));
    float ua = tb_uniform(tb_remix(b, 3u * r + 3u));
    float z = tb_box_muller(u1, u2);
    float v = 1.0f + c * z;
    float lv = logf(fmaxf(v, TB_TINY_F32));
    float lv3 = (lv + lv) + lv;
    float v3 = v * v * v;
    float zz = z * z;
    bool squeeze = (1.0f - ua) > 0.0331f * zz * zz;
    bool log_ok = (logf(fmaxf(ua, TB_TINY_F32)) - 0.5f * zz) <
                  d * ((1.0f - v3) + lv3);
    if (v > 0.0f && (squeeze || log_ok)) return d * v3;  // first accept wins
  }
  return d;
}

// An elementwise float stage (everything but bits, normal, bernoulli).
__device__ __forceinline__ float tb_float_stage(u32 b, const Stage& st) {
  switch (st.kind) {
    case STAGE_UNIFORM:
      return tb_uniform(b);
    case STAGE_EXPONENTIAL:
      return -logf(1.0f - tb_uniform(b)) * st.f0;
    case STAGE_POISSON: {
      float u = tb_uniform(b), x = 0.0f;
      for (int j = 0; j < st.n_table && u >= st.table_f[j]; ++j) x += 1.0f;
      return x;
    }
    case STAGE_GAMMA: {
      float x = st.flag ? -logf(1.0f - tb_uniform(b)) * 1.0f
                        : tb_gamma(b, st.f0, st.f1);
      return x * st.f2;
    }
    case STAGE_GUMBEL:
      return -logf(-logf(fmaxf(tb_uniform(b), TB_TINY_F32)));
    case STAGE_CATEGORICAL: {
      if (st.n_table == 1) return 0.0f;
      float bin = floorf(tb_uniform(b) * (float)st.n_table);
      float flip = tb_uniform(tb_remix(b, 0u));
      int j = (int)bin;
      return flip < st.table_f[j] ? bin : (float)st.table_i[j];
    }
  }
  return 0.0f;
}

__device__ __forceinline__ void tb_store_float(void* out, size_t i, int out_type,
                                               float v) {
  if (out_type == OUT_F32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

// Sampler stage for the row pair (r, r+1) of one stream column: b0 at
// element i0, b1 at i0 + stride (present only when has1).  Box-Muller
// pairs the two rows, so a thread that owns row pairs needs no shuffle.
__device__ __forceinline__ void tb_emit_pair(void* out, size_t i0, size_t stride,
                                             bool has1, u32 b0, u32 b1,
                                             const Stage& st) {
  switch (st.kind) {
    case STAGE_BITS:
      static_cast<u32*>(out)[i0] = b0;
      if (has1) static_cast<u32*>(out)[i0 + stride] = b1;
      return;
    case STAGE_BERNOULLI:
      static_cast<uint8_t*>(out)[i0] = (st.flag || b0 < st.thresh) ? 1 : 0;
      if (has1)
        static_cast<uint8_t*>(out)[i0 + stride] = (st.flag || b1 < st.thresh) ? 1 : 0;
      return;
    case STAGE_NORMAL: {
      float u1 = tb_uniform(b0), u2 = tb_uniform(b1);
      float r = sqrtf(-2.0f * logf(fmaxf(u1, TB_TINY_F32)));
      float theta = TB_TWO_PI_F32 * u2;
      tb_store_float(out, i0, st.out_type, r * cosf(theta));
      if (has1) tb_store_float(out, i0 + stride, st.out_type, r * sinf(theta));
      return;
    }
    default:
      tb_store_float(out, i0, st.out_type, tb_float_stage(b0, st));
      if (has1) tb_store_float(out, i0 + stride, st.out_type, tb_float_stage(b1, st));
  }
}
