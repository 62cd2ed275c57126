// ThundeRiNG arithmetic and sampler output stages, in registers.
//
// Shared by every kernel of csrc/ (block generators, Monte-Carlo, dropout,
// gumbel-max sampling).  Every function here is the device form of a
// function in repro_torch/core (lcg, splitmix, xorshift, sampler) and must
// agree with it: bit for bit on the integer
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

// PCG's XSH-RR output of a 64-bit state: bits 27..58 of s ^ (s >> 18),
// rotated right by s >> 59.  Worked in 32-bit halves: bits 27..58 of s
// are one funnel shift of (hi, lo), those of s >> 18 are hi >> 13, and the
// rotation is a funnel shift of the word with itself - five INT32
// instructions where the 64-bit form takes seven.
__device__ __forceinline__ u32 tb_xsh_rr(u64 s) {
  const u32 lo = (u32)s, hi = (u32)(s >> 32);
  const u32 xorshifted = __funnelshift_r(lo, hi, 27) ^ (hi >> 13);
  return __funnelshift_r(xorshifted, xorshifted, hi >> 27);
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

// The same pipeline split into a column's term and a row's term, for a
// thread that owns several columns of a row: the leaf term is made once
// per column (splitmix64: h ^ K; fmix32: the folded seed), the row term
// once per row (splitmix64: the counter product (counter + 1) * GAMMA,
// carried from row to row by adding GAMMA; fmix32: the counter's two
// products).  tb_ctr_bits(root, h, counter, deco) ==
//   tb_xsh_rr(root + h) ^ tb_deco_pre<deco>(tb_deco_leaf<deco>(h), row),
// row = TbRowTerm<deco>(counter).term: both decorrelators add the two terms
// modulo 2^64 / 2^32, and addition commutes.
template <int DECO>
__device__ __forceinline__ u64 tb_deco_leaf(u64 h) {
  if constexpr (DECO == 0) {
    return h ^ TB_CTR_KEY;
  } else {
    const u32 hh = (u32)(h >> 32), hl = (u32)h;
    return (u64)(hl ^ ((hh << 16) | (hh >> 16)));
  }
}

template <int DECO>
__device__ __forceinline__ u32 tb_deco_pre(u64 leaf, u64 row) {
  if constexpr (DECO == 0) {
    const u64 z = tb_mix64(leaf + row);
    return (u32)(z >> 32) ^ (u32)z;
  } else {
    return tb_fmix32((u32)leaf + (u32)row);
  }
}

// The row term of counter `counter`, stepped one row at a time.
template <int DECO>
struct TbRowTerm {
  u64 counter, term;
  __device__ __forceinline__ static u64 of(u64 c) {
    if constexpr (DECO == 0)
      return (c + 1ULL) * TB_GAMMA;
    else
      return (u64)((u32)c * 0x9E3779B9u + (u32)(c >> 32) * 0x85EBCA77u);
  }
  __device__ __forceinline__ explicit TbRowTerm(u64 c) : counter(c), term(of(c)) {}
  __device__ __forceinline__ void next() {
    ++counter;
    if constexpr (DECO == 0)
      term += TB_GAMMA;
    else
      term = of(counter);
  }
};

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

// Standard Gumbel by double-log inversion (the "gumbel" stage), log(0)-safe.
__device__ __forceinline__ float tb_gumbel(u32 b) {
  return -logf(-logf(fmaxf(tb_uniform(b), TB_TINY_F32)));
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


// ---- stage emitters, specialised on the stage and the output type ----------
//
// A thread writes runs of 16 bytes: RUN elements of its output type.  The
// stage kind and the output type are template arguments, so a row loop
// carries no switch; the float stages keep the operation order of the plain
// versions (sampler.py), so their bytes do not depend on the layout.

template <int OUT> struct TbOut;
template <> struct TbOut<OUT_U32> { typedef u32 T; static constexpr int RUN = 4; };
template <> struct TbOut<OUT_F32> { typedef float T; static constexpr int RUN = 4; };
template <> struct TbOut<OUT_BF16> { typedef unsigned short T; static constexpr int RUN = 8; };
template <> struct TbOut<OUT_BOOL> { typedef uint8_t T; static constexpr int RUN = 16; };

// One run of 16 bytes in registers.
template <int OUT>
struct TbRun {
  typename TbOut<OUT>::T v[TbOut<OUT>::RUN];
};

// The run as the four words of one 16-byte store, little-endian.
template <int OUT>
__device__ __forceinline__ uint4 tb_pack(const TbRun<OUT>& run) {
  u32 w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (OUT == OUT_U32) {
      w[k] = run.v[k];
    } else if constexpr (OUT == OUT_F32) {
      w[k] = __float_as_uint(run.v[k]);
    } else if constexpr (OUT == OUT_BF16) {
      w[k] = (u32)run.v[2 * k] | ((u32)run.v[2 * k + 1] << 16);
    } else {
      w[k] = (u32)run.v[4 * k] | ((u32)run.v[4 * k + 1] << 8) |
             ((u32)run.v[4 * k + 2] << 16) | ((u32)run.v[4 * k + 3] << 24);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int OUT>
__device__ __forceinline__ typename TbOut<OUT>::T tb_to_out(float v) {
  if constexpr (OUT == OUT_F32)
    return v;
  else
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// An elementwise float stage (everything but bits, normal, bernoulli).
template <int KIND>
__device__ __forceinline__ float tb_float_stage(u32 b, const Stage& st) {
  if constexpr (KIND == STAGE_UNIFORM) {
    return tb_uniform(b);
  } else if constexpr (KIND == STAGE_EXPONENTIAL) {
    return -logf(1.0f - tb_uniform(b)) * st.f0;
  } else if constexpr (KIND == STAGE_POISSON) {
    float u = tb_uniform(b), x = 0.0f;
    for (int j = 0; j < st.n_table && u >= st.table_f[j]; ++j) x += 1.0f;
    return x;
  } else if constexpr (KIND == STAGE_GAMMA) {
    float x = st.flag ? -logf(1.0f - tb_uniform(b)) * 1.0f
                      : tb_gamma(b, st.f0, st.f1);
    return x * st.f2;
  } else if constexpr (KIND == STAGE_GUMBEL) {
    return tb_gumbel(b);
  } else {
    static_assert(KIND == STAGE_CATEGORICAL, "not an elementwise float stage");
    if (st.n_table == 1) return 0.0f;
    float bin = floorf(tb_uniform(b) * (float)st.n_table);
    float flip = tb_uniform(tb_remix(b, 0u));
    int j = (int)bin;
    return flip < st.table_f[j] ? bin : (float)st.table_i[j];
  }
}

// One element of an elementwise stage (every stage but normal).
template <int KIND, int OUT>
__device__ __forceinline__ typename TbOut<OUT>::T tb_stage_out(u32 b, const Stage& st) {
  if constexpr (KIND == STAGE_BITS)
    return b;
  else if constexpr (KIND == STAGE_BERNOULLI)
    return (st.flag || b < st.thresh) ? 1 : 0;
  else
    return tb_to_out<OUT>(tb_float_stage<KIND>(b, st));
}

// Box-Muller over one pair of uniforms' bits: (r cos theta, r sin theta).
template <int OUT>
__device__ __forceinline__ void tb_normal_pair(u32 b0, u32 b1, typename TbOut<OUT>::T* z0,
                                               typename TbOut<OUT>::T* z1) {
  float u1 = tb_uniform(b0), u2 = tb_uniform(b1);
  float r = sqrtf(-2.0f * logf(fmaxf(u1, TB_TINY_F32)));
  float theta = TB_TWO_PI_F32 * u2;
  *z0 = tb_to_out<OUT>(r * cosf(theta));
  *z1 = tb_to_out<OUT>(r * sinf(theta));
}

// Store the first n elements of a run at element i of out: one 16-byte
// store when the run is whole and its address is 16-byte aligned, element
// by element otherwise (a ragged last run, a row that does not start on a
// 16-byte line, an out= view at any offset).
template <int OUT>
__device__ __forceinline__ void tb_store_run(void* out, size_t i, const TbRun<OUT>& run, int n) {
  typedef typename TbOut<OUT>::T T;
  constexpr int V = TbOut<OUT>::RUN;
  T* p = static_cast<T*>(out) + i;
  if (n == V && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = tb_pack<OUT>(run);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < n) p[j] = run.v[j];
  }
}

// A thread's two rows (r, r+1) of n <= RUN adjacent columns: b0 at element
// i0, b1 at i0 + stride (present only when has1).  Box-Muller pairs the
// two rows column by column, so no shuffle is needed.
template <int KIND, int OUT>
__device__ __forceinline__ void tb_emit_rows(void* out, size_t i0, size_t stride, bool has1,
                                             int n, const u32 (&b0)[TbOut<OUT>::RUN],
                                             const u32 (&b1)[TbOut<OUT>::RUN],
                                             const Stage& st) {
  constexpr int V = TbOut<OUT>::RUN;
  TbRun<OUT> r0, r1;
  if constexpr (KIND == STAGE_NORMAL) {
#pragma unroll
    for (int j = 0; j < V; ++j) tb_normal_pair<OUT>(b0[j], b1[j], &r0.v[j], &r1.v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) r0.v[j] = tb_stage_out<KIND, OUT>(b0[j], st);
    if (has1) {
#pragma unroll
      for (int j = 0; j < V; ++j) r1.v[j] = tb_stage_out<KIND, OUT>(b1[j], st);
    }
  }
  tb_store_run<OUT>(out, i0, r0, n);
  if (has1) tb_store_run<OUT>(out, i0 + stride, r1, n);
}

// RUN consecutive rows of one column (an S = 1 block), the first n of them
// at element i; rows pair up (2k, 2k+1) within the run for Box-Muller.
template <int KIND, int OUT>
__device__ __forceinline__ void tb_emit_run(void* out, size_t i, int n,
                                            const u32 (&b)[TbOut<OUT>::RUN],
                                            const Stage& st) {
  constexpr int V = TbOut<OUT>::RUN;
  TbRun<OUT> run;
  if constexpr (KIND == STAGE_NORMAL) {
#pragma unroll
    for (int j = 0; j < V; j += 2) tb_normal_pair<OUT>(b[j], b[j + 1], &run.v[j], &run.v[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) run.v[j] = tb_stage_out<KIND, OUT>(b[j], st);
  }
  tb_store_run<OUT>(out, i, run, n);
}
