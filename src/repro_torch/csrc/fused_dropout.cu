// Fused dropout for Hopper (sm_90a): the mask is regenerated in registers and
// never exists in memory.  Plain C interface for ctypes.
//
// Replaces repro/kernels/fused_dropout.py, fused_dropout_2d (_kernel).
// Element p of the flattened x keeps iff the ctr-mode bits of a one-stream
// plan at counter ctr0 + p,
//     XSH_RR(x_{ctr0+p+1} + h) ^ splitmix64(h ^ K, ctr0 + p)   (tb_ctr_bits),
// are below thresh = round((1 - rate) 2^32); then y = x * scale, rounded
// once to x's dtype (scale is x's dtype's rounding of 1 / (1 - rate), done
// on the host), else y = +0.  These are stream.random_bits(stream, n)[p].
//
// What bounds it on an H100.  It reads x and writes y once: 4 bytes per
// element for bfloat16 and float16, 8 for float32, 0.120 / 0.240 ms at
// (32768, 3072) and 3.35 TB/s.  The mask costs integer work per element:
// XSH-RR, splitmix64's two xor-shift / multiply rounds and its fold, the
// compare and the mask; the LCG step and splitmix64's multiplies are IMADs
// on the FMA pipe.  Hopper runs INT32 at 64 lanes a clock per SM, half the
// issue rate, and this bfloat16 loop needs 22.5 INT32 instructions per
// element, so it is held by the INT32 pipe a little above its bytes.  The
// function needs fewer (a form with splitmix64's shifts as IMAD needs
// 18.4, and runs slower), so its bound is its bytes, as float32's is.
//
// What the design does about it.
//   * A grid-stride loop over runs of K = 16 / sizeof(T) consecutive
//     elements: thread g takes runs g*K, g*K + K*G, ..., G the number of
//     threads (one full wave: SMs x resident blocks per SM).  One jump to
//     its first element, one LCG step per element inside a run, one
//     multiply-add by host affine constants of K*G steps from run to run.
//   * Nothing per element that a run can share.  The thread carries the
//     leaf-shifted state s = x + h, whose step is s' = A s + (C + h - A h),
//     and the counter term z = (h ^ K) + (counter + 1) GAMMA of splitmix64,
//     element j of a run being z + j GAMMA (compile-time constants); both
//     jump from run to run by host constants.  So no 64-bit add of h, no
//     64-bit multiply by the counter and no h ^ K per element.
//   * splitmix64's mix in 32-bit halves with the fold fused into its last
//     xor-shift (tb_mix64_fold_xor).
//   * bfloat16 and float16 multiply pairs (mul.rn.bf16x2 / mul.rn.f16x2)
//     and drop an element by clearing its half of the word: no unpack,
//     conversion or repack per element.  The product of two 8- or 11-bit
//     significands is exact in float32, so the float32 product rounded
//     once to T - what the plain version computes - is the correctly
//     rounded product that the packed multiply gives; subnormals, +-0,
//     +-inf and the overflow to inf agree bit for bit, and a NaN comes out
//     as the same canonical NaN (the recorded digests hold every 16-bit
//     pattern).
//   * The whole runs of a thread are counted on the host (no 64-bit bound
//     test per run) and read and written as 16-byte loads and stores where
//     x and y are 16-byte aligned; a misaligned x or y and the ragged tail
//     go element by element.  Registers are not capped (__launch_bounds__
//     asks for one resident block an SM, so ptxas may take the 50-odd
//     that a run's independent elements want): the elements give the
//     parallelism that fewer resident warps lose, and the 32 or 40
//     registers of more resident blocks spilled or ran slower
//     (tools/dropout_variants.py times these choices against each other).
// Build with -fmad=false and never --use_fast_math.
#include <cuda_fp16.h>
#include <string.h>

#include "sampler_stage.cuh"

#define FD_THREADS 256

enum FdType { FD_F32 = 0, FD_BF16 = 1, FD_F16 = 2 };

// The host constants of a launch, h folded in.
struct FdSteps {
  u64 step_c;  // s' = TB_LCG_A s + step_c inside a run
  u64 jump_a;  // s' = jump_a s + jump_c from run to run
  u64 jump_c;
  u64 z_step;  // z' = z + z_step from run to run
};

// x * scale rounded once to x's type: a product of two values of 8- or
// 11-bit significand is exact in float32.
__device__ __forceinline__ float fd_scaled(float v, float s) { return v * s; }
__device__ __forceinline__ __nv_bfloat16 fd_scaled(__nv_bfloat16 v, float s) {
  return __float2bfloat16_rn(__bfloat162float(v) * s);
}
__device__ __forceinline__ __half fd_scaled(__half v, float s) {
  return __float2half_rn(__half2float(v) * s);
}

template <typename T>
__device__ __forceinline__ T fd_zero() { return T(0.0f); }
template <>
__device__ __forceinline__ __nv_bfloat16 fd_zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}
template <>
__device__ __forceinline__ __half fd_zero<__half>() { return __float2half_rn(0.0f); }

// Both halves of a times the pair s, each rounded once.
template <typename T>
__device__ __forceinline__ u32 fd_mul2(u32 a, u32 s);
template <>
__device__ __forceinline__ u32 fd_mul2<__nv_bfloat16>(u32 a, u32 s) {
  u32 d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(s));
  return d;
}
template <>
__device__ __forceinline__ u32 fd_mul2<__half>(u32 a, u32 s) {
  u32 d;
  asm("mul.rn.f16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(s));
  return d;
}

// One 32-bit word of a whole run: two 16-bit elements or one float32.
template <typename T>
__device__ __forceinline__ u32 fd_word(u32 w, const u32* b, u32 thresh,
                                       float scale, u32 scale2) {
  if constexpr (sizeof(T) == 2) {
    u32 r = fd_mul2<T>(w, scale2);
    if (!(b[0] < thresh)) r &= 0xFFFF0000u;
    if (!(b[1] < thresh)) r &= 0x0000FFFFu;
    return r;
  } else {
    return b[0] < thresh ? __float_as_uint(__uint_as_float(w) * scale) : 0u;
  }
}

// The mask bits of the K elements of one run: s = x + h and z are the
// run's first element's; element j's counter term is z + j GAMMA.
template <int K>
__device__ __forceinline__ void fd_bits(u32 (&b)[K], u64 s, u64 z, u64 step_c) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    b[j] = tb_mix64_fold_xor(z + (u64)j * TB_GAMMA, tb_xsh_rr(s));
    s = TB_LCG_A * s + step_c;
  }
}

// A whole run of 16 bytes: K elements, masked and scaled.
template <typename T>
__device__ __forceinline__ uint4 fd_run(const uint4& v, const u32* b, u32 thresh,
                                        float scale, u32 scale2) {
  constexpr int E = sizeof(u32) / sizeof(T);  // elements per 32-bit word
  return make_uint4(fd_word<T>(v.x, b, thresh, scale, scale2),
                    fd_word<T>(v.y, b + E, thresh, scale, scale2),
                    fd_word<T>(v.z, b + 2 * E, thresh, scale, scale2),
                    fd_word<T>(v.w, b + 3 * E, thresh, scale, scale2));
}

// Thread g owns runs g, g + G, g + 2G, ... (G threads, K elements a run).
// Where x and y are 16-byte aligned (vec), its first runs_q + (g <
// runs_r) runs are whole: (runs_q, runs_r) = divmod(n / K, G) from the
// host.  What is left - the ragged last run, or every run of a misaligned
// x or y - goes element by element.
template <typename T>
__global__ void __launch_bounds__(FD_THREADS, 1)
fused_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                     u64 base, u64 h, u64 z0, FdSteps st, u32 runs_q,
                     u32 runs_r, u32 thresh, float scale, u32 scale2, int vec) {
  constexpr int K = 16 / sizeof(T);
  const unsigned g = blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x * K;
  long long p = (long long)g * K;
  if (p >= n) return;
  u64 A, C;
  tb_lcg_skip((u64)p + 1ULL, &A, &C);
  u64 s = A * base + C + h;          // x_{ctr0 + p + 1} + h
  u64 z = z0 + (u64)p * TB_GAMMA;    // (h ^ K) + (ctr0 + p + 1) GAMMA
  u32 b[K];
  if (vec) {
    const u32 runs = runs_q + (g < runs_r ? 1u : 0u);
    const long long step = stride / K;  // in runs of 16 bytes
    const uint4* xr = reinterpret_cast<const uint4*>(x + p);
    uint4* yr = reinterpret_cast<uint4*>(y + p);
    // float32's run of 4 elements is too short to hide its own load, so
    // the next run's load is issued before this run's mask; a 16-bit run
    // of 8 hides it, and runs slower with the prefetch (its registers
    // grow from 56 to 64).
    constexpr bool prefetch = sizeof(T) == 4;
    uint4 next = make_uint4(0u, 0u, 0u, 0u);
    if (prefetch && runs) next = *xr;
    for (u32 i = 0; i < runs; ++i) {
      uint4 v;
      if constexpr (prefetch) {
        v = next;
        if (i + 1 < runs) next = xr[step];
      } else {
        v = *xr;
      }
      fd_bits<K>(b, s, z, st.step_c);
      *yr = fd_run<T>(v, b, thresh, scale, scale2);
      xr += step;
      yr += step;
      s = st.jump_a * s + st.jump_c;
      z += st.z_step;
    }
    p += (long long)runs * stride;
  }
  for (; p < n; p += stride) {
    fd_bits<K>(b, s, z, st.step_c);
    const int m = (int)min((long long)K, n - p);
    for (int j = 0; j < m; ++j)
      y[p + j] = b[j] < thresh ? fd_scaled(x[p + j], scale) : fd_zero<T>();
    s = st.jump_a * s + st.jump_c;
    z += st.z_step;
  }
}

// The scale as the 32-bit word fd_word multiplies by: a pair of T for the
// 16-bit types (scale is exactly a value of T), the float's bits for float32.
static u32 fd_scale_word(float scale, __nv_bfloat16) {
  const __nv_bfloat16_raw r = __float2bfloat16_rn(scale);
  return (u32)r.x | ((u32)r.x << 16);
}
static u32 fd_scale_word(float scale, __half) {
  const __half_raw r = __float2half_rn(scale);
  return (u32)r.x | ((u32)r.x << 16);
}
static u32 fd_scale_word(float scale, float) {
  u32 bits;
  memcpy(&bits, &scale, sizeof bits);
  return bits;
}

template <typename T>
static int fd_launch_typed(const void* x, void* y, long long n, u64 base,
                           u64 ctr0, u64 h, u32 thresh, float scale,
                           cudaStream_t stream) {
  constexpr int K = 16 / sizeof(T);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_dropout_kernel<T>, FD_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = (long long)K * FD_THREADS;
  const long long wanted = (n + per_block - 1) / per_block;
  const long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long blocks = wanted < wave ? wanted : wave;
  const u64 stride = (u64)(blocks * per_block);
  const u64 threads = (u64)(blocks * FD_THREADS);
  const u64 whole = (u64)n / K;  // whole runs of an aligned x
  if (whole / threads >= (1ULL << 32)) return (int)cudaErrorInvalidValue;
  // s = x + h steps as s' = A s + (C + h - A h); likewise across a stride.
  FdSteps st;
  st.step_c = TB_LCG_C + h - TB_LCG_A * h;
  u64 jump_c;
  tb_lcg_skip(stride, &st.jump_a, &jump_c);
  st.jump_c = jump_c + h - st.jump_a * h;
  st.z_step = stride * TB_GAMMA;
  const u64 z0 = (h ^ TB_CTR_KEY) + (ctr0 + 1ULL) * TB_GAMMA;
  const int vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  fused_dropout_kernel<T><<<(unsigned)blocks, FD_THREADS, 0, stream>>>(
      (const T*)x, (T*)y, n, base, h, z0, st, (u32)(whole / threads),
      (u32)(whole % threads), thresh, scale, fd_scale_word(scale, T()), vec);
  return (int)cudaGetLastError();
}

extern "C" {

// Launch kernel C on `stream`; returns the CUDA error code (0 = success).
// x, y: n contiguous elements of type `dtype` (FdType); base = x_{ctr0}, the
// root state after ctr0 steps; scale is x's dtype's value of 1 / (1 - rate).
int fd_launch(const void* x, void* y, long long n, int dtype, u64 base,
              u64 ctr0, u64 h, u32 thresh, float scale, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case FD_F32:
      return fd_launch_typed<float>(x, y, n, base, ctr0, h, thresh, scale, s);
    case FD_BF16:
      return fd_launch_typed<__nv_bfloat16>(x, y, n, base, ctr0, h, thresh, scale, s);
    case FD_F16:
      return fd_launch_typed<__half>(x, y, n, base, ctr0, h, thresh, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* fd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
