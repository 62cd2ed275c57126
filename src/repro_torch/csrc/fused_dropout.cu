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
// element for bfloat16 and float16, 8 for float32.  The ctr pipeline costs
// some 34 INT32-pipe instructions per element (XSH-RR, the splitmix64
// xor-shifts, the 64-bit adds, the compare), 34 / (132 SMs x 64 lanes x
// 1.98 GHz) = 2.0 ps, against 1.2 ps of bandwidth for bfloat16 and 2.4 ps for
// float32.  So bfloat16 is bound by integer issue and float32 by bytes.
//
// What the design does about it.
//   * The Pallas layout (a base root per tile plus in-tile affine tables of
//     the tile's size) would read the tables from memory, and a jump-ahead
//     per element would cost ~64 64-bit multiply-adds.  Instead a grid-stride
//     loop: thread g takes runs of K = 16 / sizeof(T) consecutive elements,
//     g*K, g*K + K*G, ..., G the number of threads.  It makes one jump to its
//     first element, takes one LCG step per element inside a run, and moves
//     to its next run with one multiply-add by the affine constants of K*G
//     steps (computed on the host with the same tb_lcg_skip).
//   * Each run is one 16-byte load and one 16-byte store where x and y are
//     16-byte aligned; a misaligned x and the ragged tail go element by
//     element.
//   * The grid is one full wave (SMs x resident blocks per SM), so no block
//     waits for a second wave.
// Build with -fmad=false (the product is a single multiply anyway) and never
// --use_fast_math.
#include <cuda_fp16.h>

#include "sampler_stage.cuh"

#define FD_THREADS 256

enum FdType { FD_F32 = 0, FD_BF16 = 1, FD_F16 = 2 };

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

template <typename T>
__device__ __forceinline__ T fd_element(T v, u64 root, u64 h, u64 counter,
                                        u32 thresh, float scale) {
  return tb_ctr_bits(root, h, counter, 0) < thresh ? fd_scaled(v, scale)
                                                   : fd_zero<T>();
}

template <typename T>
__global__ void __launch_bounds__(FD_THREADS)
fused_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                     u64 base, u64 ctr0, u64 h, u32 thresh, float scale,
                     u64 jump_a, u64 jump_c, int vec) {
  constexpr int K = 16 / sizeof(T);
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x * K;
  long long p0 = g * K;
  if (p0 >= n) return;
  u64 A, C;
  tb_lcg_skip((u64)p0 + 1ULL, &A, &C);
  u64 run_root = A * base + C;  // x_{ctr0 + p0 + 1}, the root of element p0
  for (; p0 < n; p0 += stride) {
    u64 root = run_root;
    const u64 c0 = ctr0 + (u64)p0;
    if (vec && p0 + K <= n) {
      uint4 v = *reinterpret_cast<const uint4*>(x + p0);
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        e[j] = fd_element(e[j], root, h, c0 + (u64)j, thresh, scale);
        root = TB_LCG_A * root + TB_LCG_C;
      }
      *reinterpret_cast<uint4*>(y + p0) = v;
    } else {
      const int m = (int)min((long long)K, n - p0);
      for (int j = 0; j < m; ++j) {
        y[p0 + j] = fd_element(x[p0 + j], root, h, c0 + (u64)j, thresh, scale);
        root = TB_LCG_A * root + TB_LCG_C;
      }
    }
    run_root = jump_a * run_root + jump_c;
  }
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
  u64 jump_a, jump_c;
  tb_lcg_skip((u64)(blocks * per_block), &jump_a, &jump_c);
  const int vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  fused_dropout_kernel<T><<<(unsigned)blocks, FD_THREADS, 0, stream>>>(
      (const T*)x, (T*)y, n, base, ctr0, h, thresh, scale, jump_a, jump_c, vec);
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
