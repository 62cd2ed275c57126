// Monte-Carlo kernels of the paper's two case studies (Sec. 6) for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Replaces repro/kernels/mc.py, both pallas_calls:
//   mc_pi      <- pi_partials (_pi_kernel): in-circle counts of (x, y)
//                 uniform pairs, x and y drawn from two leaf families (hx, hy)
//                 of one shared root;
//   mc_option  <- option_partials (_option_kernel): Box-Muller -> GBM terminal
//                 price -> discounted European call payoff, summed.
// Both write the reference's partial layout, (n_tiles, S): entry (i, s) is
// the reduction over rows [i*bt, min((i+1)*bt, T)) of lane s, so partials can
// be held against the reference's tile by tile.
//
// Row t of lane s draws ux = U(XSH_RR(root(ctr+t+1) + hx_s) ^ deco(hx_s, ctr+t))
// and uy likewise with hy_s (tb_ctr_bits, the pipeline of kernel A), then the
// integrand.  Only one int32 or float32 per (tile, lane) reaches device memory
// - the paper's generate-into-the-application dataflow (Table 7).
//
// What bounds them on an H100.  Nothing is read per draw and one partial is
// written per bt rows, so bytes are negligible: at (T, S) = (2^14, 2^14) the
// output is 4 MiB.  Each row costs two ctr pipelines (some 26 INT32-pipe
// instructions each past the shared root step and counter), so both kernels
// are bound by integer issue; the option kernel adds a logf, sqrtf, cosf and
// expf per row (FP32 software sequences around MUFU), which share the FMA
// pipe with the 64-bit multiplies.
//
// What the design does about it.
//   * The Pallas kernel streams a precomputed (T,) root vector in; here each
//     thread owns one (row tile, lane), makes one Brown jump (tb_lcg_skip) to
//     its tile's first row and then pays one 64-bit multiply-add per row.
//     The root and counter are shared by the x and y draws of a row.
//   * hx[s] and hy[s] are loaded once; rows >= T are never visited, which is
//     the reference's row mask.
//   * The reduction stays in a register (int count, or a float32 sum in row
//     order), so the sum order is fixed and the plain version can follow it.
//   * Threads lie across lanes, so each tile's partial row is stored
//     coalesced; at (n_tiles, S) = (64, 2^14) there are 2^20 threads, enough
//     for 132 SMs.
// Build with -fmad=false: ux*ux + uy*uy is two multiplies and an add, each
// rounded, as in eager PyTorch and in the reference.
#include "sampler_stage.cuh"

#define MC_THREADS 256

enum McApp { MC_PI = 0, MC_OPTION = 1 };

// float32 constants of the option integrand, rounded on the host.
struct McOption {
  float s0, strike, drift, vol, disc;
};

template <int kApp>
__global__ void __launch_bounds__(MC_THREADS)
mc_kernel(void* __restrict__ out, long long T, int S, u64 base, u64 ctr,
          const u32* __restrict__ hx_hi, const u32* __restrict__ hx_lo,
          const u32* __restrict__ hy_hi, const u32* __restrict__ hy_lo,
          int bt, long long n_tiles, McOption opt) {
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const long long tile = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (col >= S || tile >= n_tiles) return;
  const u64 hx = ((u64)hx_hi[col] << 32) | (u64)hx_lo[col];
  const u64 hy = ((u64)hy_hi[col] << 32) | (u64)hy_lo[col];
  const long long r0 = tile * bt;
  const long long r_end = min(r0 + (long long)bt, T);
  u64 A, C;
  tb_lcg_skip((u64)r0 + 1ULL, &A, &C);
  u64 root = A * base + C;  // x_{ctr + r0 + 1}
  int count = 0;
  float acc = 0.0f;
  for (long long r = r0; r < r_end; ++r) {
    const u64 counter = ctr + (u64)r;
    const float ux = tb_uniform(tb_ctr_bits(root, hx, counter, 0));
    const float uy = tb_uniform(tb_ctr_bits(root, hy, counter, 0));
    if (kApp == MC_PI) {
      count += (ux * ux + uy * uy) < 1.0f ? 1 : 0;
    } else {
      const float z = tb_box_muller(ux, uy);
      const float st = opt.s0 * expf(opt.drift + opt.vol * z);
      acc += fmaxf(st - opt.strike, 0.0f) * opt.disc;
    }
    root = TB_LCG_A * root + TB_LCG_C;
  }
  const size_t i = (size_t)tile * (size_t)S + (size_t)col;
  if (kApp == MC_PI)
    static_cast<int*>(out)[i] = count;
  else
    static_cast<float*>(out)[i] = acc;
}

extern "C" {

// Launch kernel D (app 0, int32 partials) or E (app 1, float32 partials) on
// `stream`; returns the CUDA error code (0 = success).  base = x_ctr, the
// root state after ctr steps; ctr = row 0's counter; out is (n_tiles, S).
int mc_launch(int app, void* out, long long T, int S, u64 base, u64 ctr,
              const void* hx_hi, const void* hx_lo, const void* hy_hi,
              const void* hy_lo, int bt, long long n_tiles,
              const McOption* opt, void* stream) {
  if (T <= 0 || S <= 0) return 0;
  const dim3 block = tb_block_shape(S, MC_THREADS);
  const long long gx = (n_tiles + block.y - 1) / block.y;
  const long long gy = ((long long)S + block.x - 1) / block.x;
  if (gx > 0x7FFFFFFFLL || gy > 65535LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = (cudaStream_t)stream;
  if (app == MC_PI)
    mc_kernel<MC_PI><<<grid, block, 0, s>>>(
        out, T, S, base, ctr, (const u32*)hx_hi, (const u32*)hx_lo,
        (const u32*)hy_hi, (const u32*)hy_lo, bt, n_tiles, *opt);
  else if (app == MC_OPTION)
    mc_kernel<MC_OPTION><<<grid, block, 0, s>>>(
        out, T, S, base, ctr, (const u32*)hx_hi, (const u32*)hx_lo,
        (const u32*)hy_hi, (const u32*)hy_lo, bt, n_tiles, *opt);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* mc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
