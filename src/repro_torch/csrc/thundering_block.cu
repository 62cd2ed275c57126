// ThundeRiNG block generators for Hopper (sm_90a): the two kernels of the
// generator's main path, with a plain C interface for ctypes.
//
// Replaces repro/kernels/thundering_block.py, all four pallas_calls:
//   thundering_ctr       <- block_ctr (_ctr_kernel) and block_ctr_windows:
//                           a stack of W consecutive counter windows is one
//                           block of W*T consecutive rows, so one launch over
//                           W*T rows viewed as (W, T, S) is the windowed form.
//   thundering_faithful  <- block_faithful (_faithful_kernel) and
//                           block_faithful_windows, the same way.
//
// Element (t, s) of a block is
//     XSH_RR(root(ctr + t + 1) + h_s) ^ deco_s(t)
// followed by the sampler stage, so only the sampled dtype reaches device
// memory (the paper's never-spill-raw-numbers dataflow, Table 7).
//
// What bounds them on an H100.  Each element writes 4 bytes (uint32 /
// float32), 2 (bfloat16) or 1 (bool) and reads nothing per element: the h
// table and tile states are O(S).  At 3.35 TB/s a 4-byte element costs
// 1.2 ps.  The ctr kernel with splitmix64 spends some 60 integer
// instructions per element (three 64-bit multiplies, each a short IMAD
// sequence, and the xor-shifts of mix64 and XSH-RR); at 64 INT32 lanes per
// SM that is about 3.6 ps per element, so the kernel is bound by integer
// issue, not by bandwidth.  fmix32 cuts the decorrelator to two 32-bit
// multiplies.  The faithful kernel's xorshift128 step is 8 instructions,
// so it sits closer to the bandwidth line; its cost is the serial chain.
//
// What the design does about it.
//   * The root is derived in the kernel, never read: each thread jumps to
//     its first row with Brown's lcg_skip, then pays one a*x + c per row -
//     the paper's one shared root multiply (RSGU), amortised over a thread's
//     rows.  Nothing but the output touches device memory.
//   * Threads lie across S so each row is written coalesced; blocks also
//     tile the rows, so an S = 1 plan (the stream API) still fills the card.
//   * A thread owns row pairs (2k, 2k+1), so Box-Muller pairs the rows in
//     registers with no shuffle (the reference rolls the tile).
//   * Faithful mode: one thread owns one stream column for one row tile and
//     steps its xorshift128 state in registers, starting from the tile's
//     GF(2)-pre-jumped state (computed on the host).
// Build with -fmad=false and never --use_fast_math: the bytes must not
// depend on the batch shape.
#include "sampler_stage.cuh"

#define TB_THREADS 256
#define TB_PAIRS_PER_THREAD 8

// Kernel A.  blockDim = (bx, by), bx * by = TB_THREADS: x across stream
// columns, y across row pairs.  Thread (tx, ty) of block (i, j) owns column
// j*bx + tx and the row pairs p = i*by*ppt + ty + k*by, k < ppt; the root
// advances by 2*by rows between its pairs with the affine step (step_a,
// step_c).
__global__ void __launch_bounds__(TB_THREADS)
thundering_ctr_kernel(void* __restrict__ out, long long rows, int S, u64 base,
                      u64 ctr, const u32* __restrict__ h_hi,
                      const u32* __restrict__ h_lo, int deco, u64 step_a,
                      u64 step_c, Stage st) {
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= S) return;
  const long long n_pairs = (rows + 1) >> 1;
  long long p = (long long)blockIdx.x * blockDim.y * TB_PAIRS_PER_THREAD + threadIdx.y;
  if (p >= n_pairs) return;
  const u64 h = ((u64)h_hi[col] << 32) | (u64)h_lo[col];
  u64 A, C;
  tb_lcg_skip((u64)(2 * p) + 1ULL, &A, &C);
  u64 x = A * base + C;  // root of row 2p: x_{ctr + 2p + 1}
  for (int k = 0; k < TB_PAIRS_PER_THREAD && p < n_pairs; ++k, p += blockDim.y) {
    const long long r = 2 * p;
    const bool has1 = r + 1 < rows;
    const u32 b0 = tb_ctr_bits(x, h, ctr + (u64)r, deco);
    const u32 b1 = has1 ? tb_ctr_bits(TB_LCG_A * x + TB_LCG_C, h, ctr + (u64)r + 1ULL, deco) : 0u;
    tb_emit_pair(out, (size_t)r * (size_t)S + (size_t)col, (size_t)S, has1, b0, b1, st);
    x = step_a * x + step_c;
  }
}

// Kernel B.  Thread (tx, ty) of block (i, j) owns column j*bx + tx and row
// tile i*by + ty: rows [tile*bt, tile*bt + bt), bt even.  states is
// (n_tiles, 4, S) u32, the xorshift128 state of each stream at the tile's
// first row.
__global__ void __launch_bounds__(TB_THREADS)
thundering_faithful_kernel(void* __restrict__ out, long long rows, int S, u64 base,
                           const u32* __restrict__ h_hi,
                           const u32* __restrict__ h_lo,
                           const u32* __restrict__ states, int n_tiles, int bt,
                           Stage st) {
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const int tile = blockIdx.x * blockDim.y + threadIdx.y;
  if (col >= S || tile >= n_tiles) return;
  const u64 h = ((u64)h_hi[col] << 32) | (u64)h_lo[col];
  const u32* s = states + (size_t)tile * 4 * (size_t)S + (size_t)col;
  u32 x = s[0], y = s[S], z = s[2 * (size_t)S], w = s[3 * (size_t)S];
  const long long r0 = (long long)tile * bt;
  const long long r_end = min(r0 + (long long)bt, rows);
  u64 A, C;
  tb_lcg_skip((u64)r0 + 1ULL, &A, &C);
  u64 root = A * base + C;
  for (long long r = r0; r < r_end; r += 2) {
    const bool has1 = r + 1 < r_end;
    const u32 b0 = tb_xsh_rr(root + h) ^ tb_xs_step(x, y, z, w);
    root = TB_LCG_A * root + TB_LCG_C;
    u32 b1 = 0u;
    if (has1) {
      b1 = tb_xsh_rr(root + h) ^ tb_xs_step(x, y, z, w);
      root = TB_LCG_A * root + TB_LCG_C;
    }
    tb_emit_pair(out, (size_t)r * (size_t)S + (size_t)col, (size_t)S, has1, b0, b1, st);
  }
}

extern "C" {

// Launch kernel A on `stream`; returns the CUDA error code (0 = success).
// base = x_ctr, the root state after ctr steps; ctr = the first row's
// counter; deco 0 = splitmix64, 1 = fmix32.
int tb_ctr_launch(void* out, long long rows, int S, u64 base, u64 ctr,
                  const void* h_hi, const void* h_lo, int deco,
                  const Stage* stage, void* stream) {
  if (rows <= 0 || S <= 0) return 0;
  const dim3 block = tb_block_shape(S);
  const long long n_pairs = (rows + 1) >> 1;
  const long long per_block = (long long)block.y * TB_PAIRS_PER_THREAD;
  const long long gx = (n_pairs + per_block - 1) / per_block;
  const long long gy = ((long long)S + block.x - 1) / block.x;
  if (gx > 0x7FFFFFFFLL || gy > 65535LL) return (int)cudaErrorInvalidConfiguration;
  u64 step_a, step_c;
  tb_lcg_skip(2ULL * block.y, &step_a, &step_c);
  thundering_ctr_kernel<<<dim3((unsigned)gx, (unsigned)gy), block, 0,
                          (cudaStream_t)stream>>>(
      out, rows, S, base, ctr, (const u32*)h_hi, (const u32*)h_lo, deco,
      step_a, step_c, *stage);
  return (int)cudaGetLastError();
}

// Launch kernel B on `stream`; returns the CUDA error code (0 = success).
int tb_faithful_launch(void* out, long long rows, int S, u64 base,
                       const void* h_hi, const void* h_lo, const void* states,
                       int n_tiles, int bt, const Stage* stage, void* stream) {
  if (rows <= 0 || S <= 0) return 0;
  const dim3 block = tb_block_shape(S);
  const long long gx = ((long long)n_tiles + block.y - 1) / block.y;
  const long long gy = ((long long)S + block.x - 1) / block.x;
  if (gx > 0x7FFFFFFFLL || gy > 65535LL) return (int)cudaErrorInvalidConfiguration;
  thundering_faithful_kernel<<<dim3((unsigned)gx, (unsigned)gy), block, 0,
                               (cudaStream_t)stream>>>(
      out, rows, S, base, (const u32*)h_hi, (const u32*)h_lo,
      (const u32*)states, n_tiles, bt, *stage);
  return (int)cudaGetLastError();
}

const char* tb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
