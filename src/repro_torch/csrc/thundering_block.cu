// ThundeRiNG block generators for Hopper (sm_90a): the two kernels of the
// generator's main path, with a plain C interface for ctypes.
//
// Replaces repro/kernels/thundering_block.py, all four pallas_calls:
//   thundering_ctr       <- block_ctr (_ctr_kernel) and block_ctr_windows:
//                           a stack of W consecutive counter windows is one
//                           block of W*T consecutive rows, so one launch over
//                           W*T rows viewed as (W, T, S) is the windowed form.
//   thundering_faithful  <- block_faithful (_faithful_kernel) and
//                           block_faithful_windows, the same way; its tile
//                           start states come from the GF(2) jump kernels
//                           below, the counterpart of the reference's
//                           xorshift.jump_traced.
//
// Beside them, tb_leaf_table_kernel writes a family's (S,) leaf offsets,
// the table every plan carries (engine.leaf_table): one launch where the
// plain version's limb arithmetic takes 177 device operations.
//
// Element (t, s) of a block is
//     XSH_RR(root(ctr + t + 1) + h_s) ^ deco_s(t)
// followed by the sampler stage, so only the sampled dtype reaches device
// memory (the paper's never-spill-raw-numbers dataflow, Table 7).
//
// What bounds them on an H100.  Each element writes 4 bytes (uint32 /
// float32), 2 (bfloat16) or 1 (bool) and reads nothing per element: the h
// table and tile states are O(S).  A (4096, 2^14) uint32 block is 256 MiB,
// 0.080 ms at 3.35 TB/s.  Per element the ctr pipeline needs XSH-RR of
// root + h and, for splitmix64, mix64 (two 64-bit multiplies, IMADs on the
// FMA pipe, and three 64-bit xor-shifts as funnel-shift pairs).  The
// built loop takes 36.6 instructions an element, 22.1 of them on the
// INT32 pipe, which Hopper runs at 64 lanes a clock per SM, half the issue
// rate: 0.089 ms, just above the byte bound.  fmix32 (14.4 INT32) and the
// faithful xorshift128 (14.3) sit below it, so they are bound by the bytes
// they store, as Philox is (chip_smoke.py, BLOCK_OPS_PER_ELEMENT).
//
// What the design does about it.
//   * A thread owns a run of adjacent columns - 16 bytes of output: 4
//     uint32 / float32, 8 bfloat16, 16 bool - over consecutive row pairs.
//     Per row it pays the root step (one 64-bit multiply-add, the paper's
//     shared root, RSGU) and the decorrelator's row term (splitmix64's
//     counter product, carried by adding GAMMA) once for all its columns;
//     per column it loads h once.  Each run is written with one 16-byte
//     store, so a warp writes 512 contiguous bytes of a row: four full
//     128-byte lines.
//   * The stage kind, the output type and the decorrelator are template
//     arguments: the row loop carries no switch.
//   * The root is derived in the kernel, never read: each thread jumps to its
//     first row with one affine product per set bit of its offset, from a
//     table of x -> A^(2^k) x + C_k folded at compile time.  Nothing but the
//     output touches device memory.
//   * Blocks are (runs, row groups); a thread's pairs per launch are cut
//     until the grid has two waves of the card's SMs, so a (256, 2^14) block
//     still fills 132 SMs.  At S = 1 (the stream API) columns are too few,
//     so kernel A runs its 16-byte runs down the rows of the one column
//     instead (thundering_ctr_rows_kernel).
//   * A run that is ragged (S % RUN != 0), a row whose start is not 16-byte
//     aligned (S % RUN != 0, or an out= view at any offset, as producer ring
//     slots and window views are) is stored element by element; an odd row
//     count leaves the last pair's second row unstored.  The bytes are the
//     same either way.
//   * A thread owns row pairs (2k, 2k+1), so Box-Muller pairs the rows in
//     registers with no shuffle (the reference rolls the tile).
//   * Faithful mode: one thread owns the same run of columns for one row
//     tile and steps one xorshift128 state per column in registers (16
//     registers for 4 columns), from the tile's start state.  The start
//     states are jumped on the card: tb_jump_lanes_kernel takes the (4, S)
//     lane table at substream start by ctr steps, one thread per stream, and
//     tb_tile_states_kernel takes each tile i on by i*bt more, one thread per
//     (tile, stream).  A jump is one 128x128 GF(2) matvec by M^(2^k) per set
//     bit k of the count; each matvec is 32 lookups in the matrix's nibble
//     table (8 KiB, all 64 uploaded once, 512 KiB) and their XOR, where the
//     packed rows would take 128 popcounts.
// Build with -fmad=false and never --use_fast_math: the bytes must not
// depend on the batch shape.
#include <algorithm>

#include "sampler_stage.cuh"

#define TB_THREADS 256
#define TB_MAX_PAIRS_PER_THREAD 16
#define TB_MAX_RUNS_PER_THREAD 8
#define TB_THREADS_PER_SM 2048

// x -> A x + C applied 2^k times, k = 0..63, folded at compile time
// (Brown's doubling, as in tb_lcg_skip).
struct TbAffine {
  u64 a, c;
};
struct TbLcgPow2 {
  TbAffine k[64];
};
__host__ __device__ constexpr TbLcgPow2 tb_lcg_pow2_table() {
  TbLcgPow2 t{};
  u64 a = TB_LCG_A, c = TB_LCG_C;
  for (int k = 0; k < 64; ++k) {
    t.k[k] = TbAffine{a, c};
    c = (a + 1ULL) * c;
    a = a * a;
  }
  return t;
}
__constant__ TbLcgPow2 tb_lcg_pow2 = tb_lcg_pow2_table();

// The root of a thread's first row, x_{k+n} = A x_k + C: one affine
// product per set bit of n from the table, where tb_lcg_skip squares its
// way through every bit.  With 64 elements a thread this is what keeps
// the jump to ~1 instruction an element.
__device__ __forceinline__ u64 tb_lcg_jump(u64 x, u64 n) {
  u64 acc_a = 1ULL, acc_c = 0ULL;
  while (n) {
    const TbAffine p = tb_lcg_pow2.k[__ffsll((long long)n) - 1];
    acc_a = acc_a * p.a;
    acc_c = acc_c * p.a + p.c;
    n &= n - 1ULL;
  }
  return acc_a * x + acc_c;
}

// ---- kernel A ----------------------------------------------------------------

// blockDim = (bx, by), bx * by = TB_THREADS: x across runs of RUN columns,
// y across row groups.  Thread (tx, ty) of block (i, j) owns columns
// [c0, c0 + RUN), c0 = (j*bx + tx) * RUN, and the row pairs
// [p0, p0 + ppt), p0 = (i*by + ty) * ppt.
template <int KIND, int OUT, int DECO>
__global__ void __launch_bounds__(TB_THREADS)
thundering_ctr_kernel(void* __restrict__ out, long long rows, int S, u64 base,
                      u64 ctr, const u64* __restrict__ h_hi,
                      const u64* __restrict__ h_lo, int ppt, Stage st) {
  constexpr int V = TbOut<OUT>::RUN;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c0 >= S) return;
  const long long n_pairs = (rows + 1) >> 1;
  long long p = ((long long)blockIdx.x * blockDim.y + threadIdx.y) * ppt;
  if (p >= n_pairs) return;
  const long long p_end = min(p + (long long)ppt, n_pairs);
  const int n = min(V, S - c0);
  u64 h[V], leaf[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    h[j] = j < n ? (h_hi[c0 + j] << 32) | h_lo[c0 + j] : 0ULL;
    leaf[j] = tb_deco_leaf<DECO>(h[j]);
  }
  u64 x = tb_lcg_jump(base, (u64)(2 * p) + 1ULL);  // x_{ctr + 2p + 1}
  TbRowTerm<DECO> row(ctr + (u64)(2 * p));
  for (; p < p_end; ++p) {
    const long long r = 2 * p;
    u32 b0[V], b1[V];
#pragma unroll
    for (int j = 0; j < V; ++j) b0[j] = tb_xsh_rr(x + h[j]) ^ tb_deco_pre<DECO>(leaf[j], row.term);
    x = TB_LCG_A * x + TB_LCG_C;
    row.next();
#pragma unroll
    for (int j = 0; j < V; ++j) b1[j] = tb_xsh_rr(x + h[j]) ^ tb_deco_pre<DECO>(leaf[j], row.term);
    x = TB_LCG_A * x + TB_LCG_C;
    row.next();
    tb_emit_rows<KIND, OUT>(out, (size_t)r * (size_t)S + (size_t)c0, (size_t)S,
                            r + 1 < rows, n, b0, b1, st);
  }
}

// Kernel A for S = 1: thread t owns the runs [t*rpt, (t+1)*rpt) of RUN
// consecutive rows each, one 16-byte store per run.
template <int KIND, int OUT, int DECO>
__global__ void __launch_bounds__(TB_THREADS)
thundering_ctr_rows_kernel(void* __restrict__ out, long long rows, u64 base, u64 ctr,
                           const u64* __restrict__ h_hi,
                           const u64* __restrict__ h_lo, int rpt, Stage st) {
  constexpr int V = TbOut<OUT>::RUN;
  const long long n_runs = (rows + V - 1) / V;
  long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * rpt;
  if (q >= n_runs) return;
  const long long q_end = min(q + (long long)rpt, n_runs);
  const u64 h = (h_hi[0] << 32) | h_lo[0];
  const u64 leaf = tb_deco_leaf<DECO>(h);
  u64 x = tb_lcg_jump(base, (u64)(q * V) + 1ULL);
  TbRowTerm<DECO> row(ctr + (u64)(q * V));
  for (; q < q_end; ++q) {
    u32 b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      b[j] = tb_xsh_rr(x + h) ^ tb_deco_pre<DECO>(leaf, row.term);
      x = TB_LCG_A * x + TB_LCG_C;
      row.next();
    }
    const long long r = q * V;
    tb_emit_run<KIND, OUT>(out, (size_t)r, (int)min((long long)V, rows - r), b, st);
  }
}

// ---- kernel B ----------------------------------------------------------------

// Thread (tx, ty) of block (i, j) owns columns [c0, c0 + RUN),
// c0 = (j*bx + tx) * RUN, and row tile i*by + ty: rows [tile*bt, tile*bt + bt),
// bt even.  states is (n_tiles, 4, S) u32, the xorshift128 state of each
// stream at the tile's first row.
template <int KIND, int OUT>
__global__ void __launch_bounds__(TB_THREADS)
thundering_faithful_kernel(void* __restrict__ out, long long rows, int S, u64 base,
                           const u64* __restrict__ h_hi,
                           const u64* __restrict__ h_lo,
                           const u32* __restrict__ states, int n_tiles, int bt,
                           Stage st) {
  constexpr int V = TbOut<OUT>::RUN;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  const int tile = blockIdx.x * blockDim.y + threadIdx.y;
  if (c0 >= S || tile >= n_tiles) return;
  const int n = min(V, S - c0);
  u64 h[V];
  u32 xs[V], ys[V], zs[V], ws[V];
  const u32* s = states + (size_t)tile * 4 * (size_t)S + (size_t)c0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool in = j < n;
    h[j] = in ? (h_hi[c0 + j] << 32) | h_lo[c0 + j] : 0ULL;
    xs[j] = in ? s[j] : 0u;
    ys[j] = in ? s[(size_t)S + j] : 0u;
    zs[j] = in ? s[2 * (size_t)S + j] : 0u;
    ws[j] = in ? s[3 * (size_t)S + j] : 0u;
  }
  const long long r0 = (long long)tile * bt;
  const long long r_end = min(r0 + (long long)bt, rows);
  u64 root = tb_lcg_jump(base, (u64)r0 + 1ULL);
  for (long long r = r0; r < r_end; r += 2) {
    u32 b0[V], b1[V];
#pragma unroll
    for (int j = 0; j < V; ++j) b0[j] = tb_xsh_rr(root + h[j]) ^ tb_xs_step(xs[j], ys[j], zs[j], ws[j]);
    root = TB_LCG_A * root + TB_LCG_C;
#pragma unroll
    for (int j = 0; j < V; ++j) b1[j] = tb_xsh_rr(root + h[j]) ^ tb_xs_step(xs[j], ys[j], zs[j], ws[j]);
    root = TB_LCG_A * root + TB_LCG_C;
    tb_emit_rows<KIND, OUT>(out, (size_t)r * (size_t)S + (size_t)c0, (size_t)S,
                            r + 1 < r_end, n, b0, b1, st);
  }
}

// ---- GF(2) jumps of the xorshift128 substreams ------------------------------

// s <- M s for one 128x128 GF(2) matrix given as its nibble table (32 x 16
// entries of 4 words, xorshift.py's _pow2_nibble_tables): entry (p, v) is
// M applied to the state whose only set bits are v << 4p, the XOR of
// columns 4p + b for the set bits b of v.  A matvec is 32 independent
// lookups and their XOR - no popcount, and no per-bit loop.
__device__ __forceinline__ void tb_gf2_matvec(const uint4* __restrict__ tab, u32 (&s)[4]) {
  u32 o0 = 0u, o1 = 0u, o2 = 0u, o3 = 0u;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 t = __ldg(tab + (w * 8 + q) * 16 + ((s[w] >> (4 * q)) & 15u));
      o0 ^= t.x;
      o1 ^= t.y;
      o2 ^= t.z;
      o3 ^= t.w;
    }
  }
  s[0] = o0;
  s[1] = o1;
  s[2] = o2;
  s[3] = o3;
}

// s <- M^n s: one matvec by M^(2^k) (tabs, the nibble tables of k = 0..63)
// per set bit k of n.  The powers of M commute, so the order does not
// matter.
__device__ __forceinline__ void tb_gf2_jump(const uint4* __restrict__ tabs, u64 n, u32 (&s)[4]) {
  while (n) {
    const int k = __ffsll((long long)n) - 1;
    tb_gf2_matvec(tabs + (size_t)k * 512, s);
    n &= n - 1ULL;
  }
}

// out[:, c] = M^n lanes[:, c]; lanes and out are (4, S).
__global__ void __launch_bounds__(TB_THREADS)
tb_jump_lanes_kernel(const u32* __restrict__ lanes, u32* __restrict__ out, int S, u64 n,
                     const uint4* __restrict__ tabs) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= S) return;
  u32 s[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) s[w] = lanes[(size_t)w * S + c];
  tb_gf2_jump(tabs, n, s);
#pragma unroll
  for (int w = 0; w < 4; ++w) out[(size_t)w * S + c] = s[w];
}

// states[i, :, c] = M^(i*bt) at[:, c] for tiles i = blockIdx.y, +gridDim.y, ...
__global__ void __launch_bounds__(TB_THREADS)
tb_tile_states_kernel(const u32* __restrict__ at, u32* __restrict__ states, int S,
                      int n_tiles, long long bt, const uint4* __restrict__ tabs) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= S) return;
  u32 s0[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) s0[w] = at[(size_t)w * S + c];
  for (int i = blockIdx.y; i < n_tiles; i += gridDim.y) {
    u32 s[4] = {s0[0], s0[1], s0[2], s0[3]};
    tb_gf2_jump(tabs, (u64)i * (u64)bt, s);
    u32* dst = states + (size_t)i * 4 * (size_t)S + c;
#pragma unroll
    for (int w = 0; w < 4; ++w) dst[(size_t)w * S] = s[w];
  }
}

// ---- leaf table ---------------------------------------------------------------

// The leaf offsets of streams 0..S-1 of a family, h_s = splitmix64(h_family,
// s) << 1, one thread a stream, as the port's u32 limbs in int64 words: the
// (2, S) buffer out holds the hi limbs in row 0 and the lo limbs in row 1.
__global__ void __launch_bounds__(TB_THREADS)
tb_leaf_table_kernel(u64* __restrict__ out, int S, u64 h_family) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const u64 h = tb_mix64(h_family + ((u64)s + 1ULL) * TB_GAMMA) << 1;
  out[s] = h >> 32;
  out[(size_t)S + s] = h & 0xFFFFFFFFULL;
}

// ---- launches ----------------------------------------------------------------

// Threads for two waves of the card: enough bytes in flight on every SM.
static long long tb_two_waves() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return 2LL * sms * TB_THREADS_PER_SM;
}

// Units of work per thread: as many as `cap`, fewer while the grid would
// have under two waves of threads.
static int tb_per_thread(long long units, long long lanes, int cap) {
  const long long wave2 = tb_two_waves();
  const long long want = (units * lanes + wave2 - 1) / wave2;
  return (int)std::max(1LL, std::min((long long)cap, want));
}

template <int KIND, int OUT, int DECO>
static int tb_ctr_launch_t(void* out, long long rows, int S, u64 base, u64 ctr,
                           const u64* h_hi, const u64* h_lo, const Stage& st,
                           cudaStream_t stream) {
  constexpr int V = TbOut<OUT>::RUN;
  if (S == 1) {
    const long long n_runs = (rows + V - 1) / V;
    const int rpt = tb_per_thread(n_runs, 1, TB_MAX_RUNS_PER_THREAD);
    const long long threads = (n_runs + rpt - 1) / rpt;
    const long long grid = (threads + TB_THREADS - 1) / TB_THREADS;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    thundering_ctr_rows_kernel<KIND, OUT, DECO><<<(unsigned)grid, TB_THREADS, 0, stream>>>(
        out, rows, base, ctr, h_hi, h_lo, rpt, st);
    return (int)cudaGetLastError();
  }
  const int n_runs = (S + V - 1) / V;
  const dim3 block = tb_block_shape(n_runs, TB_THREADS);
  const long long n_pairs = (rows + 1) >> 1;
  const int ppt = tb_per_thread(n_pairs, n_runs, TB_MAX_PAIRS_PER_THREAD);
  const long long per_block = (long long)block.y * ppt;
  const long long gx = (n_pairs + per_block - 1) / per_block;
  const long long gy = ((long long)n_runs + block.x - 1) / block.x;
  if (gx > 0x7FFFFFFFLL || gy > 65535LL) return (int)cudaErrorInvalidConfiguration;
  thundering_ctr_kernel<KIND, OUT, DECO><<<dim3((unsigned)gx, (unsigned)gy), block, 0, stream>>>(
      out, rows, S, base, ctr, h_hi, h_lo, ppt, st);
  return (int)cudaGetLastError();
}

template <int KIND, int OUT>
static int tb_faithful_launch_t(void* out, long long rows, int S, u64 base, const u64* h_hi,
                                const u64* h_lo, const u32* states, int n_tiles, int bt,
                                const Stage& st, cudaStream_t stream) {
  constexpr int V = TbOut<OUT>::RUN;
  const int n_runs = (S + V - 1) / V;
  const dim3 block = tb_block_shape(n_runs, TB_THREADS);
  const long long gx = ((long long)n_tiles + block.y - 1) / block.y;
  const long long gy = ((long long)n_runs + block.x - 1) / block.x;
  if (gx > 0x7FFFFFFFLL || gy > 65535LL) return (int)cudaErrorInvalidConfiguration;
  thundering_faithful_kernel<KIND, OUT><<<dim3((unsigned)gx, (unsigned)gy), block, 0, stream>>>(
      out, rows, S, base, h_hi, h_lo, states, n_tiles, bt, st);
  return (int)cudaGetLastError();
}

// Calls LAUNCH<KIND, OUT>(args...) for the stage's (kind, out_type); every
// stage but bits (uint32) and bernoulli (bool) writes float32 or bfloat16.
#define TB_FLOAT_KIND(KIND, LAUNCH, ...)                                    \
  case KIND:                                                                \
    return st.out_type == OUT_F32 ? LAUNCH<KIND, OUT_F32>(__VA_ARGS__)      \
                                  : LAUNCH<KIND, OUT_BF16>(__VA_ARGS__);
#define TB_DISPATCH(LAUNCH, ...)                                            \
  switch (st.kind) {                                                        \
    case STAGE_BITS: return LAUNCH<STAGE_BITS, OUT_U32>(__VA_ARGS__);       \
    case STAGE_BERNOULLI: return LAUNCH<STAGE_BERNOULLI, OUT_BOOL>(__VA_ARGS__); \
    TB_FLOAT_KIND(STAGE_UNIFORM, LAUNCH, __VA_ARGS__)                       \
    TB_FLOAT_KIND(STAGE_NORMAL, LAUNCH, __VA_ARGS__)                        \
    TB_FLOAT_KIND(STAGE_EXPONENTIAL, LAUNCH, __VA_ARGS__)                   \
    TB_FLOAT_KIND(STAGE_POISSON, LAUNCH, __VA_ARGS__)                       \
    TB_FLOAT_KIND(STAGE_GAMMA, LAUNCH, __VA_ARGS__)                         \
    TB_FLOAT_KIND(STAGE_GUMBEL, LAUNCH, __VA_ARGS__)                        \
    TB_FLOAT_KIND(STAGE_CATEGORICAL, LAUNCH, __VA_ARGS__)                   \
  }                                                                         \
  return (int)cudaErrorInvalidValue;

template <int KIND, int OUT>
static int tb_ctr_splitmix(void* out, long long rows, int S, u64 base, u64 ctr,
                           const u64* h_hi, const u64* h_lo, const Stage& st,
                           cudaStream_t stream) {
  return tb_ctr_launch_t<KIND, OUT, 0>(out, rows, S, base, ctr, h_hi, h_lo, st, stream);
}

template <int KIND, int OUT>
static int tb_ctr_fmix32(void* out, long long rows, int S, u64 base, u64 ctr,
                         const u64* h_hi, const u64* h_lo, const Stage& st,
                         cudaStream_t stream) {
  return tb_ctr_launch_t<KIND, OUT, 1>(out, rows, S, base, ctr, h_hi, h_lo, st, stream);
}

extern "C" {

// Launch kernel A on `stream`; returns the CUDA error code (0 = success).
// base = x_ctr, the root state after ctr steps; ctr = the first row's
// counter; h_hi, h_lo = the (S,) leaf offsets as the port's u32 limbs in
// int64 words (a plan's own tensors, so a launch converts nothing);
// deco 0 = splitmix64, 1 = fmix32.
int tb_ctr_launch(void* out, long long rows, int S, u64 base, u64 ctr,
                  const void* h_hi, const void* h_lo, int deco,
                  const Stage* stage, void* stream) {
  if (rows <= 0 || S <= 0) return 0;
  const Stage& st = *stage;
  const u64* hh = (const u64*)h_hi;
  const u64* hl = (const u64*)h_lo;
  cudaStream_t s = (cudaStream_t)stream;
  if (deco == 0) {
    TB_DISPATCH(tb_ctr_splitmix, out, rows, S, base, ctr, hh, hl, st, s)
  }
  TB_DISPATCH(tb_ctr_fmix32, out, rows, S, base, ctr, hh, hl, st, s)
}

// Write the (n_tiles, 4, S) start states of kernel B's row tiles on
// `stream`: tile i is the (4, S) lane table `lanes` (substreams at their
// start) advanced by ctr + i*bt steps.  scratch is (4, S), used when
// ctr != 0; tabs is the (64, 32, 16, 4) nibble tables of M^(2^k).
int tb_tile_states_launch(void* states, const void* lanes, void* scratch,
                          const void* tabs, int S, u64 ctr, long long bt,
                          int n_tiles, void* stream) {
  if (S <= 0 || n_tiles <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned gx = (unsigned)((S + TB_THREADS - 1) / TB_THREADS);
  const u32* at = (const u32*)lanes;
  if (ctr != 0ULL) {
    tb_jump_lanes_kernel<<<gx, TB_THREADS, 0, s>>>(at, (u32*)scratch, S, ctr,
                                                   (const uint4*)tabs);
    const int code = (int)cudaGetLastError();
    if (code != 0) return code;
    at = (const u32*)scratch;
  }
  const unsigned gy = (unsigned)std::min(n_tiles, 65535);
  tb_tile_states_kernel<<<dim3(gx, gy), TB_THREADS, 0, s>>>(at, (u32*)states, S, n_tiles, bt,
                                                            (const uint4*)tabs);
  return (int)cudaGetLastError();
}

// Launch kernel B on `stream`; returns the CUDA error code (0 = success).
int tb_faithful_launch(void* out, long long rows, int S, u64 base,
                       const void* h_hi, const void* h_lo, const void* states,
                       int n_tiles, int bt, const Stage* stage, void* stream) {
  if (rows <= 0 || S <= 0) return 0;
  const Stage& st = *stage;
  TB_DISPATCH(tb_faithful_launch_t, out, rows, S, base, (const u64*)h_hi, (const u64*)h_lo,
              (const u32*)states, n_tiles, bt, st, (cudaStream_t)stream)
}

// Write the (2, S) int64 leaf table of family h_family (hi limbs, then lo
// limbs) into out on `stream`; no launch when S <= 0.
int tb_leaf_table_launch(void* out, int S, u64 h_family, void* stream) {
  if (S <= 0) return 0;
  const unsigned grid = (unsigned)(((long long)S + TB_THREADS - 1) / TB_THREADS);
  tb_leaf_table_kernel<<<grid, TB_THREADS, 0, (cudaStream_t)stream>>>((u64*)out, S, h_family);
  return (int)cudaGetLastError();
}

const char* tb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
