#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of ThundeRiNG on one GPU.

Builds the CUDA kernels of ``src/repro_torch/csrc`` with nvcc, holds each
kernel against its plain PyTorch version (every sampler stage of the block
generators, at S = 1, ragged S, odd row counts and misaligned out= views;
pi and option partials; fused dropout in float32 and bfloat16; gumbel-max
token sampling), holds the block generators to the recorded digests of
their output bytes and kernel B's on-card GF(2) tile jumps to the host's,
drives the port's three main paths at
full width - the generator (engine -> stream -> BlockService) at the
README's bulk size, S = 2**14 streams by T = 4096 steps, the paper's
applications (ops.estimate_pi, ops.price_option, their leased forms,
ops.fused_dropout) at 2**28 draws and a (32768, 3072) activation, and the
inference tier (the continuous batcher over the gumbel-max sampler at
gemma-7b's vocabulary of 256000, with crash replay in a subprocess) -
checks what comes out, and times the kernels with CUDA events beside their
bounds and torch's own generators and samplers.  Then it checks the
repaired faults (kernel C's re-recorded subnormal digests, stream.normal,
kernel F on subnormal logits) and drives the quality path: the
generate_sharded fan-out at the main path's width on meshes of shards of
the card and on a CPU + card split, a mesh BlockService, and the port's
Crush-lite battery (fast profile over every row, each cuda row against its
torch twin; the full profile on the main delivery rows), its launch counts
read around it.  Last the serving tier: a RandServer at the reference's
``make service`` width (1024 requests from 1024 tenants, with and without
standing pools, a 16384-request backlog from 4 submitter threads), every
response of the burst held against a CPU server's plain versions, its
journals replayed on the card, ``python -m repro_torch.service`` with
replay and a SIGTERM drain, and a 2-shard fleet on the card at ``make
fleet`` width with no fault, a killed and a hung shard - one digest.
Then the model serving path (gemma-7b unmodified through
``launch.serve``) and the training substrate: AdamW on the card against
the CPU, ``train`` at the smoke width on the card against the CPU and
through its CLI, gemma-7b at full width over 8 of its 28 layers through
``make_train_step`` (two runs from one seed, equal parameter digests) and
over 2 layers through ``train`` with its loop and checkpoints (a failure
at step 3 resumed, the service and ``--no-service`` paths, remat on and
off - one digest each).

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Any failure
exits non-zero and prints no result; so does a run without a CUDA device
or outside a checkout of the repository.

    python3 chip_smoke.py
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

S_FULL = 2 ** 14          # README bulk example: make_plan(seed=42, ...)
T_FULL = 4096
SEED = 42
HIGH_OFFSET = 2 ** 32 + 12345
ULP_BOUND = 8.0           # the reference's own slack for log / trig stages

# H100 SXM published peaks (NVIDIA data sheet and Hopper white paper):
# 3.35 TB/s HBM3; 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.7e12
# integer ALU instructions per second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# The block generators' bits stage, counted from ``cuobjdump -sass`` of
# their sm_90a build (nvcc 12.8) with tools/sass_loop_counts.py over the
# path one loop trip takes with whole, aligned 16-byte runs (the element-
# by-element store of a ragged or misaligned run left out): (INT32-pipe
# instructions, all instructions) per element.  A trip of kernel A is one
# row pair of 4 columns (8 elements), of kernel B the same.
#   ctr splitmix64 (thundering_ctr_kernel<0,0,0>): 0ba0-1b50,
#     1bc0-1d20, 1d90-1ea0: 177 INT32 of 293                           /8
#   ctr fmix32 (thundering_ctr_kernel<0,0,1>): 0910-12b0, 1320-13f0,
#     1460-1530: 115 INT32 of 183                                      /8
#   faithful (thundering_faithful_kernel<0,0>): 0c50-1500, 1590-16d0,
#     1740-1830: 114 INT32 of 177                                      /8
# The 64-bit multiplies run as IMAD on the FMA pipe; they count in the
# issue total.  MATVEC_OPS is one 128x128 GF(2) matvec (32 nibble-table
# lookups) of kernel B's tile-state jump (tb_tile_states_kernel), the
# loop 0290-1170: 199 INT32 of 239.
BLOCK_OPS_PER_ELEMENT = {"splitmix64": (177 / 8, 293 / 8),
                         "fmix32": (115 / 8, 183 / 8),
                         "faithful": (114 / 8, 177 / 8)}
MATVEC_OPS = (199.0, 239.0)

# Earlier times at the same shapes, logged beside this run's (chip_smoke
# runs on NVIDIA H100 80GB HBM3, 700.00 W, as PERF.md's kernel table gives
# them): kernel C's from the run before its redesign, the others' from the
# run before the redesign of kernels A and B.
EARLIER_MS = {"thundering_ctr splitmix64 bits float32": 0.2525,
              "thundering_ctr fmix32 bits float32": 0.2065,
              "thundering_ctr splitmix64 uniform float32": 0.2872,
              "thundering_ctr splitmix64 uniform bfloat16": 0.2969,
              "thundering_ctr splitmix64 normal float32": 0.3710,
              "thundering_faithful bits (kernel alone, tile states ready)":
                  0.1696,
              "pi_partials": 1.0349, "option_partials": 1.9881,
              "fused_dropout_2d torch.bfloat16": 0.2283,
              "fused_dropout_2d torch.float32": 0.3045,
              "gumbel_argmax B=64": 0.1000, "gumbel_argmax B=256": 0.3569}

# The applications' kernels, counted from ``cuobjdump -sass`` of their
# sm_90a build (nvcc 12.8) with tools/sass_loop_counts.py over the hot
# path of each loop (slow paths that these inputs never take left out):
# (INT32-pipe instructions, all instructions) per (x, y) row for pi and the
# option, per element for dropout.
#   pi: the row loop, unrolled twice, 0960-1430: 100 INT32 of 174    /2
#   option: the row loop 0710-1730 less cosf's Payne-Hanek reduction
#     (0e60-1270, |2 pi u| < 105615 never takes it) and sqrtf's slow call
#     (13f0-1420): 70 INT32 of 189
#   dropout bf16: the fewest INT32 instructions a build of this function
#     was seen to need, the "mulhi" form of tools/dropout_variants.py
#     (splitmix64's shifts as IMAD on the FMA pipe), its loop over whole
#     16-byte runs of 8 elements, with the subnormal flush: 155 INT32
#     (150 IMAD) of 316                                                /8
#     Its INT32, IMAD and issue times all fall below the bytes', so the
#     bound is the bytes'.  The kept build (fused_dropout_kernel<
#     __nv_bfloat16>: 188 INT32 of 302) runs faster than that form and
#     still misses the byte bound by its INT32 pipe.
#   dropout f32: the kept build's loop over whole runs of 4: 90 INT32 of
#     167                                                              /4
# A warp scheduler issues one instruction per clock: 132 SMs x 4 x 32 lanes
# x 1.98 GHz.  The operation bound is the larger of the INT32 pipe's time
# and the issue time.
APP_OPS_PER_ELEMENT = {"pi": (50.0, 87.0), "option": (70.0, 189.0),
                       "dropout_bf16": (155 / 8, 316 / 8),
                       "dropout_f32": (90 / 4, 167 / 4)}
DISPATCH_OPS_PER_S = 132 * 4 * 32 * 1.98e9

# The applications' main path (paper Sec. 6): the README's estimate_pi
# call, 2**14 lanes x 2**14 draws = 2**28 (x, y) pairs.
APP_LANES = 2 ** 14
APP_DRAWS = 2 ** 14
OPTION = dict(s0=100.0, strike=100.0, r=0.05, sigma=0.2, t=1.0)
# Option partials against the plain version, relative to the largest
# partial: the kernel sums each tile in row order and the plain version in
# torch's order, and the libm of each may differ by a few ULP per draw.
OPTION_RTOL = 1e-5
# gemma-7b's d_model (src/repro/configs/gemma_7b.py) x 8 sequences of 4096
# tokens: 100.7M activations.
DROPOUT_SHAPE = (8 * 4096, 3072)
DROPOUT_RATE = 0.1

# The inference tier at full width: gemma-7b's vocabulary
# (src/repro/configs/gemma_7b.py), the harness's default decode batch of 64
# slots and the reference kernel's batch tile of 256.
INF_VOCAB = 256000
INF_BATCHES = (64, 256)
INF_SHAPES = [(INF_VOCAB, 64), (INF_VOCAB, 256), (1000, 130), (300, 20),
              (64, 8)]
INF_OPTIONS = [(1.0, 0), (1.25, 0), (1.0, 16), (2.0, 4)]
INF_SEQUENCES = 128
INF_KILL_SEQUENCES = 32
# Kernel F per vocabulary element, counted from ``cuobjdump -sass`` of its
# sm_90a build (nvcc 12.8) with tools/sass_loop_counts.py over the
# splitmix64 grid-stride loop, 0e90-15f0 (unmasked elements take all of
# it): 34 INT32 of 119 instructions; 45 of them are FP32 (the two logf are
# polynomials on the FMA pipe, no MUFU).  (INT32, all) per element.
GA_OPS_PER_ELEMENT = (34.0, 119.0)

EXACT_STAGES = ("bits", "uniform", "bernoulli", "poisson", "categorical")
STAGES = [
    ("bits", ("float32",)),
    ("uniform", ("float32", "bfloat16")),
    ("normal", ("float32", "bfloat16")),
    ("bernoulli(0.3)", ("float32",)),
    ("bernoulli(0.0)", ("float32",)),
    ("bernoulli(1.0)", ("float32",)),
    ("exponential(1.5)", ("float32", "bfloat16")),
    ("poisson(3.5)", ("float32", "bfloat16")),
    ("gamma(2.5)", ("float32", "bfloat16")),
    ("gamma(1.0)", ("float32",)),
    ("gamma(3.0,0.5)", ("float32", "bfloat16")),
    ("gumbel", ("float32", "bfloat16")),
    ("categorical[0.5,0.25,0.125,0.125]", ("float32", "bfloat16")),
    ("categorical[1.0]", ("float32",)),
]


# Kernel A and B instantiations on the main path, whose registers the build
# phase prints (the other (stage, output type) instantiations are summed).
MAIN_PATH_KERNELS = (
    "thundering_ctr_kernelILi0ELi0ELi0E", "thundering_ctr_kernelILi0ELi0ELi1E",
    "thundering_ctr_kernelILi1ELi1ELi0E", "thundering_ctr_kernelILi1ELi2ELi0E",
    "thundering_ctr_kernelILi2ELi1ELi0E",
    "thundering_ctr_rows_kernelILi0ELi0ELi0E",
    "thundering_faithful_kernelILi0ELi0E", "tb_jump_lanes_kernel",
    "tb_tile_states_kernel")


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(kernel_out, plain_out, kind: str):
    """(ok, max_abs_err, max_ulp) of a kernel output against its plain
    version: bit equality for the integer and threshold stages, the
    ULP measure of ``sampler.ulp_error`` for the log / trig stages."""
    import torch
    from repro_torch.core import sampler
    require(kernel_out.shape == plain_out.shape
            and kernel_out.dtype == plain_out.dtype,
            f"{kind}: shape/dtype {tuple(kernel_out.shape)} "
            f"{kernel_out.dtype} vs {tuple(plain_out.shape)} "
            f"{plain_out.dtype}")
    if kernel_out.dtype in (torch.uint32, torch.bool):
        view = torch.int32 if kernel_out.dtype == torch.uint32 else torch.uint8
        a, b = kernel_out.view(view), plain_out.view(view)
        diff = (a.to(torch.int64) - b.to(torch.int64)).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        return err == 0.0, err, 0.0
    a, b = kernel_out.float(), plain_out.float()
    finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())
    err = float((a - b).abs().max()) if a.numel() else 0.0
    if kind in EXACT_STAGES:
        iv = torch.int32 if kernel_out.dtype == torch.float32 else torch.int16
        same = torch.equal(kernel_out.view(iv), plain_out.view(iv))
        return finite and same, err, 0.0
    ulp = float(sampler.ulp_error(kernel_out, plain_out).max()) \
        if a.numel() else 0.0
    return finite and ulp <= ULP_BOUND, err, ulp


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` on the host clock, ending in a
    synchronize: what a caller waits, host work included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build() -> float:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    secs = time.perf_counter() - t0
    for name, path in paths.items():
        log(f"built {name}: {path.name}")
        funcs = re.split(r"Compiling entry function '",
                         path.with_suffix(".ptxas.txt").read_text())[1:]
        regs, spills = [], []
        for text in funcs:
            fn = text.split("'")[0]
            regs.append(int(re.search(r"Used (\d+) registers",
                                      text).group(1)))
            spill = re.search(r"(\d+) bytes spill stores", text)
            if spill and int(spill.group(1)):
                spills.append(f"{fn} ({spill.group(1)} bytes)")
            if name != "thundering_block" or any(
                    k in fn for k in MAIN_PATH_KERNELS):
                log(f"  ptxas: {fn}: {regs[-1]} registers")
        log(f"  ptxas: {len(funcs)} kernels, {min(regs)}-{max(regs)} "
            f"registers; spill stores in {len(spills)}: {spills}")
    log(f"build seconds: {secs:.3f}")
    return secs


def _block_pair(kname, deco, plan, T, spec, dtype, out=None):
    """(kernel, plain) outputs of kernel A or B on one plan's inputs."""
    from repro_torch.core import engine
    from repro_torch.kernels import thundering_block as tb
    kw = dict(sampler=spec, out_dtype=dtype)
    if kname == "thundering_ctr":
        args = (plan.x0, plan.ctr, T, plan.h)
        kernel, plain = tb.thundering_ctr, tb.thundering_ctr_plain
        kw["deco"] = deco
    else:
        args = (plan.x0, plan.ctr, T, plan.h,
                tb.lane_states(plan.num_streams, plan.device))
        kernel, plain = tb.thundering_faithful, tb.thundering_faithful_plain
        kw["block_t"] = tb.tile_rows(engine.DEFAULT_BLOCK_T, T)
    got = kernel(*args, out=out, **kw)
    return got, plain(*args, **kw)


def phase_parity(device) -> dict:
    """Every kernel x stage x dtype x shape against the plain version:
    the main path's shapes, S = 1 (the stream API), S that no 16-byte run
    divides, odd row counts, and out= views one element past a 16-byte
    line."""
    import torch
    from repro_torch.core import engine, sampler
    shapes = [(40, 130, 12345), (1, 1, 7), (2, 1, HIGH_OFFSET),
              (33, 1, 12345), (7, 3, HIGH_OFFSET), (9, 5, 12345),
              (5, S_FULL + 1, 2 ** 32), (256, S_FULL, HIGH_OFFSET)]
    worst = {"thundering_ctr": 0.0, "thundering_faithful": 0.0}
    stage_ulp: dict = {}
    n = 0
    t0 = time.perf_counter()
    cases = [("thundering_ctr", "splitmix64"), ("thundering_ctr", "fmix32"),
             ("thundering_faithful", None)]
    for T, S, off in shapes:
        plan = engine.make_plan(seed=SEED, num_streams=S, num_steps=T,
                                offset=off, device=device)
        for spec_text, dtypes in STAGES:
            spec = sampler.parse(spec_text)
            if spec[0] == "normal" and T % 2:
                continue
            for dtype in dtypes:
                for kname, deco in cases:
                    out = None
                    if S != S_FULL:      # an out= view 1 element past a line
                        rdt = sampler.result_dtype(spec, dtype)
                        out = torch.empty(T * S + 1, dtype=rdt,
                                          device=device)[1:]
                    got, want = _block_pair(kname, deco, plan, T, spec,
                                            dtype, out=out)
                    sync(device)
                    ok, err, ulp = compare(got.view(T, S), want, spec[0])
                    tag = f"{kname}/{deco or 'xorshift128'} {spec_text} " \
                          f"{dtype} T={T} S={S} off={off}"
                    require(ok, f"parity failed: {tag}: max_abs_err={err} "
                                f"max_ulp={ulp}")
                    worst[kname] = max(worst[kname], err)
                    key = f"{spec[0]}/{dtype}"
                    stage_ulp[key] = max(stage_ulp.get(key, 0.0), ulp)
                    n += 1
    log(f"parity: {n} kernel-vs-plain checks passed in "
        f"{time.perf_counter() - t0:.1f} s")
    for key in sorted(stage_ulp):
        log(f"  max ulp {key}: {stage_ulp[key]}")
    return worst


def phase_digests(device) -> None:
    """Kernels A and B reproduce the recorded bytes of every stage x dtype,
    both decorrelators and faithful mode (what journal replay needs; the
    float stages' ULP check above cannot show it); kernel C those of every
    dtype x rate x counter x input, special values and NaNs included; and
    kernel B's device GF(2) tile states equal the host jump at four
    counters."""
    import numpy as np
    from repro_torch.core import engine, u64
    from repro_torch.kernels import digests
    from repro_torch.kernels import thundering_block as tb
    t0 = time.perf_counter()
    got = digests.compute(device)
    bad = digests.mismatches(got)
    require(set(got) == set(digests.RECORDED) and not bad,
            f"kernel bytes differ from the recorded digests: {bad[:5]}")
    log(f"digests: {len(got)} outputs equal the recorded bytes in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    got = digests.compute_dropout(device)
    bad = digests.mismatches(got)
    require(set(got) == set(digests.DROPOUT_RECORDED) and not bad,
            f"kernel C bytes differ from the recorded digests: {bad[:5]}")
    log(f"digests: {len(got)} kernel C outputs equal the recorded bytes in "
        f"{time.perf_counter() - t0:.1f} s")
    S, T, bt = 1000, 1000, 64
    for ctr in (0, 12345, HIGH_OFFSET, 2 ** 63 + 1):
        plan = engine.make_plan(seed=SEED, num_streams=S, num_steps=T,
                                offset=ctr, mode="faithful", device=device)
        dev = tb.faithful_tile_states(tb.lane_states(S, device), ctr, bt,
                                      -(-T // bt))
        host = engine._faithful_tile_states(plan, bt, -(-T // bt))
        require(np.array_equal(u64.limbs(dev.cpu()).numpy()
                               .astype(np.uint32), host),
                f"device tile states != host jump_batch at ctr={ctr}")
    log("device GF(2) tile states equal the host jump at ctr = 0, 12345, "
        "2^32 + 12345, 2^63 + 1")


def phase_golden(device) -> None:
    """Small blocks against the numpy uint64 golden model."""
    import numpy as np
    from repro_torch.core import engine, golden, u64
    for mode in ("ctr", "faithful"):
        plan = engine.make_plan(seed=SEED, num_streams=5, num_steps=24,
                                offset=HIGH_OFFSET, mode=mode, device=device)
        got = engine.generate(plan).cpu().numpy()
        h = [u64.join64(a, b) for a, b in zip(plan.h[0].tolist(),
                                              plan.h[1].tolist())]
        want = golden.thundering_block(plan.x0, np.array(h, np.uint64), 24,
                                       mode=mode, offset=HIGH_OFFSET).T
        require(np.array_equal(got, want), f"golden mismatch ({mode})")
    log("golden: ctr and faithful blocks equal the numpy uint64 model")


def _window_check(name: str, block, plan, row0: int, rows: int,
                  kind: str) -> None:
    """Rows [row0, row0+rows) of a main-path block against the plain
    oracle (the port's "torch" backend) on the same device."""
    from repro_torch.core import engine
    sub = dataclasses.replace(engine.shift_plan(plan, row0), num_steps=rows)
    want = engine.generate(sub, backend="torch")
    ok, err, ulp = compare(block[row0:row0 + rows], want, kind)
    require(ok, f"main path {name}: window [{row0}, {row0 + rows}) "
                f"disagrees (max_abs_err={err}, max_ulp={ulp})")


def _count_host_jumps():
    """Count calls of the host GF(2) jumps (engine._faithful_tile_states,
    xorshift.jump_batch) until the returned function is called; it
    restores them and returns the count."""
    from repro_torch.core import engine, xorshift
    calls = [0]
    saved = {(engine, "_faithful_tile_states"): engine._faithful_tile_states,
             (xorshift, "jump_batch"): xorshift.jump_batch}

    def counting(fn):
        def wrapper(*args, **kw):
            calls[0] += 1
            return fn(*args, **kw)
        return wrapper
    for (mod, name), fn in saved.items():
        setattr(mod, name, counting(fn))

    def stop() -> int:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
        return calls[0]
    return stop


def phase_main_path(device) -> dict:
    """The port's main path at full size, through the user entry points."""
    import torch
    from repro_torch.core import engine, stream
    from repro_torch.kernels import thundering_block as tb
    from repro_torch.runtime.blocks import BlockService

    host_jumps = _count_host_jumps()
    tb.reset_counts()
    t0 = time.perf_counter()
    base = engine.make_plan(seed=SEED, num_streams=S_FULL, num_steps=T_FULL,
                            device=device)
    results = {}
    results["bits"] = engine.generate(base)
    results["uniform_f32"] = engine.sample(base, sampler="uniform")
    results["normal_f32"] = engine.sample(base, sampler="normal")
    results["uniform_bf16"] = engine.sample(base, sampler="uniform",
                                            out_dtype="bfloat16")
    fmix = engine.make_plan(seed=SEED, num_streams=S_FULL,
                            num_steps=T_FULL, deco="fmix32", device=device)
    results["fmix32_bits"] = engine.generate(fmix)
    faithful = engine.make_plan(seed=SEED, num_streams=S_FULL,
                                num_steps=T_FULL, mode="faithful",
                                device=device)
    results["faithful_bits"] = engine.generate(faithful)
    windows = engine.generate_windows(base, 4)
    sync(device)

    svc = BlockService(seed=SEED, device=device)
    svc.open("smoke/bulk", num_streams=S_FULL)
    plan_of = {}
    produced = 0
    t_prod = time.perf_counter()
    with svc.producer("smoke/bulk", T_FULL, fuse=4, depth=2, donate=True,
                      count=8, check_ring=True) as prod:
        for lease, blk in prod:
            produced += 1
            if lease.lo in (0, 5 * T_FULL):
                plan_of[lease.lo] = (lease.plan(), blk[:256].clone(),
                                     blk[-256:].clone())
            require(tuple(blk.shape) == (T_FULL, S_FULL),
                    f"producer block shape {tuple(blk.shape)}")
    sync(device)
    prod_s = time.perf_counter() - t_prod
    require(produced == 8, f"producer yielded {produced} blocks, not 8")

    fam = stream.new_stream(SEED, 0, device=device)
    sbits = stream.random_bits(fam, (2 ** 20,))
    col3 = stream.random_bits(stream.derive(fam, 3), (T_FULL,))
    sync(device)
    main_s = time.perf_counter() - t0

    launches = {"thundering_ctr": tb.thundering_ctr.launches,
                "thundering_faithful": tb.thundering_faithful.launches}
    plain_runs = (tb.thundering_ctr_plain.cuda_runs
                  + tb.thundering_faithful_plain.cuda_runs)
    host_jumps = host_jumps()
    log(f"main path: {main_s:.2f} s wall; launches {launches}; plain "
        f"versions run on the card: {plain_runs}; host GF(2) jumps: "
        f"{host_jumps}")
    log(f"producer: 8 blocks of {T_FULL}x{S_FULL} u32 (fuse=4, depth=2, "
        f"donate) in {prod_s:.3f} s = "
        f"{8 * T_FULL * S_FULL / prod_s / 1e9:.1f} GSample/s wall")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    require(plain_runs == 0, "a plain version ran on a CUDA tensor")
    require(host_jumps == 0, f"the faithful card path made {host_jumps} "
                             f"host GF(2) jumps")

    # what came out: shapes, dtypes, ranges, and windows against the oracle
    for name, blk in results.items():
        require(tuple(blk.shape) == (T_FULL, S_FULL), f"{name} shape")
        if blk.dtype in (torch.float32, torch.bfloat16):
            require(bool(torch.isfinite(blk).all()), f"{name} not finite")
    for name in ("uniform_f32", "uniform_bf16"):
        u = results[name].float()
        require(float(u.min()) >= 0.0 and float(u.max()) <= 1.0, name)
    z = results["normal_f32"]
    mean, std = float(z.mean()), float(z.std())
    require(abs(mean) < 1e-3 and abs(std - 1.0) < 1e-3,
            f"normal moments {mean} {std}")
    mid = T_FULL // 2
    _window_check("bits", results["bits"], base, mid, 256, "bits")
    _window_check("uniform_f32", results["uniform_f32"],
                  dataclasses.replace(base, sampler="uniform"),
                  mid, 256, "uniform")
    _window_check("normal_f32", results["normal_f32"],
                  dataclasses.replace(base, sampler="normal"),
                  mid, 256, "normal")
    _window_check("uniform_bf16", results["uniform_bf16"],
                  dataclasses.replace(base, sampler="uniform",
                                             out_dtype="bfloat16"),
                  mid, 256, "uniform")
    _window_check("fmix32_bits", results["fmix32_bits"], fmix, mid, 256,
                  "bits")
    _window_check("faithful_bits", results["faithful_bits"], faithful,
                  T_FULL - 256, 256, "bits")
    require(torch.equal(windows[0].view(torch.int32),
                        results["bits"].view(torch.int32)),
            "generate_windows window 0 != generate")
    _window_check("generate_windows[3]", windows[3],
                  engine.shift_plan(base, 3 * T_FULL), 0, 256, "bits")
    for lo, (plan, head, tail) in plan_of.items():
        _window_check(f"producer@{lo}", head, plan, 0, 256, "bits")
        _window_check(f"producer@{lo} tail", tail,
                      engine.shift_plan(plan, T_FULL - 256), 0, 256, "bits")
    splan = engine.plan_for_stream(stream.advance(fam, 2 ** 20 - 4096), 4096)
    want = engine.generate(splan, backend="torch")[:, 0]
    require(torch.equal(sbits[-4096:].view(torch.int32),
                        want.view(torch.int32)), "stream tail != oracle")
    require(torch.equal(col3.view(torch.int32),
                        results["bits"][:, 3].contiguous().view(torch.int32)),
            "bulk column 3 != random_bits(derive(family, 3))")
    log("main path outputs: shapes, ranges and oracle windows check out")
    return launches


def _device_busy_us(prof) -> float:
    """Sum of the device-side events' (kernels, copies) time in a
    profiler trace, us; host-side ops are left out so nothing counts
    twice."""
    from torch.autograd import DeviceType
    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            total += float(getattr(evt, "self_device_time_total", 0.0)
                           or getattr(evt, "self_cuda_time_total", 0.0))
    return total


def phase_delivery(device) -> None:
    """End to end on the host clock: BlockProducer blocks and stream API
    calls, each run ending in a synchronize; then one profiled producer
    run for the device's busy share."""
    import torch
    from repro_torch.core import stream
    from repro_torch.runtime.blocks import BlockService

    svc = BlockService(seed=SEED, device=device)
    svc.open("smoke/delivery", num_streams=S_FULL)

    def run(count, **kw):
        with svc.producer("smoke/delivery", T_FULL, count=count, **kw) as p:
            for _ in p:
                pass
        sync(device)

    n = 64
    for label, kw in (("fuse=4 depth=2 donate", dict(fuse=4, depth=2,
                                                     donate=True)),
                      ("fuse=1 depth=2", dict(fuse=1, depth=2))):
        run(8, **kw)                                   # warm-up
        t0 = time.perf_counter()
        run(n, **kw)
        wall = time.perf_counter() - t0
        log(f"producer {label}: {n} blocks of {T_FULL}x{S_FULL} u32 in "
            f"{wall * 1e3:.3f} ms = {n * T_FULL * S_FULL / wall / 1e9:.1f} "
            f"GSample/s, {wall / n * 1e3:.4f} ms/block (host clock)")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n, fuse=4, depth=2, donate=True)
        wall = time.perf_counter() - t0
    busy = _device_busy_us(prof)
    if busy > 0.0:
        log(f"producer fuse=4 depth=2 donate under the profiler: device busy "
            f"{busy / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall = "
            f"{busy / (wall * 1e6) * 100:.1f} % (idle "
            f"{100 - busy / (wall * 1e6) * 100:.1f} %)")
    else:
        log("producer device busy share: not measured (the profiler "
            "recorded no device time)")
    fam = stream.new_stream(SEED, 0, device=device)
    for n_el in (2 ** 10, 2 ** 20):
        stream.random_bits(fam, (n_el,))
        sync(device)
        reps = 50
        t0 = time.perf_counter()
        for i in range(reps):
            stream.random_bits(stream.advance(fam, i * n_el), (n_el,))
        sync(device)
        per = (time.perf_counter() - t0) / reps
        log(f"stream.random_bits({n_el}): {per * 1e6:.1f} us per call "
            f"(host clock, {reps} calls)")


def _was(key: str) -> str:
    return f" (earlier: {EARLIER_MS[key]} ms)" if key in EARLIER_MS else ""


def _matvecs(S: int, ctr: int, bt: int, n_tiles: int) -> int:
    """GF(2) matvecs of kernel B's device tile-state jump: one per set bit
    of ctr and of each tile's i * bt, for every stream."""
    return S * (bin(ctr).count("1")
                + sum(bin(i * bt).count("1") for i in range(n_tiles)))


def phase_timing(device) -> list:
    """Kernels A and B at the main path's shape: ms beside PR 13's, the
    byte bound alone and the bound (the larger of bytes and SASS issue),
    the plain version and torch's Philox; kernel B's prep both ways."""
    import ctypes

    import numpy as np
    import torch
    from repro_torch.core import engine, lcg, sampler, u64, xorshift
    from repro_torch.kernels import thundering_block as tb

    plan = engine.make_plan(seed=SEED, num_streams=S_FULL, num_steps=T_FULL,
                            device=device)
    T, S = T_FULL, S_FULL
    elems = T * S
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rows = []

    def bound(out_bytes, in_bytes, ops_key, extra=(0, 0)):
        int_ops, all_ops = BLOCK_OPS_PER_ELEMENT[ops_key]
        t_bytes = (out_bytes + in_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = max((elems * int_ops + extra[0]) / INT32_OPS_PER_S,
                    (elems * all_ops + extra[1]) / DISPATCH_OPS_PER_S) * 1e3
        return (max(t_bytes, t_ops),
                "operations" if t_ops > t_bytes else "bytes", t_bytes, t_ops)

    def report(label, ms, out_bytes, b=None):
        gbps = out_bytes / (ms * 1e-3) / 1e9
        text = (f"  {label}: {ms:.4f} ms{_was(label)}  "
                f"{elems / (ms * 1e-3) / 1e9:.1f} GSample/s  {gbps:.1f} GB/s"
                f"; byte bound {out_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
        if b is not None:
            text += (f", SASS issue bound {b[3]:.4f} ms: bound {b[0]:.4f} "
                     f"ms by {b[1]} ({b[0] / ms * 100:.1f}% of its speed)")
        log(text)

    log(f"timing at T={T} S={S} (CUDA events):")
    variants = [("bits", "float32", "splitmix64", 4),
                ("bits", "float32", "fmix32", 4),
                ("uniform", "float32", "splitmix64", 4),
                ("uniform", "bfloat16", "splitmix64", 2),
                ("normal", "float32", "splitmix64", 4)]
    ctr_row = None
    for spec_text, dtype, deco, width in variants:
        spec = sampler.parse(spec_text)
        out = torch.empty((T, S), dtype=sampler.result_dtype(spec, dtype),
                          device=device)

        def launch(spec=spec, dtype=dtype, deco=deco, out=out):
            tb.thundering_ctr(plan.x0, plan.ctr, T, plan.h, deco=deco,
                              sampler=spec, out_dtype=dtype, out=out)
        ms = time_cuda(launch, reps=20)
        b = bound(elems * width, S * 8, deco) if spec_text == "bits" \
            else None
        report(f"thundering_ctr {deco} {spec_text} {dtype}", ms,
               elems * width, b)
        if (spec_text, deco) == ("bits", "splitmix64"):
            ctr_row = dict(name="thundering_ctr", ms=ms, bound_ms=b[0],
                           bound_by=b[1])
        del out
    bits_spec = sampler.parse("bits")
    plain_ctr = time_cuda(lambda: tb.thundering_ctr_plain(
        plan.x0, plan.ctr, T, plan.h, sampler=bits_spec), reps=3, warmup=1)
    log(f"  thundering_ctr_plain bits: {plain_ctr:.4f} ms")
    lib_bits = torch.empty((T, S), dtype=torch.int32, device=device)
    lib_ctr = time_cuda(lambda: lib_bits.random_(generator=gen), reps=20)
    lib_uni = time_cuda(lambda: torch.rand((T, S), generator=gen,
                                           device=device), reps=20)
    report("library torch random_ int32 (Philox)", lib_ctr, elems * 4)
    report("library torch.rand f32 (Philox)", lib_uni, elems * 4)
    del lib_bits
    rows.append(dict(ctr_row, plain_ms=plain_ctr, library_ms=lib_ctr))

    # kernel B: its prep, the one-time lane table and the per-call jump
    bt = tb.tile_rows(engine.DEFAULT_BLOCK_T, T)
    n_tiles = -(-T // bt)
    t0 = time.perf_counter()
    table = xorshift.lane_table.__wrapped__(S)
    lanes = tb.states_tensor(table.T.copy(), device)
    sync(device)
    log(f"  faithful one-time prep: lane_table({S}) on the host and its "
        f"upload, {time.perf_counter() - t0:.3f} s (cached per S and "
        f"device)")
    for ctr in (0, HIGH_OFFSET):
        faithful = engine.make_plan(seed=SEED, num_streams=S, num_steps=T,
                                    offset=ctr, mode="faithful",
                                    device=device)
        t0 = time.perf_counter()
        host = engine._faithful_tile_states(faithful, bt, n_tiles)
        host_s = time.perf_counter() - t0
        tb.faithful_tile_states(lanes, ctr, bt, n_tiles)
        sync(device)
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            dev = tb.faithful_tile_states(lanes, ctr, bt, n_tiles)
        sync(device)
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
        ev_ms = time_cuda(lambda: tb.faithful_tile_states(
            lanes, ctr, bt, n_tiles), reps=reps)
        require(np.array_equal(u64.limbs(dev.cpu()).numpy().astype(np.uint32),
                               host),
                f"device tile states != host jump at ctr={ctr}")
        log(f"  faithful per-call prep at ctr={ctr}, {n_tiles} tiles: device "
            f"GF(2) jump {wall_ms:.4f} ms wall with its launches "
            f"({ev_ms:.4f} ms CUDA events, "
            f"{_matvecs(S, ctr, bt, n_tiles)} matvecs); the host jump it "
            f"replaces {host_s:.3f} s (PR 13: 1.767-2.280 s)")
    out = torch.empty((T, S), dtype=torch.uint32, device=device)
    states = tb.faithful_tile_states(lanes, plan.ctr, bt, n_tiles)
    rec, _ = tb._stage(bits_spec, "float32", device)
    lib = tb._lib()
    h_hi, h_lo = tb.limb_words(plan.h[0]), tb.limb_words(plan.h[1])
    sptr = torch.cuda.current_stream(device).cuda_stream

    def kernel_b():
        require(lib.tb_faithful_launch(
            out.data_ptr(), T, S, lcg.advance(plan.x0, plan.ctr),
            h_hi.data_ptr(), h_lo.data_ptr(), states.data_ptr(), n_tiles,
            bt, ctypes.byref(rec), sptr) == 0, "tb_faithful_launch failed")
    k_ms = time_cuda(kernel_b, reps=20)
    kb = bound(elems * 4, S * 8 + states.numel() * 4, "faithful")
    report("thundering_faithful bits (kernel alone, tile states ready)",
           k_ms, elems * 4, kb)
    f_ms = time_cuda(lambda: tb.thundering_faithful(
        plan.x0, plan.ctr, T, plan.h, lanes, block_t=bt, sampler=bits_spec,
        out=out), reps=20)
    m = _matvecs(S, plan.ctr, bt, n_tiles)
    fb = bound(elems * 4, S * 8 + lanes.numel() * 4 + 64 * 512 * 16,
               "faithful", (m * MATVEC_OPS[0], m * MATVEC_OPS[1]))
    report("thundering_faithful bits", f_ms, elems * 4, fb)
    plain_f = time_cuda(lambda: tb.thundering_faithful_plain(
        plan.x0, plan.ctr, T, plan.h, lanes, block_t=bt,
        sampler=bits_spec), reps=1, warmup=1)
    log(f"  thundering_faithful_plain bits (host jump_batch included): "
        f"{plain_f:.4f} ms")
    rows.append(dict(name="thundering_faithful", ms=f_ms, plain_ms=plain_f,
                     bound_ms=fb[0], bound_by=fb[1], library_ms=lib_ctr))
    return rows


# ---------------------------------------------------------------------------
# the applications: kernels C (fused dropout), D (pi), E (option)
# ---------------------------------------------------------------------------

def _mc_plans(T: int, S: int, off: int, purposes, device):
    from repro_torch.core import engine
    return tuple(engine.make_plan(seed=SEED, num_streams=S, num_steps=T,
                                  purpose=p, offset=off, device=device)
                 for p in purposes)


def _option_gap(got, want) -> float:
    """Largest |got - want| over the largest |want| of a partial array."""
    return float((got - want).abs().max()) / float(want.abs().max())


def _bits_equal(a, b) -> bool:
    import torch
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16, torch.int32: torch.int32}[a.dtype]
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.view(view), b.view(view))


def phase_apps_parity(device) -> dict:
    """Kernels C, D and E against their plain versions on the card."""
    import torch
    from repro_torch.core import stream
    from repro_torch.kernels import fused_dropout as fd, mc
    worst = {"pi_partials": 0.0, "option_partials": 0.0,
             "fused_dropout_2d": 0.0}
    worst_gap = 0.0
    n = 0
    for T, S, bt in ((37, 130, 8), (256, 130, 256), (4096, S_FULL, 256)):
        for off in (0, HIGH_OFFSET):
            tag = f"T={T} S={S} block_t={bt} off={off}"
            px, py = _mc_plans(T, S, off, (1, 2), device)
            args = (px.x0, px.ctr, T, px.h, py.h)
            got = mc.pi_partials(*args, block_t=bt)
            want = mc.pi_partials_plain(*args, block_t=bt)
            sync(device)
            require(_bits_equal(got, want), f"pi partials disagree: {tag}")
            ox, oy = _mc_plans(T, S, off, (3, 4), device)
            args = (ox.x0, ox.ctr, T, ox.h, oy.h)
            got = mc.option_partials(*args, block_t=bt, **OPTION)
            want = mc.option_partials_plain(*args, block_t=bt, **OPTION)
            sync(device)
            gap = _option_gap(got, want)
            require(bool(torch.isfinite(got).all()) and gap <= OPTION_RTOL,
                    f"option partials disagree: {tag}: {gap:.3e} of the "
                    f"largest partial")
            worst["option_partials"] = max(worst["option_partials"],
                                           float((got - want).abs().max()))
            worst_gap = max(worst_gap, gap)
            n += 2
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    fam = stream.new_stream(SEED, 0, device=device)
    for shape in ((3, 1001), (8, 128), (4096, 3072)):
        base = torch.randn(shape, generator=gen, device=device)
        dtypes = [torch.float32, torch.bfloat16]
        if shape[0] <= 8:
            dtypes.append(torch.float16)
        for dtype in dtypes:
            x = base.to(dtype)
            for off in (0, HIGH_OFFSET):
                s = stream.advance(fam, off)
                for rate in (0.1, 0.5, 1e-9):
                    got = fd.fused_dropout_2d(x, s.h, s.x0, s.ctr, rate)
                    want = fd.fused_dropout_2d_plain(x, s.h, s.x0, s.ctr,
                                                     rate)
                    sync(device)
                    require(_bits_equal(got, want),
                            f"fused dropout disagrees: {tuple(shape)} "
                            f"{dtype} off={off} rate={rate}")
                    n += 1
    flat = torch.randn(64 * 1001 + 1, generator=gen, device=device)
    x = flat[1:].view(64, 1001)       # 4 bytes past a 16-byte line
    s = stream.advance(fam, HIGH_OFFSET)
    require(_bits_equal(fd.fused_dropout_2d(x, s.h, s.x0, s.ctr, 0.3),
                        fd.fused_dropout_2d_plain(x, s.h, s.x0, s.ctr, 0.3)),
            "fused dropout disagrees on a misaligned x")
    n += 1
    log(f"apps parity: {n} kernel-vs-plain checks passed (pi and dropout "
        f"bit-equal; option partials within {worst_gap:.3e} of the largest "
        f"partial, limit {OPTION_RTOL})")
    return worst


def _black_scholes(s0, strike, r, sigma, t):
    """(closed-form call price, standard deviation of one discounted
    payoff) under GBM."""
    import math

    def norm_cdf(v):
        return 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))
    vt = sigma * math.sqrt(t)
    d1 = (math.log(s0 / strike) + (r + 0.5 * sigma * sigma) * t) / vt
    d2 = d1 - vt
    price = s0 * norm_cdf(d1) - strike * math.exp(-r * t) * norm_cdf(d2)
    second = math.exp(-2 * r * t) * (
        s0 * s0 * math.exp((2 * r + sigma * sigma) * t) * norm_cdf(d1 + vt)
        - 2 * strike * s0 * math.exp(r * t) * norm_cdf(d1)
        + strike * strike * norm_cdf(d2))
    return price, math.sqrt(second - price * price)


def phase_apps(device) -> dict:
    """The applications' main path at full width, through the user entry
    points: ops.estimate_pi, ops.price_option, the leased
    runtime.blocks.estimate_pi, ops.fused_dropout on a stream and on a
    lease."""
    import math
    import torch
    from repro_torch.core import engine, stream
    from repro_torch.kernels import fused_dropout as fd, mc, ops, ref
    from repro_torch.kernels import thundering_block as tb
    from repro_torch.runtime import blocks
    from repro_torch.runtime.blocks import BlockService

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    xs = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(DROPOUT_SHAPE, generator=gen, device=device,
                        dtype=dtype)
        xs[dtype] = x.masked_fill_(x == 0, 1.0)   # 0 out = dropped
    x_lease = xs[torch.float32][:8]
    drop = stream.derive(stream.new_stream(SEED, 0, device=device), 0xD0)
    n_drop = xs[torch.float32].numel()
    sync(device)

    tb.reset_counts()
    mc.reset_counts()
    fd.reset_counts()
    t0 = time.perf_counter()
    kw = dict(seed=SEED, num_lanes=APP_LANES, draws_per_lane=APP_DRAWS)
    pi = ops.estimate_pi(**kw)
    price = ops.price_option(**kw)
    svc = BlockService(seed=SEED, device=device)
    lease_kw = dict(num_lanes=APP_LANES, draws_per_lane=APP_DRAWS)
    e1 = blocks.estimate_pi(svc, **lease_kw)
    e2 = blocks.estimate_pi(svc, **lease_kw)
    y = {torch.bfloat16: ops.fused_dropout(xs[torch.bfloat16], drop,
                                           DROPOUT_RATE),
         torch.float32: ops.fused_dropout(xs[torch.float32],
                                          stream.advance(drop, n_drop),
                                          DROPOUT_RATE)}
    svc.open("smoke/dropout")
    lease = svc.lease("smoke/dropout", fd.mask_elems(x_lease.shape))
    y_lease = ops.fused_dropout(x_lease, lease, DROPOUT_RATE)
    lease.commit()
    sync(device)
    wall = time.perf_counter() - t0
    launches = {"pi_partials": mc.pi_partials.launches,
                "option_partials": mc.option_partials.launches,
                "fused_dropout_2d": fd.fused_dropout_2d.launches}
    plain_runs = (mc.pi_partials_plain.cuda_runs
                  + mc.option_partials_plain.cuda_runs
                  + fd.fused_dropout_2d_plain.cuda_runs
                  + tb.thundering_ctr_plain.cuda_runs
                  + tb.thundering_faithful_plain.cuda_runs)
    log(f"apps path: {wall:.2f} s wall; launches {launches}; plain versions "
        f"run on the card: {plain_runs}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the apps path never launched: {launches}")
    require(plain_runs == 0, "a plain version ran on a CUDA tensor")

    # pi: within 5 sigma of the binomial estimate; three tiles of the
    # partials against the plain oracle on shifted windows
    N = APP_LANES * APP_DRAWS
    p = math.pi / 4
    sigma_pi = 4 * math.sqrt(p * (1 - p) / N)
    require(pi.dtype == torch.float32 and pi.dim() == 0, "pi result type")
    log(f"estimate_pi: {pi.item()!r} (|err| {abs(pi.item() - math.pi):.3e}, "
        f"5 sigma {5 * sigma_pi:.3e}); leased: {e1.item()!r}, {e2.item()!r}")
    require(abs(pi.item() - math.pi) < 5 * sigma_pi, "pi off by > 5 sigma")
    require(e1.item() != e2.item() and
            abs(e1.item() - math.pi) < 5 * sigma_pi and
            abs(e2.item() - math.pi) < 5 * sigma_pi, "leased pi estimates")
    require(svc.ledger_state()["channels"]["mc/pi"]["committed"] ==
            [[0, 2 * APP_DRAWS]], "leased windows not committed")
    px, py = _mc_plans(APP_DRAWS, APP_LANES, 0, (1, 2), device)
    partials = mc.pi_partials_from_plans(px, py)
    hits = partials.to(torch.float32).sum()
    require((4.0 * hits / torch.full((), N, dtype=torch.float32,
                                     device=device)).item() == pi.item(),
            "estimate_pi != its partials")
    bt, n_tiles = mc.tile_layout(APP_DRAWS, mc.DEFAULT_BLOCK_T)
    for i in (0, n_tiles // 2, n_tiles - 1):
        want = ref.mc_pi_partial(px.x0, px.h, py.h, bt, px.ctr + i * bt)
        require(torch.equal(partials[i], want), f"pi tile {i} != oracle")
    bs, sd = _black_scholes(**OPTION)
    sigma_opt = sd / math.sqrt(N)
    log(f"price_option: {price.item()!r} (Black-Scholes {bs!r}, |err| "
        f"{abs(price.item() - bs):.3e}, 5 sigma {5 * sigma_opt:.3e})")
    require(abs(price.item() - bs) < 5 * sigma_opt,
            "option price off by > 5 sigma")
    ox, oy = _mc_plans(APP_DRAWS, APP_LANES, 0, (3, 4), device)
    opart = mc.option_partials_from_plans(ox, oy, **OPTION)
    want = ref.mc_option_partial(ox.x0, ox.h, oy.h, bt, ox.ctr, OPTION["s0"],
                                 OPTION["strike"], OPTION["r"],
                                 OPTION["sigma"], OPTION["t"])
    require(_option_gap(opart[0], want) <= OPTION_RTOL,
            "option tile 0 != oracle")

    # dropout: keep fraction, kept values, a mask window against the oracle
    thresh = fd.keep_threshold(DROPOUT_RATE)
    for dtype, out in y.items():
        x = xs[dtype]
        keep = out != 0
        frac = keep.sum().item() / n_drop
        sd_keep = math.sqrt((1 - DROPOUT_RATE) * DROPOUT_RATE / n_drop)
        log(f"fused_dropout {dtype}: keep fraction {frac!r} (5 sigma "
            f"{5 * sd_keep:.2e})")
        require(abs(frac - (1 - DROPOUT_RATE)) < 5 * sd_keep,
                f"dropout keep fraction {frac}")
        scale = torch.tensor(1.0 / (1.0 - DROPOUT_RATE), dtype=dtype,
                             device=device)
        require(_bits_equal(out, torch.where(keep, x * scale,
                                             torch.zeros_like(x))),
                f"dropout kept values != x * scale ({dtype})")
        s = drop if dtype == torch.bfloat16 else stream.advance(drop, n_drop)
        p0 = n_drop // 2 + 12345
        bits = engine.generate(engine.plan_for_stream(
            stream.advance(s, p0), 4096), backend="torch")[:, 0]
        require(torch.equal(keep.reshape(-1)[p0:p0 + 4096],
                            bits.to(torch.int64) < thresh),
                f"dropout mask window != stream bits < threshold ({dtype})")
    st = lease.stream()
    require(_bits_equal(y_lease, ref.fused_dropout(x_lease, st.h, st.x0,
                                                   st.ctr, DROPOUT_RATE)),
            "leased dropout != oracle")
    log("apps outputs: pi, option price, leases, dropout masks check out")
    return launches


def phase_apps_timing(device) -> list:
    """Kernels C, D, E at the apps path's shapes: ms, bound, plain ms,
    torch's generators, the torch "vendor" pipelines and draws per s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_dropout as fd, mc, ops, ref
    T, S = APP_DRAWS, APP_LANES
    N = T * S
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rows = []

    def bound(n_bytes, n_elems, key):
        int_ops, all_ops = APP_OPS_PER_ELEMENT[key]
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(n_elems * int_ops / INT32_OPS_PER_S,
                    n_elems * all_ops / DISPATCH_OPS_PER_S) * 1e3
        return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                     else "bytes")

    log(f"apps timing at T={T} draws x S={S} lanes = {N} (x, y) pairs, "
        f"dropout at {DROPOUT_SHAPE} (CUDA events):")
    bt, n_tiles = mc.tile_layout(T, mc.DEFAULT_BLOCK_T)
    out_bytes, in_bytes = n_tiles * S * 4, 4 * S * 4
    for name, purposes, app in (("pi_partials", (1, 2), "pi"),
                                ("option_partials", (3, 4), "option")):
        px, py = _mc_plans(T, S, 0, purposes, device)
        args = (px.x0, px.ctr, T, px.h, py.h)
        kw = {} if app == "pi" else OPTION
        kernel = getattr(mc, name)
        plain = getattr(mc, name + "_plain")
        out = torch.empty((n_tiles, S), device=device,
                          dtype=torch.int32 if app == "pi" else torch.float32)
        ms = time_cuda(lambda: kernel(*args, out=out, **kw), reps=10)
        plain_ms = time_cuda(lambda: plain(*args, **kw), reps=1, warmup=1)
        b_ms, b_by = bound(out_bytes + in_bytes, N, app)
        entry = getattr(ops, "estimate_pi" if app == "pi" else "price_option")
        e_ms = time_cuda(lambda: entry(seed=SEED, num_lanes=S,
                                       draws_per_lane=T), reps=5)
        if app == "pi":
            u = torch.empty((2, N), device=device)
            lib_ms = time_cuda(lambda: torch.rand((2, N), generator=gen,
                                                  device=device, out=u),
                               reps=10)

            def vendor():
                torch.rand((2, N), generator=gen, device=device, out=u)
                return 4.0 * ((u[0] * u[0] + u[1] * u[1]) < 1.0).sum() / N
            lib_label = f"torch.rand of {2 * N} f32"
        else:
            z = torch.empty(N, device=device)
            lib_ms = time_cuda(lambda: torch.randn(N, generator=gen,
                                                   device=device, out=z),
                               reps=10)
            s0, k, drift, vol, disc = ref.option_constants(
                OPTION["s0"], OPTION["strike"], OPTION["r"],
                OPTION["sigma"], OPTION["t"])

            def vendor():
                torch.randn(N, generator=gen, device=device, out=z)
                st = s0 * torch.exp(drift + vol * z)
                return (torch.clamp_min(st - k, 0.0) * disc).sum() / N
            lib_label = f"torch.randn of {N} f32"
        v_ms = time_cuda(vendor, reps=5)
        log(f"  {name} kernel: {ms:.4f} ms{_was(name)} = "
            f"{N / (ms * 1e-3) / 1e9:.1f} G "
            f"(x, y) draws/s; bound {b_ms:.4f} ms by {b_by} "
            f"({b_ms / ms * 100:.1f}% of the bound's speed)")
        log(f"  {name} plain version at the same shape: {plain_ms:.2f} ms")
        log(f"  ops.{entry.__name__} end to end: {e_ms:.4f} ms = "
            f"{N / (e_ms * 1e-3) / 1e9:.1f} G draws/s")
        log(f"  library {lib_label} (Philox): {lib_ms:.4f} ms; torch vendor "
            f"pipeline (generate -> integrand -> sum): {v_ms:.4f} ms = "
            f"{N / (v_ms * 1e-3) / 1e9:.1f} G draws/s "
            f"({v_ms / e_ms:.2f}x the entry point's time)")
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms))

    from repro_torch.core import stream
    s = stream.new_stream(SEED, 0, device=device)
    n = DROPOUT_SHAPE[0] * DROPOUT_SHAPE[1]
    per_dtype = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(DROPOUT_SHAPE, generator=gen, device=device,
                        dtype=dtype)
        out = torch.empty_like(x)
        ms = time_cuda(lambda: fd.fused_dropout_2d(
            x, s.h, s.x0, s.ctr, DROPOUT_RATE, out=out), reps=20)
        plain_ms = time_cuda(lambda: fd.fused_dropout_2d_plain(
            x, s.h, s.x0, s.ctr, DROPOUT_RATE), reps=1, warmup=1)
        lib_ms = time_cuda(lambda: F.dropout(x, DROPOUT_RATE, training=True),
                           reps=20)
        e_ms = host_ms(lambda: ops.fused_dropout(x, s, DROPOUT_RATE),
                        reps=20)
        moved = 2 * n * x.element_size()
        b_ms, b_by = bound(moved, n, "dropout_bf16"
                           if dtype == torch.bfloat16 else "dropout_f32")
        log(f"  fused_dropout_2d {dtype}: {ms:.4f} ms"
            f"{_was(f'fused_dropout_2d {dtype}')} = "
            f"{moved / (ms * 1e-3) / 1e9:.1f} GB/s; bound {b_ms:.4f} ms by "
            f"{b_by} ({b_ms / ms * 100:.1f}% of the bound's speed); plain "
            f"{plain_ms:.2f} ms; torch F.dropout {lib_ms:.4f} ms")
        log(f"  ops.fused_dropout {dtype} end to end (host clock, the "
            f"wrapper's host work included): {e_ms:.4f} ms")
        per_dtype[dtype] = dict(name="fused_dropout_2d", ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib_ms)
        del x, out
    rows.append(per_dtype[torch.bfloat16])   # the training dtype
    return rows


# ---------------------------------------------------------------------------
# the inference tier: kernel F (gumbel-max sampling)
# ---------------------------------------------------------------------------

def _ga_case(V: int, B: int, device, seed: int = 9):
    """(B, V) normal logits and (B,) leaf words of family (seed, 0xD0)."""
    import torch
    from repro_torch.core import engine
    from repro_torch.inference.kernels import gumbel_argmax as ga
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    logits = torch.randn((B, V), generator=gen, device=device)
    x0, h_fam = engine.family_from_seed(seed, 0xD0)
    h = ga.leaf_words([engine.derive_leaf_host(h_fam, t) for t in range(B)],
                      device)
    return logits, h, x0


def _ga_check(tag: str, logits, h, x0, ctr, th, inv_temp, deco="splitmix64"):
    """Kernel F against its plain version: tokens equal and the winning
    scores equal bit for bit (the plain version's debug output)."""
    import torch
    from repro_torch.inference.kernels import gumbel_argmax as ga
    B = logits.shape[0]
    scores = torch.empty(B, device=logits.device)
    got = ga.fused_argmax(logits, h, x0, ctr, th, inv_temp=inv_temp,
                          deco=deco, scores_out=scores)
    want, best = ga.fused_argmax_plain(logits, h, x0, ctr, th,
                                       inv_temp=inv_temp, deco=deco,
                                       with_scores=True)
    sync(logits.device)
    require(torch.equal(got, want),
            f"gumbel_argmax tokens disagree: {tag}: "
            f"{int((got != want).sum())} of {B}")
    require(torch.equal(scores.view(torch.int32), best.view(torch.int32)),
            f"gumbel_argmax winning scores disagree: {tag}")
    return got


def phase_inference_parity(device) -> dict:
    """Kernel F against its plain version on the card: every shape x
    (inv_temp, top_k) x decorrelator, counters below and past 2**32, the
    reference's (V, B) layout as a view, all-masked columns, top-1, and
    scores that tie at -0.0 / +0.0."""
    import torch
    from repro_torch.core import engine
    from repro_torch.inference.kernels import gumbel_argmax as ga
    n = 0
    t0 = time.perf_counter()
    for V, B in INF_SHAPES:
        logits, h, x0 = _ga_case(V, B, device)
        for inv_temp, top_k in INF_OPTIONS:
            th = (torch.topk(logits, top_k, dim=-1).values[:, -1] if top_k
                  else torch.full((B,), float("-inf"), device=device))
            for deco in ("splitmix64", "fmix32"):
                for ctr in (977, HIGH_OFFSET):
                    got = _ga_check(f"V={V} B={B} inv_temp={inv_temp} "
                                    f"top_k={top_k} {deco} ctr={ctr}",
                                    logits, h, x0, ctr, th, inv_temp, deco)
                    if top_k:
                        rows = torch.arange(B, device=device)
                        require(bool((logits[rows, got.long()] >= th).all()),
                                "a sampled token lies outside its top-k set")
                    n += 1
        # the reference's vocab-major layout, as a strided view
        lt = logits.T.contiguous()
        th = torch.full((B,), float("-inf"), device=device)
        _ga_check(f"V={V} B={B} vocab-major view", lt.T, h, x0, 5, th, 1.0)
        # all-masked columns give token 0; top-1 is the argmax
        masked = logits.clone()
        masked[0] = float("-inf")
        th[B // 2] = float("inf")
        got = _ga_check(f"V={V} B={B} all-masked", masked, h, x0,
                        HIGH_OFFSET, th, 1.0)
        require(got[0].item() == 0 and got[B // 2].item() == 0,
                "an all-masked column did not give token 0")
        top1 = torch.topk(logits, 1, dim=-1).values[:, -1]
        got = _ga_check(f"V={V} B={B} top_k=1", logits, h, x0, 977, top1, 2.0)
        require(torch.equal(got.long(), torch.argmax(logits, -1)),
                "top_k = 1 is not the argmax")
        n += 3
        del logits, lt, masked
    # -0.0 and +0.0 scores tie; the first index wins (tests/test_torch_gpu)
    x0, h_fam = engine.family_from_seed(7, 0xD0)
    hv = engine.derive_leaf_host(h_fam, 13)
    ctr = 24235 - 5
    g = engine.generate(engine.GenPlan(
        x0=x0, h=engine.leaf_limbs([hv], device), num_steps=40, ctr=ctr,
        sampler="gumbel"))[:, 0]
    logits = torch.full((1, 40), -100.0, device=device)
    logits[0, 5] = -0.0
    logits[0, 9] = -g[9]
    got = _ga_check("-0.0 / +0.0 tie", logits, ga.leaf_words([hv], device),
                    x0, ctr, torch.full((1,), float("-inf"), device=device),
                    1.0)
    neg_zero = g[5].item() == 0.0 and bool(torch.signbit(g[5]))
    require(not neg_zero or got.item() == 5, "-0.0 lost its tie to +0.0")
    n += 1
    log(f"inference parity: {n} kernel-vs-plain checks passed in "
        f"{time.perf_counter() - t0:.1f} s (tokens equal, winning scores "
        f"bit-equal; the -0.0 noise case {'ran' if neg_zero else 'did not occur'} "
        f"on this card's logf)")
    return {"gumbel_argmax": 0.0}


def _inference_report(label: str, rep) -> dict:
    j = rep.to_json()
    log(f"inference {label}: {j['retired']}/{j['admitted']} sequences, "
        f"{j['total_tokens']} tokens in {j['decode_steps']} steps; "
        f"{rep.tokens_per_s:.1f} tokens/s; p50 "
        f"{rep.result.latency_percentiles()['p50_ms']:.4f} ms, p99 "
        f"{rep.result.latency_percentiles()['p99_ms']:.4f} ms per step; "
        f"occupancy {rep.result.occupancy:.4f}; calls/step "
        f"{j['calls_per_step']}; digest {j['digest'][:16]} == two-pass "
        f"{(j['parity_digest'] or '-')[:16]}; wall {rep.wall_seconds:.3f} s")
    require(j["calls_per_step"] == 1.0, f"{label}: calls/step {j}")
    require(j["parity_digest"] == j["digest"], f"{label}: parity digest")
    require(j["retired"] == j["admitted"] == rep.config.sequences,
            f"{label}: not every sequence was served")
    for toks in rep.result.transcripts.values():
        require(len(toks) >= rep.config.min_len and
                all(0 <= t < rep.config.vocab for t in toks),
                f"{label}: a transcript is out of range")
    return j


def phase_inference(device) -> dict:
    """The inference tier's main path at full width, through the user entry
    points: run_offline with parity at temperature 1 and with top-k 50,
    then kill-and-replay of ``python -m repro_torch.inference`` in a
    subprocess against the fault-free digest."""
    import os
    import shutil
    from repro_torch.inference import ScheduleConfig, run_offline
    from repro_torch.inference.kernels import gumbel_argmax as ga
    from repro_torch.kernels import fused_dropout as fd, mc
    from repro_torch.kernels import thundering_block as tb
    base = ScheduleConfig(capacity=64, vocab=INF_VOCAB,
                          sequences=INF_SEQUENCES, rate=8.0, seed=0)
    # warm-up: first-call costs (the library load, torch's first top-k)
    run_offline(dataclasses.replace(base, sequences=4, top_k=50),
                device=device)
    tb.reset_counts()
    mc.reset_counts()
    fd.reset_counts()
    ga.reset_counts()
    t0 = time.perf_counter()
    reports = {}
    for label, cfg in (("temperature 1", base),
                       ("top_k 50", dataclasses.replace(base, top_k=50))):
        reports[label] = _inference_report(
            label, run_offline(cfg, parity=True, device=device))
    sync(device)
    wall = time.perf_counter() - t0
    launches = {"gumbel_argmax": ga.fused_argmax.launches}
    plain_runs = (ga.fused_argmax_plain.cuda_runs
                  + tb.thundering_ctr_plain.cuda_runs
                  + tb.thundering_faithful_plain.cuda_runs)
    steps = sum(r["decode_steps"] for r in reports.values())
    log(f"inference path: {wall:.2f} s wall; launches {launches} "
        f"({steps} fused decode steps); thundering_ctr launches "
        f"{tb.thundering_ctr.launches} (arrivals, admissions, two-pass "
        f"noise); plain versions run on the card: {plain_runs}")
    require(launches["gumbel_argmax"] == steps,
            f"kernel F launched {launches['gumbel_argmax']} times for "
            f"{steps} fused decode steps")
    require(plain_runs == 0, "a plain version ran on a CUDA tensor")
    require(reports["temperature 1"]["digest"] !=
            reports["top_k 50"]["digest"], "top-k did not change the tokens")

    # kill-and-replay in a subprocess: exits 1 at decode step 6, the
    # restart on its journal gives the fault-free digest
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    small = dataclasses.replace(base, sequences=INF_KILL_SEQUENCES)
    clean = run_offline(small, device=device).result.digest
    args = [sys.executable, "-m", "repro_torch.inference", "--batch", "64",
            "--vocab", str(INF_VOCAB), "--sequences", str(INF_KILL_SEQUENCES),
            "--rate", "8", "--seed", "0", "--journal", str(work / "j.jsonl")]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    killed = subprocess.run(args + ["--fault-plan", "kill@6"], env=env,
                            cwd=ROOT, capture_output=True, text=True,
                            timeout=300)
    require(killed.returncode == 1, f"the killed run exited "
            f"{killed.returncode}, not 1: {killed.stderr[-2000:]}")
    again = subprocess.run(args + ["--digest-out", str(work / "d.txt")],
                           env=env, cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
    require(again.returncode == 0, f"the replay failed: "
            f"{again.stderr[-2000:]}")
    replayed = (work / "d.txt").read_text().strip()
    log(f"kill-and-replay ({INF_KILL_SEQUENCES} sequences, kill@6): killed "
        f"run exit 1; restart digest {replayed[:16]} == fault-free "
        f"{clean[:16]}; {time.perf_counter() - t0:.1f} s for both "
        f"subprocesses; {again.stdout.strip()}")
    require(replayed == clean, "the replayed digest differs from the "
                               "fault-free run's")
    return launches


def phase_inference_timing(device) -> list:
    """Kernel F at (V, B) = (256000, 64) and (256000, 256): ms, elements
    per s, bound, plain ms, and two torch samplers on the same logits."""
    import torch
    from repro_torch.inference.kernels import gumbel_argmax as ga
    int_ops, all_ops = GA_OPS_PER_ELEMENT
    rows = []
    log("inference timing (CUDA events, tokens preallocated):")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    for B in INF_BATCHES:
        V = INF_VOCAB
        n = V * B
        logits, h, x0 = _ga_case(V, B, device)
        th = torch.full((B,), float("-inf"), device=device)
        out = torch.empty(B, dtype=torch.int32, device=device)
        ms = time_cuda(lambda: ga.fused_argmax(logits, h, x0, 977, th,
                                               inv_temp=1.0, out=out),
                       reps=50)
        plain_ms = time_cuda(lambda: ga.fused_argmax_plain(
            logits, h, x0, 977, th, inv_temp=1.0), reps=1, warmup=1)
        u = torch.empty((B, V), device=device)

        def philox():
            torch.rand((B, V), generator=gen, device=device, out=u)
            g = -torch.log(-torch.log(u))
            return torch.argmax(logits * 1.0 + g, -1)
        lib_ms = time_cuda(philox, reps=20)
        multi_ms = time_cuda(lambda: torch.multinomial(
            torch.softmax(logits * 1.0, -1), 1, generator=gen), reps=20)
        n_bytes = n * 4 + B * (8 + 4 + 4)
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(n * int_ops / INT32_OPS_PER_S,
                    n * all_ops / DISPATCH_OPS_PER_S) * 1e3
        b_ms, b_by = max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                           else "bytes")
        log(f"  gumbel_argmax (V, B) = ({V}, {B}): {ms:.4f} ms"
            f"{_was(f'gumbel_argmax B={B}')} = "
            f"{n / (ms * 1e-3) / 1e9:.1f} G elements/s, "
            f"{n * 4 / (ms * 1e-3) / 1e9:.1f} GB/s of logits; bound "
            f"{b_ms:.4f} ms by {b_by} (bytes {t_bytes:.4f} ms, operations "
            f"{t_ops:.4f} ms; {b_ms / ms * 100:.1f}% of the bound's speed); "
            f"plain {plain_ms:.2f} ms; torch Philox gumbel-max (rand, "
            f"-log(-log u), scaled add, argmax) {lib_ms:.4f} ms; "
            f"torch.multinomial(softmax) {multi_ms:.4f} ms")
        rows.append(dict(name="gumbel_argmax", B=B, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         multinomial_ms=multi_ms))
        del logits, u
    _decode_step_breakdown(device)
    return rows


def _decode_step_breakdown(device) -> None:
    """Where one decode step's time goes at (B, V) = (64, 256000): the
    synthetic logit model and top-k on CUDA events, a whole
    ``sample_step`` on the host clock (lease, leaf offsets, their copy,
    kernel F, the tokens' copy back), and the device's busy share over a
    profiled ``run_offline``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.inference import (ActiveSeq, GumbelMaxSampler,
                                       SamplingSpec, ScheduleConfig,
                                       SyntheticLogitModel, run_offline)
    B, V = 64, INF_VOCAB
    model = SyntheticLogitModel(B, V, device=device)
    hashes = np.arange(B, dtype=np.uint32) * np.uint32(0x9E3779B1)
    pos = np.arange(B, dtype=np.uint32)
    logit_ms = time_cuda(lambda: model(hashes, pos), reps=20)
    logits = model(hashes, pos)
    topk_ms = time_cuda(lambda: torch.topk(logits, 50, dim=-1), reps=20)
    for top_k in (0, 50):
        smp = GumbelMaxSampler.standalone(
            seed=SEED, vocab=V, capacity=B, device=device,
            spec=SamplingSpec(top_k=top_k))
        active = [ActiveSeq(slot=i, seq_id=f"s{i}", tenant_id=f"s{i}",
                            tag=smp.registry.register(f"s{i}").tag(0),
                            position=0) for i in range(B)]
        for step in range(3):
            smp.sample_step(step, logits, active)
        reps = 50
        t0 = time.perf_counter()
        for step in range(3, 3 + reps):
            smp.sample_step(step, logits, active)
        step_ms = (time.perf_counter() - t0) / reps * 1e3
        log(f"  decode step parts at (B, V) = ({B}, {V}): sample_step "
            f"top_k={top_k} {step_ms:.4f} ms (host clock, {reps} steps)")
    log(f"  synthetic logit model {logit_ms:.4f} ms; torch.topk(k=50) "
        f"{topk_ms:.4f} ms (CUDA events)")
    cfg = ScheduleConfig(capacity=B, vocab=V, sequences=INF_SEQUENCES,
                         rate=8.0, seed=0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep = run_offline(cfg, device=device)
    busy = _device_busy_us(prof)
    wall = sum(rep.result.step_seconds) * 1e6
    if busy > 0.0:
        log(f"  run_offline under the profiler: device busy {busy / 1e3:.3f} "
            f"ms of {wall / 1e3:.3f} ms of decode steps = "
            f"{busy / wall * 100:.1f} % (idle {100 - busy / wall * 100:.1f} "
            f"%); busy time includes the arrival and admission draws")
    else:
        log("  run_offline device busy share: not measured (the profiler "
            "recorded no device time)")


# ---------------------------------------------------------------------------
# repairs, the sharded fan-out and the quality battery
# ---------------------------------------------------------------------------

NORMAL_DRAWS = 2 ** 20
#: meshes of the sharded phase: (shape, axis names, devices)
SHARD_MESHES = (((1,), ("streams",)), ((3,), ("streams",)),
                ((4,), ("streams",)), ((2, 2), ("hosts", "streams")))
QUALITY_FULL_ROWS = ("thundering/ctr/cuda", "thundering/faithful/cuda",
                     "thundering/ctr/sharded", "thundering/ctr/service")
QUALITY_DIR = ROOT / "build" / "chip_smoke"


def _card_mesh(device, shape, names):
    from repro_torch.core import engine
    n = 1
    for d in shape:
        n *= d
    return engine.Mesh.of([device] * n, shape, names)


def phase_repairs(device) -> None:
    """The repaired faults on the card: kernel C's 24 re-recorded digests
    (bfloat16 / float32 subnormal inputs read as zeros) and its
    per-element epilogue on the same values, ``stream.normal``
    (the reference's ErfInv32 in float32 ops) against the port's CPU
    result and a float64 truth, and kernel F on subnormal logits under a
    top-k mask against its plain version."""
    import numpy as np
    import torch
    from repro_torch.core import sampler, stream
    from repro_torch.kernels import digests
    from repro_torch.kernels import fused_dropout as fd
    from repro_torch.inference.kernels import gumbel_argmax as ga
    n = 0
    for key, (dtype, name, rate, ctr) in digests.dropout_cases(
            ("special", "special+nan")):
        if dtype == "float16":
            continue
        x = digests.dropout_input(dtype, name, device)
        s = stream.advance(stream.new_stream(digests.SEED, 0, device=device),
                           ctr)
        got = digests.digest(fd.fused_dropout_2d(x, s.h, s.x0, s.ctr, rate))
        require(got == digests.DROPOUT_RECORDED[key],
                f"kernel C differs from its re-recorded digest: {key}")
        n += 1
    log(f"repairs: kernel C writes the {n} re-recorded bfloat16 / float32 "
        f"special-value digests")
    s = stream.advance(stream.new_stream(digests.SEED, 0, device=device), 3)
    for dtype in ("float32", "bfloat16", "float16"):
        view = torch.int32 if dtype == "float32" else torch.int16
        for layout, x in digests.special_layouts(dtype, device):
            for rate in (0.1, 0.5):
                got = fd.fused_dropout_2d(x, s.h, s.x0, s.ctr, rate)
                want = fd.fused_dropout_2d_plain(x, s.h, s.x0, s.ctr, rate)
                require(torch.equal(got.view(view), want.view(view)),
                        f"kernel C's per-element epilogue differs from its "
                        f"plain version: {dtype} {layout} rate {rate}")
    log("repairs: kernel C's per-element epilogue (misaligned view, ragged "
        "last run) equals its plain version bit for bit on the special "
        "values, subnormals included, at rates 0.1 and 0.5")
    card = stream.normal(stream.new_stream(SEED, 0, device=device),
                         (NORMAL_DRAWS,)).cpu()
    cpu_s = stream.new_stream(SEED, 0, device="cpu")
    host = stream.normal(cpu_s, (NORMAL_DRAWS,))
    u = stream.uniform(cpu_s, (NORMAL_DRAWS,), torch.float32, -1.0, 1.0)
    tiny = np.float32(1e-7)
    u = torch.clamp(u, float(np.float32(-1.0) + tiny),
                    float(np.float32(1.0) - tiny))
    truth = (torch.erfinv(u.double()) * math.sqrt(2.0)).float()
    vs_cpu = float(sampler.ulp_error(card, host).max())
    vs_truth = float(sampler.ulp_error(card, truth).max())
    cpu_truth = float(sampler.ulp_error(host, truth).max())
    log(f"repairs: stream.normal at {NORMAL_DRAWS} draws on the card: max "
        f"ulp_error {vs_cpu} against the port's CPU result, {vs_truth} "
        f"against float64 erfinv (the CPU result's own: {cpu_truth}; "
        f"the reference's ErfInv32 is that far from the truth at |u| > "
        f"0.999)")
    require(vs_cpu <= ULP_BOUND, f"stream.normal card vs CPU {vs_cpu} ULP")
    require(vs_truth <= cpu_truth + ULP_BOUND,
            f"stream.normal card vs float64 truth {vs_truth} ULP")
    V, B = 4096, 64
    pats = np.array([0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF,
                     0x00400000, 0x80400000, 0x0, 0x80000000, 0x00800000,
                     0x80800000], np.uint32)
    rng = np.random.default_rng(11)
    bits = pats[rng.integers(0, len(pats), size=(B, V))]
    logits = torch.from_numpy(bits.view(np.float32).copy()).to(device)
    _, h, x0 = _ga_case(V, B, device)
    for top_k, inv_temp in ((0, 1.0), (3, 0.5), (40, 2.0)):
        th = (torch.topk(logits, top_k, dim=-1).values[:, -1].contiguous()
              if top_k else torch.full((B,), float("-inf"), device=device))
        _ga_check(f"subnormal logits top_k={top_k}", logits, h, x0, 977, th,
                  inv_temp)
    log("repairs: kernel F tokens and winning scores equal the plain "
        "version on subnormal logits at top-k 0, 3, 40")


def phase_sharded(device) -> None:
    """``engine.generate_sharded`` at the main path's width against
    ``generate``, bit for bit: meshes of 1, 3 and 4 shards of the card and
    a (2, 2) mesh, both modes, both decorrelators, bits and a float stage;
    S = 2**14 + 1 over 4 shards; a CPU + card split; 4 shards timed
    against one ``generate``; and a mesh ``BlockService`` against a
    mesh-less one over 4 leased windows."""
    import torch
    from repro_torch.core import engine
    from repro_torch.runtime.blocks import BlockService
    n = 0

    def check(plan, mesh, names, tag):
        nonlocal n
        got = engine.generate_sharded(plan, mesh=mesh, axis_names=names)
        want = engine.generate(plan)
        require(got.device.type == mesh.devices.flat[0].type
                and got.dtype == want.dtype
                and torch.equal(got.to(want.device).view(torch.uint8),
                                want.view(torch.uint8)),
                f"generate_sharded != generate: {tag}")
        n += 1

    for mode, deco in (("ctr", "splitmix64"), ("ctr", "fmix32"),
                       ("faithful", "splitmix64")):
        plan = engine.make_plan(seed=SEED, num_streams=S_FULL,
                                num_steps=T_FULL, offset=HIGH_OFFSET,
                                mode=mode, deco=deco, device=device)
        for shape, names in SHARD_MESHES:
            mesh = _card_mesh(device, shape, names)
            for spec in ("bits", "uniform"):
                check(dataclasses.replace(plan, sampler=spec), mesh, names,
                      f"{mode}/{deco} {spec} mesh {shape}")
        odd = engine.make_plan(seed=SEED, num_streams=S_FULL + 1,
                               num_steps=T_FULL, mode=mode, deco=deco,
                               device=device)
        check(odd, _card_mesh(device, (4,), ("streams",)), ("streams",),
              f"{mode}/{deco} S = 2**14 + 1 over 4 shards")
        small = engine.make_plan(seed=SEED, num_streams=130, num_steps=64,
                                 offset=HIGH_OFFSET, mode=mode, deco=deco,
                                 device=device)
        split = engine.Mesh.of([torch.device("cpu"), device], (2,),
                               ("streams",))
        check(small, split, ("streams",), f"{mode}/{deco} CPU + card")
    sync(device)
    log(f"sharded: {n} generate_sharded blocks equal generate bit for bit "
        f"(T = {T_FULL}, S = {S_FULL} and {S_FULL + 1}; 1, 3, 4 and 2x2 "
        f"shards of the card; (64, 130) over the CPU and the card)")
    base = engine.make_plan(seed=SEED, num_streams=S_FULL, num_steps=T_FULL,
                            device=device)
    four = _card_mesh(device, (4,), ("streams",))
    one_ms = time_cuda(lambda: engine.generate(base), reps=20)
    four_ms = time_cuda(lambda: engine.generate_sharded(base, mesh=four),
                        reps=20)
    log(f"sharded: generate {one_ms:.4f} ms, generate_sharded over 4 shards "
        f"of the card {four_ms:.4f} ms (CUDA events, bits at {T_FULL} x "
        f"{S_FULL}: four launches of {S_FULL // 4} columns and the "
        f"torch.cat)")
    for mode in ("ctr", "faithful"):
        meshed = BlockService(seed=SEED, mesh=four, device=device)
        plain = BlockService(seed=SEED, device=device)
        for svc in (meshed, plain):
            svc.open("smoke/mesh", num_streams=S_FULL, mode=mode)
        for _ in range(4):
            a = meshed.take("smoke/mesh", T_FULL // 4)
            b = plain.take("smoke/mesh", T_FULL // 4)
            require(torch.equal(a.view(torch.int32), b.view(torch.int32)),
                    f"mesh BlockService != mesh-less ({mode})")
        require(meshed.ledger_state() == plain.ledger_state(),
                "mesh BlockService ledger differs")
    log("sharded: a 4-shard BlockService hands back the mesh-less "
        "service's bytes over 4 leased windows, both modes")


def _twin_rows(report) -> int:
    """Each cuda row's statistics equal its torch twin's (both rows in the
    report): the same bits, so the same numbers."""
    rows = {g["name"]: g for g in report["generators"]}
    n = 0
    for name, g in rows.items():
        twin = rows.get(name[:-len("cuda")] + "torch")
        if not name.endswith("/cuda") or twin is None:
            continue
        require(g["intra"] == twin["intra"] and g["cross"] == twin["cross"],
                f"battery row {name} differs from its torch twin")
        n += 1
    return n


def phase_coalescer(device) -> None:
    """One ``Coalescer.flush`` of 2**14 single-column requests of T = 4096
    samples from distinct tenants - the battery's service draw at the main
    path's width: the whole flush on the host clock (it ends in the
    block's copy to the host), its one engine call on CUDA events, and
    the journal replay of every request."""
    import numpy as np
    import torch
    from repro_torch.runtime.blocks import BlockService, channel_purpose
    from repro_torch.service import audit
    from repro_torch.service.frontend import (Coalescer, RandRequest,
                                              class_channel)
    from repro_torch.service.tenants import TenantRegistry
    journal = audit.Journal()
    co = Coalescer(BlockService(seed=SEED, device=device), TenantRegistry(),
                   journal=journal, max_rows=T_FULL)
    reqs = [RandRequest(tenant_id=f"smoke/{j:05d}", shape=(T_FULL,),
                        rid=f"c{j:05d}") for j in range(S_FULL)]
    t0 = time.perf_counter()
    responses, assignments, errors = co.flush(reqs)
    flush_s = time.perf_counter() - t0
    require(not errors and len(responses) == S_FULL, f"flush: {errors}")
    fn = co._window_fn(channel_purpose(class_channel("bits", "float32")),
                       T_FULL, S_FULL, "bits", "float32")
    tags = [t for a in assignments for t in a.tags]
    call_ms = time_cuda(lambda: fn(tags, assignments[0].lo), reps=10)
    t0 = time.perf_counter()
    replayed = audit.replay(journal, seed=SEED, device=device)
    replay_s = time.perf_counter() - t0
    for rid in (reqs[0].rid, reqs[-1].rid):
        require(np.array_equal(responses[rid], replayed[rid]),
                f"coalesced response {rid} != its replay")
    stats = co.stats()
    log(f"coalescer: flush of {S_FULL} requests of {T_FULL} samples "
        f"{flush_s:.3f} s (host clock, the ({T_FULL}, {S_FULL}) block copied to "
        f"the host); its engine call {call_ms:.4f} ms (CUDA events, tag "
        f"leaf offsets derived on the card); replay of every request "
        f"{replay_s:.3f} s; stats {stats['engine_calls']} engine call, "
        f"{stats['lease_calls']} lease, fill {stats['fill_ratio']}")


def phase_quality(device) -> None:
    """The port's Crush-lite battery on the card: the ``fast`` profile over
    every row (each as expected; each cuda row's statistics equal its
    torch twin's), then the ``full`` profile - the cross-battery at the
    main path's width - on the main delivery rows; reports under
    ``build/chip_smoke/``."""
    from repro_torch.quality import battery
    QUALITY_DIR.mkdir(parents=True, exist_ok=True)
    for profile, rows in (("fast", None), ("full", list(QUALITY_FULL_ROWS))):
        timings = {}
        t0 = time.perf_counter()
        report = battery.run_battery(profile, generators=rows, device=device,
                                     timings=timings)
        secs = time.perf_counter() - t0
        (QUALITY_DIR / f"QUALITY_{profile}.json").write_text(
            battery.report_json(report))
        for g in report["generators"]:
            t = timings[g["name"]]
            log(f"  battery[{profile}] {g['name']}: draw {t['draw_s']:.3f} "
                f"s, statistics {t['stats_s']:.3f} s, ok {g['ok']}, as "
                f"expected {g['as_expected']}")
        bad = [g["name"] for g in report["generators"]
               if not g["as_expected"]]
        require(report["ok"] and not bad,
                f"battery[{profile}] rows not as expected: {bad}")
        twins = _twin_rows(report)
        log(f"quality: battery[{profile}] {len(report['generators'])} rows "
            f"as expected in {secs:.1f} s; {twins} cuda rows equal their "
            f"torch twins")


def phase_quality_path(device) -> dict:
    """The slice's path - the sharded fan-out, the mesh service, the
    coalescer at the main path's width and the battery - with the block generators' launch counts
    set to 0 just before and read just after."""
    from repro_torch.kernels import thundering_block as tb
    tb.reset_counts()
    phase_sharded(device)
    phase_coalescer(device)
    phase_quality(device)
    launches = {"thundering_ctr": tb.thundering_ctr.launches,
                "thundering_faithful": tb.thundering_faithful.launches}
    plain_runs = (tb.thundering_ctr_plain.cuda_runs
                  + tb.thundering_faithful_plain.cuda_runs)
    log(f"quality path: launches {launches}; plain versions run on the "
        f"card: {plain_runs}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the quality path never launched: {launches}")
    require(plain_runs == 0, "a plain version ran on a CUDA tensor")
    return launches


# ---------------------------------------------------------------------------
# the serving tier (RandServer, burst driver, wire transport, shard fleet)
# ---------------------------------------------------------------------------

#: the reference's ``make service`` width (Makefile) and its ServerConfig
SERVICE_BURST = 1024
SERVICE_TENANTS = 1024
SERVICE_BACKLOG = 16384
SERVICE_HOT = (("bits", "float32"), ("uniform", "float32"))
#: the reference's ``make fleet`` width, FleetConfig defaults otherwise
FLEET_BURST = 256
FLEET_TENANTS = 64
#: the hung-shard client deadline of the reference's own hang test
FLEET_HANG_DEADLINE_S = 8.0
SERVICE_DIR = ROOT / "build" / "chip_smoke" / "service"


def _service_config(hot):
    from repro_torch.service import ServerConfig
    return ServerConfig(max_batch=256, max_delay_s=0.25, queue_depth=4096,
                        hot_classes=hot, pool_donate=True)


def _service_run(device, hot, reqs, name: str, *, submit_threads: int = 0,
                 profile: bool = False, replay: bool = False) -> dict:
    """One burst through a journaled RandServer on ``device``: submitted
    in order before the loop starts (deterministic batches), or from
    ``submit_threads`` threads into a running server (backpressure).
    Checks every request is served once with its shape and dtype and the
    ledgers are disjoint, and with ``replay`` that the journal replays on
    the card bit for bit; returns its figures."""
    import torch
    from repro_torch.service import RandServer, audit
    from repro_torch.service.burst import run_burst
    path = SERVICE_DIR / f"{name}.jsonl"
    srv = RandServer(0, config=_service_config(hot),
                     journal=audit.Journal(str(path)),
                     start=submit_threads > 0, device=device)
    busy = None
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as profiler
        prof = profiler(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    if submit_threads:
        out = run_burst(srv, reqs, submit_threads=submit_threads,
                        timeout=600)
    else:
        futs = [srv.submit(r) for r in reqs]
        srv.start()
        out = {r.rid: f.result(timeout=600) for r, f in zip(reqs, futs)}
    sync(device)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        busy = _device_busy_us(prof)
    stats = srv.stats()
    audit.verify_ledger_disjoint(srv.block_service)
    require(srv.shutdown(timeout=120), f"{name}: the server did not drain")
    journal = audit.Journal(str(path), readonly=True)
    audit.verify_ledger_disjoint(journal)
    require(len(out) == len(reqs) and stats["requests_served"] == len(reqs)
            and stats["requests_failed"] == 0,
            f"{name}: served {stats['requests_served']} of {len(reqs)}")
    rids = [e["rid"] for e in journal.requests()]
    require(sorted(rids) == sorted(r.rid for r in reqs),
            f"{name}: the journal does not hold every request once")
    digest = audit.response_digest(out)
    replay_s = None
    if replay:
        t0 = time.perf_counter()
        replayed = audit.replay(journal, seed=0, device=device)
        replay_s = time.perf_counter() - t0
        require(audit.response_digest(replayed) == digest,
                f"{name}: the journal's replay on the card differs")
    _check_responses(name, reqs, out)
    return {"digest": digest, "stats": stats, "wall": wall, "busy": busy,
            "replay_s": replay_s, "batches": len(journal.entries)}


def _response_tensor(a):
    """A served response (a numpy array, or a CPU bfloat16 tensor) as a
    tensor."""
    import numpy as np
    import torch
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def _check_responses(name: str, reqs, out) -> None:
    """Each response has its request's shape and dtype, on the host, and
    every float response is finite."""
    import torch
    from repro_torch.core import sampler
    for r in reqs:
        want = sampler.result_dtype(sampler.parse(r.sampler), r.out_dtype)
        t = _response_tensor(out[r.rid])
        require(tuple(t.shape) == tuple(r.shape) and t.dtype == want
                and t.device.type == "cpu",
                f"{name}: {r.rid} is {tuple(t.shape)} {t.dtype} on "
                f"{t.device}, not {r.shape} {want} on the host")
        if t.is_floating_point():
            require(bool(torch.isfinite(t).all()),
                    f"{name}: {r.rid} has non-finite values")


def _service_report(label: str, run: dict) -> None:
    st = run["stats"]
    busy = run["busy"]
    share = ("not measured" if busy is None else
             "not measured (the profiler recorded no device time)"
             if busy <= 0.0 else
             f"{busy / 1e3:.3f} ms of {run['wall'] * 1e3:.3f} ms wall = "
             f"{busy / (run['wall'] * 1e6) * 100:.2f} %")
    log(f"service[{label}]: {st['requests_served']} requests in "
        f"{run['wall']:.4f} s (host clock) = "
        f"{st['requests_served'] / run['wall']:.1f} req/s wall, server "
        f"{st['requests_per_s']:.1f} req/s; p50 {st['latency_p50_ms']:.3f} "
        f"ms, p99 {st['latency_p99_ms']:.3f} ms; {run['batches']} batch "
        f"records; {st['engine_calls']} engine calls + {st['lease_calls']} "
        f"leases = {st['calls_per_request']:.4f} calls/request; pool hit "
        f"rate {st['pool_hit_rate']:.4f}; fill {st['fill_ratio']:.4f}; "
        f"device busy {share}; "
        + ("" if run["replay_s"] is None else
           f"replay of every request on the card {run['replay_s']:.3f} s, "
           f"bit-identical; ")
        + f"ledgers disjoint; digest {run['digest'][:16]}")


def phase_service(device) -> str:
    """The in-process server at ``make service`` width: the burst three
    times without pools and three times with them - the first run
    replayed on the card, the second timed, the third under the profiler
    for the device's busy share; one digest each - then a 16384-request
    backlog from 4 submitter threads into a queue of 4096, replayed, and
    once more under the profiler.  Returns the no-pool digest."""
    import shutil
    from repro_torch.service.burst import make_requests
    shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    SERVICE_DIR.mkdir(parents=True)
    reqs = make_requests(burst=SERVICE_BURST, tenants=SERVICE_TENANTS,
                         seed=0)
    digests = {}
    for label, hot in (("no pools", ()), ("pools", SERVICE_HOT)):
        tag = label.replace(" ", "_")
        runs = [_service_run(device, hot, reqs, f"{tag}_{k}",
                             replay=k == 0, profile=k == 2)
                for k in range(3)]
        require(len({r["digest"] for r in runs}) == 1,
                f"service[{label}]: the same burst gave two digests")
        require((runs[0]["stats"]["pool_requests"] > 0) == bool(hot),
                f"service[{label}]: pool hits {runs[0]['stats']}")
        _service_report(f"{label}, first run", runs[0])
        _service_report(label, runs[1])
        _service_report(f"{label}, profiled", runs[2])
        digests[label] = runs[0]["digest"]
    backlog = make_requests(burst=SERVICE_BACKLOG, tenants=SERVICE_TENANTS,
                            seed=0, rid_prefix="backlog")
    label = f"backlog {SERVICE_BACKLOG}, 4 submitters, queue 4096"
    _service_report(label, _service_run(device, SERVICE_HOT, backlog,
                                        "backlog", submit_threads=4,
                                        replay=True))
    # threaded arrivals batch by wall clock: a second run has its own
    # batches, so it is held to its own journal's replay (outside the
    # profiled window), not to the first digest
    _service_report(f"{label}, profiled",
                    _service_run(device, SERVICE_HOT, backlog, "backlog_1",
                                 submit_threads=4, profile=True,
                                 replay=True))
    return digests["no pools"]


def phase_service_cli(device, digest: str) -> None:
    """``python -m repro_torch.service`` in subprocesses: the burst with
    ``--verify-replay`` gives the in-process no-pool digest; ``--linger``
    then drains on SIGTERM and exits 0."""
    import os
    import signal
    env = dict(os.environ, PYTHONPATH=str(SRC))
    base = [sys.executable, "-m", "repro_torch.service", "--burst",
            str(SERVICE_BURST), "--tenants", str(SERVICE_TENANTS)]
    if device.type != "cuda":
        base += ["--device", str(device)]
    t0 = time.perf_counter()
    out = subprocess.run(base + ["--journal", str(SERVICE_DIR / "cli.jsonl"),
                                 "--verify-replay", "--digest-out",
                                 str(SERVICE_DIR / "cli.digest")],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    require(out.returncode == 0, f"python -m repro_torch.service exited "
            f"{out.returncode}: {out.stderr[-2000:]}")
    got = (SERVICE_DIR / "cli.digest").read_text().strip()
    require("replay: OK" in out.stdout, f"CLI replay: {out.stdout}")
    require(got == digest, f"CLI digest {got} != in-process {digest}")
    log(f"service CLI: {time.perf_counter() - t0:.1f} s for the process; "
        f"digest == in-process no-pool run; "
        + " | ".join(line for line in out.stdout.splitlines()
                     if line.startswith(("served", "latency", "replay"))))
    proc = subprocess.Popen(base + ["--linger", "60"], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("ready"):
                proc.send_signal(signal.SIGTERM)
                break
        rest, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    require(proc.returncode == 0 and rest.strip().endswith("drained"),
            f"--linger + SIGTERM: exit {proc.returncode}, {rest!r} "
            f"{err[-2000:]}")
    log("service CLI: --linger 60 drained on SIGTERM and exited 0")


def phase_fleet(device) -> None:
    """Two shard processes at ``make fleet`` width, binary v2 with the
    default hot classes: no fault, ``kill@128`` and ``hang@128`` (client
    deadline 8 s) give one digest; the union replay of each run's shard
    journals on the card reproduces it; each shard logs its device."""
    from repro_torch.runtime.fault import FaultPlan
    from repro_torch.service import audit
    from repro_torch.service.__main__ import _shard_stats
    from repro_torch.service.burst import make_requests
    from repro_torch.service.fleet import Fleet, FleetConfig, run_fleet_burst
    reqs = make_requests(burst=FLEET_BURST, tenants=FLEET_TENANTS, seed=0)
    half = FLEET_BURST // 2
    digests = {}
    for label, plan, kw in (
            ("no fault", "", {}), (f"kill@{half}", f"kill@{half}", {}),
            (f"hang@{half}", f"hang@{half}",
             {"deadline_s": FLEET_HANG_DEADLINE_S})):
        jdir = SERVICE_DIR / f"fleet_{label.replace('@', '_')}"
        cfg = FleetConfig(num_shards=2, seed=0, journal_dir=str(jdir),
                          queue_depth=4096,
                          device=None if device.type == "cuda"
                          else str(device))
        t0 = time.perf_counter()
        with Fleet(cfg, FaultPlan.parse(plan)) as fleet:
            spawn = time.perf_counter() - t0
            client = fleet.client(**kw)
            t0 = time.perf_counter()
            responses = run_fleet_burst(client, reqs)
            wall = time.perf_counter() - t0
            cstats = client.stats()
            shards = _shard_stats(client)
            client.close()
            journals = fleet.journals()
        require(len(responses) == FLEET_BURST, f"fleet[{label}]: "
                f"{len(responses)} of {FLEET_BURST} served")
        digest = audit.response_digest(responses)
        replayed = {}
        for path in journals.values():
            replayed.update(audit.replay(path, seed=0, device=device))
            audit.verify_ledger_disjoint(audit.Journal(path, readonly=True))
        require(set(replayed) == set(responses)
                and audit.response_digest(replayed) == digest,
                f"fleet[{label}]: the union replay differs")
        want = 0 if not plan else 1
        require(cstats["failovers"] == want,
                f"fleet[{label}]: {cstats['failovers']} failovers")
        for i in range(2):
            first = (jdir / f"shard{i}.log").read_text().splitlines()[0]
            require(device.type in first, f"fleet shard {i}: {first!r}")
        rec = cstats["recovery_ms"]
        log(f"fleet[{label}]: {FLEET_BURST} requests in {wall:.4f} s "
            f"(host clock) = {FLEET_BURST / wall:.1f} req/s; p50 "
            f"{cstats['latency_p50_ms']:.3f} ms, p99 "
            f"{cstats['latency_p99_ms']:.3f} ms; failovers "
            f"{cstats['failovers']}, retries {cstats['retries']}, recovery "
            f"{'none' if rec is None else f'{rec:.3f} ms'}; "
            f"{cstats['bytes_on_wire_per_req']:.1f} bytes/request on the "
            f"wire (v2); live shards: {shards['engine_calls']} engine "
            f"calls + {shards['lease_calls']} leases for "
            f"{shards['requests_served']} requests, pool hit rate "
            f"{shards['pool_hit_rate']:.4f}; spawn {spawn:.1f} s; union "
            f"replay on the card bit-identical; shard logs: "
            + "; ".join((jdir / f"shard{i}.log").read_text().splitlines()[0]
                        for i in range(2)))
        digests[label] = digest
    require(len(set(digests.values())) == 1,
            f"fleet digests differ: {digests}")
    log(f"fleet: no-fault, kill and hang digests equal "
        f"({digests['no fault'][:16]})")


#: the log-stage classes, held within the 8-ULP slack of ``sampler.ulp_error``
SERVICE_LOG_STAGES = ("normal", "exponential", "gamma")
SERVICE_ULP_SLACK = 8.0


def _serve_deterministic(device, hot, reqs) -> dict:
    """``reqs`` through an unjournaled RandServer on ``device``, submitted
    before the loop starts, so the batches are a function of the list."""
    from repro_torch.service import RandServer
    srv = RandServer(0, config=_service_config(hot), journal=None,
                     start=False, device=device)
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    out = {r.rid: f.result(timeout=600) for r, f in zip(reqs, futs)}
    require(srv.shutdown(timeout=120), "the plain-check server did not drain")
    return out


def phase_service_plain(device) -> None:
    """Kernel A at the service path's shapes against the plain version:
    the ``make service`` burst, with and without pools, served on the card
    and by a server on the CPU, where every block comes from the plain
    torch version (held to the reference by the CPU tests), compared
    response by response - bit for bit on the integer and threshold
    classes, within 8 ULP (``sampler.ulp_error``) on normal, exponential
    and gamma.  This covers the pool windows, the class calls with their
    leaf offsets at their (rows, S) shapes and the S = 1 calls.  Runs
    before the path's counts are reset."""
    import torch
    from repro_torch.core import sampler
    from repro_torch.service.burst import make_requests
    reqs = make_requests(burst=SERVICE_BURST, tenants=SERVICE_TENANTS,
                         seed=0)
    for label, hot in (("no pools", ()), ("pools", SERVICE_HOT)):
        t0 = time.perf_counter()
        card = _serve_deterministic(device, hot, reqs)
        plain = _serve_deterministic(torch.device("cpu"), hot, reqs)
        exact, worst = 0, {}
        for r in reqs:
            got, want = _response_tensor(card[r.rid]), _response_tensor(
                plain[r.rid])
            require(got.dtype == want.dtype and got.shape == want.shape,
                    f"service plain check[{label}]: {r.rid} is {got.dtype} "
                    f"{tuple(got.shape)}, plain {want.dtype} "
                    f"{tuple(want.shape)}")
            cls = r.sampler.split("(")[0]
            if cls in SERVICE_LOG_STAGES:
                err = (float(sampler.ulp_error(got, want).max())
                       if got.numel() else 0.0)
                worst[cls] = max(worst.get(cls, 0.0), err)
                require(err <= SERVICE_ULP_SLACK,
                        f"service plain check[{label}]: {r.rid} "
                        f"({r.sampler}) is {err} ULP off the plain version")
            else:
                require(torch.equal(got.reshape(-1).view(torch.uint8),
                                    want.reshape(-1).view(torch.uint8)),
                        f"service plain check[{label}]: {r.rid} "
                        f"({r.sampler}, {r.out_dtype}) differs from the "
                        f"plain version")
                exact += 1
        log(f"service plain check[{label}]: {len(reqs)} responses on the "
            f"card against a CPU server's plain versions: {exact} integer / "
            f"threshold responses bit-identical, log stages within "
            + ", ".join(f"{k} {v:.2f}" for k, v in sorted(worst.items()))
            + f" ULP (limit {SERVICE_ULP_SLACK:g}); "
            f"{time.perf_counter() - t0:.1f} s")


def phase_service_path(device) -> dict:
    """The serving tier's path - the in-process server, its CLI and the
    shard fleet - with the block generators' launch counts set to 0 just
    before and read just after.  The CLI's and the shards' launches are
    their own processes'; this process's runs must launch kernel A."""
    from repro_torch.kernels import thundering_block as tb
    phase_service_plain(device)
    tb.reset_counts()
    digest = phase_service(device)
    phase_service_cli(device, digest)
    phase_fleet(device)
    launches = {"thundering_ctr": tb.thundering_ctr.launches}
    plain_runs = (tb.thundering_ctr_plain.cuda_runs
                  + tb.thundering_faithful_plain.cuda_runs)
    log(f"service path: launches {launches}; thundering_faithful "
        f"{tb.thundering_faithful.launches} (the server opens ctr channels "
        f"only); plain versions run on the card: {plain_runs}")
    require(launches["thundering_ctr"] > 0,
            "kernel A never launched on the service path")
    require(plain_runs == 0, "a plain version ran on a CUDA tensor")
    return launches


# ---------------------------------------------------------------------------
# the model serving path: gemma-7b at full width through kernels A and F
# ---------------------------------------------------------------------------

SERVE_ARCH = "gemma_7b"       # unmodified config: 28 layers, d 3072, V 256000
SERVE_BATCH = 64              # the inference tier's capacity
SERVE_PROMPT = 128
SERVE_GEN = 32
SERVE_CLI_GEN = 8
SERVE_TEMPERATURE = 0.8
SERVE_SEED = 0
# decode against forward at full width: the reference's own slack
# (tests/test_models.py::test_decode_matches_forward, 2 layers)
SERVE_ROWS, SERVE_POSITIONS = 4, 16
SERVE_SLACK_ATOL, SERVE_SLACK_RTOL = 0.15, 0.05
# bf16 decode at full depth: the RMS distance of its logits from the
# float32 run over bf16 forward's (tools/serve_numerics.py on an H100:
# 0.995-1.007 sound over 2 seeds x 4 row sets; 3.75-3.84 with a float8
# cache; 21.6-23.4 decoding one position early)
SERVE_DECODE_RMS_RATIO = 1.1
# card against CPU at the smoke width: the CPU tests' port-against-
# reference logit tolerance (tests/test_torch_models.py LOGIT_ATOL)
SERVE_LOGIT_ATOL = 0.02
SERVE_INIT_ULP = 8
SERVE_PROFILE_STEPS = 8
# kernel A's draws at the full-width path's shapes against the plain
# version: (parameter path, chunk) of gemma-7b's init - the first full
# chunk of 2^28 elements and the ragged last chunk of an MLP matrix and of
# the embedding - and the prompts' (batch, prompt + 1) uniforms
SERVE_DRAWS = (("layers/wg", 0), ("layers/wg", -1), ("embed", -1))
SERVE_PLAIN_WINDOW = 1 << 24   # elements per plain call (its temporaries)


def _ordered_f32(t):
    """float32 tensor -> int64 keys in float order (ULP distance)."""
    import torch
    i = t.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(2 ** 31) - i, i)


def _greedy_teacher_forced(model, params, prompts, gen, tokens=None):
    """Prefill ``prompts`` and decode ``gen`` - 1 steps; each step's input
    token is ``tokens[:, i]`` when given, else this run's own argmax.
    Returns the (B, gen, V) float32 logits on the host and the tokens."""
    import torch
    from repro_torch.launch import serve as srv
    B, P = prompts.shape
    logits, pcache = model.prefill(params, {"tokens": prompts})
    cache = srv._graft(model.cfg, model.init_cache(B, P + gen), pcache, P)
    out, toks = [logits.cpu()], []
    for i in range(gen):
        tok = (tokens[:, i:i + 1] if tokens is not None
               else torch.argmax(out[-1], -1)[:, None].to(torch.int32))
        toks.append(tok)
        if i < gen - 1:
            logits, cache = model.decode(params, cache, tok.to(model.device),
                                         P + i)
            out.append(logits.cpu())
    return torch.stack(out, 1), torch.cat(toks, 1)


def _draw_against_plain(label: str, s, n: int) -> None:
    """``stream.uniforms(s, (n,))`` - one launch of kernel A at S = 1, as
    ``stream.normal`` and the data pipeline draw - against the plain torch
    version of the same elements on the card, ``SERVE_PLAIN_WINDOW`` at a
    time: bit for bit (an exact stage, as in ``phase_parity``)."""
    from repro_torch.core import engine
    from repro_torch.core import stream as tstream
    from repro_torch.kernels import thundering_block as tb
    t0 = time.perf_counter()
    before = tb.thundering_ctr.launches
    got = tstream.uniforms(s, (n,))
    require(tb.thundering_ctr.launches == before + 1, f"kernel A draws: "
            f"{label} took {tb.thundering_ctr.launches - before} launches")
    for lo in range(0, n, SERVE_PLAIN_WINDOW):
        m = min(SERVE_PLAIN_WINDOW, n - lo)
        want = engine.generate_flat(
            engine.plan_for_stream(tstream.advance(s, lo), m,
                                   sampler="uniform"), backend="torch")
        ok, err, _ = compare(got[lo:lo + m], want, "uniform")
        require(ok, f"kernel A draws: the kernel differs from the plain version "
                    f"in {label} at elements [{lo}, {lo + m}) "
                    f"(max_abs_err={err})")
    log(f"kernel A draws: {label}: {n} uniforms (T = {n}, S = 1, ctr "
        f"{s.ctr}) equal the plain version bit for bit; "
        f"{time.perf_counter() - t0:.1f} s")


def phase_serve_draws(device) -> None:
    """Kernel A at the full-width serve path's shapes against the plain
    version: the chunks of ``SERVE_DRAWS`` at the counters
    ``common.trunc_normal`` gives them, and the prompts' uniforms of
    ``pipeline_for(...).batch_at(0)``.  Runs before the path's counts are
    reset."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.core import stream as tstream
    from repro_torch.launch.train import pipeline_for
    from repro_torch.models import registry
    from repro_torch.models.common import PARAM_CHUNK, flatten, param_stream
    cfg = get_config(SERVE_ARCH)
    shapes = flatten(registry.build(cfg, "meta").init(SERVE_SEED)[0])
    for path, chunk in SERVE_DRAWS:
        n = math.prod(shapes[path].shape)
        lo = (chunk % -(-n // PARAM_CHUNK)) * PARAM_CHUNK
        m = min(PARAM_CHUNK, n - lo)
        s = tstream.advance(param_stream(SERVE_SEED, path, device), lo)
        _draw_against_plain(f"{path} chunk {chunk} of {-(-n // PARAM_CHUNK)}"
                            f" ({n} elements)", s, m)
    pipe = pipeline_for(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_SEED,
                        device=device)
    _draw_against_plain(f"prompts ({SERVE_BATCH}, {SERVE_PROMPT + 1})",
                        tstream.derive(pipe._root, 0),
                        SERVE_BATCH * (SERVE_PROMPT + 1))


def phase_serve_plain(device) -> None:
    """The serving path at ``launch.train.smoke_config(gemma_7b)`` width
    on the card against the same code on the CPU (which the CPU tests hold
    against the reference): init within 8 ULP per parameter; prefill and
    decode logits on equal weights within ``SERVE_LOGIT_ATOL``; greedy
    tokens equal wherever the CPU's top-2 margin exceeds twice that.
    Runs before the path's counts are reset."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import pipeline_for, smoke_config
    from repro_torch.models import registry
    from repro_torch.models.common import flatten, unflatten
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cfg = smoke_config(get_config(SERVE_ARCH))
    m_cpu, m_card = registry.build(cfg, cpu), registry.build(cfg, device)
    p_cpu = flatten(m_cpu.init(SERVE_SEED)[0])
    p_card = flatten(m_card.init(SERVE_SEED)[0])
    worst_ulp, exact_zero = 0, 0
    for path, want in p_cpu.items():
        got = p_card[path].cpu()
        if not want.any():
            require(not got.any(), f"serve plain check: {path} is not zero")
            exact_zero += 1
            continue
        worst_ulp = max(worst_ulp, int((_ordered_f32(got)
                                        - _ordered_f32(want)).abs().max()))
    require(worst_ulp <= SERVE_INIT_ULP, f"serve plain check: init is "
            f"{worst_ulp} ULP from the CPU's (limit {SERVE_INIT_ULP})")
    same = unflatten({k: v.to(device) for k, v in p_cpu.items()})
    B, P, G = 8, 32, 16
    prompts = pipeline_for(cfg, B, P, SERVE_SEED,
                           device=cpu).batch_at(0)["tokens"]
    want, toks = _greedy_teacher_forced(m_cpu, unflatten(p_cpu), prompts, G)
    got, _ = _greedy_teacher_forced(m_card, same, prompts.to(device), G,
                                    tokens=toks)
    err = float((got - want).abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * SERVE_LOGIT_ATOL
    agree = torch.argmax(got, -1) == torch.argmax(want, -1)
    log(f"serve plain check (smoke width {cfg.d_model}/{cfg.n_layers} "
        f"layers/V {cfg.vocab}): init within {worst_ulp} ULP of the CPU "
        f"({len(p_cpu) - exact_zero} drawn tensors, {exact_zero} zeros "
        f"exact); prefill + {G - 1} decode logits on equal weights max "
        f"|card - cpu| {err:.6f} (limit {SERVE_LOGIT_ATOL}); greedy tokens "
        f"equal at {int((agree & sure).sum())} of {int(sure.sum())} "
        f"positions with a top-2 margin > {2 * SERVE_LOGIT_ATOL} "
        f"({int(agree.sum())} of {agree.numel()} overall); "
        f"{time.perf_counter() - t0:.1f} s")
    require(err <= SERVE_LOGIT_ATOL, f"serve plain check: logits {err} "
            f"from the CPU's")
    require(bool(agree[sure].all()), "serve plain check: a greedy token "
            "with a clear margin differs from the CPU's")


def _serve_report(label: str, toks, stats, peak=None) -> None:
    line = (f"serve[{label}]: tokens {tuple(toks.shape)}; init "
            f"{stats['init_s']:.3f} s; prefill {stats['prefill_s']:.3f} s; "
            f"decode {stats['decode_s']:.3f} s = "
            f"{stats['decode_tok_s']:.1f} tok/s; step p50 "
            f"{stats['step_p50_ms']:.3f} ms, p99 {stats['step_p99_ms']:.3f} "
            f"ms")
    if "sampler_calls_per_step" in stats:
        line += f"; sampler calls/step {stats['sampler_calls_per_step']}"
    if peak is not None:
        line += f"; peak memory {peak / 2 ** 30:.2f} GiB"
    log(line + f" ({card_line()})")


def _free_card() -> None:
    """Return the cached blocks of finished runs to the card (before a
    subprocess or a fresh full-width model needs them)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_cli(device, want: str) -> None:
    """``python -m repro_torch.launch.serve`` at full width in a
    subprocess: its 8 tokens per row give the in-process run's digest of
    the first 8 steps."""
    import os
    _free_card()
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            SERVE_ARCH, "--batch", str(SERVE_BATCH), "--prompt-len",
            str(SERVE_PROMPT), "--gen", str(SERVE_CLI_GEN), "--temperature",
            str(SERVE_TEMPERATURE)]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run(args, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    require(out.returncode == 0, f"the serve CLI failed: "
            f"{out.stderr[-2000:]}")
    got = re.search(r"tokens sha256: ([0-9a-f]{64})", out.stdout)
    require(got is not None, f"the serve CLI printed no digest: "
            f"{out.stdout[-2000:]}")
    log(f"serve CLI (gen {SERVE_CLI_GEN}, subprocess): digest "
        f"{got.group(1)[:16]} == in-process first {SERVE_CLI_GEN} steps "
        f"{want[:16]}; {time.perf_counter() - t0:.1f} s; "
        + " ".join(out.stdout.strip().splitlines()[:2]))
    require(got.group(1) == want, "the serve CLI's tokens differ from the "
                                  "in-process run's")


def _kernel_kind(name: str) -> str:
    low = name.lower()
    if "gumbel_argmax" in low:
        return "kernel F"
    if "thundering" in low:
        return "kernel A"
    if any(k in low for k in ("gemm", "gemv", "xmma", "cutlass", "sm90_",
                              "ampere", "splitk", "nvjet")):
        return "matmul"
    if "copy" in low or "cast" in low:
        return "copy / cast"
    return "other elementwise / reduce"


def _decode_and_forward(model, params, toks):
    """(decode logits position by position, ``lm_forward`` logits), both
    (rows, positions, V) float32."""
    import torch
    R, S = toks.shape
    full, _ = model.forward(params, {"tokens": toks})
    cache = model.init_cache(R, S)
    dec = []
    for pos in range(S):
        lg, cache = model.decode(params, cache, toks[:, pos:pos + 1], pos)
        dec.append(lg)
    return torch.stack(dec, 1), full


def _excess(a, b) -> float:
    """max(|a - b| - rtol |b|): within the slack when <= atol."""
    return float(((a - b).abs() - SERVE_SLACK_RTOL * b.abs()).max())


def _rms(a, b) -> float:
    return float((a - b).pow(2).mean().sqrt())


def _serve_decode_vs_forward(model, params, device) -> None:
    """Decode logits against ``lm_forward``'s on 4 rows x 16 positions at
    full width.  The reference states its slack (atol 0.15, rtol 0.05)
    for 2 layers; over 28 layers bf16 rounding alone moves the logits
    further (``tools/serve_numerics.py``: forward is 0.33 from a float32
    run).  So the decode logic is held to the slack with float32
    activations at full depth, and with bf16 at the reference's depth
    (the first 2 layers, full width); at full depth in bf16, decode's RMS
    distance from the float32 run may exceed forward's by the factor
    ``SERVE_DECODE_RMS_RATIO`` at most."""
    import torch
    from repro_torch.launch.train import pipeline_for
    from repro_torch.models import layers as L
    from repro_torch.models import registry
    t0 = time.perf_counter()
    cfg = model.cfg
    toks = pipeline_for(cfg, SERVE_ROWS, SERVE_POSITIONS, SERVE_SEED,
                        device=device).batch_at(0)["tokens"]
    dec, full = _decode_and_forward(model, params, toks)
    L.COMPUTE_DTYPE = torch.float32
    try:
        dec32, full32 = _decode_and_forward(model, params, toks)
    finally:
        L.COMPUTE_DTYPE = torch.bfloat16
    two = registry.build(cfg.scaled(n_layers=2), device)
    p2 = dict(params, layers={k: v[:2] for k, v in params["layers"].items()})
    dec2, full2 = _decode_and_forward(two, p2, toks)
    gap = float((dec - full).abs().max())
    e_fwd = float((full - full32).abs().max())
    e_dec = float((dec - full32).abs().max())
    ratio = _rms(dec, full32) / _rms(full, full32)
    ex32, ex2 = _excess(dec32, full32), _excess(dec2, full2)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (dec, full, dec32, dec2))
    log(f"serve decode vs forward (full width, {SERVE_ROWS} rows x "
        f"{SERVE_POSITIONS} positions, logits up to "
        f"{float(full.abs().max()):.3f}): float32 activations, "
        f"{cfg.n_layers} layers: max |decode - forward| "
        f"{float((dec32 - full32).abs().max()):.6f}, excess over the slack "
        f"{ex32:.6f} (limit {SERVE_SLACK_ATOL}); bf16, 2 layers: "
        f"{float((dec2 - full2).abs().max()):.5f}, excess {ex2:.5f} (limit "
        f"{SERVE_SLACK_ATOL}); bf16, {cfg.n_layers} layers: "
        f"{gap:.5f}, excess {_excess(dec, full):.5f} (not held to the "
        f"slack), decode {e_dec:.5f} and forward {e_fwd:.5f} from the "
        f"float32 run (max abs), RMS ratio {ratio:.4f} (limit "
        f"{SERVE_DECODE_RMS_RATIO}); finite {finite}; "
        f"{time.perf_counter() - t0:.1f} s")
    require(finite, "non-finite logits in decode against forward")
    require(ex32 <= SERVE_SLACK_ATOL, "float32 decode logits leave the "
            "reference's slack around forward's")
    require(ex2 <= SERVE_SLACK_ATOL, "2-layer bf16 decode logits leave the "
            "reference's slack around forward's")
    require(ratio <= SERVE_DECODE_RMS_RATIO, f"bf16 decode's RMS distance "
            f"from the float32 run is {ratio:.4f}x forward's")


def _serve_profile(model, params, device) -> None:
    """Prefill at (64, 128), then 8 fused decode steps under
    ``torch.profiler``: the device's busy share over the steps, kernel
    F's share, device time by kind and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as srv
    from repro_torch.launch.train import pipeline_for
    cfg = model.cfg
    prompts = pipeline_for(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_SEED,
                           device=device).batch_at(0)["tokens"]
    P, G = SERVE_PROMPT, SERVE_PROFILE_STEPS
    logits, pcache = model.prefill(params, {"tokens": prompts})
    cache = srv._graft(cfg, model.init_cache(SERVE_BATCH, P + G), pcache, P)
    del pcache
    picker = srv.TokenPicker(seed=SERVE_SEED, batch=SERVE_BATCH,
                             vocab=cfg.vocab, temperature=SERVE_TEMPERATURE,
                             device=device)
    tok = picker.pick(0, logits)
    tok.cpu()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(G):
            logits, cache = model.decode(params, cache, tok, P + i)
            tok = picker.pick(i + 1, logits)
            tok.cpu()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds, top = {}, []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(evt, "self_device_time_total", 0.0)
                   or getattr(evt, "self_cuda_time_total", 0.0))
        kinds[_kernel_kind(evt.key)] = kinds.get(_kernel_kind(evt.key),
                                                 0.0) + us
        top.append((us, evt.key, evt.count))
    busy = sum(kinds.values())
    if busy <= 0.0:
        log("serve profile: not measured (the profiler recorded no device "
            "time)")
        return
    log(f"serve profile ({G} fused decode steps at (B, V) = "
        f"({SERVE_BATCH}, {cfg.vocab}), ctx {P + G}): wall "
        f"{wall_us / 1e3:.3f} ms = {wall_us / G / 1e3:.3f} ms/step; device "
        f"busy {busy / 1e3:.3f} ms = {busy / wall_us * 100:.1f} % (idle "
        f"{100 - busy / wall_us * 100:.1f} %); kernel F "
        f"{kinds.get('kernel F', 0.0) / G:.1f} us/step = "
        f"{kinds.get('kernel F', 0.0) / wall_us * 100:.2f} % of a step")
    for kind, us in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  device time {kind}: {us / G / 1e3:.3f} ms/step "
            f"({us / busy * 100:.1f} % of busy)")
    for us, key, count in sorted(top, reverse=True)[:12]:
        log(f"  top kernel {us / G / 1e3:.4f} ms/step x{count / G:.0f}: "
            f"{key[:110]}")


def phase_serve_model(device) -> None:
    """Full-width model checks on one init: decode against forward, then
    the profile of decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    _free_card()
    model = registry.build(get_config(SERVE_ARCH), device)
    params, _ = model.init(SERVE_SEED)
    _serve_decode_vs_forward(model, params, device)
    _serve_profile(model, params, device)


def phase_serve_path(device) -> dict:
    """Kernel A at the path's draw shapes and the smoke width on the card
    against the plain versions; then the model serving path at gemma-7b's
    full width through the user entry point ``launch.serve.serve``:
    temperature 0.8 on the fused path (kernel F every step) twice - equal
    tokens - then on the card's two-pass path (kernel A noise, plain
    argmax) - the same tokens - and greedy (no sampler, no leases), with
    kernel A and F's counts set to 0 just before and read just after; then
    ``python -m repro_torch.launch.serve`` in a subprocess, decode against
    forward at full width and the profile of decode steps."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.inference.kernels import gumbel_argmax as ga
    from repro_torch.kernels import thundering_block as tb
    from repro_torch.launch import serve as srv
    from repro_torch.models import registry
    from repro_torch.models.common import flatten
    phase_serve_draws(device)
    phase_serve_plain(device)
    cfg = get_config(SERVE_ARCH)
    shapes = flatten(registry.build(cfg, "meta").init(0)[0])
    n_params = sum(v.numel() for v in shapes.values())
    log(f"serve: {cfg.name} unmodified ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads x {cfg.resolved_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.act}, tied "
        f"{cfg.tie_embeddings}): {n_params} parameters, "
        f"{n_params * 4 / 1e9:.1f} GB in float32; batch {SERVE_BATCH}, "
        f"prompt {SERVE_PROMPT}, {SERVE_GEN} tokens, seed {SERVE_SEED}")
    kw = dict(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
              seed=SERVE_SEED, device=device)
    total = torch.cuda.get_device_properties(device).total_memory
    tb.reset_counts()
    ga.reset_counts()
    runs = {}
    for label, temp, path in (("fused", SERVE_TEMPERATURE, "fused"),
                              ("fused again", SERVE_TEMPERATURE, "fused"),
                              ("two-pass", SERVE_TEMPERATURE, "cuda"),
                              ("greedy", 0.0, "fused")):
        _free_card()
        torch.cuda.reset_peak_memory_stats(device)
        f0 = ga.fused_argmax.launches
        toks, stats = srv.serve(cfg, temperature=temp, sampler_path=path,
                                **kw)
        peak = torch.cuda.max_memory_allocated(device)
        runs[label] = toks
        _serve_report(label, toks, stats, peak)
        require(toks.shape == (SERVE_BATCH, SERVE_GEN)
                and toks.dtype == np.int32 and toks.min() >= 0
                and toks.max() < cfg.vocab, f"serve[{label}]: tokens "
                f"{toks.shape} {toks.dtype} outside [0, {cfg.vocab})")
        require(peak < total, f"serve[{label}]: peak {peak} >= {total}")
        f_launches = ga.fused_argmax.launches - f0
        if temp > 0:
            require(stats["sampler_calls_per_step"] == 1.0,
                    f"serve[{label}]: {stats['sampler_calls_per_step']} "
                    f"sampler calls per step")
            require(f_launches == (SERVE_GEN if path == "fused" else 0),
                    f"serve[{label}]: kernel F launched {f_launches} times")
        else:
            require("sampler_calls_per_step" not in stats and
                    f_launches == 0, "greedy serving drew randomness")
    launches = {"thundering_ctr": tb.thundering_ctr.launches,
                "gumbel_argmax": ga.fused_argmax.launches}
    plain_runs = (ga.fused_argmax_plain.cuda_runs
                  + tb.thundering_ctr_plain.cuda_runs
                  + tb.thundering_faithful_plain.cuda_runs)
    log(f"serve path: launches {launches}; plain versions run on the card: "
        f"{plain_runs}; tokens equal: fused twice "
        f"{np.array_equal(runs['fused'], runs['fused again'])}, fused = "
        f"two-pass {np.array_equal(runs['fused'], runs['two-pass'])}; greedy "
        f"= fused at {int((runs['greedy'] == runs['fused']).sum())} of "
        f"{runs['greedy'].size}")
    require(launches["thundering_ctr"] > 0 and launches["gumbel_argmax"] > 0,
            "kernel A or F never launched on the serve path")
    require(plain_runs == 0, "a plain version ran on a CUDA tensor")
    require(np.array_equal(runs["fused"], runs["fused again"]),
            "two in-process runs gave different tokens")
    require(np.array_equal(runs["fused"], runs["two-pass"]),
            "the fused and two-pass samplers gave different tokens")
    phase_serve_cli(device,
                    srv.tokens_digest(runs["fused"][:, :SERVE_CLI_GEN]))
    phase_serve_model(device)
    return launches


TRAIN_ARCH = "gemma_7b"       # published widths: d 3072, 16 x 256, V 256000
# 8 of 28 layers: 3.0e9 parameters, ~48 GB of float32 params, grads, m and
# v (all 28 would need ~137 GB); the loop-and-checkpoint runs take 2
# layers (1.34e9 parameters, a 16 GB checkpoint)
TRAIN_LAYERS, TRAIN_LOOP_LAYERS = 8, 2
TRAIN_BATCH, TRAIN_SEQ = 8, 256     # the reference CLI's defaults
TRAIN_STEPS = 4
TRAIN_SEED = 0
TRAIN_DIR = ROOT / "build" / "chip_smoke" / "train"
# card against CPU at the smoke width: the CPU tests' loss tolerance
# against the reference (tests/test_torch_train.py LOSS_ATOL)
TRAIN_LOSS_ATOL = 0.02
# step 0's chunked, remat'd loss against forward + the unchunked xent
TRAIN_UNCHUNKED_ATOL = 1e-3
TRAIN_ADAMW_SHAPE = (4096, 3072)
TRAIN_PEAK_GIB = 72.0


def _tree_digest(tree) -> str:
    """sha256 over each leaf's path and the sha256 of its bytes, in
    sorted path order; the leaves are copied and hashed in threads
    (hashlib releases the GIL)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from repro_torch.models.common import flatten
    flat = sorted(flatten(tree).items())

    def leaf(t):
        host = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
        return hashlib.sha256(host.numpy()).digest()

    with ThreadPoolExecutor(8) as ex:
        digests = list(ex.map(leaf, [t for _, t in flat]))
    h = hashlib.sha256()
    for (path, _), d in zip(flat, digests):
        h.update(path.encode())
        h.update(d)
    return h.hexdigest()


def _train_cfg(layers: int, **over):
    from repro_torch.configs import get_config
    return get_config(TRAIN_ARCH).scaled(n_layers=layers, **over)


def _step_bound(steps: int) -> float:
    """The most that ``steps`` steps of ``train``'s schedule can move one
    parameter beyond another run's: 2 lr per step (a gradient may change
    sign)."""
    from repro_torch.optim import cosine_schedule
    lr = cosine_schedule(3e-4, 100, max(steps, 2))
    return 2 * sum(float(lr(s)) for s in range(1, steps + 1))


def phase_train_adamw(device) -> None:
    """(d) One AdamW update of a (4096, 3072) leaf on the card against the
    same update on the CPU, with clipping off and on.  Without clipping
    the update is bit-equal; with it, the scale comes from global_norm's
    float32 sum, whose order differs between the devices."""
    import numpy as np
    import torch
    from repro_torch.optim import AdamWState, adamw_update, cosine_schedule
    from repro_torch.optim.adamw import global_norm
    rng = np.random.default_rng(TRAIN_SEED)
    shape = TRAIN_ADAMW_SHAPE
    host = {k: torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))
            for k, s in (("p", 0.02), ("g", 1e-3), ("m", 1e-4),
                         ("v", 1e-8))}
    host["v"] = host["v"].abs()
    lr = cosine_schedule(3e-4, 100, 1000)
    t0 = time.perf_counter()
    for clip in (1e9, 1.0):
        out = []
        for dev in (torch.device("cpu"), device):
            p = {"w": host["p"].to(dev, copy=True)}
            st = AdamWState(torch.tensor(2, dtype=torch.int32),
                            {"w": host["m"].to(dev, copy=True)},
                            {"w": host["v"].to(dev, copy=True)})
            g = {"w": host["g"].to(dev, copy=True)}
            norm = global_norm(g).cpu()
            p, st = adamw_update(g, st, p, lr=lr, clip_norm=clip)
            out.append((norm, p["w"].cpu(), st.m["w"].cpu(),
                        st.v["w"].cpu()))
        (n0, *cpu), (n1, *card) = out
        differ = [int((a.view(torch.int32) != b.view(torch.int32)).sum())
                  for a, b in zip(cpu, card)]
        ulp = max(int((_ordered_f32(a) - _ordered_f32(b)).abs().max())
                  for a, b in zip(cpu, card))
        norm_ulp = int((_ordered_f32(n0.reshape(1))
                        - _ordered_f32(n1.reshape(1))).abs().max())
        clipped = float(n0) > clip
        log(f"train adamw card vs cpu ({shape}, clip {clip:g}, "
            f"{'clipped' if clipped else 'not clipped'}): global_norm "
            f"{float(n0):.6f} vs {float(n1):.6f} ({norm_ulp} ULP apart); "
            f"elements differing in p / m / v: {differ} of "
            f"{host['p'].numel()}; max {ulp} ULP")
        if not clipped:
            require(sum(differ) == 0, "train adamw: the card's update "
                    "differs from the CPU's without clipping")
        else:
            require(norm_ulp > 0 or sum(differ) == 0, "train adamw: equal "
                    "norms but a different clipped update")
            require(ulp <= 4, f"train adamw: the clipped update is {ulp} "
                    f"ULP from the CPU's")
    log(f"train adamw: {time.perf_counter() - t0:.1f} s")


def phase_train_draws(device) -> None:
    """Kernel A at the train path's own shapes against the plain version:
    the ragged last chunk of the 8-layer ``layers/wg`` and a step's batch
    uniforms.  Runs before the path's counts are reset."""
    import math
    from repro_torch.core import stream as tstream
    from repro_torch.launch.train import pipeline_for
    from repro_torch.models import registry
    from repro_torch.models.common import PARAM_CHUNK, flatten, param_stream
    cfg = _train_cfg(TRAIN_LAYERS)
    n = math.prod(flatten(registry.build(cfg, "meta").init(0)[0])[
        "layers/wg"].shape)
    lo = (n - 1) // PARAM_CHUNK * PARAM_CHUNK
    _draw_against_plain(f"train layers/wg ({n} elements) last chunk",
                        tstream.advance(param_stream(TRAIN_SEED, "layers/wg",
                                                     device), lo), n - lo)
    pipe = pipeline_for(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED,
                        device=device)
    _draw_against_plain(f"train batch of step 3 ({TRAIN_BATCH}, "
                        f"{TRAIN_SEQ + 1})", tstream.derive(pipe._root, 3),
                        TRAIN_BATCH * (TRAIN_SEQ + 1))


def phase_train_smoke(device) -> None:
    """(a) ``train`` for 4 steps at ``smoke_config(gemma_7b)`` on the card
    and on the CPU: losses within ``TRAIN_LOSS_ATOL`` and parameters
    within the schedule's bound of each other; then the CLI in a
    subprocess: its loss lines equal the in-process card run's and its
    final checkpoint holds the same parameters bit for bit."""
    import os
    import shutil
    import torch
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch.train import smoke_config, train
    from repro_torch.models.common import flatten
    t0 = time.perf_counter()
    cfg = smoke_config(get_config(TRAIN_ARCH))
    runs = []
    for i, dev in enumerate((device, torch.device("cpu"))):
        d = TRAIN_DIR / f"smoke_{i}"
        shutil.rmtree(d, ignore_errors=True)
        runs.append(train(cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                          seq_len=TRAIN_SEQ, ckpt_dir=str(d), save_every=2,
                          seed=TRAIN_SEED, device=dev))
        shutil.rmtree(d, ignore_errors=True)
    (pc, _, lc), (pp, _, lp) = runs
    loss_err = max(abs(a - b) for (_, a), (_, b) in zip(lc, lp))
    fc, fp = flatten(pc), flatten(pp)
    p_err = max(float((fc[k].cpu() - fp[k]).abs().max()) for k in fp)
    bound = _step_bound(TRAIN_STEPS)
    log(f"train smoke ({cfg.d_model}/{cfg.n_layers} layers/V {cfg.vocab}, "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps) card vs "
        f"cpu: losses {[round(l, 6) for _, l in lc]}, max |diff| "
        f"{loss_err:.3g} (limit {TRAIN_LOSS_ATOL}); params max |diff| "
        f"{p_err:.3g} (limit {bound:.3g}, 2 lr a step)")
    require(len(lc) == len(lp) and [s for s, _ in lc] == [s for s, _ in lp],
            "train smoke: the runs logged different steps")
    require(loss_err <= TRAIN_LOSS_ATOL, "train smoke: card losses differ "
                                         "from the CPU's")
    require(p_err <= bound, "train smoke: card params differ from the "
                            "CPU's beyond the schedule's bound")
    cli_dir = TRAIN_DIR / "cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            TRAIN_ARCH, "--smoke", "--steps", str(TRAIN_STEPS),
            "--save-every", "2", "--global-batch", str(TRAIN_BATCH),
            "--seq-len", str(TRAIN_SEQ), "--seed", str(TRAIN_SEED),
            "--ckpt-dir", str(cli_dir)]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(args, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    require(out.returncode == 0, f"the train CLI failed: "
            f"{out.stderr[-2000:]}")
    cli_lines = re.findall(r"^step .*$", out.stdout, re.M)
    want = [f"step {s:5d} loss {l:.4f}" for s, l in lc]   # log_every 10
    tree, step, _ = load_checkpoint(str(cli_dir), device=device)
    same = all(torch.equal(flatten(tree["params"])[k].view(torch.int32),
                           fc[k].view(torch.int32)) for k in fc)
    shutil.rmtree(cli_dir, ignore_errors=True)
    log(f"train CLI (subprocess): {cli_lines} == in-process "
        f"{cli_lines == want}; step-{step} checkpoint params bit-equal to "
        f"the in-process card run's: {same}; "
        f"{out.stdout.strip().splitlines()[-1]}; "
        f"{time.perf_counter() - t0:.1f} s")
    require(cli_lines == want, "the train CLI's loss lines differ from the "
                               "in-process run's")
    require(step == TRAIN_STEPS and same, "the train CLI's parameters "
                                          "differ from the in-process run's")


def _train_profile(step_fn, params, opt, batch, step, device) -> None:
    """One step under ``torch.profiler``: busy share, device time by kind
    and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, met = step_fn(params, opt, batch, step)
        float(met["loss"])
        torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds, top = {}, []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(evt, "self_device_time_total", 0.0)
                   or getattr(evt, "self_cuda_time_total", 0.0))
        kind = _kernel_kind(evt.key)
        if kind == "other elementwise / reduce" and \
                "index" in evt.key.lower():
            kind = "index (embedding gather / scatter)"
        kinds[kind] = kinds.get(kind, 0.0) + us
        top.append((us, evt.key, evt.count))
    busy = sum(kinds.values())
    if busy <= 0.0:
        log("train profile: not measured (the profiler recorded no device "
            "time)")
        return
    log(f"train profile (one full-width step, {TRAIN_LAYERS} layers): wall "
        f"{wall_us / 1e3:.1f} ms; device busy {busy / 1e3:.1f} ms = "
        f"{busy / wall_us * 100:.1f} % (idle "
        f"{100 - busy / wall_us * 100:.1f} %)")
    for kind, us in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  device time {kind}: {us / 1e3:.1f} ms "
            f"({us / busy * 100:.1f} % of busy)")
    for us, key, count in sorted(top, reverse=True)[:12]:
        log(f"  top kernel {us / 1e3:.2f} ms x{count}: {key[:110]}")


def _train_split(model, params, opt, batch, step, device):
    """fwd + bwd and the AdamW update of one step, timed apart with CUDA
    events (the same calls ``make_train_step``'s step makes)."""
    import torch
    from repro_torch.core import stream as tstream
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_update, cosine_schedule
    root = tstream.new_stream(TRAIN_SEED, 0xD07, device=device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    (loss, _), grads = steps.value_and_grad(
        model, params, batch, tstream.derive(root, step))
    ev[1].record()
    params, opt = adamw_update(grads, opt, params,
                               lr=cosine_schedule(3e-4, 100, TRAIN_STEPS))
    ev[2].record()
    ev[2].synchronize()
    log(f"train step split (step {step}): fwd + bwd "
        f"{ev[0].elapsed_time(ev[1]):.1f} ms, AdamW update "
        f"{ev[1].elapsed_time(ev[2]):.1f} ms (CUDA events)")
    return params, opt


def phase_train_full(device) -> None:
    """(b) gemma-7b at full width, ``TRAIN_LAYERS`` layers: step 0's loss
    against ``model.forward`` + the unchunked ``softmax_xent``; then
    ``make_train_step`` with ``adamw_init`` for 4 steps, twice from the
    same seed: equal sha256 digests of the parameters.  Reports init s,
    step s, tokens/s, peak memory, the fwd+bwd / update split and one
    step's profile."""
    import numpy as np
    import torch
    from repro_torch.launch import steps
    from repro_torch.launch.train import pipeline_for
    from repro_torch.models import layers as L
    from repro_torch.models import registry
    from repro_torch.models.common import flatten
    from repro_torch.optim import adamw_init
    cfg = _train_cfg(TRAIN_LAYERS)
    model = registry.build(cfg, device)
    pipe = pipeline_for(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED,
                        device=device)
    digests, step_s, init_s, peaks = [], [], [], []
    for run in range(2):
        _free_card()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        params, _ = model.init(TRAIN_SEED)
        sync(device)
        init_s.append(time.perf_counter() - t0)
        if run == 0:
            n = sum(p.numel() for p in flatten(params).values())
            log(f"train full width: {cfg.name} d_model {cfg.d_model}, "
                f"{cfg.n_heads} heads x {cfg.resolved_head_dim}, d_ff "
                f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.n_layers} of 28 "
                f"layers: {n} parameters ({n * 16 / 1e9:.1f} GB of float32 "
                f"params, grads, m, v); batch {TRAIN_BATCH} x {TRAIN_SEQ}")
            with torch.no_grad():
                b0 = pipe.batch_at(0)
                logits, _ = model.forward(params, b0)
                whole = float(L.softmax_xent(logits, b0["labels"]))
                del logits
        opt = adamw_init(params)
        step_fn = steps.make_train_step(model, seed=TRAIN_SEED,
                                        total_steps=TRAIN_STEPS)
        losses, times = [], []
        for s in range(TRAIN_STEPS):
            batch = pipe.batch_at(s)
            sync(device)
            t0 = time.perf_counter()
            params, opt, met = step_fn(params, opt, batch, s)
            losses.append(float(met["loss"]))
            sync(device)
            times.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated(device))
        t0 = time.perf_counter()
        digests.append(_tree_digest(params))
        step_s.extend(times[1:])
        log(f"train full run {run}: init {init_s[-1]:.3f} s; step s "
            f"{[round(t, 4) for t in times]}; losses {losses}; peak "
            f"{peaks[-1] / 2 ** 30:.2f} GiB; params sha256 "
            f"{digests[-1][:16]} ({time.perf_counter() - t0:.1f} s)")
        if run == 0:
            err = abs(losses[0] - whole)
            log(f"train step 0 loss {losses[0]:.6f} (chunked, remat) vs "
                f"forward + unchunked xent {whole:.6f}: |diff| {err:.3g} "
                f"(limit {TRAIN_UNCHUNKED_ATOL})")
            require(err <= TRAIN_UNCHUNKED_ATOL, "train: step 0's chunked "
                    "loss differs from the unchunked one")
        require(all(np.isfinite(losses)), "train: a non-finite loss")
        if run == 1:
            params, opt = _train_split(model, params, opt,
                                       pipe.batch_at(TRAIN_STEPS),
                                       TRAIN_STEPS, device)
            _train_profile(step_fn, params, opt,
                           pipe.batch_at(TRAIN_STEPS + 1), TRAIN_STEPS + 1,
                           device)
        del params, opt
    p50 = float(np.percentile(step_s, 50))
    total = torch.cuda.get_device_properties(device).total_memory
    log(f"train full width: init {min(init_s):.3f}-{max(init_s):.3f} s; "
        f"step p50 {p50:.4f} s (steps 1-{TRAIN_STEPS - 1} of 2 runs) = "
        f"{TRAIN_BATCH * TRAIN_SEQ / p50:.0f} tokens/s; peak memory "
        f"{max(peaks) / 2 ** 30:.2f} GiB of {total / 2 ** 30:.1f}; digests "
        f"equal {digests[0] == digests[1]} ({card_line()})")
    require(digests[0] == digests[1], "train: two runs from one seed gave "
                                      "different parameters")
    require(max(peaks) / 2 ** 30 <= TRAIN_PEAK_GIB,
            f"train: peak memory above {TRAIN_PEAK_GIB} GiB")


class _CheckpointMeter:
    """While active, times the checkpoint module's host snapshots, writes
    and loads (``CheckpointManager`` calls them as module globals) and
    sums each written checkpoint's bytes."""

    NAMES = ("_host_copy", "save_checkpoint", "load_checkpoint")

    def __init__(self):
        self.secs = {name: [] for name in self.NAMES}
        self.bytes = []
        self._depth = {name: 0 for name in self.NAMES}

    def _timed(self, name, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            self._depth[name] += 1          # _host_copy calls itself
            try:
                out = fn(*args, **kw)
            finally:
                self._depth[name] -= 1
            if self._depth[name] == 0:
                self.secs[name].append(time.perf_counter() - t0)
            if name == "save_checkpoint":
                self.bytes.append(sum(f.stat().st_size
                                      for f in Path(out).iterdir()))
            return out
        return timed

    def __enter__(self):
        from repro_torch.checkpoint import checkpoint as ck
        self._real = {name: getattr(ck, name) for name in self.NAMES}
        for name, fn in self._real.items():
            setattr(ck, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.checkpoint import checkpoint as ck
        for name, fn in self._real.items():
            setattr(ck, name, fn)


def phase_train_loop(device) -> None:
    """(c) gemma-7b at full width, ``TRAIN_LOOP_LAYERS`` layers, through
    ``train`` with the loop and checkpoints: 4 steps with save_every 2 and
    a failure injected at step 3 (resumed from step 2's checkpoint),
    against an uninterrupted run and a ``use_service=False`` run - equal
    parameter digests; then the
    gradients with ``remat="full"`` and ``"none"`` - equal digests.  Each
    run's checkpoints are deleted once its parameters are digested."""
    import shutil
    import torch
    from repro_torch.launch import steps
    from repro_torch.launch.train import pipeline_for, train
    from repro_torch.models import registry
    cfg = _train_cfg(TRAIN_LOOP_LAYERS)
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    du = shutil.disk_usage(TRAIN_DIR)
    log(f"train loop: disk at {TRAIN_DIR}: {du.free / 1e9:.1f} GB free of "
        f"{du.total / 1e9:.1f} GB")
    digests, logged = {}, {}
    with _CheckpointMeter() as meter:
        # the uninterrupted runs save once, at the end (what they are
        # compared on does not depend on the cadence)
        for name, kw in (("fail@3", dict(fail_at=3, save_every=2)),
                         ("clean", dict(save_every=TRAIN_STEPS)),
                         ("no-service", dict(use_service=False,
                                             save_every=TRAIN_STEPS))):
            _free_card()
            d = TRAIN_DIR / name.replace("@", "_")
            shutil.rmtree(d, ignore_errors=True)
            t0 = time.perf_counter()
            params, opt, losses = train(
                cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, ckpt_dir=str(d), seed=TRAIN_SEED,
                log_every=1, device=device, **kw)
            secs = time.perf_counter() - t0
            digests[name] = _tree_digest(params)
            logged[name] = losses
            shutil.rmtree(d, ignore_errors=True)
            del params, opt
            log(f"train loop [{name}]: {secs:.1f} s; logged steps "
                f"{[s for s, _ in losses]}; params sha256 "
                f"{digests[name][:16]}")
    snap, write, load = (meter.secs[n] for n in meter.NAMES)
    log(f"train loop checkpoints: {len(write)} saves of "
        f"{max(meter.bytes) / 1e9:.2f} GB; host snapshot "
        f"{min(snap):.2f}-{max(snap):.2f} s, write {min(write):.2f}-"
        f"{max(write):.2f} s ({max(meter.bytes) / 1e9 / max(write):.2f}-"
        f"{max(meter.bytes) / 1e9 / min(write):.2f} GB/s), restore "
        f"{[round(t, 2) for t in load]} s ({card_line()})")
    require(len(set(digests.values())) == 1, f"train loop: digests differ "
            f"{digests}")
    require(dict(logged["fail@3"]) == dict(logged["clean"])
            == dict(logged["no-service"]), "train loop: losses differ")
    require([s for s, _ in logged["fail@3"]] == [0, 1, 2, 2, 3],
            "train loop: the failed run did not resume at step 2")
    require(len(load) == 1, "train loop: expected one restore")
    grads = {}
    batch = pipeline_for(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED,
                         device=device).batch_at(0)
    for remat in ("full", "none"):
        _free_card()
        model = registry.build(cfg.scaled(remat=remat), device)
        params, _ = model.init(TRAIN_SEED)
        torch.cuda.reset_peak_memory_stats(device)
        sync(device)
        t0 = time.perf_counter()
        (loss, _), g = steps.value_and_grad(model, params, batch)
        sync(device)
        secs = time.perf_counter() - t0
        grads[remat] = (float(loss), _tree_digest(g))
        log(f"train remat={remat}: loss {float(loss):.6f}, grads sha256 "
            f"{grads[remat][1][:16]}, fwd + bwd {secs:.3f} s, peak "
            f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB")
        del params, g
    require(grads["full"] == grads["none"], "train: remat full and none "
            "gave different gradients")


def phase_train_path(device) -> dict:
    """The training substrate: AdamW and kernel A at the path's shapes
    against the plain versions on the CPU / card first, then the smoke
    width on the card against the CPU and the CLI, then - kernel A's
    counts set to 0 just before and read just after - gemma-7b at full
    width: 8 layers through ``make_train_step``, 2 layers through
    ``train`` with its loop and checkpoints."""
    from repro_torch.kernels import thundering_block as tb
    phase_train_adamw(device)
    phase_train_draws(device)
    phase_train_smoke(device)
    tb.reset_counts()
    phase_train_full(device)
    phase_train_loop(device)
    launches = {"thundering_ctr": tb.thundering_ctr.launches}
    plain_runs = (tb.thundering_ctr_plain.cuda_runs
                  + tb.thundering_faithful_plain.cuda_runs)
    log(f"train path: launches {launches}; plain versions run on the "
        f"card: {plain_runs}")
    require(launches["thundering_ctr"] > 0, "kernel A never launched on "
                                            "the train path")
    require(plain_runs == 0, "a plain version ran on a CUDA tensor")
    return launches


def run_phase(name: str, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    result = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return result


KERNEL_SOURCES = {
    "thundering_ctr": ("src/repro_torch/csrc/thundering_block.cu",
                       "src/repro/kernels/thundering_block.py:52"),
    "thundering_faithful": ("src/repro_torch/csrc/thundering_block.cu",
                            "src/repro/kernels/thundering_block.py:65"),
    "fused_dropout_2d": ("src/repro_torch/csrc/fused_dropout.cu",
                         "src/repro/kernels/fused_dropout.py:52"),
    "pi_partials": ("src/repro_torch/csrc/mc.cu",
                    "src/repro/kernels/mc.py:51"),
    "option_partials": ("src/repro_torch/csrc/mc.cu",
                        "src/repro/kernels/mc.py:64"),
    "gumbel_argmax": ("src/repro_torch/csrc/gumbel_argmax.cu",
                      "src/repro/inference/kernels/gumbel_argmax.py:104"),
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    device = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    try:
        run_phase("build", phase_build)
        worst = run_phase("parity", phase_parity, device)
        worst.update(run_phase("apps parity", phase_apps_parity, device))
        worst.update(run_phase("inference parity", phase_inference_parity,
                               device))
        run_phase("digests", phase_digests, device)
        run_phase("golden", phase_golden, device)
        # each path's counts, set to 0 just before it and read just after
        by_path = {"main": run_phase("main path", phase_main_path, device),
                   "apps": run_phase("apps path", phase_apps, device),
                   "inference": run_phase("inference path", phase_inference,
                                          device)}
        timing = run_phase("timing", phase_timing, device)
        timing += run_phase("apps timing", phase_apps_timing, device)
        inf_rows = run_phase("inference timing", phase_inference_timing,
                             device)
        timing += [r for r in inf_rows if r["B"] == 64]   # the batcher's B
        run_phase("delivery", phase_delivery, device)
        run_phase("repairs", phase_repairs, device)
        by_path["quality"] = run_phase("quality path", phase_quality_path,
                                       device)
        by_path["service"] = run_phase("service path", phase_service_path,
                                       device)
        by_path["serve"] = run_phase("serve path", phase_serve_path, device)
        by_path["train"] = run_phase("train path", phase_train_path, device)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # a kernel's "launches" is the count of the first path that runs it;
    # "launches_by_path" holds every path's own count
    launches, per_path = {}, {}
    for path, counts in by_path.items():
        for name, n in counts.items():
            launches.setdefault(name, n)
            per_path.setdefault(name, {})[path] = n
    kernels = []
    for row in timing:
        name = row["name"]
        source, replaces = KERNEL_SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": per_path[name],
            "max_abs_err": worst[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    line = json.dumps({"kernels": kernels})
    print(line)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
