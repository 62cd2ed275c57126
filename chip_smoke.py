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
standing pools, an 8192-request backlog from 4 submitter threads), every
response of the burst held against a CPU server's plain versions, its
journals replayed on the card, ``python -m repro_torch.service`` with
replay and a SIGTERM drain, and a 2-shard fleet on the card at ``make
fleet`` width with no fault, a killed and a hung shard - one digest.
Then the model serving path (gemma-7b unmodified through
``launch.serve``) and the training substrate: AdamW on the card against
the CPU, ``train`` at the smoke width on the card against the CPU and
through its CLI, gemma-7b at full width over 8 of its 28 layers through
``make_train_step`` (two runs from one seed, equal parameter digests) and
over 1 layer through ``train`` with its loop and checkpoints (a failure
at step 3 resumed, the service and ``--no-service`` paths, remat on and
off - one digest each).  Last the other model families: olmoe-1b-7b,
granite-moe-3b-a800m, mamba2-2.7b, zamba2-7b and whisper-small served
unmodified through ``launch.serve`` (kernel A draws every parameter,
prompt and audio frame, kernel F samples every token), each against the
CPU at smoke width (an MoE token routed otherwise on the card must be a
near-tie), decode against forward at 2 layers of full width, a profile of
olmoe and mamba2 decode steps and the serve CLI on mamba2.  Then the
four configs no earlier path serves: glm4-9b unmodified, qwen1.5-32b,
granite-34b and qwen2-vl-72b at published width cut in depth
(``LARGE_LAYERS``), the vlm with a 1152-token prompt over its (64, 1024,
8192) patches - kernel A at the new draw shapes, kernel F at V = 49152
and the float8 KV cast against the plain versions and the CPU, each
against the CPU at smoke width, served through ``launch.serve`` at batch
64, decode against forward at 2 layers, profiles of qwen1.5-32b and
qwen2-vl-72b decode steps.  Then training beyond gemma-7b: ``train`` at
the smoke width on the card against the CPU for nine configs (and for
the five below a failure at step 3 resumed and ``--no-service``, one
digest each), the train CLI on mamba2, and olmoe-1b-7b, mamba2-2.7b,
zamba2-7b, whisper-small and qwen2-vl-72b at published width cut in
depth (``TRAIN_FAMILY_LAYERS``) through ``make_train_step`` - two runs
from one seed with equal parameter digests, finite step-0 gradients,
step 0 against the unchunked loss, profiles of olmoe and mamba2 steps.
Then the four configs trained only at smoke width so far: kernel A at
their new draw shapes, a failure at step 3 resumed and ``--no-service``
on the card at smoke width, and granite-moe-3b-a800m, glm4-9b,
qwen1.5-32b and granite-34b at published width cut in depth
(``TRAIN_LARGE_LAYERS``) through ``make_train_step`` with the same
checks, profiles of granite-moe and qwen1.5-32b steps.
Last the dry run: ``python -m repro_torch.launch.dryrun`` over every
cell of both production meshes (meta tensors), and its RNG fan-out and
service burst on the card, in subprocesses; ``rng_fanout_cell`` over
256, 512 and 4 shards of the card (each block equal to one
``generate``); ``service_cell`` on the card against the CPU; the dry
run's argument bytes of every config served or trained above against
the peak memory the card measured for it, and the depth the dry run
predicts for each config the large path serves or the train paths
train, beside the depth served or trained.

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
# them): kernel C's from the run before its redesign, kernel F's from the
# last run before its redesign (one cluster per row), the others' from the
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
              "gumbel_argmax B=64": 0.0948, "gumbel_argmax B=256": 0.3391}

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
# slots, the reference kernel's batch tile of 256 and a small batch of 8.
# Kernel F is also held against its plain version at one and 8 rows (one
# cluster of 16 blocks a row), at 65 rows of 50304 (past one wave), and at
# glm4-9b's and qwen's vocabularies (151552, 152064).
INF_VOCAB = 256000
INF_BATCHES = (64, 256, 8)
INF_SHAPES = [(INF_VOCAB, 64), (INF_VOCAB, 256), (1000, 130), (300, 20),
              (64, 8), (INF_VOCAB, 1), (INF_VOCAB, 8), (50304, 65),
              (151552, 64), (152064, 64)]
INF_OPTIONS = [(1.0, 0), (1.25, 0), (1.0, 16), (2.0, 4)]
INF_SEQUENCES = 128
INF_KILL_SEQUENCES = 32
# Kernel F per vocabulary element, counted from ``cuobjdump -sass`` of its
# sm_90a build (nvcc 12.8) with tools/sass_loop_counts.py over the
# splitmix64 grid-stride loop of gumbel_argmax_kernel<1024, 0>, the block
# size of the main paths' plans (unmasked elements take all of it): one
# trip scores 4 elements, 0a40-22b0: 134 INT32 (84 IMAD beside them on the
# FMA pipe, 136 FP32, no MUFU) of 392 instructions.  (INT32, all) per
# element.  GA_OPS_PER_ELEMENT_ATOMIC is the count of kernel F's earlier
# design (a Brown jump per thread, the 64-bit mix, an atomicMax per block
# and three launches a call; its loop 0e90-15f0: 34 INT32 of 119): its
# bound is logged beside the new one, so the design is judged against the
# earlier work as well as its own.
GA_OPS_PER_ELEMENT = (134 / 4, 392 / 4)
GA_OPS_PER_ELEMENT_ATOMIC = (34.0, 119.0)

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


def enqueue_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` on the host clock with no synchronize
    inside: the host's enqueue alone.  When it exceeds the device's time
    per call, back-to-back CUDA-event timings measure the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def device_ops(fn, reps: int, warmup: int = 2) -> dict:
    """``fn`` under ``torch.profiler`` over ``reps`` calls: {device op
    name: (device ms per launch, launches recorded per call)}; kernels,
    memsets and copies each count once per launch.  Late in a long process
    the profiler may record fewer launches than ran, so a time is taken
    per recorded launch.  {} when it recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = {}, {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.count:
            us[evt.key] = us.get(evt.key, 0.0) + float(
                getattr(evt, "self_device_time_total", 0.0)
                or getattr(evt, "self_cuda_time_total", 0.0))
            count[evt.key] = count.get(evt.key, 0) + evt.count
    return {k: (us[k] / count[k] / 1e3, count[k] / reps) for k in us}


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


def _leaf_table_checks(device, S: int) -> int:
    """The leaf-table kernel against its plain version, bit for bit, at
    S streams: the families of SEED's purposes 0-4 (the apps' plans take
    1-4) and one with the top bit set.  Returns the number of checks."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels import thundering_block as tb
    fams = [engine.family_from_seed(SEED, p)[1] for p in range(5)]
    fams.append(fams[0] | 1 << 63)
    for h_fam in fams:
        got = tb.leaf_table(h_fam, S, device)
        want = tb.leaf_table_plain(h_fam, S, device)
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"leaf table: kernel != plain version for family "
                f"{h_fam:#018x}, S={S}")
    return len(fams)


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
    n += sum(_leaf_table_checks(device, S) for S in (S_FULL, S_FULL + 1))
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
    from repro_torch import trace
    from repro_torch.core import engine, stream
    from repro_torch.runtime.blocks import BlockService

    host_jumps = _count_host_jumps()
    trace.reset_counters("thundering_")
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

    launches = {k: trace.counter(f"{k}.launches")
                for k in ("thundering_ctr", "thundering_faithful")}
    plain_runs = (trace.counter("thundering_ctr_plain.cuda_runs")
                  + trace.counter("thundering_faithful_plain.cuda_runs"))
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
    from repro_torch import trace
    from repro_torch.core import engine, stream
    from repro_torch.kernels import fused_dropout as fd, mc, ops, ref
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

    trace.reset_counters(("thundering_", "pi_partials", "option_partials",
                          "fused_dropout_2d", "leaf_table"))
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
    launches = {"pi_partials": trace.counter("pi_partials.launches"),
                "option_partials": trace.counter("option_partials.launches"),
                "fused_dropout_2d": trace.counter("fused_dropout_2d.launches"),
                "leaf_table": trace.counter("leaf_table.launches")}
    plain_runs = (trace.counter("pi_partials_plain.cuda_runs")
                  + trace.counter("option_partials_plain.cuda_runs")
                  + trace.counter("fused_dropout_2d_plain.cuda_runs")
                  + trace.counter("leaf_table_plain.cuda_runs")
                  + trace.counter("thundering_ctr_plain.cuda_runs")
                  + trace.counter("thundering_faithful_plain.cuda_runs"))
    log(f"apps path: {wall:.2f} s wall; launches {launches}; plain versions "
        f"run on the card: {plain_runs}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the apps path never launched: {launches}")
    require(plain_runs == 0, "a plain version ran on a CUDA tensor")
    n_leaf = _leaf_table_checks(device, APP_LANES)
    log(f"apps path: {n_leaf} leaf tables of {APP_LANES} streams equal "
        f"their plain version")

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
    (inv_temp, top_k) x decorrelator, counters below and past 2**32 and a
    window ending where the counter wraps (2**64 - V), the reference's
    (V, B) layout as a view, all-masked rows, top-1, and scores that tie
    at -0.0 / +0.0."""
    import torch
    from repro_torch.core import engine
    from repro_torch.inference.kernels import gumbel_argmax as ga
    n = 0
    t0 = time.perf_counter()
    bad = ga.gumbel_mismatches(device)
    log(f"kernel F's branch-free logf against tb_gumbel over all 2^24 "
        f"uniforms: {bad} differ")
    require(bad == 0, "kernel F's gumbel noise differs from tb_gumbel's")
    for V, B in INF_SHAPES:
        logits, h, x0 = _ga_case(V, B, device)
        for inv_temp, top_k in INF_OPTIONS:
            th = (torch.topk(logits, top_k, dim=-1).values[:, -1] if top_k
                  else torch.full((B,), float("-inf"), device=device))
            for deco in ("splitmix64", "fmix32"):
                for ctr in (977, HIGH_OFFSET, 2 ** 64 - V):
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
    from repro_torch import trace
    from repro_torch.inference import ScheduleConfig, run_offline
    base = ScheduleConfig(capacity=64, vocab=INF_VOCAB,
                          sequences=INF_SEQUENCES, rate=8.0, seed=0)
    # warm-up: first-call costs (the library load, torch's first top-k)
    run_offline(dataclasses.replace(base, sequences=4, top_k=50),
                device=device)
    trace.reset_counters(("thundering_", "pi_partials", "option_partials",
                          "fused_dropout_2d", "fused_argmax"))
    t0 = time.perf_counter()
    reports = {}
    for label, cfg in (("temperature 1", base),
                       ("top_k 50", dataclasses.replace(base, top_k=50))):
        reports[label] = _inference_report(
            label, run_offline(cfg, parity=True, device=device))
    sync(device)
    wall = time.perf_counter() - t0
    launches = {"gumbel_argmax": trace.counter("fused_argmax.launches")}
    plain_runs = (trace.counter("fused_argmax_plain.cuda_runs")
                  + trace.counter("thundering_ctr_plain.cuda_runs")
                  + trace.counter("thundering_faithful_plain.cuda_runs"))
    steps = sum(r["decode_steps"] for r in reports.values())
    log(f"inference path: {wall:.2f} s wall; launches {launches} "
        f"({steps} fused decode steps); thundering_ctr launches "
        f"{trace.counter('thundering_ctr.launches')} (arrivals, admissions, "
        f"two-pass noise); plain versions run on the card: {plain_runs}")
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


def _ga_bound(V: int, B: int, ops=GA_OPS_PER_ELEMENT):
    """Kernel F's bound at (V, B): (ms, "bytes" or "operations", the
    bytes' ms, the operations' ms): the logits read once and B tokens,
    leaf words and thresholds; ``ops``, its SASS counts per element."""
    int_ops, all_ops = ops
    n = V * B
    t_bytes = (n * 4 + B * (8 + 4 + 4)) / HBM_BYTES_PER_S * 1e3
    t_ops = max(n * int_ops / INT32_OPS_PER_S,
                n * all_ops / DISPATCH_OPS_PER_S) * 1e3
    return (max(t_bytes, t_ops),
            "operations" if t_ops > t_bytes else "bytes", t_bytes, t_ops)


def _philox_gumbel_ms(logits, gen) -> float:
    """ms per call of torch's Philox Gumbel-max on ``logits`` (rand,
    -log(-log u), scaled add, argmax), CUDA events."""
    import torch
    u = torch.empty(logits.shape, device=logits.device)

    def philox():
        torch.rand(logits.shape, generator=gen, device=logits.device, out=u)
        g = -torch.log(-torch.log(u))
        return torch.argmax(logits * 1.0 + g, -1)
    return time_cuda(philox, reps=20)


def _ga_device(call) -> str:
    """Kernel F's own device time per launch of ``call`` under
    ``torch.profiler``, its device launches per call and the host's
    enqueue ms per call, as one phrase.  The profiler must see kernel F
    and nothing else on the device, at most once per call (late in a long
    process it may record fewer launches than ran: the phrase says how
    many)."""
    reps = 50
    ops = device_ops(call, reps=reps)
    if not ops:
        return "device ms: not measured (the profiler recorded no device time)"
    require(len(ops) == 1 and "gumbel_argmax_kernel" in next(iter(ops))
            and next(iter(ops.values()))[1] <= 1.0,
            f"a kernel F call is not one device launch: {ops}")
    (f_ms, per_call), = ops.values()
    return (f"profiler: kernel F {f_ms:.4f} ms of device time per launch, "
            f"1 device launch per call and no other device op "
            f"({round(per_call * reps)} of {reps} launches recorded); host "
            f"enqueue {enqueue_ms(call, reps=reps):.4f} ms per call")


def phase_inference_timing(device) -> list:
    """Kernel F at (V, B) = (256000, 64), (256000, 256) and (256000, 8):
    ms, elements per s, its device time and launches per call under the
    profiler, bound (this design's count and the earlier design's),
    plain ms, and two torch samplers on the same logits."""
    import torch
    from repro_torch.inference.kernels import gumbel_argmax as ga
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

        def call():
            ga.fused_argmax(logits, h, x0, 977, th, inv_temp=1.0, out=out)
        ms = time_cuda(call, reps=50)
        prof = _ga_device(call)
        plain_ms = time_cuda(lambda: ga.fused_argmax_plain(
            logits, h, x0, 977, th, inv_temp=1.0), reps=1, warmup=1)
        lib_ms = _philox_gumbel_ms(logits, gen)
        multi_ms = time_cuda(lambda: torch.multinomial(
            torch.softmax(logits * 1.0, -1), 1, generator=gen), reps=20)
        b_ms, b_by, t_bytes, t_ops = _ga_bound(V, B)
        old_ms = _ga_bound(V, B, GA_OPS_PER_ELEMENT_ATOMIC)[0]
        log(f"  gumbel_argmax (V, B) = ({V}, {B}): {ms:.4f} ms"
            f"{_was(f'gumbel_argmax B={B}')} = "
            f"{n / (ms * 1e-3) / 1e9:.1f} G elements/s, "
            f"{n * 4 / (ms * 1e-3) / 1e9:.1f} GB/s of logits; bound "
            f"{b_ms:.4f} ms by {b_by} (bytes {t_bytes:.4f} ms, operations "
            f"{t_ops:.4f} ms; {b_ms / ms * 100:.1f}% of the bound's speed; "
            f"the earlier design's count: {old_ms:.4f} ms, "
            f"{old_ms / ms * 100:.1f}%); {prof}; "
            f"plain {plain_ms:.2f} ms; torch Philox gumbel-max (rand, "
            f"-log(-log u), scaled add, argmax) {lib_ms:.4f} ms; "
            f"torch.multinomial(softmax) {multi_ms:.4f} ms")
        rows.append(dict(name="gumbel_argmax", B=B, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         multinomial_ms=multi_ms))
        del logits
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
    from repro_torch import trace
    trace.reset_counters("thundering_")
    phase_sharded(device)
    phase_coalescer(device)
    phase_quality(device)
    launches = {k: trace.counter(f"{k}.launches")
                for k in ("thundering_ctr", "thundering_faithful")}
    plain_runs = (trace.counter("thundering_ctr_plain.cuda_runs")
                  + trace.counter("thundering_faithful_plain.cuda_runs"))
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
# a standing backlog of 8 bursts (a longer one would add to the whole
# run's time, which has a limit)
SERVICE_BACKLOG = 8192
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
    for the device's busy share; one digest each - then an 8192-request
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


def _responses_alike(label: str, reqs, got_of, want_of):
    """Each response of ``got_of`` against ``want_of``'s: bit for bit on
    the integer and threshold classes, within 8 ULP
    (``sampler.ulp_error``) on normal, exponential and gamma.  Returns
    (the bit-identical rids, the worst ULP per log class)."""
    import torch
    from repro_torch.core import sampler
    exact, worst = [], {}
    for r in reqs:
        got, want = (_response_tensor(got_of[r.rid]),
                     _response_tensor(want_of[r.rid]))
        require(got.dtype == want.dtype and got.shape == want.shape,
                f"{label}: {r.rid} is {got.dtype} {tuple(got.shape)}, plain "
                f"{want.dtype} {tuple(want.shape)}")
        cls = r.sampler.split("(")[0]
        if cls in SERVICE_LOG_STAGES:
            err = (float(sampler.ulp_error(got, want).max())
                   if got.numel() else 0.0)
            worst[cls] = max(worst.get(cls, 0.0), err)
            require(err <= SERVICE_ULP_SLACK, f"{label}: {r.rid} "
                    f"({r.sampler}) is {err} ULP off the plain version")
        else:
            require(torch.equal(got.reshape(-1).view(torch.uint8),
                                want.reshape(-1).view(torch.uint8)),
                    f"{label}: {r.rid} ({r.sampler}, {r.out_dtype}) "
                    f"differs from the plain version")
            exact.append(r.rid)
    return exact, worst


def _ulp_note(worst: dict) -> str:
    return (", ".join(f"{k} {v:.2f}" for k, v in sorted(worst.items()))
            + f" ULP (limit {SERVICE_ULP_SLACK:g})")


def phase_service_plain(device) -> None:
    """Kernel A at the service path's shapes against the plain version:
    the ``make service`` burst, with and without pools, served on the card
    and by a server on the CPU, where every block comes from the plain
    torch version (held to the reference by the CPU tests), compared
    response by response (``_responses_alike``).  This covers the pool
    windows, the class calls with their leaf offsets at their (rows, S)
    shapes and the S = 1 calls.  Runs before the path's counts are
    reset."""
    import torch
    from repro_torch.service.burst import make_requests
    reqs = make_requests(burst=SERVICE_BURST, tenants=SERVICE_TENANTS,
                         seed=0)
    for label, hot in (("no pools", ()), ("pools", SERVICE_HOT)):
        t0 = time.perf_counter()
        card = _serve_deterministic(device, hot, reqs)
        plain = _serve_deterministic(torch.device("cpu"), hot, reqs)
        exact, worst = _responses_alike(f"service plain check[{label}]",
                                        reqs, card, plain)
        log(f"service plain check[{label}]: {len(reqs)} responses on the "
            f"card against a CPU server's plain versions: {len(exact)} "
            f"integer / threshold responses bit-identical, log stages "
            f"within {_ulp_note(worst)}; {time.perf_counter() - t0:.1f} s")


def phase_service_path(device) -> dict:
    """The serving tier's path - the in-process server, its CLI and the
    shard fleet - with the block generators' launch counts set to 0 just
    before and read just after.  The CLI's and the shards' launches are
    their own processes'; this process's runs must launch kernel A."""
    from repro_torch import trace
    phase_service_plain(device)
    trace.reset_counters("thundering_")
    digest = phase_service(device)
    phase_service_cli(device, digest)
    phase_fleet(device)
    launches = {"thundering_ctr": trace.counter("thundering_ctr.launches")}
    plain_runs = (trace.counter("thundering_ctr_plain.cuda_runs")
                  + trace.counter("thundering_faithful_plain.cuda_runs"))
    log(f"service path: launches {launches}; thundering_faithful "
        f"{trace.counter('thundering_faithful.launches')} (the server opens "
        f"ctr channels only); plain versions run on the card: {plain_runs}")
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
SERVE_GEN = 16                # tokens: the whole run's time has a limit
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
# router probabilities of the MoE configs at smoke width on equal
# weights: the largest |card - CPU| over tokens whose rows were routed
# alike so far (``_flips_are_near_ties``).  An H100 gave 3.7e-4 for both
# MoE configs; the limit keeps a 5x margin over that
MOE_PROB_ATOL = 2e-3
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
    """Prefill the batch ``prompts`` (its (B, P) "tokens", and "frames"
    for an encoder-decoder) and decode ``gen`` - 1 steps; each step's
    input token is ``tokens[:, i]`` when given, else this run's own
    argmax.  Returns the (B, gen, V) float32 logits on the host and the
    tokens."""
    import torch
    from repro_torch.launch import serve as srv
    B, P = prompts["tokens"].shape
    logits, pcache = model.prefill(params, prompts)
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
    from repro_torch import trace
    from repro_torch.core import engine
    from repro_torch.core import stream as tstream
    t0 = time.perf_counter()
    before = trace.counter("thundering_ctr.launches")
    got = tstream.uniforms(s, (n,))
    took = trace.counter("thundering_ctr.launches") - before
    require(took == 1, f"kernel A draws: {label} took {took} launches")
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


def _param_chunk_draw(cfg, path: str, chunk: int, device) -> None:
    """Kernel A's draw of chunk ``chunk`` (of 2**28 elements; negative
    counts from the end) of ``cfg``'s parameter ``path`` at the counter
    ``common.trunc_normal`` gives it, against the plain version
    (``_draw_against_plain``)."""
    from repro_torch.core import stream as tstream
    from repro_torch.models import registry
    from repro_torch.models.common import PARAM_CHUNK, flatten, param_stream
    shape = flatten(registry.build(cfg, "meta").init(SERVE_SEED)[0])[path]
    n = math.prod(shape.shape)
    chunks = -(-n // PARAM_CHUNK)
    lo = (chunk % chunks) * PARAM_CHUNK
    s = tstream.advance(param_stream(SERVE_SEED, path, device), lo)
    _draw_against_plain(f"{cfg.name} ({cfg.n_layers} layers) {path} chunk "
                        f"{chunk} of {chunks} ({n} elements)", s,
                        min(PARAM_CHUNK, n - lo))


def phase_serve_draws(device) -> None:
    """Kernel A at the full-width serve path's shapes against the plain
    version: the chunks of ``SERVE_DRAWS`` at the counters
    ``common.trunc_normal`` gives them, and the prompts' uniforms of
    ``pipeline_for(...).batch_at(0)``.  Runs before the path's counts are
    reset."""
    from repro_torch.configs import get_config
    from repro_torch.core import stream as tstream
    from repro_torch.launch.train import pipeline_for
    cfg = get_config(SERVE_ARCH)
    for path, chunk in SERVE_DRAWS:
        _param_chunk_draw(cfg, path, chunk, device)
    pipe = pipeline_for(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_SEED,
                        device=device)
    _draw_against_plain(f"prompts ({SERVE_BATCH}, {SERVE_PROMPT + 1})",
                        tstream.derive(pipe._root, 0),
                        SERVE_BATCH * (SERVE_PROMPT + 1))


class _MoeRoutes:
    """While active, records each ``moe.route`` call: ``calls`` holds,
    per call, (the chosen experts (tokens, k) sorted, the (tokens, k) mask
    of choices dropped past the capacity, the group size, the router
    probabilities (tokens, E) in float32), tokens in the call's flat
    order."""

    def __enter__(self):
        from repro_torch.models import moe
        self._real = real = moe.route
        self.calls = []

        def recorded(probs, k, capacity):
            out = real(probs, k, capacity)
            self.calls.append((out[1].reshape(-1, k).sort(-1).values.cpu(),
                               (out[2] == probs.shape[-1] * capacity)
                               .reshape(-1, k).cpu(), probs.shape[1],
                               probs.reshape(-1, probs.shape[-1]).float()
                               .cpu()))
            return out
        moe.route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._real

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def _rows_routed_alike(a, b, rows: int):
    """(rows whose MoE routes agree in the two recordings, tokens routed
    differently): a row is left out when a token of a group it shares
    took another expert set in either run (that moves the group's
    capacity slots)."""
    import torch
    ok = torch.ones(rows, dtype=torch.bool)
    flipped = 0
    for (ea, _, gs, _), (eb, _, _, _) in zip(a, b):
        diff = (ea != eb).any(-1)
        group = diff.reshape(-1, gs).any(-1).repeat_interleave(gs)
        ok[(torch.arange(diff.numel()) // (diff.numel() // rows))[group]] = \
            False
        flipped += int(diff.sum())
    return ok, flipped


def _flips_are_near_ties(cpu, card, rows: int) -> dict:
    """Holds every token that the card routed otherwise than the CPU (the
    recordings of ``_MoeRoutes``) to a near-tie, at the first call where
    its group diverged: the gap between its k-th and (k+1)-th router
    probability on the CPU (the stable descending order of ``moe.top_k``)
    must be at most 2 eps, eps the call's largest |p_card - p_cpu| over
    the tokens whose rows were routed alike in every earlier call: two
    devices within eps of each other cannot swap a pair further apart.
    eps must stay within ``MOE_PROB_ATOL``.  Flips in rows that diverged
    earlier follow from that divergence and are only counted.  Returns
    {"flips", "held", "gap" (the largest held), "eps" (the largest)}."""
    import torch
    clean = torch.ones(rows, dtype=torch.bool)
    out = {"flips": 0, "held": 0, "gap": 0.0, "eps": 0.0}
    for i, ((ea, _, gs, pa), (eb, _, _, pb)) in enumerate(zip(cpu, card)):
        n, k = ea.shape
        row = torch.arange(n) // (n // rows)
        first = clean[row]
        eps = (float((pa - pb)[first].abs().max()) if bool(first.any())
               else 0.0)
        diff = (ea != eb).any(-1)
        held = diff & first
        if bool(held.any()):
            top = torch.sort(pa[held], dim=-1, descending=True,
                             stable=True).values
            gap = float((top[:, k - 1] - top[:, k]).max())
            require(gap <= 2 * eps, f"MoE call {i}: a token routed "
                    f"otherwise on the card has a top-{k} gap of {gap:.3g} "
                    f"on the CPU, more than 2 eps = {2 * eps:.3g}")
            out["gap"] = max(out["gap"], gap)
        out["flips"] += int(diff.sum())
        out["held"] += int(held.sum())
        out["eps"] = max(out["eps"], eps)
        group = diff.reshape(-1, gs).any(-1).repeat_interleave(gs)
        clean[row[group]] = False
    require(out["eps"] <= MOE_PROB_ATOL, f"MoE router probabilities "
            f"{out['eps']:.3g} from the CPU's (limit {MOE_PROB_ATOL})")
    return out


def _card_against_cpu(arch: str, device, label: str, **over) -> None:
    """``arch`` at ``launch.train.smoke_config`` width (scaled by ``over``,
    as a vlm's patch prefix must be to fit the prompt) on the card against
    the same code on the CPU (which the CPU tests hold against the
    reference): init within 8 ULP per parameter; prefill and decode
    logits on equal weights within ``SERVE_LOGIT_ATOL``; greedy tokens
    equal wherever the CPU's top-2 margin exceeds twice that.  An MoE row
    whose router chose another expert set on the card is counted and left
    out; at least half the rows must remain, and each flip must be a
    near-tie (``_flips_are_near_ties``: the two devices sum the router's
    products in other orders)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import pipeline_for, smoke_config
    from repro_torch.models import registry
    from repro_torch.models.common import flatten, unflatten
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cfg = smoke_config(get_config(arch)).scaled(**over)
    m_cpu, m_card = registry.build(cfg, cpu), registry.build(cfg, device)
    p_cpu = flatten(m_cpu.init(SERVE_SEED)[0])
    p_card = flatten(m_card.init(SERVE_SEED)[0])
    worst_ulp, exact_zero = 0, 0
    for path, want in p_cpu.items():
        got = p_card[path].cpu()
        if not want.any():
            require(not got.any(), f"{label}: {path} is not zero")
            exact_zero += 1
            continue
        worst_ulp = max(worst_ulp, int((_ordered_f32(got)
                                        - _ordered_f32(want)).abs().max()))
    require(worst_ulp <= SERVE_INIT_ULP, f"{label}: init is "
            f"{worst_ulp} ULP from the CPU's (limit {SERVE_INIT_ULP})")
    same = unflatten({k: v.to(device) for k, v in p_cpu.items()})
    B, P, G = 8, 32, 16
    prompts = pipeline_for(cfg, B, P, SERVE_SEED, device=cpu).batch_at(0)
    prompts.pop("labels")
    with _MoeRoutes() as on_cpu:
        want, toks = _greedy_teacher_forced(m_cpu, unflatten(p_cpu),
                                            prompts, G)
    with _MoeRoutes() as on_card:
        got, _ = _greedy_teacher_forced(
            m_card, same, {k: v.to(device) for k, v in prompts.items()}, G,
            tokens=toks)
    rows, flipped = _rows_routed_alike(on_cpu.calls, on_card.calls, B)
    ties = _flips_are_near_ties(on_cpu.calls, on_card.calls, B)
    got, want = got[rows], want[rows]
    err = float((got - want).abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * SERVE_LOGIT_ATOL
    agree = torch.argmax(got, -1) == torch.argmax(want, -1)
    log(f"{label} ({cfg.name} at smoke width {cfg.d_model}/{cfg.n_layers} "
        f"layers/V {cfg.vocab}{over or ''}): init within {worst_ulp} ULP of the CPU "
        f"({len(p_cpu) - exact_zero} drawn tensors, {exact_zero} zeros "
        f"exact); prefill + {G - 1} decode logits on equal weights max "
        f"|card - cpu| {err:.6f} (limit {SERVE_LOGIT_ATOL}); greedy tokens "
        f"equal at {int((agree & sure).sum())} of {int(sure.sum())} "
        f"positions with a top-2 margin > {2 * SERVE_LOGIT_ATOL} "
        f"({int(agree.sum())} of {agree.numel()} overall); MoE tokens "
        f"routed otherwise on the card {flipped}, {ties['held']} of them at "
        f"their group's first divergence, each a near-tie (largest top-k "
        f"gap {ties['gap']:.3g} <= 2 eps, eps = max |p_card - p_cpu| "
        f"{ties['eps']:.3g}, limit {MOE_PROB_ATOL}), rows held "
        f"{int(rows.sum())} of {B}; {time.perf_counter() - t0:.1f} s")
    require(2 * int(rows.sum()) >= B, f"{label}: {B - int(rows.sum())} of "
            f"{B} rows routed otherwise on the card")
    require(err <= SERVE_LOGIT_ATOL, f"{label}: logits {err} from the "
            f"CPU's")
    require(bool(agree[sure].all()), f"{label}: a greedy token with a "
            f"clear margin differs from the CPU's")


def phase_serve_plain(device) -> None:
    """The serving path at smoke width on the card against the CPU
    (``_card_against_cpu``).  Runs before the path's counts are reset."""
    _card_against_cpu(SERVE_ARCH, device, "serve plain check")


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


def phase_serve_cli(device, want: str, arch: str = SERVE_ARCH) -> None:
    """``python -m repro_torch.launch.serve --arch arch`` at full width in
    a subprocess: its 8 tokens per row give the in-process run's digest of
    the first 8 steps."""
    import os
    _free_card()
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            arch, "--batch", str(SERVE_BATCH), "--prompt-len",
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
    log(f"serve CLI ({arch}, gen {SERVE_CLI_GEN}, subprocess): digest "
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


def _serve_profile(model, params, device, prompt: int = SERVE_PROMPT) -> None:
    """Prefill the pipeline's batch at (64, ``prompt``) (with a vlm's
    patches), then 8 fused decode steps under ``torch.profiler``: the
    device's busy share over the steps, kernel F's share, device time by
    kind and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve as srv
    from repro_torch.launch.train import pipeline_for
    cfg = model.cfg
    prompts = pipeline_for(cfg, SERVE_BATCH, prompt, SERVE_SEED,
                           device=device).batch_at(0)
    prompts.pop("labels")
    P, G = prompt, SERVE_PROFILE_STEPS
    logits, pcache = model.prefill(params, prompts)
    cache = srv._graft(cfg, model.init_cache(SERVE_BATCH, P + G), pcache, P)
    del pcache, prompts
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
    log(f"serve profile ({cfg.name}, {cfg.n_layers} layers, {G} fused "
        f"decode steps at (B, V) = "
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


def phase_serve_path(device, measured: dict) -> dict:
    """Kernel A at the path's draw shapes and the smoke width on the card
    against the plain versions; then the model serving path at gemma-7b's
    full width through the user entry point ``launch.serve.serve``:
    temperature 0.8 on the fused path (kernel F every step) twice - equal
    tokens - then on the card's two-pass path (kernel A noise, plain
    argmax) - the same tokens - and greedy (no sampler, no leases), with
    kernel A and F's counts set to 0 just before and read just after; then
    ``python -m repro_torch.launch.serve`` in a subprocess, decode against
    forward at full width and the profile of decode steps.  Each run's
    peak memory goes into ``measured[(arch, "serve")]``."""
    import numpy as np
    import torch
    from repro_torch import trace
    from repro_torch.configs import get_config
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
    trace.reset_counters(("thundering_", "fused_argmax"))
    runs = {}
    for label, temp, path in (("fused", SERVE_TEMPERATURE, "fused"),
                              ("fused again", SERVE_TEMPERATURE, "fused"),
                              ("two-pass", SERVE_TEMPERATURE, "cuda"),
                              ("greedy", 0.0, "fused")):
        _free_card()
        torch.cuda.reset_peak_memory_stats(device)
        f0 = trace.counter("fused_argmax.launches")
        toks, stats = srv.serve(cfg, temperature=temp, sampler_path=path,
                                **kw)
        peak = torch.cuda.max_memory_allocated(device)
        measured.setdefault((SERVE_ARCH, "serve"), []).append(peak)
        runs[label] = toks
        _serve_report(label, toks, stats, peak)
        require(toks.shape == (SERVE_BATCH, SERVE_GEN)
                and toks.dtype == np.int32 and toks.min() >= 0
                and toks.max() < cfg.vocab, f"serve[{label}]: tokens "
                f"{toks.shape} {toks.dtype} outside [0, {cfg.vocab})")
        require(peak < total, f"serve[{label}]: peak {peak} >= {total}")
        f_launches = trace.counter("fused_argmax.launches") - f0
        if temp > 0:
            require(stats["sampler_calls_per_step"] == 1.0,
                    f"serve[{label}]: {stats['sampler_calls_per_step']} "
                    f"sampler calls per step")
            require(f_launches == (SERVE_GEN if path == "fused" else 0),
                    f"serve[{label}]: kernel F launched {f_launches} times")
        else:
            require("sampler_calls_per_step" not in stats and
                    f_launches == 0, "greedy serving drew randomness")
    launches = {"thundering_ctr": trace.counter("thundering_ctr.launches"),
                "gumbel_argmax": trace.counter("fused_argmax.launches")}
    plain_runs = (trace.counter("fused_argmax_plain.cuda_runs")
                  + trace.counter("thundering_ctr_plain.cuda_runs")
                  + trace.counter("thundering_faithful_plain.cuda_runs"))
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
# v (all 28 would need ~137 GB); the loop-and-checkpoint runs take 1 layer
# (1.06e9 parameters, a 12.7 GB checkpoint: the whole run's time has a
# limit)
TRAIN_LAYERS, TRAIN_LOOP_LAYERS = 8, 1
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
DIGEST_PIECE = 1 << 28      # bytes of a leaf one digest task hashes


def _tree_digest(tree) -> str:
    """sha256 over each leaf's path and the sha256s of its bytes in
    ``DIGEST_PIECE``-byte pieces, in sorted path order; 8 threads copy
    the pieces to the host (through pinned buffers from the card) and hash
    them (hashlib releases the GIL), so one large leaf is hashed by all
    of them."""
    import hashlib
    import queue
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from repro_torch.models.common import flatten
    flat = sorted(flatten(tree).items())
    pieces = []
    for path, t in flat:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        pieces += [(path, b[lo:lo + DIGEST_PIECE])
                   for lo in range(0, max(b.numel(), 1), DIGEST_PIECE)]
    bufs = queue.SimpleQueue()
    for _ in range(8):
        bufs.put(torch.empty(DIGEST_PIECE, dtype=torch.uint8,
                             pin_memory=pieces[0][1].is_cuda))

    def piece(b):
        buf = bufs.get()
        try:
            host = buf[:b.numel()]
            host.copy_(b)
            return hashlib.sha256(host.numpy()).digest()
        finally:
            bufs.put(buf)

    with ThreadPoolExecutor(8) as ex:
        digests = list(ex.map(piece, [b for _, b in pieces]))
    h = hashlib.sha256()
    for (path, _), d in zip(pieces, digests):
        h.update(path.encode())
        h.update(d)
    return h.hexdigest()


def _trained_shape(arch: str) -> dict:
    """The shape at which the train paths train ``arch`` at full width:
    the depth trained (``layers``), the reference CLI's ``batch`` and
    ``seq`` (a vlm's: its patch prefix + ``TRAIN_VLM_TEXT`` text
    positions, as it refuses a shorter one) and the batch's ``extras``
    {name: shape}, a vlm's patches or an encdec's frames."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    seq = (cfg.vision_prefix + TRAIN_VLM_TEXT if cfg.vision_prefix
           else TRAIN_SEQ)
    layers = (TRAIN_LAYERS if arch == TRAIN_ARCH else
              {**TRAIN_FAMILY_LAYERS, **TRAIN_LARGE_LAYERS}[arch])
    return dict(layers=layers, batch=TRAIN_BATCH, seq=seq,
                extras={k: tuple(v.shape) for k, v in
                        _extra_inputs(cfg, TRAIN_BATCH).items()})


def _trained_cfg(arch: str, layers: int = 0):
    """``arch``'s published config cut to ``layers`` (default: the depth
    trained)."""
    from repro_torch.configs import get_config
    return get_config(arch).scaled(
        n_layers=layers or _trained_shape(arch)["layers"])


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
    from repro_torch.core import stream as tstream
    from repro_torch.launch.train import pipeline_for
    cfg = _trained_cfg(TRAIN_ARCH)
    _param_chunk_draw(cfg, "layers/wg", -1, device)
    pipe = pipeline_for(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED,
                        device=device)
    _draw_against_plain(f"train batch of step 3 ({TRAIN_BATCH}, "
                        f"{TRAIN_SEQ + 1})", tstream.derive(pipe._root, 3),
                        TRAIN_BATCH * (TRAIN_SEQ + 1))


def _train_run(cfg, device, seq: int, name: str, **kw):
    """``train`` for ``TRAIN_STEPS`` steps at ``cfg``, batch
    ``TRAIN_BATCH`` x ``seq``, on ``device``, checkpointing every 2 steps
    into ``TRAIN_DIR / name`` (removed before and after), ``kw`` passed
    on.  Returns (its parameters, its losses logged every step)."""
    import contextlib
    import io
    import shutil
    from repro_torch.launch.train import train
    d = TRAIN_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    with contextlib.redirect_stdout(io.StringIO()):
        params, _, logged = train(
            cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=seq,
            ckpt_dir=str(d), save_every=2, seed=TRAIN_SEED, log_every=1,
            device=device, **kw)
    shutil.rmtree(d, ignore_errors=True)
    return params, logged


def _train_smoke(arch: str, device, seq: int, **over):
    """``train`` for ``TRAIN_STEPS`` steps at ``smoke_config(arch)``
    (scaled by ``over``), batch ``TRAIN_BATCH`` x ``seq``, on the card and
    on the CPU: losses within ``TRAIN_LOSS_ATOL`` and parameters within
    the schedule's bound of each other.  Returns (the config, the card
    run's parameters, its losses, logged every step)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import smoke_config
    from repro_torch.models.common import flatten
    t0 = time.perf_counter()
    cfg = smoke_config(get_config(arch)).scaled(**over)
    (pc, lc), (pp, lp) = (
        _train_run(cfg, dev, seq, f"smoke_{arch}_{i}")
        for i, dev in enumerate((device, torch.device("cpu"))))
    loss_err = max(abs(a - b) for (_, a), (_, b) in zip(lc, lp))
    fc, fp = flatten(pc), flatten(pp)
    p_err = max(float((fc[k].cpu() - fp[k]).abs().max()) for k in fp)
    bound = _step_bound(TRAIN_STEPS)
    log(f"train smoke {arch} ({cfg.d_model}/{cfg.n_layers} layers/V "
        f"{cfg.vocab}{over or ''}, batch {TRAIN_BATCH} x {seq}, "
        f"{TRAIN_STEPS} steps) card vs cpu: losses "
        f"{[round(l, 6) for _, l in lc]}, max |diff| {loss_err:.3g} (limit "
        f"{TRAIN_LOSS_ATOL}); params max |diff| {p_err:.3g} (limit "
        f"{bound:.3g}, 2 lr a step); {time.perf_counter() - t0:.1f} s")
    require(len(lc) == len(lp) == TRAIN_STEPS
            and [s for s, _ in lc] == [s for s, _ in lp],
            f"train smoke {arch}: the runs logged different steps")
    require(loss_err <= TRAIN_LOSS_ATOL, f"train smoke {arch}: card losses "
                                         f"differ from the CPU's")
    require(p_err <= bound, f"train smoke {arch}: card params differ from "
                            f"the CPU's beyond the schedule's bound")
    return cfg, pc, lc


class _TrainCli:
    """``python -m repro_torch.launch.train --arch arch --smoke`` in a
    subprocess on the card, started on entry, so that its start-up and
    smoke-width steps run beside the caller's untimed checks; ``check``
    waits for it: its loss lines equal the in-process card run's
    (``_train_smoke``) and its final checkpoint holds the same parameters
    bit for bit.  Exit stops it if it still runs."""

    def __init__(self, arch: str, seq: int):
        self.arch, self.seq = arch, seq
        self.dir = TRAIN_DIR / f"cli_{arch}"

    def __enter__(self):
        import os
        import shutil
        shutil.rmtree(self.dir, ignore_errors=True)
        args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                self.arch, "--smoke", "--steps", str(TRAIN_STEPS),
                "--save-every", "2", "--global-batch", str(TRAIN_BATCH),
                "--seq-len", str(self.seq), "--seed", str(TRAIN_SEED),
                "--ckpt-dir", str(self.dir)]
        env = dict(os.environ, PYTHONPATH=str(SRC))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(args, env=env, cwd=ROOT, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE)
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()

    def check(self, params, losses) -> None:
        import shutil
        import torch
        from repro_torch.checkpoint import load_checkpoint
        from repro_torch.models.common import flatten
        arch = self.arch
        stdout, stderr = self.proc.communicate(timeout=600)
        require(self.proc.returncode == 0, f"the train CLI ({arch}) failed: "
                f"{stderr[-2000:]}")
        cli_lines = re.findall(r"^step .*$", stdout, re.M)
        # the CLI logs every 10th step and the first 3
        want = [f"step {s:5d} loss {l:.4f}" for s, l in losses
                if s < 3 or s % 10 == 0]
        fc = flatten(params)
        tree, step, _ = load_checkpoint(str(self.dir),
                                        device=next(iter(fc.values())).device)
        same = all(torch.equal(flatten(tree["params"])[k].view(torch.int32),
                               fc[k].view(torch.int32)) for k in fc)
        shutil.rmtree(self.dir, ignore_errors=True)
        log(f"train CLI {arch} (subprocess): {cli_lines} == in-process "
            f"{cli_lines == want}; step-{step} checkpoint params bit-equal "
            f"to the in-process card run's: {same}; "
            f"{stdout.strip().splitlines()[-1]}; "
            f"{time.perf_counter() - self.t0:.1f} s from its start")
        require(cli_lines == want, f"the train CLI's loss lines ({arch}) "
                                   f"differ from the in-process run's")
        require(step == TRAIN_STEPS and same, f"the train CLI's parameters "
                                              f"({arch}) differ from the "
                                              f"in-process run's")


def _train_profile(step_fn, params, opt, batch, step, device,
                   label: str) -> None:
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
        log(f"train profile ({label}): not measured (the profiler recorded "
            f"no device time)")
        return
    log(f"train profile ({label}, one full-width step): wall "
        f"{wall_us / 1e3:.1f} ms; device busy {busy / 1e3:.1f} ms = "
        f"{busy / wall_us * 100:.1f} % (idle "
        f"{100 - busy / wall_us * 100:.1f} %)")
    for kind, us in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"  device time {kind}: {us / 1e3:.1f} ms "
            f"({us / busy * 100:.1f} % of busy)")
    for us, key, count in sorted(top, reverse=True)[:12]:
        log(f"  top kernel {us / 1e3:.2f} ms x{count}: {key[:110]}")


class _StepWatch:
    """While active, wraps the AdamW update that ``make_train_step``'s
    step calls once its gradients are in: with ``check`` set, the next
    call lists in ``nonfinite`` each gradient leaf holding a NaN or an
    inf; every call records CUDA events at its start and end
    (``update``), which split the step into fwd + bwd and the update."""

    def __init__(self):
        self.check, self.nonfinite, self.update = False, None, None

    def __enter__(self):
        import torch
        from repro_torch.launch import steps
        from repro_torch.models.common import flatten
        self._real = real = steps.adamw_update

        def watched(grads, opt_state, params, **kw):
            if self.check:
                self.check = False
                # the max norm is NaN or inf where an element is, and
                # takes no leaf-sized temporary (isfinite would)
                self.nonfinite = [
                    k for k, g in flatten(grads).items()
                    if not bool(torch.isfinite(torch.linalg.vector_norm(
                        g, float("inf"))))]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(grads, opt_state, params, **kw)
            end.record()
            self.update = (start, end)
            return out
        steps.adamw_update = watched
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import steps
        steps.adamw_update = self._real


def _train_full(arch: str, device, measured: dict, steps: int,
                profile: bool) -> None:
    """``arch`` at published width, cut to the depth ``_trained_shape``
    gives, through ``make_train_step`` with ``adamw_init``: ``steps``
    steps, twice from one seed - equal sha256 digests of the parameters;
    every gradient of step 0 finite; step 0's chunked, remat'd loss
    against ``model.forward`` + the unchunked ``softmax_xent`` (+ the
    weighted aux loss) at step 0's rng; for an MoE, the choices step 0's
    forward dropped past the capacity.  Reports init s, step s (p50 of
    steps 1 on), tokens/s, peak memory (into ``measured[(arch,
    "train")]``), the last step's fwd + bwd / update split (CUDA events)
    and, with ``profile``, one more step under the profiler."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import stream as tstream
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import pipeline_for
    from repro_torch.models import layers as L
    from repro_torch.models import registry
    from repro_torch.models.common import flatten
    from repro_torch.optim import adamw_init
    shape = _trained_shape(arch)
    B, S = shape["batch"], shape["seq"]
    cfg = _trained_cfg(arch)
    tag = f"{arch} ({cfg.n_layers} layers)"
    model = registry.build(cfg, device)
    pipe = pipeline_for(cfg, B, S, TRAIN_SEED, device=device)
    rng0 = tstream.derive(tstream.new_stream(TRAIN_SEED, 0xD07,
                                             device=device), 0)
    digests, step_s, init_s, peaks = [], [], [], []
    with _StepWatch() as watch:
        for run in range(2):
            _free_card()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            params, _ = model.init(TRAIN_SEED)
            sync(device)
            init_s.append(time.perf_counter() - t0)
            if run == 0:
                n = sum(p.numel() for p in flatten(params).values())
                extras = "".join(f", {k} {v}"
                                 for k, v in shape["extras"].items())
                log(f"train full width: {cfg.name} [{cfg.family}] d_model "
                    f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.n_layers} of "
                    f"{get_config(arch).n_layers} layers: {n} parameters "
                    f"({n * 16 / 1e9:.1f} GB of float32 params, grads, m, "
                    f"v); batch {B} x {S}{extras}")
                with torch.no_grad():
                    b0 = pipe.batch_at(0)
                    logits, aux = model.forward(params, b0, rng0)
                    whole = float(L.softmax_xent(logits, b0["labels"])
                                  + registry.AUX_WEIGHT * aux)
                    del logits
            opt = adamw_init(params)
            step_fn = steps_mod.make_train_step(model, seed=TRAIN_SEED,
                                                total_steps=steps)
            losses, times = [], []
            for s in range(steps):
                batch = pipe.batch_at(s)
                first = run == 0 and s == 0
                watch.check = first
                routes = (_MoeRoutes() if first and cfg.family == "moe"
                          else contextlib.nullcontext())
                sync(device)
                t0 = time.perf_counter()
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                with routes as drops:
                    params, opt, met = step_fn(params, opt, batch, s)
                losses.append(float(met["loss"]))
                sync(device)
                times.append(time.perf_counter() - t0)
                if first:
                    log(f"train {tag} step 0: gradient leaves not finite "
                        f"{watch.nonfinite} (of {len(flatten(params))})")
                    require(watch.nonfinite == [], f"train {tag}: step 0 "
                            f"has non-finite gradients {watch.nonfinite}")
                if drops is not None:
                    masks = [c[1] for c in drops.calls[:cfg.n_layers]]
                    log(f"train {tag} step 0: (token, choice) pairs dropped "
                        f"past the capacity in the forward "
                        f"{sum(int(m.sum()) for m in masks)} of "
                        f"{sum(m.numel() for m in masks)} over "
                        f"{len(masks)} layers")
            peaks.append(torch.cuda.max_memory_allocated(device))
            t0 = time.perf_counter()
            digests.append(_tree_digest(params))
            step_s.extend(times[1:])
            log(f"train {tag} run {run}: init {init_s[-1]:.3f} s; step s "
                f"{[round(t, 4) for t in times]}; losses {losses}; peak "
                f"{peaks[-1] / 2 ** 30:.2f} GiB; params sha256 "
                f"{digests[-1][:16]} ({time.perf_counter() - t0:.1f} s)")
            if run == 0:
                err = abs(losses[0] - whole)
                log(f"train {tag} step 0 loss {losses[0]:.6f} (chunked, "
                    f"remat) vs forward + unchunked xent {whole:.6f}: |diff| "
                    f"{err:.3g} (limit {TRAIN_UNCHUNKED_ATOL})")
                require(err <= TRAIN_UNCHUNKED_ATOL, f"train {tag}: step "
                        f"0's chunked loss differs from the unchunked one")
            require(all(np.isfinite(losses)), f"train {tag}: a non-finite "
                                              f"loss")
            if run == 1:
                upd0, upd1 = watch.update
                log(f"train {tag} step {steps - 1} split: fwd + bwd "
                    f"{start.elapsed_time(upd0):.1f} ms, AdamW update "
                    f"{upd0.elapsed_time(upd1):.1f} ms (CUDA events)")
                if profile:
                    _train_profile(step_fn, params, opt,
                                   pipe.batch_at(steps), steps, device, tag)
            del params, opt
    measured[(arch, "train")] = list(peaks)
    p50 = float(np.percentile(step_s, 50))
    total = torch.cuda.get_device_properties(device).total_memory
    log(f"train full width {tag}: init {min(init_s):.3f}-"
        f"{max(init_s):.3f} s; step p50 {p50:.4f} s (steps 1-{steps - 1} "
        f"of 2 runs) = {B * S / p50:.0f} tokens/s; peak memory "
        f"{max(peaks) / 2 ** 30:.2f} GiB of {total / 2 ** 30:.1f}; digests "
        f"equal {digests[0] == digests[1]} ({card_line()})")
    require(digests[0] == digests[1], f"train {tag}: two runs from one "
                                      f"seed gave different parameters")


def _require_train_peaks(measured: dict, archs) -> None:
    """Each of ``archs``' full-width train peaks at most
    ``TRAIN_PEAK_GIB`` (checked once all have run, so that one config's
    failure does not hide the others' peaks)."""
    for arch in archs:
        peak = max(measured[(arch, "train")]) / 2 ** 30
        require(peak <= TRAIN_PEAK_GIB, f"train {arch}: peak memory "
                f"{peak:.2f} GiB above {TRAIN_PEAK_GIB} GiB")


def _kernel_a_launches(path: str) -> dict:
    """Kernel A's launches since the last ``trace.reset_counters``, on a path
    whose kernel is kernel A alone: at least one, and no plain version run
    on a CUDA tensor."""
    from repro_torch import trace
    launches = {"thundering_ctr": trace.counter("thundering_ctr.launches")}
    plain_runs = (trace.counter("thundering_ctr_plain.cuda_runs")
                  + trace.counter("thundering_faithful_plain.cuda_runs"))
    log(f"{path} path: launches {launches}; plain versions run on the "
        f"card: {plain_runs}")
    require(launches["thundering_ctr"] > 0, f"kernel A never launched on "
                                            f"the {path} path")
    require(plain_runs == 0, "a plain version ran on a CUDA tensor")
    return launches


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
    cfg = _trained_cfg(TRAIN_ARCH, TRAIN_LOOP_LAYERS)
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


def phase_train_path(device, measured: dict) -> dict:
    """The training substrate: AdamW and kernel A at the path's shapes
    against the plain versions on the CPU / card first, then the smoke
    width on the card against the CPU and the CLI (a subprocess started
    first, which runs beside these checks), then - kernel A's
    counts set to 0 just before and read just after - gemma-7b at full
    width: 8 layers through ``make_train_step`` (``_train_full``, with a
    profiled step), 1 layer through ``train`` with its loop and
    checkpoints."""
    from repro_torch import trace
    with _TrainCli(TRAIN_ARCH, TRAIN_SEQ) as cli:
        phase_train_adamw(device)
        phase_train_draws(device)
        _, params, losses = _train_smoke(TRAIN_ARCH, device, TRAIN_SEQ)
        cli.check(params, losses)
    del params
    trace.reset_counters("thundering_")
    _train_full(TRAIN_ARCH, device, measured, TRAIN_STEPS, profile=True)
    _require_train_peaks(measured, [TRAIN_ARCH])
    phase_train_loop(device)
    return _kernel_a_launches("train")


# ---------------------------------------------------------------------------
# the families path: the moe, ssm, hybrid and encdec configs served
# unmodified through kernels A and F
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("olmoe_1b_7b", "granite_moe_3b", "mamba2_2p7b", "zamba2_7b",
                "whisper_small")
FAMILY_GEN = 8      # tokens: the whole run's time has a limit
FAMILY_CLI_ARCH = "mamba2_2p7b"
FAMILY_PROFILE_ARCHS = ("olmoe_1b_7b", "mamba2_2p7b")
# decode against forward at the published width: 8 rows x 16 positions.
# Forward groups an MoE layer's tokens 4 at a time and decode 2 at a
# time, each with capacity 1 per expert at olmoe's 64 experts x top-8:
# at the published capacity factor every position drops a choice in one
# of the two, and the two drop different ones by design (on an H100 the
# served prompts dropped 52 % of their prefill choices).  So the check
# raises the capacity factor to E / k, where no choice drops, and holds
# every position
FAMILY_ROWS = 8
# kernel A at the path's draw shapes: olmoe's expert matrix (the largest
# tensor of the five configs) in its first and its ragged last 2^28 chunk
FAMILY_DRAWS = (("olmoe_1b_7b", "layers/moe_wg", 0),
                ("olmoe_1b_7b", "layers/moe_wg", -1))


def phase_families_draws(device) -> None:
    """Kernel A against its plain version, bit for bit, at the path's
    draw shapes: ``FAMILY_DRAWS`` at the counters ``common.trunc_normal``
    gives them, and the uniforms under whisper-small's (64, 1500, 768)
    frames of ``pipeline_for(...).batch_at(0)``."""
    from repro_torch.configs import get_config
    from repro_torch.core import stream as tstream
    from repro_torch.launch.train import pipeline_for
    for arch, path, chunk in FAMILY_DRAWS:
        _param_chunk_draw(get_config(arch), path, chunk, device)
    cfg = get_config("whisper_small")
    pipe = pipeline_for(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_SEED,
                        device=device)
    est = tstream.derive(tstream.derive(pipe._root, 0), 0xE57A)
    _draw_against_plain(f"whisper frames ({SERVE_BATCH}, {cfg.enc_ctx}, "
                        f"{cfg.d_model})", est,
                        SERVE_BATCH * cfg.enc_ctx * cfg.d_model)


def _sampler_against_plain(arch: str, V: int, device, gen) -> float:
    """Kernel F against its plain version at (V, 64) (every (inv_temp,
    top_k) option, both decorrelators, counters below and past 2**32 and a
    window ending where the counter wraps; an odd vocabulary ends in a
    ragged V tile), then its time there (CUDA events; its device time and
    launches per call under the profiler) beside its bound and torch's
    Philox Gumbel-max on the same logits.  Returns the CUDA-event ms."""
    import torch
    from repro_torch.inference.kernels import gumbel_argmax as ga
    B = SERVE_BATCH
    logits, h, x0 = _ga_case(V, B, device)
    for inv_temp, top_k in INF_OPTIONS:
        th = (torch.topk(logits, top_k, dim=-1).values[:, -1] if top_k
              else torch.full((B,), float("-inf"), device=device))
        for deco in ("splitmix64", "fmix32"):
            for ctr in (977, 2 ** 32 + 12345, 2 ** 64 - V):
                _ga_check(f"{arch} (V, B) = ({V}, {B}) inv_temp "
                          f"{inv_temp} top_k {top_k} {deco} ctr {ctr}",
                          logits, h, x0, ctr, th, inv_temp, deco)
    th = torch.full((B,), float("-inf"), device=device)
    out = torch.empty(B, dtype=torch.int32, device=device)

    def call():
        ga.fused_argmax(logits, h, x0, 977, th, inv_temp=1.0, out=out)
    ms = time_cuda(call, reps=50)
    prof = _ga_device(call)
    b_ms, b_by, _, _ = _ga_bound(V, B)
    old_ms = _ga_bound(V, B, GA_OPS_PER_ELEMENT_ATOMIC)[0]
    lib_ms = _philox_gumbel_ms(logits, gen)
    log(f"kernel F at {arch}'s (V, B) = ({V}, {B}): equal to the plain "
        f"version ({len(INF_OPTIONS)} options x 2 decorrelators x 3 "
        f"counters); {ms:.4f} "
        f"ms, bound {b_ms:.4f} ms by {b_by} ({b_ms / ms * 100:.1f}% of "
        f"the bound's speed; the earlier design's count: "
        f"{old_ms:.4f} ms, {old_ms / ms * 100:.1f}%); {prof}; torch "
        f"Philox gumbel-max {lib_ms:.4f} ms ({card_line()})")
    return ms


def phase_families_sampler(device) -> None:
    """``_sampler_against_plain`` at each family config's vocabulary."""
    import torch
    from repro_torch.configs import get_config
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    for arch in FAMILY_ARCHS:
        _sampler_against_plain(arch, get_config(arch).vocab, device, gen)


class _KvStored:
    """While active, ``layers.attention`` attends to K and V as a KV cache
    of ``dtype`` stores them (``layers.cast`` to ``dtype`` and back), the
    values decode reads back from such a cache."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __enter__(self):
        from repro_torch.models import layers as L
        self._real = real = L.attention
        dtype = self.dtype

        def stored(q, k, v, **kw):
            return real(q, L.cast(k, dtype).to(k.dtype),
                        L.cast(v, dtype).to(v.dtype), **kw)
        L.attention = stored
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.attention = self._real


def _decode_vs_forward_logits(cut, params, device):
    """(decode logits, forward's at the same positions, MoE (token,
    choice) pairs dropped in either, the prefix P0) of ``cut`` on
    ``FAMILY_ROWS`` x 16 positions.  Forward attends to K and V as the
    cache stores them (``_KvStored``; with a bf16 cache they are
    unchanged).  Decode takes no patches, so a vlm first prefills its
    patch prefix and ``VLM_TEXT`` text positions, grafts that cache and
    decodes the 16 positions after it; forward runs over the whole
    sequence with the same patches."""
    import torch
    from repro_torch.launch import serve as srv
    from repro_torch.launch.train import pipeline_for
    from repro_torch.models import registry
    model = registry.build(cut, device)
    R, S = FAMILY_ROWS, SERVE_POSITIONS
    P0 = cut.vision_prefix + VLM_TEXT if cut.family == "vlm" else 0
    batch = pipeline_for(cut, R, P0 + S, SERVE_SEED,
                         device=device).batch_at(0)
    batch.pop("labels")
    toks = batch["tokens"]
    with _MoeRoutes() as drops:
        with _KvStored(registry._kv_dt(cut)):
            full, _ = model.forward(params, batch)
        full = full[:, P0:].clone()
        fwd = drops.take()
        cache = model.init_cache(R, P0 + S)
        if cut.family == "encdec":     # cross K/V from a 1-token prefill
            pc = model.prefill(params, dict(batch, tokens=toks[:, :1]))[1]
            cache = cache[:2] + pc[2:]
            drops.take()
        if P0:                         # the patch prefix and text after it
            pc = model.prefill(params, dict(batch, tokens=toks[:, :P0]))[1]
            cache = srv._graft(cut, cache, pc, P0)
            del pc
        dec = []
        for pos in range(P0, P0 + S):
            lg, cache = model.decode(params, cache, toks[:, pos:pos + 1], pos)
            dec.append(lg)
        steps = drops.take()
    require(P0 >= cut.vision_prefix, f"{cut.name}: a decode position lies "
            f"inside the patch prefix")
    pairs = sum(int(c[1].sum()) for c in fwd + steps)
    return torch.stack(dec, 1), full, pairs, P0


def _family_decode_vs_forward(cfg, device) -> None:
    """Decode logits against forward's (``_decode_vs_forward_logits``) at
    the published width, cut to 2 layers (zamba2: its first group of
    ``attn_every`` mamba layers with the shared block, and one trailing
    layer; an MoE config with its capacity factor raised to E / k, so
    that no choice drops): within the reference's slack (atol 0.15, rtol
    0.05) at every position.  A float8 cache rounds K and V to 3 mantissa
    bits, which leaves that slack around a forward over unrounded K and V
    (the reference's own decode test leaves its float8 config out,
    tests/test_models.py::test_decode_matches_forward); forward attends to
    K and V as the cache stores them, so the float8 decode is held too."""
    import torch
    from repro_torch.models import registry
    t0 = time.perf_counter()
    depth = cfg.attn_every + 1 if cfg.family == "hybrid" else 2
    cut = cfg.scaled(n_layers=depth, enc_layers=min(cfg.enc_layers, 2))
    if cfg.family == "moe":
        cut = cut.scaled(capacity_factor=cfg.n_experts / cfg.top_k)
    params, _ = registry.build(cut, device).init(SERVE_SEED)
    dec, full, pairs, P0 = _decode_vs_forward_logits(cut, params, device)
    excess = _excess(dec, full)
    finite = bool(torch.isfinite(dec).all() and torch.isfinite(full).all())
    notes = "".join(
        (f", capacity factor {cut.capacity_factor:g}" if cut.n_experts
         else "", f", KV cache {cut.kv_dtype} (forward's K and V rounded "
         f"alike)" if cut.kv_dtype != "bf16" else "",
         f", {FAMILY_ROWS} rows x {SERVE_POSITIONS} positions",
         f" after a {P0}-token prefill over {cut.vision_prefix} patches"
         if P0 else ""))
    log(f"  decode vs forward ({cfg.name}, {depth} layers at full width"
        f"{notes}, logits up to "
        f"{float(full.abs().max()):.3f}): dropped (token, choice) pairs "
        f"{pairs}; max |decode - forward| {float((dec - full).abs().max()):.5f}"
        f", excess over the slack {excess:.5f} (limit {SERVE_SLACK_ATOL}); "
        f"finite {finite}; {time.perf_counter() - t0:.1f} s")
    require(finite, f"{cfg.name}: non-finite logits in decode against "
            f"forward")
    require(pairs == 0, f"{cfg.name}: {pairs} choices dropped in decode "
            f"against forward")
    require(excess <= SERVE_SLACK_ATOL, f"{cfg.name}: decode logits leave "
            f"the reference's slack around forward's")


def phase_families_serve(device, measured: dict) -> dict:
    """Each of ``FAMILY_ARCHS`` unmodified through ``launch.serve.serve``
    at batch 64, prompt 128, 8 tokens, temperature 0.8 on the fused
    path, twice (equal tokens; olmoe also two-pass and greedy), with
    kernel A and F's counts set to 0 just before and read just after;
    then decode against forward at 2 layers of each published width.
    Each run's peak memory goes into ``measured[(arch, "serve")]``.
    Returns the counts and the in-process tokens of each arch."""
    import numpy as np
    import torch
    from repro_torch import trace
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as srv
    from repro_torch.models import registry
    from repro_torch.models.common import flatten
    total = torch.cuda.get_device_properties(device).total_memory
    kw = dict(batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, gen=FAMILY_GEN,
              seed=SERVE_SEED, device=device)
    trace.reset_counters(("thundering_", "fused_argmax"))
    fused = {}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        shapes = flatten(registry.build(cfg, "meta").init(0)[0])
        n_params = sum(v.numel() for v in shapes.values())
        log(f"families: {cfg.name} [{cfg.family}] unmodified ({cfg.n_layers} "
            f"layers, d_model {cfg.d_model}, vocab {cfg.vocab}): {n_params} "
            f"parameters, {n_params * 4 / 1e9:.1f} GB in float32; batch "
            f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, {FAMILY_GEN} tokens")
        runs = [("fused", SERVE_TEMPERATURE, "fused"),
                ("fused again", SERVE_TEMPERATURE, "fused")]
        if arch == "olmoe_1b_7b":
            runs += [("two-pass", SERVE_TEMPERATURE, "cuda"),
                     ("greedy", 0.0, "fused")]
        toks_of = {}
        for label, temp, path in runs:
            _free_card()
            torch.cuda.reset_peak_memory_stats(device)
            f0 = trace.counter("fused_argmax.launches")
            with _MoeRoutes() as drops:
                toks, stats = srv.serve(cfg, temperature=temp,
                                        sampler_path=path, **kw)
            peak = torch.cuda.max_memory_allocated(device)
            measured.setdefault((arch, "serve"), []).append(peak)
            toks_of[label] = toks
            _serve_report(f"{arch} {label}", toks, stats, peak)
            if drops.calls and label == "fused":
                masks = [c[1] for c in drops.calls]
                pre, dec = masks[:cfg.n_layers], masks[cfg.n_layers:]
                log(f"  {arch}: dropped (token, choice) pairs past the "
                    f"capacity: prefill {sum(int(m.sum()) for m in pre)} of "
                    f"{sum(m.numel() for m in pre)}, decode "
                    f"{sum(int(m.sum()) for m in dec)} of "
                    f"{sum(m.numel() for m in dec)}")
            require(toks.shape == (SERVE_BATCH, FAMILY_GEN)
                    and toks.dtype == np.int32 and toks.min() >= 0
                    and toks.max() < cfg.vocab, f"{arch} {label}: tokens "
                    f"{toks.shape} {toks.dtype} outside [0, {cfg.vocab})")
            require(peak < total, f"{arch} {label}: peak {peak} >= {total}")
            f_launches = trace.counter("fused_argmax.launches") - f0
            want_f = FAMILY_GEN if temp > 0 and path == "fused" else 0
            require(f_launches == want_f, f"{arch} {label}: kernel F "
                    f"launched {f_launches} times, not {want_f}")
        require(np.array_equal(toks_of["fused"], toks_of["fused again"]),
                f"{arch}: two in-process runs gave different tokens")
        if "two-pass" in toks_of:
            require(np.array_equal(toks_of["fused"], toks_of["two-pass"]),
                    f"{arch}: the fused and two-pass samplers differ")
            log(f"  {arch}: fused = two-pass tokens; greedy = fused at "
                f"{int((toks_of['greedy'] == toks_of['fused']).sum())} of "
                f"{toks_of['greedy'].size}")
        fused[arch] = toks_of["fused"]
    launches = {"thundering_ctr": trace.counter("thundering_ctr.launches"),
                "gumbel_argmax": trace.counter("fused_argmax.launches")}
    plain_runs = (trace.counter("fused_argmax_plain.cuda_runs")
                  + trace.counter("thundering_ctr_plain.cuda_runs")
                  + trace.counter("thundering_faithful_plain.cuda_runs"))
    log(f"families path: launches {launches}; plain versions run on the "
        f"card: {plain_runs}")
    require(launches["thundering_ctr"] > 0 and launches["gumbel_argmax"] > 0,
            "kernel A or F never launched on the families path")
    require(plain_runs == 0, "a plain version ran on a CUDA tensor")
    for arch in FAMILY_ARCHS:
        _free_card()
        _family_decode_vs_forward(get_config(arch), device)
    return launches, fused


def phase_families_path(device, measured: dict) -> dict:
    """The moe, ssm, hybrid and encdec families: (a) kernel A at the
    path's draw shapes and kernel F at each config's vocabulary against
    the plain versions; (b) each config at smoke width on the card
    against the CPU; (c) each served unmodified at full width, decode
    against forward at 2 layers; (d) a profile of 8 decode steps of olmoe
    and mamba2; (e) the serve CLI on mamba2 in a subprocess."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as srv
    from repro_torch.models import registry
    phase_families_draws(device)
    phase_families_sampler(device)
    for arch in FAMILY_ARCHS:
        _card_against_cpu(arch, device, "families plain check")
    launches, fused = phase_families_serve(device, measured)
    for arch in FAMILY_PROFILE_ARCHS:
        _free_card()
        model = registry.build(get_config(arch), device)
        params, _ = model.init(SERVE_SEED)
        _serve_profile(model, params, device)
        del model, params
    phase_serve_cli(device, srv.tokens_digest(
        fused[FAMILY_CLI_ARCH][:, :SERVE_CLI_GEN]), FAMILY_CLI_ARCH)
    return launches


# ---------------------------------------------------------------------------
# the large path: the four published configs no path above serves
# (glm4-9b, qwen1.5-32b, granite-34b, qwen2-vl-72b) at their published
# widths through kernels A and F
# ---------------------------------------------------------------------------

LARGE_ARCHS = ("glm4_9b", "qwen15_32b", "granite_34b", "qwen2_vl_72b")
# Served at published width with float32 parameters at batch 64; glm4-9b
# unmodified (40 of 40 layers), the other three cut in depth only, as
# TRAIN_LAYERS cuts gemma-7b.  The deepest that fit start from the dry
# run's fit at the shape served (28, 43 and 15 layers) and go lower only
# as far as the card's peak forces.  Peaks allocated of the 16-token serve
# alone on an H100 80GB HBM3 at 700 W (tools/families_path.py --path
# large): qwen1.5-32b 70.81 GiB at 28 layers, granite-34b 69.25 GiB at 43,
# of the card's 79.18.  qwen2-vl-72b's 73,728-token prefill holds ~25 GiB
# beside its arguments (peak - prediction 24.89 GiB; 6.75 GiB float32
# attention logits per 384-row query chunk at 64 heads): 9 layers peak at
# 67.16 GiB, and 10 and 11 ran out of memory.  The path serves about half
# of each of those depths (and 8 tokens, not 16) to keep the whole run
# inside its time limit
QWEN15_LAYERS = 14      # of 64; 28 fit
GRANITE_LAYERS = 21     # of 88; 43 fit
QWEN2_VL_LAYERS = 5     # of 80; 9 fit
LARGE_LAYERS = {"qwen15_32b": QWEN15_LAYERS, "granite_34b": GRANITE_LAYERS,
                "qwen2_vl_72b": QWEN2_VL_LAYERS}
LARGE_GEN = 8
LARGE_TWOPASS_ARCH = "qwen2_vl_72b"
LARGE_PROFILE_ARCHS = ("qwen15_32b", "qwen2_vl_72b")
# smoke width keeps the vlm's 1024-position patch prefix, longer than the
# card-against-CPU prompt of 32 tokens: scale it down in both devices
LARGE_SMOKE = {"qwen2_vl_72b": dict(vision_prefix=8)}
# decode against forward: text positions a vlm prefills after its prefix
VLM_TEXT = 4


def _large_cfg(arch: str):
    """``arch``'s published config, cut in depth to ``LARGE_LAYERS``."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.scaled(n_layers=LARGE_LAYERS[arch]) if arch in LARGE_LAYERS \
        else cfg


def _large_prompt(cfg) -> int:
    """The served prompt: 128 text tokens after a vlm's patch prefix (a
    vlm refuses a prompt shorter than its prefix)."""
    return cfg.vision_prefix + SERVE_PROMPT


def phase_large_draws(device) -> None:
    """Kernel A against its plain version, bit for bit, at the path's new
    draw shapes: the first and the last 2**28 chunk of the largest stacked
    matrix of the four configs at their served depths, and the uniforms
    under qwen2-vl-72b's (64, 1024, 8192) patches of
    ``pipeline_for(...).batch_at(0)``."""
    from repro_torch.core import stream as tstream
    from repro_torch.launch.train import pipeline_for
    from repro_torch.models import registry
    from repro_torch.models.common import flatten
    sizes = []
    for arch in LARGE_ARCHS:
        shapes = flatten(registry.build(_large_cfg(arch), "meta")
                         .init(SERVE_SEED)[0])
        sizes += [(t.numel(), arch, path) for path, t in shapes.items()
                  if path.startswith("layers/")]
    _, arch, path = max(sizes)
    for chunk in (0, -1):
        _param_chunk_draw(_large_cfg(arch), path, chunk, device)
    cfg = _large_cfg("qwen2_vl_72b")
    pipe = pipeline_for(cfg, SERVE_BATCH, _large_prompt(cfg), SERVE_SEED,
                        device=device)
    est = tstream.derive(tstream.derive(pipe._root, 0), 0xE57A)
    _draw_against_plain(f"{cfg.name} patches ({SERVE_BATCH}, "
                        f"{cfg.vision_prefix}, {cfg.d_model})", est,
                        SERVE_BATCH * cfg.vision_prefix * cfg.d_model)


def phase_large_sampler(device) -> dict:
    """``_sampler_against_plain`` at each vocabulary of the four configs
    (granite-34b's 49152 is new to kernel F).  Returns {vocab: CUDA-event
    ms a call at (V, 64)}."""
    import torch
    from repro_torch.configs import get_config
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    ms = {}
    for arch in LARGE_ARCHS:
        V = get_config(arch).vocab
        if V not in ms:
            ms[V] = _sampler_against_plain(arch, V, device, gen)
    return ms


def phase_large_f8_cast(device) -> None:
    """``layers.cast(x, float8_e4m3fn)``, which writes qwen1.5-32b's KV
    cache every step, on the card against the CPU over all 65,536 bf16
    bit patterns: NaN at the same positions, every other byte equal."""
    import torch
    from repro_torch.models import layers as L
    x = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    want = L.cast(x, torch.float8_e4m3fn)
    got = L.cast(x.to(device), torch.float8_e4m3fn).cpu()
    nan = torch.isnan(want.to(torch.float32))
    same_nan = torch.equal(torch.isnan(got.to(torch.float32)), nan)
    bytes_equal = torch.equal(got.view(torch.uint8)[~nan],
                              want.view(torch.uint8)[~nan])
    log(f"float8 cast on the card: {x.numel()} bf16 patterns, NaN at the "
        f"CPU's {int(nan.sum())} positions {same_nan}, the other bytes "
        f"equal {bytes_equal}")
    require(same_nan and bytes_equal, "the float8 cast on the card differs "
            "from the CPU's")


def phase_large_serve(device, measured: dict, f_ms: dict) -> dict:
    """Each of ``LARGE_ARCHS`` at its served depth through
    ``launch.serve.serve`` at batch 64, its prompt (``_large_prompt``),
    8 tokens, temperature 0.8 on the fused path, twice (equal tokens;
    qwen2-vl-72b also two-pass - the same tokens - and greedy), with
    kernel A and F's counts set to 0 just before and read just after;
    then decode against forward at 2 layers of each published width.
    Each run's peak memory goes into ``measured[(arch, "serve")]``, beside
    the dry run's argument bytes at the same shape."""
    import numpy as np
    import torch
    from repro_torch import trace
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as srv
    from repro_torch.models import registry
    from repro_torch.models.common import flatten
    gib = 2 ** 30
    total = torch.cuda.get_device_properties(device).total_memory
    trace.reset_counters(("thundering_", "fused_argmax"))
    for arch in LARGE_ARCHS:
        cfg = _large_cfg(arch)
        P = _large_prompt(cfg)
        shapes = flatten(registry.build(cfg, "meta").init(0)[0])
        n_params = sum(v.numel() for v in shapes.values())
        pred = _served_bytes(arch, SERVE_BATCH, P, P + LARGE_GEN,
                             LARGE_LAYERS.get(arch, 0))["total"]
        _free_card()
        free = torch.cuda.mem_get_info(device)[0]
        prefix = (f" ({cfg.vision_prefix} patch positions + {SERVE_PROMPT} "
                  f"text)" if cfg.vision_prefix else "")
        log(f"large: {cfg.name} [{cfg.family}] {cfg.n_layers} of "
            f"{get_config(arch).n_layers} layers at published width "
            f"(d_model {cfg.d_model}, {cfg.n_heads} heads x "
            f"{cfg.resolved_head_dim}, {cfg.n_kv_heads} kv heads, d_ff "
            f"{cfg.d_ff}, {cfg.act}, vocab {cfg.vocab}, KV cache "
            f"{cfg.kv_dtype}): {n_params} parameters, "
            f"{n_params * 4 / 1e9:.1f} GB in float32; batch {SERVE_BATCH}, "
            f"prompt {P}{prefix}, {LARGE_GEN} tokens; the dry run's argument bytes "
            f"{pred / gib:.3f} GiB; the card's free memory "
            f"{free / gib:.2f} of {total / gib:.2f} GiB")
        runs = [("fused", SERVE_TEMPERATURE, "fused"),
                ("fused again", SERVE_TEMPERATURE, "fused")]
        if arch == LARGE_TWOPASS_ARCH:
            runs += [("two-pass", SERVE_TEMPERATURE, "cuda"),
                     ("greedy", 0.0, "fused")]
        toks_of = {}
        for label, temp, path in runs:
            _free_card()
            torch.cuda.reset_peak_memory_stats(device)
            a0 = trace.counter("thundering_ctr.launches")
            f0 = trace.counter("fused_argmax.launches")
            toks, stats = srv.serve(cfg, batch=SERVE_BATCH, prompt_len=P,
                                    gen=LARGE_GEN, seed=SERVE_SEED,
                                    temperature=temp, sampler_path=path,
                                    device=device)
            peak = torch.cuda.max_memory_allocated(device)
            measured.setdefault((arch, "serve"), []).append(peak)
            toks_of[label] = toks
            _serve_report(f"{arch} {cfg.n_layers} layers {label}", toks,
                          stats, peak)
            log(f"  {arch} {label}: peak - prediction "
                f"{(peak - pred) / gib:.3f} GiB; peak reserved "
                f"{torch.cuda.max_memory_reserved(device) / gib:.2f} GiB; "
                f"kernel F "
                f"{f_ms[cfg.vocab]:.4f} ms a call = "
                f"{f_ms[cfg.vocab] / stats['step_p50_ms'] * 100:.3f} % of "
                f"the p50 step")
            require(toks.shape == (SERVE_BATCH, LARGE_GEN)
                    and toks.dtype == np.int32 and toks.min() >= 0
                    and toks.max() < cfg.vocab, f"{arch} {label}: tokens "
                    f"{toks.shape} {toks.dtype} outside [0, {cfg.vocab})")
            require(peak < total, f"{arch} {label}: peak {peak} >= {total}")
            a_launches = trace.counter("thundering_ctr.launches") - a0
            f_launches = trace.counter("fused_argmax.launches") - f0
            want_f = LARGE_GEN if temp > 0 and path == "fused" else 0
            require(a_launches > 0, f"{arch} {label}: kernel A never "
                                    f"launched")
            require(f_launches == want_f, f"{arch} {label}: kernel F "
                    f"launched {f_launches} times, not {want_f}")
        require(np.array_equal(toks_of["fused"], toks_of["fused again"]),
                f"{arch}: two in-process runs gave different tokens")
        if "two-pass" in toks_of:
            require(np.array_equal(toks_of["fused"], toks_of["two-pass"]),
                    f"{arch}: the fused and two-pass samplers differ")
            log(f"  {arch}: fused = two-pass tokens; greedy = fused at "
                f"{int((toks_of['greedy'] == toks_of['fused']).sum())} of "
                f"{toks_of['greedy'].size}")
    launches = {"thundering_ctr": trace.counter("thundering_ctr.launches"),
                "gumbel_argmax": trace.counter("fused_argmax.launches")}
    plain_runs = (trace.counter("fused_argmax_plain.cuda_runs")
                  + trace.counter("thundering_ctr_plain.cuda_runs")
                  + trace.counter("thundering_faithful_plain.cuda_runs"))
    log(f"large path: launches {launches}; plain versions run on the "
        f"card: {plain_runs}")
    require(launches["thundering_ctr"] > 0 and launches["gumbel_argmax"] > 0,
            "kernel A or F never launched on the large path")
    require(plain_runs == 0, "a plain version ran on a CUDA tensor")
    for arch in LARGE_ARCHS:
        _free_card()
        _family_decode_vs_forward(get_config(arch), device)
    return launches


def phase_large_path(device, measured: dict) -> dict:
    """glm4-9b, qwen1.5-32b, granite-34b and qwen2-vl-72b: (a) kernel A at
    the path's draw shapes, kernel F at their vocabularies and the float8
    KV cast against the plain versions / the CPU; (b) each config at
    smoke width on the card against the CPU; (c) each served at published
    width (``LARGE_LAYERS`` deep), decode against forward at 2 layers;
    (d) a profile of 8 decode steps of qwen1.5-32b and qwen2-vl-72b."""
    from repro_torch.models import registry
    phase_large_draws(device)
    f_ms = phase_large_sampler(device)
    phase_large_f8_cast(device)
    for arch in LARGE_ARCHS:
        _card_against_cpu(arch, device, "large plain check",
                          **LARGE_SMOKE.get(arch, {}))
    launches = phase_large_serve(device, measured, f_ms)
    for arch in LARGE_PROFILE_ARCHS:
        _free_card()
        cfg = _large_cfg(arch)
        model = registry.build(cfg, device)
        params, _ = model.init(SERVE_SEED)
        _serve_profile(model, params, device, _large_prompt(cfg))
        del model, params
    return launches


# ---------------------------------------------------------------------------
# the train families and train large paths: one config of each family the
# train path does not train, then the four published configs left, at
# published width cut in depth, through make_train_step and train
# ---------------------------------------------------------------------------

TRAIN_FAMILY_ARCHS = ("olmoe_1b_7b", "mamba2_2p7b", "whisper_small",
                      "qwen2_vl_72b", "zamba2_7b")
# Trained at published width with float32 parameters, AdamW's m and v and
# float32 gradients (16 B a parameter), cut in depth only: each from the
# most layers whose dry-run bytes and gradients fit the card less
# gemma-7b's measured transients (11, 64, 12, 2 and 61 layers), lower only
# as far as the measured peak must stay under TRAIN_PEAK_GIB.  Peaks
# allocated on an H100 80GB HBM3 at 700 W (tools/train_path.py --path
# families and chip_smoke.py):
TRAIN_FAMILY_LAYERS = {
    "olmoe_1b_7b": 9,       # of 16: 67.09 GiB; 10 ran out of memory
    # of 64: all 64 fit (44.23 GiB); 16 keep the whole run inside its time
    # limit
    "mamba2_2p7b": 16,
    "whisper_small": 12,    # of 12 (+ 12 encoder layers): 5.41 GiB
    # of 80: 68.24 GiB; a third layer's bytes and gradients alone add
    # 13.08 GiB
    "qwen2_vl_72b": 2,
    # of 81: 47 fit (71.67 GiB; a 48th layer's bytes and gradients alone
    # add 1.16 GiB); 12 (2 applications of the shared block) keep the
    # whole run inside its time limit
    "zamba2_7b": 12,
}
# The four published configs the families path trains only at smoke
# width, trained as those above, from the dry run's train budget fit (32,
# 18, 6 and 11 layers), lower only as far as the measured peak must stay
# under TRAIN_PEAK_GIB.  Peaks allocated on an H100 80GB HBM3 at 700 W
# (tools/train_path.py --path large and chip_smoke.py); "+ x" is what one
# more layer's bytes and gradients alone add:
TRAIN_LARGE_ARCHS = ("granite_moe_3b", "glm4_9b", "qwen15_32b",
                     "granite_34b")
TRAIN_LARGE_LAYERS = {
    "granite_moe_3b": 32,   # of 32: 59.88 GiB
    "glm4_9b": 16,          # of 40: 70.54 GiB, + 3.04 GiB
    "qwen15_32b": 5,        # of 64: 65.34 GiB, + 7.83 GiB
    # of 88: 65.44 GiB, + 5.65 GiB; 10 layers ran out of memory (a 5.62
    # GiB allocation beside 66.02 allocated and 7.01 reserved but free)
    "granite_34b": 9,
}
TRAIN_FAMILY_STEPS = 3
# a vlm trains on its 1024-position patch prefix + 128 text positions
TRAIN_VLM_TEXT = 128
TRAIN_FAMILY_PROFILE = ("olmoe_1b_7b", "mamba2_2p7b")
TRAIN_LARGE_PROFILE = ("granite_moe_3b", "qwen15_32b")
# card against CPU through train at the smoke width: the five families
# and the four above
TRAIN_SMOKE_ARCHS = TRAIN_FAMILY_ARCHS + TRAIN_LARGE_ARCHS
TRAIN_SMOKE_SEQ = 64
TRAIN_CLI_ARCH = "mamba2_2p7b"


def _largest_stacked(arch: str):
    """(elements, path) of ``arch``'s largest stacked per-layer parameter
    (under ``layers/``, or an encdec's ``enc_layers/`` and
    ``dec_layers/``) at the depth trained; of equal sizes, the last path
    in sorted order."""
    from repro_torch.models import registry
    from repro_torch.models.common import flatten
    shapes = flatten(registry.build(_trained_cfg(arch), "meta")
                     .init(TRAIN_SEED)[0])
    return max((t.numel(), p) for p, t in shapes.items()
               if p.split("/")[0].endswith("layers"))


def _stacked_chunk_draws(archs, device) -> None:
    """Kernel A against its plain version, bit for bit, at the ragged last
    2**28 chunk of the largest stacked matrix of each of ``archs`` at the
    depth trained, and at the first chunk of the largest of them."""
    largest = []
    for arch in archs:
        n, path = _largest_stacked(arch)
        _param_chunk_draw(_trained_cfg(arch), path, -1, device)
        largest.append((n, path, arch))
    _, path, arch = max(largest)
    _param_chunk_draw(_trained_cfg(arch), path, 0, device)


def phase_train_families_draws(device) -> None:
    """Kernel A against its plain version, bit for bit, at the draw shapes
    this path reaches first: the chunks of the largest stacked matrix of
    olmoe-1b-7b (its experts), mamba2-2.7b and zamba2-7b (their SSD input
    projections) at the depths trained (``_stacked_chunk_draws``), and the
    uniforms under the vlm's (8, 1024, 8192) patches and whisper's (8,
    1500, 768) frames of ``pipeline_for(...).batch_at(0)``."""
    import math
    from repro_torch.core import stream as tstream
    from repro_torch.launch.train import pipeline_for
    _stacked_chunk_draws(("olmoe_1b_7b", "mamba2_2p7b", "zamba2_7b"), device)
    for arch in ("qwen2_vl_72b", "whisper_small"):
        shape = _trained_shape(arch)
        pipe = pipeline_for(_trained_cfg(arch), shape["batch"], shape["seq"],
                            TRAIN_SEED, device=device)
        (name, dims), = shape["extras"].items()
        est = tstream.derive(tstream.derive(pipe._root, 0), 0xE57A)
        _draw_against_plain(f"{arch} train {name} {dims}", est,
                            math.prod(dims))


def _train_resume(arch: str, device, seq: int, cfg, clean) -> None:
    """``train`` at the smoke width on the card with a failure at step 3
    (resumed from step 2's checkpoint) and with ``use_service=False``:
    parameters bit-equal to the uninterrupted card run ``clean`` =
    (parameters, losses), as ``_train_run`` gives them, every loss
    equal."""
    t0 = time.perf_counter()
    runs = {"clean": clean}
    for name, kw in (("fail@3", dict(fail_at=3)),
                     ("no-service", dict(use_service=False))):
        runs[name] = _train_run(cfg, device, seq,
                                f"{arch}_{name.replace('@', '_')}", **kw)
    digests = {k: _tree_digest(p) for k, (p, _) in runs.items()}
    logged = {k: losses for k, (_, losses) in runs.items()}
    log(f"train resume {arch} on the card: params sha256 "
        f"{ {k: v[:16] for k, v in digests.items()} }; fail@3 logged steps "
        f"{[s for s, _ in logged['fail@3']]}; "
        f"{time.perf_counter() - t0:.1f} s")
    require(len(set(digests.values())) == 1, f"train resume {arch}: "
            f"digests differ")
    require(dict(logged["fail@3"]) == dict(logged["clean"])
            == dict(logged["no-service"]), f"train resume {arch}: losses "
                                           f"differ")
    require([s for s, _ in logged["fail@3"]] == [0, 1, 2, 2, 3],
            f"train resume {arch}: the failed run did not resume at step 2")


def phase_train_families_path(device, measured: dict) -> dict:
    """Training beyond gemma-7b: (a) kernel A at the path's new draw
    shapes against the plain version; (b) ``train`` at the smoke width on
    the card against the CPU for ``TRAIN_SMOKE_ARCHS``, and for the five
    families a failure at step 3 resumed and ``--no-service`` on the card,
    one digest each; (c) the train CLI on mamba2 in a subprocess started
    first, which runs beside (a) and (b); then - kernel A's counts set to
    0 just before and read just after - (d) each
    of ``TRAIN_FAMILY_ARCHS`` at published width cut to
    ``TRAIN_FAMILY_LAYERS`` through ``make_train_step`` (``_train_full``),
    olmoe and mamba2 with a profiled step."""
    from repro_torch import trace
    with _TrainCli(TRAIN_CLI_ARCH, TRAIN_SMOKE_SEQ) as cli:
        phase_train_families_draws(device)
        for arch in TRAIN_SMOKE_ARCHS:
            cfg, params, losses = _train_smoke(arch, device, TRAIN_SMOKE_SEQ,
                                               **LARGE_SMOKE.get(arch, {}))
            if arch in TRAIN_FAMILY_ARCHS:
                _train_resume(arch, device, TRAIN_SMOKE_SEQ, cfg,
                              (params, losses))
            if arch == TRAIN_CLI_ARCH:
                cli_run = params, losses
            del params
        cli.check(*cli_run)
        del cli_run
    trace.reset_counters("thundering_")
    for arch in TRAIN_FAMILY_ARCHS:
        _train_full(arch, device, measured, TRAIN_FAMILY_STEPS,
                    profile=arch in TRAIN_FAMILY_PROFILE)
    _require_train_peaks(measured, TRAIN_FAMILY_ARCHS)
    return _kernel_a_launches("train families")


def phase_train_large_path(device, measured: dict) -> dict:
    """The four configs the families path trains only at smoke width:
    (a) kernel A against its plain version at the chunks of their largest
    stacked matrices at the depths trained (``_stacked_chunk_draws``); (b)
    ``train`` at the smoke width on the card, uninterrupted, with a
    failure at step 3 resumed and with ``--no-service``, one digest each;
    then - kernel A's counts set to 0 just before and read just after -
    (c) each of ``TRAIN_LARGE_ARCHS`` at published width cut to
    ``TRAIN_LARGE_LAYERS`` through ``make_train_step`` (``_train_full``),
    granite-moe and qwen1.5-32b with a profiled step."""
    from repro_torch import trace
    from repro_torch.configs import get_config
    from repro_torch.launch.train import smoke_config
    _stacked_chunk_draws(TRAIN_LARGE_ARCHS, device)
    for arch in TRAIN_LARGE_ARCHS:
        cfg = smoke_config(get_config(arch))
        _train_resume(arch, device, TRAIN_SMOKE_SEQ, cfg,
                      _train_run(cfg, device, TRAIN_SMOKE_SEQ,
                                 f"{arch}_clean"))
    trace.reset_counters("thundering_")
    for arch in TRAIN_LARGE_ARCHS:
        _train_full(arch, device, measured, TRAIN_FAMILY_STEPS,
                    profile=arch in TRAIN_LARGE_PROFILE)
    _require_train_peaks(measured, TRAIN_LARGE_ARCHS)
    return _kernel_a_launches("train large")


# ---------------------------------------------------------------------------
# the dryrun path: the dry run's CLI, the RNG fan-out and the service cell
# on the card, and the dry run's argument bytes against the card's peaks
# ---------------------------------------------------------------------------

DRYRUN_DIR = ROOT / "build" / "chip_smoke" / "dryrun"
DRYRUN_CLI = (("cells", ("--all", "--both-meshes")),
              ("rng-fanout", ("--rng-fanout", "--both-meshes")),
              ("service", ("--service",)))
DRYRUN_CTX = SERVE_PROMPT + SERVE_GEN
FAMILY_CTX = SERVE_PROMPT + FAMILY_GEN


def phase_dryrun_cli() -> None:
    """``python -m repro_torch.launch.dryrun`` with ``--all
    --both-meshes`` (every cell on meta), ``--rng-fanout --both-meshes``
    and ``--service`` (on the card), in three subprocesses at once: each
    exits 0, the first prints one OK or SKIP line per cell and mesh (OK
    for every runnable one), the others OK lines."""
    import os
    from repro_torch.configs import ARCH_IDS, SHAPES, runnable_cells
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
         str(DRYRUN_DIR / name)], env=env, cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, args in DRYRUN_CLI}
    try:
        outs = {name: p.communicate(timeout=300) for name, p in
                procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p in procs.items():
        require(p.returncode == 0, f"dryrun CLI {name} exited "
                f"{p.returncode}: {outs[name][1][-2000:]}")
    lines = {name: out.strip().splitlines() for name, (out, _) in
             outs.items()}
    cells = lines["cells"]
    n_run = 2 * len(list(runnable_cells()))
    n_ok = sum(ln.startswith("[OK] ") for ln in cells)
    n_skip = sum(ln.startswith("[SKIP] ") for ln in cells)
    log(f"dryrun CLI --all --both-meshes: {n_ok} OK + {n_skip} SKIP lines "
        f"for {len(ARCH_IDS) * len(SHAPES) * 2} cells ({n_run} runnable); "
        + "; ".join(ln for ln in cells if "gemma_7b" in ln and "__pod" in ln))
    require(n_ok == n_run and n_ok + n_skip == len(cells)
            == len(ARCH_IDS) * len(SHAPES) * 2,
            f"dryrun CLI: {n_ok} OK, {n_skip} SKIP of {len(cells)} lines")
    for name in ("rng-fanout", "service"):
        require(lines[name] and all(ln.startswith("[OK] ")
                                    for ln in lines[name]),
                f"dryrun CLI {name}: {lines[name]}")
        for ln in lines[name]:
            log(f"dryrun CLI {name}: {ln}")
    require(len(lines["rng-fanout"]) == 2, "dryrun CLI --rng-fanout "
            "--both-meshes did not report both meshes")
    log(f"dryrun CLI: three subprocesses {time.perf_counter() - t0:.1f} s")


def phase_dryrun_fanout(device) -> None:
    """``rng_fanout_cell`` on both production shapes, every one of the
    256 / 512 shards on the card, and ``generate_sharded`` over 4 shards
    of the card at (4096, 2**14): each gathered block equal to one
    ``generate`` bit for bit."""
    from repro_torch.core import engine
    from repro_torch.launch import dryrun
    for mp in (False, True):
        rep = dryrun.rng_fanout_cell(multi_pod=mp, device=device)
        for s in ("bits", "uniform"):
            r = rep[s]
            log(f"rng fan-out {rep['mesh']} {s} {r['out_dtype']} "
                f"(S {rep['num_streams']}, T {rep['num_steps']}): "
                f"{r['shards']} shards of the card, {r['bytes_per_shard']} B "
                f"a shard, {r['wall_ms']:.2f} ms wall (host clock, ending "
                f"in a synchronize), collective bytes "
                f"{r['collective_bytes']['total']}; equal to one generate "
                f"{r['equal_to_generate']} ({card_line()})")
            require(r["equal_to_generate"], f"rng fan-out {rep['mesh']} "
                    f"{s}: the gathered block differs from one generate")
            require(r["shards"] == rep["chips"], f"rng fan-out "
                    f"{rep['mesh']}: {r['shards']} shards")
    plan = engine.make_plan(seed=SEED, num_streams=S_FULL,
                            num_steps=T_FULL, device=device)
    mesh = engine.Mesh.of([device] * 4, (4,), ("streams",))
    want = engine.generate(plan)
    engine.generate_sharded(plan, mesh=mesh)
    ms = host_ms(lambda: engine.generate_sharded(plan, mesh=mesh), reps=5)
    got = engine.generate_sharded(plan, mesh=mesh)
    log(f"rng fan-out over 4 shards of the card at ({T_FULL}, {S_FULL}): "
        f"{ms:.3f} ms a call (host clock); equal to one generate "
        f"{dryrun._same_bits(got, want)} ({card_line()})")
    require(dryrun._same_bits(got, want), "the 4-shard fan-out differs "
                                          "from one generate")


class _BurstResponses:
    """While active, records the responses of every
    ``service.burst.run_burst`` call into ``out`` (rid -> response)."""

    def __enter__(self):
        from repro_torch.service import burst
        self._real = real = burst.run_burst
        self.out = {}

        def recorded(*args, **kw):
            got = real(*args, **kw)
            self.out.update(got)
            return got
        burst.run_burst = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.service import burst
        burst.run_burst = self._real


def phase_dryrun_service(device) -> None:
    """``service_cell`` on the card and on the CPU (which the CPU tests
    hold against the reference's): replay bit-identical, the ledger
    windows disjoint and equal, and each response alike
    (``_responses_alike``: bit for bit on the integer and threshold
    classes, which share one digest, within 8 ULP on the log stages)."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.service.audit import response_digest
    from repro_torch.service.burst import make_requests
    with _BurstResponses() as on_card:
        rep = dryrun.service_cell(device=device)
    with _BurstResponses() as on_cpu:
        ref = dryrun.service_cell(device=torch.device("cpu"))
    reqs = make_requests(burst=rep["burst"], tenants=rep["tenants"],
                         seed=rep["seed"])
    exact, worst = _responses_alike("service cell", reqs, on_card.out,
                                    on_cpu.out)
    st = rep["stats"]
    log(f"service cell on the card: {st['requests_served']} requests, "
        f"{st['requests_per_s']:.1f} req/s, p50 {st['latency_p50_ms']:.1f} "
        f"ms, p99 {st['latency_p99_ms']:.1f} ms, "
        f"{st['calls_per_request']:.3f} calls/request, replay "
        f"{'bit-identical' if rep['replay_ok'] else 'MISMATCH'}, ledger "
        f"windows {rep['ledger_windows']}; against the CPU's cell: "
        f"{len(exact)} integer / threshold responses bit-identical (digest "
        f"{response_digest({r: on_card.out[r] for r in exact})[:16]}), log "
        f"stages within {_ulp_note(worst)}; whole digests {rep['digest'][:16]}"
        f" card, {ref['digest'][:16]} CPU ({card_line()})")
    require(rep["replay_ok"] and ref["replay_ok"], "the service cell's "
            "journal does not replay bit-identically")
    require(rep["ledger_windows"] == ref["ledger_windows"],
            "the service cell's ledger windows differ from the CPU's")
    require(st["requests_served"] == rep["burst"]
            and st["requests_failed"] == 0, "the service cell dropped "
                                            "requests")


def _extra_inputs(cfg, batch: int) -> dict:
    """The extra inputs of a batch of ``cfg`` on ``meta``, as
    ``pipeline_for`` draws them: a vlm's patches, an encdec's frames."""
    import torch
    out = {}
    if cfg.family == "vlm":
        out["patches"] = torch.empty(
            (batch, cfg.vision_prefix, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
    if cfg.family == "encdec":
        out["frames"] = torch.empty((batch, cfg.enc_ctx, cfg.d_model),
                                    dtype=torch.bfloat16, device="meta")
    return out


def _one_device():
    from repro_torch.launch.mesh import make_mesh_auto
    return make_mesh_auto((1, 1), ("data", "model"), device="meta")


def _served_bytes(arch: str, batch: int, prompt: int, ctx: int,
                  layers: int = 0) -> dict:
    """The dry run's argument bytes of serving ``arch`` (float32
    parameters, as the port serves them) at ``batch`` prompts of
    ``prompt`` tokens with a decode cache of ``ctx`` positions, on one
    device; ``layers`` cuts the depth."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    cfg = get_config(arch)
    if layers:
        cfg = cfg.scaled(n_layers=layers)
    model = registry.build(cfg, "meta")
    specs = {"tokens": torch.empty((batch, prompt), dtype=torch.int32,
                                   device="meta"),
             "cache": model.init_cache(batch, ctx),
             **_extra_inputs(cfg, batch)}
    return dryrun.argument_bytes(model, specs, _one_device(), "decode")


def _trained_bytes(arch: str, layers: int = 0) -> dict:
    """The dry run's argument bytes of one train step of ``arch`` at
    ``_trained_shape`` (float32 parameters + AdamW's m and v) on one
    device, ``layers`` deep (default: the depth trained); "grads" adds
    the float32 gradients (4 B a parameter), which the dry run leaves
    out."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    shape = _trained_shape(arch)
    cfg = _trained_cfg(arch, layers)
    tok = torch.empty((shape["batch"], shape["seq"]), dtype=torch.int32,
                      device="meta")
    out = dryrun.argument_bytes(
        registry.build(cfg, "meta"),
        {"tokens": tok, "labels": tok, **_extra_inputs(cfg, shape["batch"])},
        _one_device(), "train")
    out["grads"] = out["params"]
    return out


def _served_shape(arch: str):
    """(prompt, context, layers - 0 for all) at which the paths above
    serve ``arch``."""
    if arch == SERVE_ARCH:
        return SERVE_PROMPT, DRYRUN_CTX, 0
    if arch in LARGE_ARCHS:
        P = _large_prompt(_large_cfg(arch))
        return P, P + LARGE_GEN, LARGE_LAYERS.get(arch, 0)
    return SERVE_PROMPT, FAMILY_CTX, 0


def _hold_peaks(measured: dict):
    """The dry run against the card: the argument bytes of each config at
    the shape, depth and dtypes this run served (``_served_shape``) or
    trained (``_trained_shape``) it with must not exceed the lowest
    ``max_memory_allocated`` peak measured for it (a lower bound above
    the card's own count is wrong).  Returns the margins of the budgets:
    the largest peak - prediction of the configs served whole and of
    gemma-7b's train, and gemma-7b's train peak less its bytes and
    gradients."""
    from repro_torch.configs import get_config
    gib = 2 ** 30
    margin = train_margin = 0
    for (arch, kind), peaks in sorted(measured.items()):
        if kind == "train":
            pred = _trained_bytes(arch)
            sh = _trained_shape(arch)
            shape = (f"{sh['layers']} layers, batch {sh['batch']} x "
                     f"{sh['seq']}"
                     + "".join(f", {k} {v}" for k, v in sh["extras"].items())
                     + ", float32 params + m + v")
        else:
            prompt, ctx, layers = _served_shape(arch)
            pred = _served_bytes(arch, SERVE_BATCH, prompt, ctx, layers)
            shape = (f"{layers or get_config(arch).n_layers} layers, batch "
                     f"{SERVE_BATCH}, prompt {prompt}, context {ctx}, "
                     f"float32 params")
        low = min(peaks)
        if arch == TRAIN_ARCH or kind == "serve" and arch not in LARGE_ARCHS:
            margin = max(margin, max(peaks) - pred["total"])
        if (arch, kind) == (TRAIN_ARCH, "train"):
            train_margin = max(peaks) - pred["total"] - pred["grads"]
        log(f"dry run vs card: {arch} {kind} ({shape}): argument bytes "
            f"{pred['total'] / gib:.3f} GiB (params {pred['params'] / gib:.3f}"
            f", optimizer {pred['opt_state'] / gib:.3f}, cache "
            f"{pred['cache'] / gib:.3f}, inputs {pred['inputs'] / gib:.4f}) "
            f"<= measured peak {low / gib:.3f} GiB (of {len(peaks)} runs): "
            f"ratio {pred['total'] / low:.4f}")
        require(pred["total"] <= low, f"dry run: {arch} {kind} predicts "
                f"{pred['total']} B, more than the card's peak {low} B")
    want = ({(SERVE_ARCH, "serve"), (TRAIN_ARCH, "train")}
            | {(a, "serve") for a in FAMILY_ARCHS + LARGE_ARCHS}
            | {(a, "train") for a in TRAIN_FAMILY_ARCHS + TRAIN_LARGE_ARCHS})
    require(set(measured) == want, f"dry run: the card's peaks were not "
            f"all measured ({sorted(measured)})")
    return margin, train_margin


def phase_dryrun_memory(device, measured: dict) -> None:
    """``_hold_peaks``; then the fit the dry run predicts at the shape
    served for each config the large path serves (the most layers whose
    bytes fit the card's memory less the serve margin), and at the shape
    trained for each config the train families and train large paths
    train (the most layers whose bytes and float32 gradients fit the
    card's memory less gemma-7b's train transients), beside the depth
    served or trained, and its transient (the measured peak less the bytes
    and gradients at that depth) beside the float32 bytes of its largest
    stacked leaf, which the per-layer zero-filled stacked gradient holds
    (ROADMAP B8)."""
    import torch
    from repro_torch.configs import get_config
    gib = 2 ** 30
    margin, train_margin = _hold_peaks(measured)
    total = torch.cuda.mem_get_info(device)[1]
    budget = total - margin
    log(f"dry run: card memory {total / gib:.2f} GiB, largest measured "
        f"peak - prediction of the serve, train and families paths "
        f"{margin / gib:.2f} GiB, budget {budget / gib:.2f} GiB "
        f"({card_line()})")
    for arch in LARGE_ARCHS:
        cfg = get_config(arch)
        prompt, ctx, layers = _served_shape(arch)
        full = _served_bytes(arch, SERVE_BATCH, prompt, ctx)
        b1, b2 = (_served_bytes(arch, SERVE_BATCH, prompt, ctx,
                                layers=n)["total"] for n in (1, 2))
        per = b2 - b1
        require(b1 + (cfg.n_layers - 1) * per == full["total"],
                f"dry run: {arch}'s bytes are not linear in its layers")
        fit = min(cfg.n_layers, max(0, (budget - b1) // per + 1))
        peak = max(measured[(arch, "serve")])
        log(f"dry run: {arch} at batch {SERVE_BATCH}, prompt {prompt}, "
            f"context {ctx}, float32 params: {full['total'] / gib:.2f} GiB "
            f"at {cfg.n_layers} layers (params {full['params'] / gib:.2f}, "
            f"cache {full['cache'] / gib:.2f}); {b1 / gib:.3f} GiB at one "
            f"layer, {per / gib:.4f} GiB each further layer; the budget "
            f"predicts {fit} of {cfg.n_layers} layers; served at "
            f"{layers or cfg.n_layers}, measured peak {peak / gib:.2f} GiB")
    budget = total - train_margin
    log(f"dry run: card memory {total / gib:.2f} GiB, {TRAIN_ARCH}'s "
        f"train peak - bytes - gradients {train_margin / gib:.2f} GiB, "
        f"train budget {budget / gib:.2f} GiB")
    for arch in TRAIN_FAMILY_ARCHS + TRAIN_LARGE_ARCHS:
        n_layers = get_config(arch).n_layers
        full, one, two, own = (_trained_bytes(arch, n)
                               for n in (n_layers, 1, 2, 0))
        b1, b2, bn, bo = (b["total"] + b["grads"]
                          for b in (one, two, full, own))
        per = b2 - b1
        require(b1 + (n_layers - 1) * per == bn, f"dry run: {arch}'s train "
                f"bytes are not linear in its layers")
        fit = min(n_layers, max(0, (budget - b1) // per + 1))
        sh = _trained_shape(arch)
        peak = max(measured[(arch, "train")])
        n_big, path = _largest_stacked(arch)
        log(f"dry run: {arch} train at batch {sh['batch']} x {sh['seq']}, "
            f"float32 params, grads, m, v: {bn / gib:.2f} GiB at {n_layers} "
            f"layers; {b1 / gib:.3f} GiB at one layer, {per / gib:.4f} GiB "
            f"each further layer; the budget predicts {fit} of {n_layers} "
            f"layers; trained at {sh['layers']}, measured peak "
            f"{peak / gib:.2f} GiB (limit {TRAIN_PEAK_GIB}); one more "
            f"layer's bytes and gradients alone would take it to "
            f"{(peak + per) / gib:.2f} GiB; transient (peak - bytes - "
            f"gradients) {(peak - bo) / gib:.2f} GiB beside its largest "
            f"stacked leaf {path} {n_big * 4 / gib:.2f} GiB in float32")


def phase_dryrun_path(device, measured: dict) -> dict:
    """The dry run: its CLI in subprocesses, then - kernel A's counts set
    to 0 just before and read just after - ``rng_fanout_cell`` and
    ``service_cell`` on the card; then its argument bytes against the
    peaks the serve, train, families, large, train families and train
    large paths measured."""
    from repro_torch import trace
    phase_dryrun_cli()
    trace.reset_counters("thundering_")
    phase_dryrun_fanout(device)
    phase_dryrun_service(device)
    launches = _kernel_a_launches("dryrun")
    phase_dryrun_memory(device, measured)
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
        # the peak memory of each config's serve / train runs, for the
        # dry run's check
        measured = {}
        by_path["serve"] = run_phase("serve path", phase_serve_path, device,
                                     measured)
        by_path["train"] = run_phase("train path", phase_train_path, device,
                                     measured)
        by_path["families"] = run_phase("families path", phase_families_path,
                                        device, measured)
        by_path["large"] = run_phase("large path", phase_large_path, device,
                                     measured)
        by_path["train_families"] = run_phase(
            "train families path", phase_train_families_path, device,
            measured)
        by_path["train_large"] = run_phase(
            "train large path", phase_train_large_path, device, measured)
        by_path["dryrun"] = run_phase("dryrun path", phase_dryrun_path,
                                      device, measured)
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
