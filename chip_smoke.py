#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of ThundeRiNG on one GPU.

Builds the CUDA kernels of ``src/repro_torch/csrc`` with nvcc, holds each
kernel against its plain PyTorch version (every sampler stage of the block
generators; pi and option partials; fused dropout in float32 and
bfloat16), drives the port's two main paths at full width - the generator
(engine -> stream -> BlockService) at the README's bulk size, S = 2**14
streams by T = 4096 steps, and the paper's applications (ops.estimate_pi,
ops.price_option, their leased forms, ops.fused_dropout) at 2**28 draws and
a (32768, 3072) activation - checks what comes out, and times the kernels
with CUDA events beside their bounds and torch's own generators.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Any failure
exits non-zero and prints no result; so does a run without a CUDA device
or outside a checkout of the repository.

    python3 chip_smoke.py
"""
from __future__ import annotations

import dataclasses
import json
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

# INT32-pipe instructions (IADD3 / LOP3 / SHF / ISETP) per element of the
# bits stage, counted from csrc/thundering_block.cu and sampler_stage.cuh:
#   splitmix64: 64-bit root step and leaf add (4), XSH-RR (8), counter + 1
#     (2), the three xor-shifts of mix64 (12), the add into the seed (2),
#     the folds (2), address and store (4)                          = 34
#   fmix32: root and leaf (4), XSH-RR (8), the counter words and adds (4),
#     fmix32's three xor-shifts (6), fold (1), address and store (3) = 26
#   faithful: root and leaf (4), XSH-RR (8), the xorshift128 step (6),
#     fold (1), address and store (3)                                = 22
# The 64-bit multiplies run as IMAD on the FMA pipe and are not counted,
# so the operation bound below is a lower bound.
INT_OPS_PER_ELEMENT = {"splitmix64": 34, "fmix32": 26, "faithful": 22}

# The applications' kernels, counted from ``cuobjdump -sass`` of their
# sm_90a build (nvcc 12.8) with tools/sass_loop_counts.py over the hot
# path of each loop (slow paths that these inputs never take left out):
# (INT32-pipe instructions, all instructions) per (x, y) row for pi and the
# option, per element for dropout.
#   pi: the row loop, unrolled twice, 0960-1430: 100 INT32 of 174    /2
#   option: the row loop 0710-1730 less cosf's Payne-Hanek reduction
#     (0e60-1270, |2 pi u| < 105615 never takes it) and sqrtf's slow call
#     (13f0-1420): 70 INT32 of 189
#   dropout bf16: one 16-byte run of 8 elements, 05f0-0700, 0710-1d70,
#     3700-37f0: 233 INT32 of 393                                      /8
#   dropout f32: one run of 4, 05e0-06f0, 0700-1160, 2980-2a70: 121 INT32
#     of 201                                                           /4
# A warp scheduler issues one instruction per clock: 132 SMs x 4 x 32 lanes
# x 1.98 GHz.  The operation bound is the larger of the INT32 pipe's time
# and the issue time.
APP_OPS_PER_ELEMENT = {"pi": (50.0, 87.0), "option": (70.0, 189.0),
                       "dropout_bf16": (233 / 8, 393 / 8),
                       "dropout_f32": (121 / 4, 201 / 4)}
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
        info = path.with_suffix(".ptxas.txt")
        for line in info.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build seconds: {secs:.3f}")
    return secs


def _faithful_states(plan, rows: int, bt: int, device):
    from repro_torch.core import engine
    from repro_torch.kernels import thundering_block as tb
    return tb.states_tensor(
        engine._faithful_tile_states(plan, bt, -(-rows // bt)), device)


def phase_parity(device) -> dict:
    """Every kernel x stage x dtype x shape against the plain version."""
    from repro_torch.core import engine, sampler
    from repro_torch.kernels import thundering_block as tb
    shapes = [(40, 130, 12345), (1, 1, 7), (2, 1, HIGH_OFFSET),
              (256, S_FULL, HIGH_OFFSET)]
    worst = {"thundering_ctr": 0.0, "thundering_faithful": 0.0}
    stage_ulp: dict = {}
    n = 0
    t0 = time.perf_counter()
    cases = [("thundering_ctr", "splitmix64"), ("thundering_ctr", "fmix32"),
             ("thundering_faithful", None)]
    for T, S, off in shapes:
        plan = engine.make_plan(seed=SEED, num_streams=S, num_steps=T,
                                offset=off, device=device)
        bt = tb.tile_rows(engine.DEFAULT_BLOCK_T, T)
        st = _faithful_states(plan, T, bt, device)
        for spec_text, dtypes in STAGES:
            spec = sampler.parse(spec_text)
            if spec[0] == "normal" and T % 2:
                continue
            for dtype in dtypes:
                for kname, deco in cases:
                    if deco is not None:
                        got = tb.thundering_ctr(plan.x0, plan.ctr, T, plan.h,
                                                deco=deco, sampler=spec,
                                                out_dtype=dtype)
                        want = tb.thundering_ctr_plain(
                            plan.x0, plan.ctr, T, plan.h, deco=deco,
                            sampler=spec, out_dtype=dtype)
                    else:
                        got = tb.thundering_faithful(
                            plan.x0, plan.ctr, T, plan.h, st, block_t=bt,
                            sampler=spec, out_dtype=dtype)
                        want = tb.thundering_faithful_plain(
                            plan.x0, plan.ctr, T, plan.h, st, block_t=bt,
                            sampler=spec, out_dtype=dtype)
                    sync(device)
                    ok, err, ulp = compare(got, want, spec[0])
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


def phase_main_path(device) -> dict:
    """The port's main path at full size, through the user entry points."""
    import torch
    from repro_torch.core import engine, stream
    from repro_torch.kernels import thundering_block as tb
    from repro_torch.runtime.blocks import BlockService

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
    log(f"main path: {main_s:.2f} s wall; launches {launches}; plain "
        f"versions run on the card: {plain_runs}")
    log(f"producer: 8 blocks of {T_FULL}x{S_FULL} u32 (fuse=4, depth=2, "
        f"donate) in {prod_s:.3f} s = "
        f"{8 * T_FULL * S_FULL / prod_s / 1e9:.1f} GSample/s wall")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")
    require(plain_runs == 0, "a plain version ran on a CUDA tensor")

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


def phase_timing(device) -> list:
    """Kernel, plain and library times at the main path's shapes."""
    import torch
    from repro_torch.core import engine, sampler
    from repro_torch.kernels import thundering_block as tb

    plan = engine.make_plan(seed=SEED, num_streams=S_FULL, num_steps=T_FULL,
                            device=device)
    T, S = T_FULL, S_FULL
    elems = T * S
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rows = []

    def report(label, ms, out_bytes):
        gbps = out_bytes / (ms * 1e-3) / 1e9
        log(f"  {label}: {ms:.4f} ms  {elems / (ms * 1e-3) / 1e9:.1f} "
            f"GSample/s  {gbps:.1f} GB/s")

    def bound(out_bytes, in_bytes, ops_key):
        t_bytes = (out_bytes + in_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = elems * INT_OPS_PER_ELEMENT[ops_key] / INT32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes
                                     else "bytes")

    log(f"timing at T={T} S={S} (CUDA events):")
    variants = [("bits", "float32", "splitmix64", 4),
                ("bits", "float32", "fmix32", 4),
                ("uniform", "float32", "splitmix64", 4),
                ("uniform", "bfloat16", "splitmix64", 2),
                ("normal", "float32", "splitmix64", 4)]
    ctr_ms = None
    for spec_text, dtype, deco, width in variants:
        spec = sampler.parse(spec_text)
        out = torch.empty((T, S), dtype=sampler.result_dtype(spec, dtype),
                          device=device)

        def launch(spec=spec, dtype=dtype, deco=deco, out=out):
            tb.thundering_ctr(plan.x0, plan.ctr, T, plan.h, deco=deco,
                              sampler=spec, out_dtype=dtype, out=out)
        ms = time_cuda(launch, reps=20)
        report(f"thundering_ctr {deco} {spec_text} {dtype}", ms,
               elems * width)
        if (spec_text, deco) == ("bits", "splitmix64"):
            ctr_ms = ms
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
    ctr_bound, ctr_by = bound(elems * 4, S * 8, "splitmix64")
    rows.append(dict(name="thundering_ctr", ms=ctr_ms, plain_ms=plain_ctr,
                     bound_ms=ctr_bound, bound_by=ctr_by, library_ms=lib_ctr))

    faithful = dataclasses.replace(plan, mode="faithful")
    bt = tb.tile_rows(engine.DEFAULT_BLOCK_T, T)
    t0 = time.perf_counter()
    states_np = engine._faithful_tile_states(faithful, bt, -(-T // bt))
    prep_s = time.perf_counter() - t0
    states = tb.states_tensor(states_np, device)
    log(f"  faithful host prep (lane_table + GF(2) tile jumps, S={S}, "
        f"{states_np.shape[0]} tiles): {prep_s:.3f} s")
    out = torch.empty((T, S), dtype=torch.uint32, device=device)
    f_ms = time_cuda(lambda: tb.thundering_faithful(
        plan.x0, plan.ctr, T, plan.h, states, block_t=bt,
        sampler=bits_spec, out=out), reps=20)
    report("thundering_faithful bits", f_ms, elems * 4)
    plain_f = time_cuda(lambda: tb.thundering_faithful_plain(
        plan.x0, plan.ctr, T, plan.h, states, block_t=bt,
        sampler=bits_spec), reps=3, warmup=1)
    log(f"  thundering_faithful_plain bits: {plain_f:.4f} ms")
    f_bound, f_by = bound(elems * 4, S * 8 + states.numel() * 4, "faithful")
    rows.append(dict(name="thundering_faithful", ms=f_ms, plain_ms=plain_f,
                     bound_ms=f_bound, bound_by=f_by, library_ms=lib_ctr))
    for r in rows:
        log(f"  {r['name']}: bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({r['bound_ms'] / r['ms'] * 100:.1f}% of "
            f"the bound's speed)")
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
        log(f"  {name} kernel: {ms:.4f} ms = {N / (ms * 1e-3) / 1e9:.1f} G "
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
        moved = 2 * n * x.element_size()
        b_ms, b_by = bound(moved, n, "dropout_bf16"
                           if dtype == torch.bfloat16 else "dropout_f32")
        log(f"  fused_dropout_2d {dtype}: {ms:.4f} ms = "
            f"{moved / (ms * 1e-3) / 1e9:.1f} GB/s; bound {b_ms:.4f} ms by "
            f"{b_by} ({b_ms / ms * 100:.1f}% of the bound's speed); plain "
            f"{plain_ms:.2f} ms; torch F.dropout {lib_ms:.4f} ms")
        per_dtype[dtype] = dict(name="fused_dropout_2d", ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib_ms)
        del x, out
    rows.append(per_dtype[torch.bfloat16])   # the training dtype
    return rows


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
        run_phase("golden", phase_golden, device)
        launches = run_phase("main path", phase_main_path, device)
        launches.update(run_phase("apps path", phase_apps, device))
        timing = run_phase("timing", phase_timing, device)
        timing += run_phase("apps timing", phase_apps_timing, device)
        run_phase("delivery", phase_delivery, device)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = []
    for row in timing:
        name = row["name"]
        source, replaces = KERNEL_SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
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
