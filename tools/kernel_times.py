#!/usr/bin/env python3
"""Time the port's six CUDA kernels on one card, to compare two checkouts.

    python3 tools/kernel_times.py [--src DIR] [--label NAME] [--out FILE]

Imports ``repro_torch`` from DIR (default: this checkout's ``src/``),
builds its kernels and prints one JSON line of CUDA-event ms per call at
the main paths' shapes: kernel A (``thundering_ctr``: bits splitmix64 and
fmix32, uniform float32 and bfloat16, normal float32 at (T, S) = (4096,
2^14)), kernel B's launch alone (``tb_faithful_launch`` on host-jumped
tile states, the C entry every version of the library has) and a whole
faithful ``engine.generate`` on the host clock (its tile-state prep
included), Philox ``Tensor.random_`` over the same (T, S) as the
yardstick, kernel C (fused dropout, bfloat16 and float32 at (32768,
3072)), D and E (pi and option partials, 2^14 lanes x 2^14 draws) and F
(gumbel-max at (V, B) = (256000, 64) and (256000, 256)).

Two calls may land on two cards, so compare checkouts inside one call,
in turns: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

T, S = 4096, 2 ** 14
SEED = 42
DROPOUT_SHAPE = (8 * 4096, 3072)
APP = 2 ** 14


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
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


def measure(device) -> dict:
    import torch
    from repro_torch.core import engine, lcg, sampler
    from repro_torch.inference.kernels import gumbel_argmax as ga
    from repro_torch.kernels import build, fused_dropout as fd, mc
    from repro_torch.kernels import thundering_block as tb
    from repro_torch.core import stream

    t0 = time.perf_counter()
    build.build_all()
    ms = {"build_s": time.perf_counter() - t0}
    plan = engine.make_plan(seed=SEED, num_streams=S, num_steps=T,
                            device=device)
    for label, spec, dtype, deco in (
            ("A_bits_splitmix64", "bits", "float32", "splitmix64"),
            ("A_bits_fmix32", "bits", "float32", "fmix32"),
            ("A_uniform_f32", "uniform", "float32", "splitmix64"),
            ("A_uniform_bf16", "uniform", "bfloat16", "splitmix64"),
            ("A_normal_f32", "normal", "float32", "splitmix64")):
        sp = sampler.parse(spec)
        out = torch.empty((T, S), dtype=sampler.result_dtype(sp, dtype),
                          device=device)
        ms[label] = time_cuda(lambda: tb.thundering_ctr(
            plan.x0, plan.ctr, T, plan.h, deco=deco, sampler=sp,
            out_dtype=dtype, out=out), reps=20)
        del out
    bits = torch.empty((T, S), dtype=torch.int32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    ms["philox_random_"] = time_cuda(lambda: bits.random_(generator=gen),
                                     reps=20)

    faithful = engine.make_plan(seed=SEED, num_streams=S, num_steps=T,
                                mode="faithful", device=device)
    bt = tb.tile_rows(engine.DEFAULT_BLOCK_T, T)
    n_tiles = -(-T // bt)
    states = tb.states_tensor(
        engine._faithful_tile_states(faithful, bt, n_tiles), device)
    rec, _ = tb._stage(sampler.parse("bits"), "float32", device)
    lib = tb._lib()
    # h as the checkout's library reads it: int64 limb words, or (before
    # limb_words) int32 words
    words = getattr(tb, "limb_words", tb.u32_device)
    h_hi, h_lo = words(plan.h[0]), words(plan.h[1])
    out = torch.empty((T, S), dtype=torch.uint32, device=device)
    stream_ptr = torch.cuda.current_stream(device).cuda_stream

    def kernel_b():
        code = lib.tb_faithful_launch(
            out.data_ptr(), T, S, lcg.advance(plan.x0, plan.ctr),
            h_hi.data_ptr(), h_lo.data_ptr(), states.data_ptr(), n_tiles,
            bt, ctypes.byref(rec), stream_ptr)
        assert code == 0, code
    ms["B_bits_kernel"] = time_cuda(kernel_b, reps=20)
    engine.generate(faithful, out=out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        engine.generate(faithful, out=out)
    torch.cuda.synchronize()
    ms["B_generate_wall"] = (time.perf_counter() - t0) / 3 * 1e3
    del out, bits

    s = stream.new_stream(SEED, 0, device=device)
    for name, dtype in (("C_dropout_bf16", torch.bfloat16),
                        ("C_dropout_f32", torch.float32)):
        x = torch.randn(DROPOUT_SHAPE, generator=gen, device=device,
                        dtype=dtype)
        y = torch.empty_like(x)
        ms[name] = time_cuda(lambda: fd.fused_dropout_2d(
            x, s.h, s.x0, s.ctr, 0.1, out=y), reps=20)
        del x, y
    bt_mc, tiles_mc = mc.tile_layout(APP, mc.DEFAULT_BLOCK_T)
    for name, fn, purposes, kw in (
            ("D_pi", mc.pi_partials, (1, 2), {}),
            ("E_option", mc.option_partials, (3, 4),
             dict(s0=100.0, strike=100.0, r=0.05, sigma=0.2, t=1.0))):
        px, py = (engine.make_plan(seed=SEED, num_streams=APP,
                                   num_steps=APP, purpose=p, device=device)
                  for p in purposes)
        part = torch.empty((tiles_mc, APP), device=device,
                           dtype=torch.int32 if name == "D_pi"
                           else torch.float32)
        ms[name] = time_cuda(lambda: fn(px.x0, px.ctr, APP, px.h, py.h,
                                        out=part, **kw), reps=10)
    for B in (64, 256):
        V = 256000
        g = torch.Generator(device=device)
        g.manual_seed(9)
        logits = torch.randn((B, V), generator=g, device=device)
        x0, h_fam = engine.family_from_seed(9, 0xD0)
        h = ga.leaf_words([engine.derive_leaf_host(h_fam, t)
                           for t in range(B)], device)
        th = torch.full((B,), float("-inf"), device=device)
        tok = torch.empty(B, dtype=torch.int32, device=device)
        ms[f"F_gumbel_argmax_B{B}"] = time_cuda(lambda: ga.fused_argmax(
            logits, h, x0, 977, th, inv_temp=1.0, out=tok), reps=50)
        del logits
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None, help="append the line here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    line = json.dumps({"label": args.label, "src": args.src, "card": card,
                       "ms": measure(torch.device("cuda"))})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
