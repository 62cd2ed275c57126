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
3072), with ``ops.fused_dropout`` end to end on the host clock and
``F.dropout`` as its yardstick), D and E (pi and option partials, 2^14
lanes x 2^14 draws) and F (gumbel-max at (V, B) = (256000, 64),
(256000, 256), (256000, 8) and the families' vocabularies at B = 64).

Kernel F is measured three ways at each shape: the CUDA-event ms of the
wrapper (50 back-to-back calls), the device ms per launch of each device
op under ``torch.profiler`` (their sum is a call's device time: each op
runs once a call) with the number of device ops, and the host's ms per
call for 50 enqueues without a synchronize; beside them torch's
Philox Gumbel-max on the same logits.  Its tokens and winning scores at
every timed shape (three cases each) go into the line as digests, and

    python3 tools/kernel_times.py --check FILE

exits 1 unless every line of FILE holds the same digests: run it after
the checkouts' lines to show that parent and change sample alike.
``--only F`` builds and times kernel F alone.  ``--sweep`` (a checkout
whose wrapper has launch plans) also takes kernel F's device time under
every launch plan the card holds in one wave at each shape and over a
scan of V at B = 64 and 8, the host's time for each part of the
wrapper, and the SM clock while F runs; the results go into the line
under "sweep".

Two calls may land on two cards, so compare checkouts inside one call,
in turns: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (_philox_gumbel_ms, device_ops,  # noqa: E402
                        enqueue_ms, host_ms, time_cuda)

T, S = 4096, 2 ** 14
SEED = 42
DROPOUT_SHAPE = (8 * 4096, 3072)
APP = 2 ** 14
# kernel F: gemma-7b's vocabulary at the batcher's 64, the reference
# kernel's batch tile of 256 and a small batch of 8; the five families'
# vocabularies (olmoe, granite-moe, mamba2, zamba2, whisper) at 64
F_SHAPES = ((256000, 64), (256000, 256), (256000, 8), (50304, 64),
            (49155, 64), (50280, 64), (32000, 64), (51865, 64))
# (ctr, top_k, inv_temp, deco) of the digested cases at each shape; ctr
# -1 stands for 2**64 - V, a window that ends where the counter wraps
F_CASES = ((977, 0, 1.0, "splitmix64"), (-1, 50, 1.25, "splitmix64"),
           (2 ** 32 + 12345, 0, 2.0, "fmix32"))


def measure(device) -> dict:
    import torch
    from repro_torch.core import engine, lcg, sampler
    from repro_torch.inference.kernels import gumbel_argmax as ga
    from repro_torch.kernels import build, fused_dropout as fd, mc, ops
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
        ms[name + "_ops_wall"] = host_ms(lambda: ops.fused_dropout(x, s, 0.1),
                                         reps=20)
        ms[name + "_F_dropout"] = time_cuda(
            lambda: torch.nn.functional.dropout(x, 0.1, training=True),
            reps=20)
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
    return ms


def measure_f(device) -> tuple:
    """Kernel F at ``F_SHAPES``: ({key: ms}, {shape: digest}, {shape:
    launch plan}).  Where the checkout's wrapper has launch plans, the
    CUDA-event ms is also taken under the plan of clusters of at most 8
    and of at most 16 blocks."""
    import torch
    from repro_torch.core import engine
    from repro_torch.inference.kernels import gumbel_argmax as ga
    ms, digests, plans = {}, {}, {}
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    card = ga._card(device) if hasattr(ga, "launch_plan") else None
    for V, B in F_SHAPES:
        tag = f"F_V{V}_B{B}"
        g = torch.Generator(device=device)
        g.manual_seed(9)
        logits = torch.randn((B, V), generator=g, device=device)
        x0, h_fam = engine.family_from_seed(9, 0xD0)
        h = ga.leaf_words([engine.derive_leaf_host(h_fam, t)
                           for t in range(B)], device)
        th = torch.full((B,), float("-inf"), device=device)
        tok = torch.empty(B, dtype=torch.int32, device=device)

        def call():
            ga.fused_argmax(logits, h, x0, 977, th, inv_temp=1.0, out=tok)
        ms[tag] = time_cuda(call, reps=50)
        ms[tag + "_enqueue"] = enqueue_ms(call, reps=50)
        # each device op of a call runs once in every checkout: the
        # call's device time is the sum of their times per launch
        ops = device_ops(call, reps=50)
        ms[tag + "_device"] = sum(t for t, _ in ops.values())
        ms[tag + "_device_ops"] = len(ops)
        ms[tag + "_device_launches_recorded_per_call"] = sum(
            n for _, n in ops.values())
        for name, (t, _) in ops.items():
            ms[f"{tag}_device[{name}]"] = t
        ms[tag + "_philox"] = _philox_gumbel_ms(logits, gen)
        if card is not None:
            # the plan with clusters of at most 8 (portable) and of at most
            # 16 blocks
            default = card.plan(B, V)
            for most in (8, 16):
                card.plans[B, V] = ga.launch_plan(B, V, {
                    k: n for k, n in card.max_clusters.items()
                    if k[1] <= most})
                ms[f"{tag}_limit{most}"] = time_cuda(call, reps=50)
                plans[f"{tag}_limit{most}"] = card.plans[B, V][:2]
            card.plans[B, V] = default
        sha = hashlib.sha256()
        for ctr, top_k, inv_temp, deco in F_CASES:
            ctr = ctr if ctr >= 0 else 2 ** 64 - V
            thk = (torch.topk(logits, top_k, dim=-1).values[:, -1] if top_k
                   else th)
            scores = torch.empty(B, device=device)
            got = ga.fused_argmax(logits, h, x0, ctr, thk, inv_temp=inv_temp,
                                  deco=deco, scores_out=scores)
            sha.update(got.cpu().numpy().tobytes())
            sha.update(scores.cpu().numpy().tobytes())
        digests[f"V{V}_B{B}"] = sha.hexdigest()[:16]
        del logits
    return ms, digests, plans


def sweep_f(device) -> dict:
    """Kernel F's device ms per call (``torch.profiler``) under every
    one-wave launch plan at ``F_SHAPES`` and over a scan of V under the
    default plan, the card's resident clusters per (threads, cluster), the
    host's us per call of each part of the wrapper, and the SM clock while
    F runs."""
    import torch
    from repro_torch.core import engine, lcg
    from repro_torch.inference.kernels import gumbel_argmax as ga
    out = {"plans": {}, "scan": {}}
    x0, h_fam = engine.family_from_seed(9, 0xD0)

    def case(V, B):
        g = torch.Generator(device=device)
        g.manual_seed(9)
        logits = torch.randn((B, V), generator=g, device=device)
        h = ga.leaf_words([engine.derive_leaf_host(h_fam, t)
                           for t in range(B)], device)
        th = torch.full((B,), float("-inf"), device=device)
        tok = torch.empty(B, dtype=torch.int32, device=device)
        return (lambda: ga.fused_argmax(logits, h, x0, 977, th, inv_temp=1.0,
                                        out=tok)), (logits, h, th, tok)

    def dev_ms(call):
        return sum(t for t, _ in device_ops(call, reps=20).values())
    card = ga._card(device)
    out["max_clusters"] = {f"{t}x{c}": n
                           for (t, c), n in card.max_clusters.items()}
    for V, B in F_SHAPES:
        call, _ = case(V, B)
        default = card.plan(B, V)
        for (threads, c), n in sorted(card.max_clusters.items()):
            if n < B or (c - 1) * threads >= V:
                continue
            card.plans[B, V] = ga.LaunchPlan(c, threads,
                                             *lcg.lcg_skip(c * threads))
            out["plans"][f"V{V}_B{B}_{c}x{threads}"] = dev_ms(call)
        card.plans[B, V] = default
        out["plans"][f"V{V}_B{B}_default"] = list(default[:2])
    for B in (64, 8):
        for V in (64, 1024, 8192, 32768, 65536, 131072, 256000):
            call, _ = case(V, B)
            out["scan"][f"V{V}_B{B}"] = [dev_ms(call),
                                         list(card.plan(B, V)[:2])]
    call, (logits, h, th, tok) = case(50304, 64)
    plan = card.plan(64, 50304)
    stream = torch.cuda.current_stream(device).cuda_stream
    aff = card.affine[plan.threads].data_ptr()
    args = (logits.data_ptr(), logits.stride(0), logits.stride(1), 64, 50304,
            h.data_ptr(), th.data_ptr(), x0, 977, 1.0, 0, plan.threads,
            plan.cluster, aff, plan.jump_a, plan.jump_c, tok.data_ptr(), 0,
            card.index, stream)
    one = args[:11] + (1024, 1, card.affine[1024].data_ptr()) + \
        tuple(lcg.lcg_skip(1024)) + args[16:]
    pack = ga._LAUNCH_ARGS.pack
    parts = {"wrapper": call,
             "ga_launch": lambda: card.lib.ga_launch(pack(*args)),
             "ga_launch_cluster_1": lambda: card.lib.ga_launch(pack(*one)),
             "pack": lambda: pack(*args),
             "ctypes_call": lambda: card.lib.ga_error_string(0),
             "current_stream": lambda: torch.cuda.current_stream(
                 device).cuda_stream,
             "current_raw_stream": lambda: ga._current_stream(card.index),
             "check": lambda: ga._check(logits, h, th),
             "empty": lambda: torch.empty(64, dtype=torch.int32,
                                          device=device)}
    out["host_us"] = {k: enqueue_ms(f, reps=200) * 1e3
                      for k, f in parts.items()}
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "20"], stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.5:
        for _ in range(100):
            call()
        torch.cuda.synchronize()
    smi.terminate()
    clocks = [int(x) for x in smi.communicate(timeout=30)[0].split()
              if x.strip().isdigit()]
    out["sm_clock_mhz_during_F"] = clocks
    return out


def check(path: str) -> int:
    """0 if every line of ``path`` holds the same kernel F digests."""
    lines = [json.loads(x) for x in Path(path).read_text().splitlines()
             if x.strip()]
    first = lines[0]["digests"] if lines else None
    ok = bool(lines) and all(x["digests"] == first for x in lines)
    labels = ", ".join(x["label"] for x in lines)
    print(f"kernel_times --check: {len(lines)} lines ({labels}); kernel F "
          f"tokens and winning scores {'equal' if ok else 'DIFFER'} at "
          f"{len(first or {})} shapes x {len(F_CASES)} cases")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None, help="append the line here")
    ap.add_argument("--only", choices=("F",), default=None,
                    help="build and time kernel F alone")
    ap.add_argument("--sweep", action="store_true",
                    help="time kernel F under every one-wave launch plan")
    ap.add_argument("--check", default=None, metavar="FILE",
                    help="compare the kernel F digests of FILE's lines")
    args = ap.parse_args(argv)
    if args.check:
        return check(args.check)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    if args.only == "F":
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.build_all(["gumbel_argmax"])
        ms = {"build_s": time.perf_counter() - t0}
    else:
        ms = measure(device)
    f_ms, digests, plans = measure_f(device)
    ms.update(f_ms)
    result = {"label": args.label, "src": args.src, "card": card, "ms": ms,
              "digests": digests, "plans": plans}
    if args.sweep:
        result["sweep"] = sweep_f(device)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
