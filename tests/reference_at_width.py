#!/usr/bin/env python3
"""The reference and the port side by side at granite-34b's published
width, cut to one layer, on the CPU: d_model 6144, 48 heads over one KV
head, d_ff 24576 plain GELU, vocab 49152, batch 8 x 256, seed 0, float32
parameters, gradients, m and v, three steps of each package's own
``make_train_step`` (AdamW at the reference schedule, 3e-6 at step 1).
Each package runs in a process of its own, one after the other, from its
own init and its own batches (the two agree bit for bit at the smoke
widths the tests hold them at).  Prints, for each, the loss of steps 0-2
and the loss of batch 0 after the first AdamW step, and last the port's
difference from the reference.  Not collected by pytest: it needs about
26 GB of memory and 15 minutes of eight cores.

    python3 tests/reference_at_width.py
"""
from __future__ import annotations

import multiprocessing
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH, LAYERS, BATCH, SEQ, STEPS, SEED = "granite_34b", 1, 8, 256, 3, 0


def reference(out) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import stream as tstream
    from repro.launch import steps
    from repro.launch.train import pipeline_for
    from repro.models import registry
    from repro.optim import adamw_init
    cfg = get_config(ARCH).scaled(n_layers=LAYERS)
    model = registry.build(cfg)
    pipe = pipeline_for(cfg, BATCH, SEQ, SEED)
    batch_at = jax.jit(pipe.batch_at)
    step_fn = jax.jit(steps.make_train_step(model, seed=SEED,
                                            total_steps=STEPS),
                      donate_argnums=(0, 1))
    rng0 = jax.jit(lambda: tstream.derive(tstream.new_stream(SEED, 0xD07),
                                          jnp.uint32(0)))()
    params, _ = model.init(SEED)
    opt = adamw_init(params)
    losses, after = [], None
    for s in range(STEPS):
        params, opt, met = step_fn(params, opt, batch_at(jnp.int32(s)),
                                   jnp.int32(s))
        losses.append(float(met["loss"]))
        if s == 0:
            after = float(jax.jit(model.loss)(params, batch_at(jnp.int32(0)),
                                              rng0)[0])
    out.put(("reference (JAX)", losses, after))


def port(out) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import stream as tstream
    from repro_torch.launch import steps
    from repro_torch.launch.train import pipeline_for
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    cpu = torch.device("cpu")
    cfg = get_config(ARCH).scaled(n_layers=LAYERS)
    model = registry.build(cfg, cpu)
    pipe = pipeline_for(cfg, BATCH, SEQ, SEED, device=cpu)
    step_fn = steps.make_train_step(model, seed=SEED, total_steps=STEPS)
    rng0 = tstream.derive(tstream.new_stream(SEED, 0xD07, device=cpu), 0)
    params, _ = model.init(SEED)
    opt = adamw_init(params)
    losses, after = [], None
    for s in range(STEPS):
        params, opt, met = step_fn(params, opt, pipe.batch_at(s), s)
        losses.append(float(met["loss"]))
        if s == 0:
            with torch.no_grad():
                after = float(model.loss(params, pipe.batch_at(0), rng0)[0])
    out.put(("port (PyTorch)", losses, after))


def main() -> int:
    sys.path[:0] = [str(ROOT / "src")]
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])
    ctx = multiprocessing.get_context("spawn")
    print(f"{ARCH}: {LAYERS} layer at published width, batch {BATCH} x "
          f"{SEQ}, {STEPS} steps, seed {SEED}, on the CPU", flush=True)
    runs = []
    for side in (reference, port):
        out = ctx.Queue()
        p = ctx.Process(target=side, args=(out,))
        p.start()
        p.join()
        if p.exitcode:
            return p.exitcode
        runs.append(out.get())
        name, losses, after = runs[-1]
        print(f"{name}: losses of steps 0-{STEPS - 1} {losses}; batch 0 "
              f"after the first AdamW step {after} (change "
              f"{after - losses[0]:+.6f})", flush=True)
    (_, lr, ar), (_, lp, ap) = runs
    print(f"port - reference: losses "
          f"{[round(b - a, 7) for a, b in zip(lr, lp)]}; batch 0 after the "
          f"first step {ap - ar:+.7f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
