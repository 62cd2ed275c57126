#!/usr/bin/env python3
"""The gradient of a full-width train config against the loss itself, on a
card: at the depth chip_smoke trains it (``_trained_cfg``), batch 8 x
256, step 0's rng, for each gradient leaf the central difference of
``model.loss`` along sign(g) with a step that moves the loss by about
0.02, against sum |g| - the directional derivative the gradient predicts
(ratio 1 when they agree); then one sign step of the reference
schedule's lr at step 1 (3e-4 warmed up over 100 steps: 3e-6) on every
leaf - what AdamW's first update is - against its first-order
prediction, -lr * sum |g|.  Also each of the first three batches' loss
at the init parameters.  Prints one ``GRADDIR`` line per reading, beside
the card's name and power limit.

    python3 tools/grad_direction.py arch [arch ...]

Exits non-zero when there is no card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="+")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from repro_torch.core import stream as tstream
    from repro_torch.launch import steps
    from repro_torch.launch.train import pipeline_for
    from repro_torch.models import registry
    from repro_torch.models.common import flatten
    from repro_torch.optim import cosine_schedule
    lr = float(cosine_schedule(3e-4, 100, cs.TRAIN_FAMILY_STEPS)(1))
    if not torch.cuda.is_available():
        print("grad_direction: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    cs.log(f"card: {cs.card_line()}")
    cs.run_phase("build", cs.phase_build)
    for arch in args.archs:
        cfg = cs._trained_cfg(arch)
        shape = cs._trained_shape(arch)
        model = registry.build(cfg, device)
        params, _ = model.init(cs.TRAIN_SEED)
        pipe = pipeline_for(cfg, shape["batch"], shape["seq"], cs.TRAIN_SEED,
                            device=device)
        root = tstream.new_stream(cs.TRAIN_SEED, 0xD07, device=device)
        batch, rng = pipe.batch_at(0), tstream.derive(root, 0)
        with torch.no_grad():
            at_init = [float(model.loss(params, pipe.batch_at(s),
                                        tstream.derive(root, s))[0])
                       for s in range(3)]
        cs.log(f"GRADDIR {arch} ({cfg.n_layers} layers): loss of batches "
               f"0-2 at the init parameters {at_init}")
        (loss0, _), grads = steps.value_and_grad(model, params, batch, rng)
        loss0 = float(loss0)
        fp, fg = flatten(params), flatten(grads)

        def loss() -> float:
            return float(model.loss(params, batch, rng)[0])

        l1_total = 0.0
        with torch.no_grad():
            for k in sorted(fg):
                l1 = float(fg[k].abs().sum(dtype=torch.float64))
                l1_total += l1
                if l1 == 0.0:
                    cs.log(f"GRADDIR {arch} {k}: sum |g| 0")
                    continue
                eps = 0.02 / l1
                u = torch.sign(fg[k])
                keep = fp[k].clone()
                fp[k].add_(u, alpha=eps)
                up = loss()
                fp[k].copy_(keep)
                fp[k].sub_(u, alpha=eps)
                down = loss()
                fp[k].copy_(keep)
                del u, keep
                fd = (up - down) / (2 * eps)
                cs.log(f"GRADDIR {arch} {k} {tuple(fg[k].shape)}: sum |g| "
                       f"{l1:.6g}; central difference {fd:.6g} (ratio "
                       f"{fd / l1:.4f}) at eps {eps:.3g}")
            for k in fg:
                fp[k].sub_(torch.sign(fg[k]), alpha=lr)
            stepped = loss()
        cs.log(f"GRADDIR {arch}: loss {loss0:.6f}; after a sign step of "
               f"{lr:g} on every leaf {stepped:.6f} (change "
               f"{stepped - loss0:.5g}; first order predicts "
               f"{-lr * l1_total:.5g}) ({cs.card_line()})")
        del params, grads, fp, fg, model
        cs._free_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
