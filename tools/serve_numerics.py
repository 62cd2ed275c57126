#!/usr/bin/env python3
"""How far bf16 decode drifts from forward at full width, sound and with
planted faults, on a card: the readings behind chip_smoke's
``SERVE_DECODE_RMS_RATIO``.

For each init seed and row set (``batch_at(step)`` of the data pipeline,
``--rows`` x ``--positions`` tokens) it runs chip_smoke's
``_decode_and_forward`` with bf16 and with float32 activations, and
prints the ratio of bf16 decode's distance from the float32 forward
logits to bf16 forward's (max abs, and root mean square).  Then, for each
fault planted in memory (the code on disk is unchanged), decode's ratio
and the excess over the reference's slack of chip_smoke's two other
decode checks (float32 activations at full depth, bf16 at 2 layers):

  f8-cache      the KV cache stored as float8_e4m3fn, not bf16
  bf16-logits   the attention's q.k products summed in bf16, not float32
  bf16-rope     the rotary embedding computed in bf16, not float32
  pos-1         each token decoded one position early

One JSON line per reading.

    python3 tools/serve_numerics.py --out chiprun_out/serve_numerics.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FAULTS = ("f8-cache", "bf16-logits", "bf16-rope", "pos-1")


def _bf16_attn_logits(q, k, scale):
    import torch
    return torch.einsum("bqkrd,btkd->bkrqt", q,
                        k.to(q.dtype)).float() * scale


def _bf16_rope(x, positions, theta):
    import torch
    from repro_torch.models import layers as L
    freqs = torch.from_numpy(L.rope_freqs(x.shape[-1], theta)).to(x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    for _ in range(x.ndim - angles.ndim):
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles).to(x.dtype), torch.sin(angles).to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def _faulty(fault, model):
    """``model`` with a fault that lives in its config or its decode
    call planted."""
    from repro_torch.models import registry
    if fault == "f8-cache":
        return registry.build(model.cfg.scaled(kv_dtype="f8"), model.device)
    if fault == "pos-1":
        return dataclasses.replace(model, decode=lambda p, c, t, pos:
                                   model.decode(p, c, t, max(pos - 1, 0)))
    return model


@contextlib.contextmanager
def _patched(fault):
    """A fault of the layers module planted while open."""
    from repro_torch.models import layers as L
    saved = L._attn_logits, L.apply_rope
    if fault == "bf16-logits":
        L._attn_logits = _bf16_attn_logits
    if fault == "bf16-rope":
        L.apply_rope = _bf16_rope
    try:
        yield
    finally:
        L._attn_logits, L.apply_rope = saved


def _runs(model, two, params, p2, toks, fault=None):
    """(decode, forward) logits in bf16, with float32 activations, and in
    bf16 at 2 layers; with ``fault`` planted when given."""
    import torch
    import chip_smoke as cs
    from repro_torch.models import layers as L
    if fault is not None:
        model, two = _faulty(fault, model), _faulty(fault, two)
    with _patched(fault):
        bf16 = cs._decode_and_forward(model, params, toks)
        L.COMPUTE_DTYPE = torch.float32
        try:
            f32 = cs._decode_and_forward(model, params, toks)
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        return bf16, f32, cs._decode_and_forward(two, p2, toks)


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.train import pipeline_for
    from repro_torch.models import registry
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--steps", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_numerics: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    cfg = get_config(cs.SERVE_ARCH)
    model = registry.build(cfg, dev)
    two = registry.build(cfg.scaled(n_layers=2), dev)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        params = p2 = None
        torch.cuda.empty_cache()
        params, _ = model.init(seed)
        p2 = dict(params, layers={k: v[:2]
                                  for k, v in params["layers"].items()})
        for step in args.steps:
            t0 = time.perf_counter()
            toks = pipeline_for(cfg, cs.SERVE_ROWS, cs.SERVE_POSITIONS,
                                seed, device=dev).batch_at(step)["tokens"]
            (dec, full), (_, full32), (_, full2) = _runs(
                model, two, params, p2, toks)
            e_fwd = float((full - full32).abs().max())
            for fault in (None,) + FAULTS:
                (dec, _), (dec32, _), (dec2, _) = _runs(
                    model, two, params, p2, toks, fault)
                line = {
                    "seed": seed, "step": step, "fault": fault or "none",
                    "rows": cs.SERVE_ROWS, "positions": cs.SERVE_POSITIONS,
                    "forward_from_f32": e_fwd,
                    "decode_from_f32": float((dec - full32).abs().max()),
                    "ratio_max": float((dec - full32).abs().max()) / e_fwd,
                    "ratio_rms": cs._rms(dec, full32) / cs._rms(full, full32),
                    "excess_f32_full_depth": cs._excess(dec32, full32),
                    "excess_bf16_2_layers": cs._excess(dec2, full2),
                    "finite": bool(torch.isfinite(dec).all()),
                    "card": card,
                    "seconds": round(time.perf_counter() - t0, 1)}
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
