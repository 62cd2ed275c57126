"""Shape grid, config registry and ``meta`` input specs (the reference's
``configs/base.py``).

Shapes (assigned):
  train_4k     seq 4096   global_batch 256   (training)
  prefill_32k  seq 32768  global_batch 32    (inference prefill)
  decode_32k   ctx 32768  global_batch 128   (one-token decode step)
  long_500k    ctx 524288 global_batch 1     (long-context decode;
               sub-quadratic archs only — full-attention archs skip)
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.common import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCH_IDS = [
    "gemma_7b", "glm4_9b", "qwen15_32b", "granite_34b", "qwen2_vl_72b",
    "granite_moe_3b", "olmoe_1b_7b", "mamba2_2p7b", "zamba2_7b",
    "whisper_small",
]

# accept dashed public ids too
_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update({
    "gemma-7b": "gemma_7b", "glm4-9b": "glm4_9b",
    "qwen1.5-32b": "qwen15_32b", "granite-34b": "granite_34b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "olmoe-1b-7b": "olmoe_1b_7b", "mamba2-2.7b": "mamba2_2p7b",
    "zamba2-7b": "zamba2_7b", "whisper-small": "whisper_small",
})


def get_config(arch: str) -> ArchConfig:
    key = _ALIASES.get(arch, arch)
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def shape_skipped(cfg: ArchConfig, shape: str) -> Optional[str]:
    """Reason this (arch, shape) cell is skipped, or None if runnable."""
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return ("pure full-attention arch: 500k-token decode needs "
                "sub-quadratic attention (DESIGN.md §Arch-applicability)")
    return None


def runnable_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape_skipped(cfg, shape) is None:
                yield arch, shape


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape_name: str,
                model=None) -> Dict[str, Any]:
    """``meta`` tensor stand-ins for one step of the given kind.

    train  -> {"tokens", "labels"} (+ "patches"/"frames")
    prefill-> {"tokens"} (+ extras)
    decode -> {"token", "cache", "pos"} - the cache from
              ``Model.init_cache`` on ``meta`` (no allocation; ``model``
              must be a ``meta`` model when given).
    """
    spec = SHAPES[shape_name]
    B, S = spec.global_batch, spec.seq_len
    extras: Dict[str, Any] = {}
    if cfg.family == "vlm":
        extras["patches"] = _meta((B, cfg.vision_prefix, cfg.d_model),
                                  L.COMPUTE_DTYPE)
    if cfg.family == "encdec":
        extras["frames"] = _meta((B, cfg.enc_ctx, cfg.d_model),
                                 L.COMPUTE_DTYPE)
    if spec.kind == "train":
        return {"tokens": _meta((B, S), torch.int32),
                "labels": _meta((B, S), torch.int32), **extras}
    if spec.kind == "prefill":
        return {"tokens": _meta((B, S), torch.int32), **extras}
    if spec.kind == "decode":
        from repro_torch.models import registry
        m = model or registry.build(cfg, "meta")
        if m.device.type != "meta":
            raise ValueError(f"input_specs builds the decode cache on "
                             f"meta only, not on {m.device}")
        return {"token": _meta((B, 1), torch.int32),
                "cache": m.init_cache(B, S),
                "pos": _meta((), torch.int32)}
    raise ValueError(spec.kind)
