"""Shape grid and config registry (the reference's ``configs/base.py``).

Shapes (assigned):
  train_4k     seq 4096   global_batch 256   (training)
  prefill_32k  seq 32768  global_batch 32    (inference prefill)
  decode_32k   ctx 32768  global_batch 128   (one-token decode step)
  long_500k    ctx 524288 global_batch 1     (long-context decode;
               sub-quadratic archs only — full-attention archs skip)

``input_specs`` (abstract inputs for the dry run) waits for the port of
``launch/dryrun``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

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
