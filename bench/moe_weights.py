"""MoE model weights made by the benchmark from the seed, on the device,
as ``weights`` makes a dense model's: each leaf one ``randn`` call of a
generator of its own, seeded from (seed, leaf name), in the program's
layout (``reference.moe_lm.moe_lm_leaves``)."""
from __future__ import annotations

import math
from typing import Dict

import torch

from bench import weights
from bench.reference.moe_lm import moe_lm_leaves

STD = 0.02
#: leaves made as zeros (the norms' offsets: weight 1 + w)
ZERO = ("final_norm", "layers/attn_norm", "layers/mlp_norm")
#: output projections, drawn at STD / sqrt(2 x layers)
OUT = ("layers/wo", "layers/moe_wo")


def leaf(arch: Dict, seed: int, path: str, device) -> torch.Tensor:
    """One float32 leaf, made alone."""
    for p, shape in moe_lm_leaves(arch):
        if p != path:
            continue
        if p in ZERO:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        std = STD / math.sqrt(2.0 * arch["n_layers"]) if p in OUT else STD
        t = torch.randn(shape, generator=weights.generator(seed, p, device),
                        dtype=torch.float32, device=device)
        return t.mul_(std)
    raise KeyError(path)


def moe_lm(arch: Dict, seed: int, device) -> Dict:
    """The nested float32 parameter tree of a MoE decoder LM."""
    tree: Dict = {}
    for path, _ in moe_lm_leaves(arch):
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf(arch, seed, path, device)
    return tree
