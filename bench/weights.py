"""Model weights made by the benchmark from the seed, on the device.

The same tensors go to the program and to the plain reference.  Each leaf
has a generator of its own, seeded from (seed, leaf name), so that any leaf
can be made again alone; a leaf is one ``randn`` call on the device.  The
layout is the program's: every per-layer tensor stacked on a leading
layer axis, attention heads split into (kv heads, query repeats).
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, Tuple

import torch

M64 = (1 << 64) - 1


def mix_seed(seed: int, name: str) -> int:
    """A generator seed from the run's seed and a name."""
    d = hashlib.blake2s(f"{int(seed)}/{name}".encode(), digest_size=8)
    return int.from_bytes(d.digest(), "little") & M64


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(mix_seed(seed, name))
    return g


def dense_lm_leaves(arch: Dict) -> Iterator[Tuple[str, tuple, float]]:
    """(path, shape, std) of every leaf of a dense decoder LM; std 0 makes
    a zero leaf (the norms' offsets: weight 1 + w).  With ``qkv_bias`` the
    q, k and v projections carry biases, drawn like the weights so that
    the forward pass reads them."""
    L, D, V, F = arch["n_layers"], arch["d_model"], arch["vocab"], arch["d_ff"]
    H, K = arch["n_heads"], arch["n_kv_heads"]
    hd = arch.get("head_dim") or D // H
    R = H // K
    std = 0.02
    out_std = std / math.sqrt(2.0 * L)
    yield "embed", (V, D), std
    yield "final_norm", (D,), 0.0
    if not arch.get("tie_embeddings", False):
        yield "unembed", (V, D), std
    yield "layers/attn_norm", (L, D), 0.0
    yield "layers/wq", (L, D, K, R, hd), std
    yield "layers/wk", (L, D, K, hd), std
    yield "layers/wv", (L, D, K, hd), std
    yield "layers/wo", (L, K, R, hd, D), out_std
    if arch.get("qkv_bias", False):
        yield "layers/bq", (L, K, R, hd), std
        yield "layers/bk", (L, K, hd), std
        yield "layers/bv", (L, K, hd), std
    yield "layers/mlp_norm", (L, D), 0.0
    yield "layers/wg", (L, D, F), std
    yield "layers/wi", (L, D, F), std
    yield "layers/wo_mlp", (L, F, D), out_std


def leaf(arch: Dict, seed: int, path: str, device) -> torch.Tensor:
    """One float32 leaf, made alone."""
    for p, shape, std in dense_lm_leaves(arch):
        if p == path:
            if std == 0.0:
                return torch.zeros(shape, dtype=torch.float32, device=device)
            t = torch.randn(shape, generator=generator(seed, p, device),
                            dtype=torch.float32, device=device)
            return t.mul_(std)
    raise KeyError(path)


def dense_lm(arch: Dict, seed: int, device) -> Dict:
    """The nested float32 parameter tree of a dense decoder LM."""
    tree: Dict = {}
    for path, _, _ in dense_lm_leaves(arch):
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf(arch, seed, path, device)
    return tree


def flat(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = v
    return out


def tokens(seed: int, name: str, shape, vocab: int, device) -> torch.Tensor:
    """Token ids drawn uniformly over the vocabulary, int32, on the
    device, from their own generator."""
    g = generator(seed, name, device)
    return torch.randint(0, vocab, tuple(shape), generator=g,
                         device=torch.device(device),
                         dtype=torch.int64).to(torch.int32)
