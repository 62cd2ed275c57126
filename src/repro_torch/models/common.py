"""ArchConfig + parameter initialization driven by ThundeRiNG streams.

Every weight tensor is drawn from a named ``ThunderStream`` leaf derived
from (seed, parameter path), so initialization is a pure function of the
seed.  The logical sharding axes of each parameter ride along in
``ParamFactory.specs`` as in the reference.

A parameter is drawn in counter-contiguous chunks of at most
``PARAM_CHUNK`` elements: element i of the parameter is stream element i
whatever the chunking (the stream is counter-addressed), and the chunk
bounds the temporaries of ``stream.normal`` (a full-width gemma-7b MLP
matrix has 2.1e9 elements).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import stream as tstream

#: Largest draw of one ``stream.normal`` call during init, in elements.
PARAM_CHUNK = 1 << 28


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0                 # 0 for attn-free
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 32000
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    act: str = "silu"                # silu | geglu | gelu
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dropout_rate: float = 0.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 2048            # router group size (tokens)
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    # hybrid (zamba2): shared attention block applied every k mamba blocks
    attn_every: int = 0
    # enc-dec (whisper)
    enc_layers: int = 0
    enc_ctx: int = 0                 # encoder positions (audio frames)
    # vlm: number of prefix patch-embedding positions
    vision_prefix: int = 0
    # attention chunking for long prefill (memory-efficient attention)
    q_chunk: int = 512
    # remat policy for the layer scan: "full" | "none" (training only)
    remat: str = "full"
    # KV-cache storage dtype: "bf16" | "f8" (float8_e4m3fn; for archs whose
    # full-precision cache cannot fit, e.g. qwen1.5-32b's 40-head MHA at
    # 32k x 128)
    kv_dtype: str = "bf16"
    # sequence chunks for the vocab-chunked xent loss
    loss_chunks: int = 16
    # unroll layer scans (the reference's cost-analysis mode)
    scan_unroll: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def scaled(self, **overrides) -> "ArchConfig":
        """A reduced copy for smoke tests."""
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class GraniteConfig(ArchConfig):
    """An ``ArchConfig`` with GraniteMoe's four scalars, each left out
    where None: the embedding times ``embedding_multiplier``, attention
    logits times ``attention_multiplier`` in place of 1 / sqrt(head_dim),
    each residual branch times ``residual_multiplier`` and the logits over
    ``logits_scaling``.  The port's own class: ``ArchConfig``'s fields stay
    those of the reference package."""
    embedding_multiplier: Optional[float] = None
    attention_multiplier: Optional[float] = None
    residual_multiplier: Optional[float] = None
    logits_scaling: Optional[float] = None


def param_stream(seed: int, path: str, device=None) -> tstream.ThunderStream:
    """The ThunderStream leaf for one named parameter."""
    s = tstream.new_stream(seed, 0, device=device)
    # fold the path string into successive derives (stable across runs)
    for token in path.split("/"):
        tag = int.from_bytes(token.encode()[:8].ljust(8, b"\0"), "little")
        s = tstream.derive(s, tag & 0x7FFFFFFF)
    return s


def trunc_normal(s: tstream.ThunderStream, shape, std: float,
                 dtype=torch.float32, *, chunk: int = PARAM_CHUNK
                 ) -> torch.Tensor:
    """clip(normal, -3, 3) * std, drawn ``chunk`` elements at a time into
    one preallocated float32 tensor (bit-identical to one whole draw)."""
    n = int(math.prod(shape))
    out = torch.empty(n, dtype=torch.float32, device=s.device)
    std32 = float(np.float32(std))
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        x = tstream.normal(tstream.advance(s, lo), (m,), torch.float32)
        torch.mul(torch.clamp(x, -3.0, 3.0), std32, out=out[lo:lo + m])
        del x
    return out.reshape(tuple(shape)).to(dtype)


class ParamFactory:
    """Collects (path -> tensor, logical axes) during model init, on
    ``device`` (the card unless given; ``meta`` for shapes alone)."""

    def __init__(self, seed: int, dtype=torch.float32, device=None):
        self.seed = seed
        self.dtype = dtype
        self.device = engine.resolve_device(device)
        self.specs: Dict[str, Tuple[str, ...]] = {}

    def normal(self, path: str, shape, std: float, axes: Tuple[str, ...]):
        assert len(shape) == len(axes), (path, shape, axes)
        self.specs[path] = axes
        if self.device.type == "meta":   # shapes only, nothing drawn
            return torch.empty(tuple(shape), dtype=self.dtype,
                               device=self.device)
        return trunc_normal(param_stream(self.seed, path, self.device),
                            shape, std, self.dtype)

    def zeros(self, path: str, shape, axes: Tuple[str, ...]):
        assert len(shape) == len(axes), (path, shape, axes)
        self.specs[path] = axes
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)

    def ones(self, path: str, shape, axes: Tuple[str, ...]):
        assert len(shape) == len(axes), (path, shape, axes)
        self.specs[path] = axes
        return torch.ones(tuple(shape), dtype=self.dtype, device=self.device)

    def const(self, path: str, value: torch.Tensor, axes: Tuple[str, ...]):
        assert value.ndim == len(axes), (path, tuple(value.shape), axes)
        self.specs[path] = axes
        return value.to(device=self.device, dtype=self.dtype)


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """'a/b/c' keyed dict -> nested dicts."""
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out
