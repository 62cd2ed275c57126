"""Uniform model API over the served families.

``build(cfg, device=None)`` returns a ``Model`` on ``device`` (the card
unless the caller passes another) with:
  init(seed)                  -> (params, flat path->logical-axes specs)
  loss(params, batch, rng)    -> (scalar loss, metrics dict)
  forward(params, batch, rng) -> (logits, aux)
  prefill(params, batch)      -> (last logits, cache)
  decode(params, cache, token, pos) -> (logits, cache), cache in place
  init_cache(batch, ctx)      -> zeroed decode cache

The port builds every family of the reference: ``dense``, ``moe``,
``vlm``, ``encdec``, ``ssm`` and ``hybrid``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import engine
from repro_torch.core import stream as tstream
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import layers as L
from repro_torch.models import ssm_lm
from repro_torch.models import transformer as tf
from repro_torch.models.common import ArchConfig

AUX_WEIGHT = 0.01  # MoE aux-loss weight

FAMILIES = ("dense", "moe", "vlm", "encdec", "ssm", "hybrid")


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    init: Callable
    forward: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable
    device: torch.device


def _xent_loss(cfg, forward, table_fn):
    """Loss via hidden states + vocab-chunked xent (the (B,S,V) logits
    tensor is never materialized; see layers.softmax_xent_chunked)."""
    def loss(params, batch, rng: Optional[tstream.ThunderStream] = None):
        h, aux = forward(params, batch, rng, return_hidden=True)
        nll = L.softmax_xent_chunked(h, table_fn(params), batch["labels"],
                                     n_chunks=cfg.loss_chunks,
                                     divisor=getattr(cfg, "logits_scaling",
                                                     None))
        total = nll + AUX_WEIGHT * aux
        return total, {"nll": nll, "aux": aux}
    return loss


def _lm_table(cfg):
    def table_fn(params):
        if cfg.tie_embeddings or "unembed" not in params:
            return params["embed"]
        return params["unembed"]
    return table_fn


def _kv_dt(cfg):
    return torch.float8_e4m3fn if cfg.kv_dtype == "f8" else L.COMPUTE_DTYPE


def build(cfg: ArchConfig, device=None) -> Model:
    fam = cfg.family
    if fam not in FAMILIES:
        raise ValueError(f"unknown family {fam}")
    dev = engine.resolve_device(device)

    def zeros(shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or L.COMPUTE_DTYPE, device=dev)

    if fam in ("dense", "moe", "vlm"):
        def forward(params, batch, rng=None, return_hidden=False):
            return tf.lm_forward(cfg, params, batch["tokens"],
                                 patches=batch.get("patches"), rng=rng,
                                 return_hidden=return_hidden)

        def prefill(params, batch):
            return tf.lm_prefill(cfg, params, batch["tokens"],
                                 patches=batch.get("patches"))

        def decode(params, cache, token, pos):
            return tf.lm_decode(cfg, params, cache, token, pos)

        def init_cache(batch, ctx):
            shape = (cfg.n_layers, batch, ctx, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            return zeros(shape, _kv_dt(cfg)), zeros(shape, _kv_dt(cfg))

        return Model(cfg, lambda seed: tf.init_lm(cfg, seed, device=dev),
                     forward, _xent_loss(cfg, forward, _lm_table(cfg)),
                     prefill, decode, init_cache, dev)

    if fam == "encdec":
        def forward(params, batch, rng=None, return_hidden=False):
            return tf.encdec_forward(cfg, params, batch["frames"],
                                     batch["tokens"], rng=rng,
                                     return_hidden=return_hidden)

        def prefill(params, batch):
            return tf.encdec_prefill(cfg, params, batch["frames"],
                                     batch["tokens"])

        def decode(params, cache, token, pos):
            return tf.encdec_decode(cfg, params, cache, token, pos)

        def init_cache(batch, ctx):
            K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
            self_shape = (cfg.n_layers, batch, ctx, K, hd)
            cross_shape = (cfg.n_layers, batch, cfg.enc_ctx, K, hd)
            return (zeros(self_shape), zeros(self_shape),
                    zeros(cross_shape), zeros(cross_shape))

        return Model(cfg, lambda seed: tf.init_encdec(cfg, seed, device=dev),
                     forward, _xent_loss(cfg, forward, lambda p: p["embed"]),
                     prefill, decode, init_cache, dev)

    if fam == "ssm":
        def forward(params, batch, rng=None, return_hidden=False):
            return ssm_lm.ssm_forward(cfg, params, batch["tokens"], rng=rng,
                                      return_hidden=return_hidden)

        def prefill(params, batch):
            return ssm_lm.ssm_prefill(cfg, params, batch["tokens"])

        def decode(params, cache, token, pos):
            return ssm_lm.ssm_decode(cfg, params, cache, token, pos)

        def init_cache(batch, ctx):
            return ssm_lm.init_ssm_cache(cfg, batch, dev)

        return Model(cfg, lambda seed: ssm_lm.init_ssm_lm(cfg, seed, dev),
                     forward, _xent_loss(cfg, forward, _lm_table(cfg)),
                     prefill, decode, init_cache, dev)

    def forward(params, batch, rng=None, return_hidden=False):
        return hybrid_mod.hybrid_forward(cfg, params, batch["tokens"],
                                         rng=rng, return_hidden=return_hidden)

    def prefill(params, batch):
        return hybrid_mod.hybrid_prefill(cfg, params, batch["tokens"])

    def decode(params, cache, token, pos):
        return hybrid_mod.hybrid_decode(cfg, params, cache, token, pos)

    def init_cache(batch, ctx):
        return hybrid_mod.init_hybrid_cache(cfg, batch, ctx, dev)

    return Model(cfg, lambda seed: hybrid_mod.init_hybrid(cfg, seed, dev),
                 forward, _xent_loss(cfg, forward, lambda p: p["embed"]),
                 prefill, decode, init_cache, dev)
