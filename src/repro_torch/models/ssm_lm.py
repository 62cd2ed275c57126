"""Mamba2 decoder-only LM (attention-free) — family "ssm".

As in the reference, prefill and decode unembed with ``params["embed"]``
whatever ``tie_embeddings`` says (forward honours it).  ``ssm_decode``
updates its cache — (states (L, B, H, N, P) fp32, conv tails x3) — in
place.
"""
from __future__ import annotations

import torch

from repro_torch.core import stream as tstream
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import sharding as shd
from repro_torch.models.common import ArchConfig, ParamFactory, unflatten
from repro_torch.models.transformer import _layer


def init_ssm_lm(cfg: ArchConfig, seed: int, device=None):
    pf = ParamFactory(seed, device=device)
    D, V = cfg.d_model, cfg.vocab
    flat = {"embed": pf.normal("embed", (V, D), 0.02, ("vocab", "embed")),
            "final_norm": pf.zeros("final_norm", (D,), ("embed",))}
    flat.update(mamba2.mamba_layer_params(pf, cfg, "layers", cfg.n_layers))
    return unflatten(flat), dict(pf.specs)


def run_layers(cfg: ArchConfig, h, params_layers, lo: int, hi: int, rng):
    """Mamba blocks [lo, hi) of the full sequence, layer ``li`` with the
    stream ``derive(rng, li)``; each layer recomputed in the backward
    pass under ``cfg.remat == "full"``."""
    def body(h, lp, lrng):
        return mamba2.mamba_block(cfg, lp, h, lrng)[0]

    for li in range(lo, hi):
        lrng = tstream.derive(rng, li) if rng is not None else None
        lp = _layer(params_layers, li)
        h = L.remat(body, h, lp, lrng) if cfg.remat == "full" \
            else body(h, lp, lrng)
    return h


def prefill_layers(cfg: ArchConfig, h, params_layers, lo: int, hi: int,
                   cache):
    """Mamba blocks [lo, hi) writing each layer's final state and conv
    tails into ``cache`` = (states, tx, tb, tc), each (L, ...)."""
    for li in range(lo, hi):
        h, (state, tails) = mamba2.mamba_block(cfg, _layer(params_layers, li),
                                               h)
        for dst, t in zip(cache, (state,) + tails):
            dst[li].copy_(t)
    return h


def decode_layers(cfg: ArchConfig, h, params_layers, lo: int, hi: int,
                  cache):
    """One token through mamba layers [lo, hi); ``cache`` = (states, tx,
    tb, tc), each (L, ...), updated in place."""
    states, tx, tb, tc = cache
    for li in range(lo, hi):
        h, _, _ = mamba2.mamba_decode_step(
            cfg, _layer(params_layers, li), h, states[li],
            (tx[li], tb[li], tc[li]))
    return h


def ssm_forward(cfg: ArchConfig, params, tokens, *, rng=None,
                return_hidden: bool = False):
    h = shd.activation_hint(L.embed(tokens, params["embed"]))
    h = run_layers(cfg, h, params["layers"], 0, cfg.n_layers, rng)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if return_hidden:
        return h, aux
    table = params["embed"] if cfg.tie_embeddings else params.get(
        "unembed", params["embed"])
    return L.unembed(h, table), aux


def ssm_prefill(cfg: ArchConfig, params, tokens):
    """Returns (last logits, cache = (ssm_states, conv tails x3))."""
    h = shd.activation_hint(L.embed(tokens, params["embed"]))
    cache = init_ssm_cache(cfg, tokens.shape[0], h.device)
    h = prefill_layers(cfg, h, params["layers"], 0, cfg.n_layers, cache)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(h[:, -1:], params["embed"])[:, 0]
    return logits, cache


def ssm_decode(cfg: ArchConfig, params, cache, token, pos):
    """One token step; ``pos`` unused (state-based), kept for API parity.
    The cache is updated in place."""
    h = L.embed(token, params["embed"])
    h = decode_layers(cfg, h, params["layers"], 0, cfg.n_layers, cache)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed(h, params["embed"])[:, 0], cache


def init_ssm_cache(cfg: ArchConfig, batch: int, device=None):
    """Zeroed decode cache (ssm_states, conv tails)."""
    Lc, H, N, P = cfg.n_layers, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    ck = cfg.ssm_conv
    z = lambda *s, dt=L.COMPUTE_DTYPE: torch.zeros(s, dtype=dt, device=device)
    return (z(Lc, batch, H, N, P, dt=torch.float32),
            z(Lc, batch, ck - 1, cfg.d_inner),
            z(Lc, batch, ck - 1, N),
            z(Lc, batch, ck - 1, N))
