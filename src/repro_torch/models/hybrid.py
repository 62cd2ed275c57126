"""Zamba2-style hybrid: mamba2 backbone + ONE shared attention+MLP block
applied before each group of ``attn_every`` mamba layers (weights shared
across all applications, so its gradient is the sum over them;
per-application LoRA adapters of the reference model are omitted, as in
the reference).  Layers past the last whole group run without it.

Cache: (kc, vc, states, tx, tb, tc) — the KV cache of the shared-block
applications (n_apps, B, T, K, hd) and the mamba cache of ``ssm_lm`` —
updated in place by ``hybrid_decode``.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import sharding as shd
from repro_torch.models import ssm_lm
from repro_torch.models import mamba2
from repro_torch.models.common import ArchConfig, ParamFactory, unflatten
from repro_torch.models.transformer import write_kv


def n_apps(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def init_hybrid(cfg: ArchConfig, seed: int, device=None):
    pf = ParamFactory(seed, device=device)
    D, V = cfg.d_model, cfg.vocab
    K = cfg.n_kv_heads
    R = cfg.n_heads // K
    hd = cfg.resolved_head_dim
    F_ = cfg.d_ff
    std = 0.02
    flat = {"embed": pf.normal("embed", (V, D), 0.02, ("vocab", "embed")),
            "final_norm": pf.zeros("final_norm", (D,), ("embed",))}
    flat.update(mamba2.mamba_layer_params(pf, cfg, "layers", cfg.n_layers))
    # shared attention + MLP block (single copy)
    flat["shared/attn_norm"] = pf.zeros("shared/attn_norm", (D,), ("embed",))
    flat["shared/wq"] = pf.normal("shared/wq", (D, K, R, hd), std,
                                  ("embed", "kv_heads", "q_rep", "head"))
    flat["shared/wk"] = pf.normal("shared/wk", (D, K, hd), std,
                                  ("embed", "kv_heads", "head"))
    flat["shared/wv"] = pf.normal("shared/wv", (D, K, hd), std,
                                  ("embed", "kv_heads", "head"))
    flat["shared/wo"] = pf.normal("shared/wo", (K, R, hd, D), std,
                                  ("kv_heads", "q_rep", "head", "embed"))
    flat["shared/mlp_norm"] = pf.zeros("shared/mlp_norm", (D,), ("embed",))
    flat["shared/wg"] = pf.normal("shared/wg", (D, F_), std, ("embed", "f"))
    flat["shared/wi"] = pf.normal("shared/wi", (D, F_), std, ("embed", "f"))
    flat["shared/wo_mlp"] = pf.normal("shared/wo_mlp", (F_, D), std,
                                      ("f", "embed"))
    return unflatten(flat), dict(pf.specs)


def _shared_block(cfg, sp, h, positions, kv_cache=None, pos=None):
    a_in = L.rms_norm(h, sp["attn_norm"], cfg.norm_eps)
    q, k, v = L.qkv_split(a_in, sp["wq"], sp["wk"], sp["wv"])
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is not None:
        kc, vc = write_kv(kv_cache, k, v, pos)
        o = L.decode_attention(q, kc, vc, pos)
        new_kv = (kc, vc)
    else:
        o = L.attention(q, k, v, causal=True, q_chunk=cfg.q_chunk)
        new_kv = (k, v)
    h = h + L.attn_out(o, sp["wo"])
    m_in = L.rms_norm(h, sp["mlp_norm"], cfg.norm_eps)
    h = shd.activation_hint(h + L.mlp(m_in, sp["wi"], sp["wo_mlp"], "silu",
                                      sp["wg"]))
    return h, new_kv


def _groups(cfg: ArchConfig):
    """(with the shared block first?, lo, hi) per group of mamba layers."""
    ae = cfg.attn_every
    out = [(True, g * ae, (g + 1) * ae) for g in range(n_apps(cfg))]
    if n_apps(cfg) * ae < cfg.n_layers:
        out.append((False, n_apps(cfg) * ae, cfg.n_layers))
    return out


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device).expand(B, S)


def hybrid_forward(cfg: ArchConfig, params, tokens, *, rng=None,
                   return_hidden: bool = False):
    h = shd.activation_hint(L.embed(tokens, params["embed"]))
    positions = _positions(tokens)
    for shared, lo, hi in _groups(cfg):
        if shared:
            h, _ = _shared_block(cfg, params["shared"], h, positions)
        h = ssm_lm.run_layers(cfg, h, params["layers"], lo, hi, rng)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if return_hidden:
        return h, aux
    return L.unembed(h, params["embed"]), aux


def hybrid_prefill(cfg: ArchConfig, params, tokens):
    h = shd.activation_hint(L.embed(tokens, params["embed"]))
    positions = _positions(tokens)
    mcache = ssm_lm.init_ssm_cache(cfg, tokens.shape[0], h.device)
    kvs = []
    for shared, lo, hi in _groups(cfg):
        if shared:
            h, kv = _shared_block(cfg, params["shared"], h, positions)
            kvs.append(kv)
        h = ssm_lm.prefill_layers(cfg, h, params["layers"], lo, hi, mcache)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(h[:, -1:], params["embed"])[:, 0]
    cache = (torch.stack([kv[0] for kv in kvs]),
             torch.stack([kv[1] for kv in kvs])) + mcache
    return logits, cache


def hybrid_decode(cfg: ArchConfig, params, cache, token, pos):
    """One decode step; every tensor of ``cache`` is updated in place."""
    pos = int(pos)
    kc_all, vc_all = cache[:2]
    h = L.embed(token, params["embed"])
    positions = torch.full((token.shape[0], 1), pos, dtype=torch.int32,
                           device=h.device)
    for g, (shared, lo, hi) in enumerate(_groups(cfg)):
        if shared:
            h, _ = _shared_block(cfg, params["shared"], h, positions,
                                 kv_cache=(kc_all[g], vc_all[g]), pos=pos)
        h = ssm_lm.decode_layers(cfg, h, params["layers"], lo, hi, cache[2:])
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return L.unembed(h, params["embed"])[:, 0], cache


def init_hybrid_cache(cfg: ArchConfig, batch: int, ctx: int, device=None):
    K = cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    shape = (n_apps(cfg), batch, ctx, K, hd)
    return (torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=device),
            torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=device)) + \
        ssm_lm.init_ssm_cache(cfg, batch, device)
