"""Decoder-only LM (dense / VLM backbone) as plain torch functions.

Parameter layout is the reference's: every per-layer tensor is stacked on
a leading "layer" axis.  The reference runs the layer body under
``lax.scan``; the port runs a Python loop over the layer index of the
same stacked ``(L, ...)`` tensors.  ``lm_decode`` updates the
``(L, B, T, K, hd)`` KV cache in place.

All randomness (init, dropout) comes from named ThundeRiNG streams.  The
MoE MLP and the encoder-decoder (whisper-family) functions are not
ported yet: they raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import stream as tstream
from repro_torch.models import layers as L
from repro_torch.models import sharding as shd
from repro_torch.models.common import ArchConfig, ParamFactory, unflatten

#: Where the families this module does not serve yet are queued.
FAMILIES_TODO = ("ROADMAP.md queue A item 7 ports the moe, ssm, hybrid and "
                 "encdec families")


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: {FAMILIES_TODO}")


def _kr(cfg: ArchConfig) -> Tuple[int, int]:
    K = cfg.n_kv_heads
    R = cfg.n_heads // max(K, 1)
    return K, R


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_params(pf: ParamFactory, cfg: ArchConfig, prefix: str,
                  n_layers: int, cross: bool = False,
                  moe: bool = False) -> Dict[str, Any]:
    if cross:
        raise not_ported("cross-attention (encdec) init")
    if moe:
        raise not_ported("MoE init")
    D = cfg.d_model
    K, R = _kr(cfg)
    hd = cfg.resolved_head_dim
    F_ = cfg.d_ff
    std = 0.02
    std_out = std / np.sqrt(2.0 * max(cfg.n_layers, 1))
    p = {}
    Lx = ("layer",)
    p[f"{prefix}/attn_norm"] = pf.zeros(f"{prefix}/attn_norm",
                                        (n_layers, D), Lx + ("embed",))
    p[f"{prefix}/wq"] = pf.normal(f"{prefix}/wq", (n_layers, D, K, R, hd),
                                  std, Lx + ("embed", "kv_heads", "q_rep", "head"))
    p[f"{prefix}/wk"] = pf.normal(f"{prefix}/wk", (n_layers, D, K, hd), std,
                                  Lx + ("embed", "kv_heads", "head"))
    p[f"{prefix}/wv"] = pf.normal(f"{prefix}/wv", (n_layers, D, K, hd), std,
                                  Lx + ("embed", "kv_heads", "head"))
    p[f"{prefix}/wo"] = pf.normal(f"{prefix}/wo", (n_layers, K, R, hd, D),
                                  std_out, Lx + ("kv_heads", "q_rep", "head", "embed"))
    if cfg.qkv_bias:
        p[f"{prefix}/bq"] = pf.zeros(f"{prefix}/bq", (n_layers, K, R, hd),
                                     Lx + ("kv_heads", "q_rep", "head"))
        p[f"{prefix}/bk"] = pf.zeros(f"{prefix}/bk", (n_layers, K, hd),
                                     Lx + ("kv_heads", "head"))
        p[f"{prefix}/bv"] = pf.zeros(f"{prefix}/bv", (n_layers, K, hd),
                                     Lx + ("kv_heads", "head"))
    p[f"{prefix}/mlp_norm"] = pf.zeros(f"{prefix}/mlp_norm", (n_layers, D),
                                       Lx + ("embed",))
    if cfg.act in ("silu", "geglu"):
        p[f"{prefix}/wg"] = pf.normal(f"{prefix}/wg", (n_layers, D, F_), std,
                                      Lx + ("embed", "f"))
    p[f"{prefix}/wi"] = pf.normal(f"{prefix}/wi", (n_layers, D, F_), std,
                                  Lx + ("embed", "f"))
    p[f"{prefix}/wo_mlp"] = pf.normal(f"{prefix}/wo_mlp", (n_layers, F_, D),
                                      std_out, Lx + ("f", "embed"))
    return p


def init_lm(cfg: ArchConfig, seed: int, device=None):
    """Decoder-only LM params. Returns (nested params, flat path->axes).

    On the ``meta`` device the tensors carry shapes and dtypes only (no
    draw), the port's counterpart of ``jax.eval_shape(init)``."""
    pf = ParamFactory(seed, device=device)
    D, V = cfg.d_model, cfg.vocab
    flat = {"embed": pf.normal("embed", (V, D), 0.02, ("vocab", "embed")),
            "final_norm": pf.zeros("final_norm", (D,), ("embed",))}
    if not cfg.tie_embeddings:
        flat["unembed"] = pf.normal("unembed", (V, D), 0.02,
                                    ("vocab", "embed"))
    flat.update(_layer_params(pf, cfg, "layers", cfg.n_layers,
                              moe=cfg.family == "moe"))
    return unflatten(flat), dict(pf.specs)


def init_encdec(cfg: ArchConfig, seed: int, device=None):
    raise not_ported("init_encdec")


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _norm(cfg, x, w, b=None):
    if cfg.family == "encdec":
        return L.layer_norm(x, w, b, cfg.norm_eps)
    return L.rms_norm(x, w, cfg.norm_eps)


def _self_attention(cfg, lp, h, positions, *, causal, kv_cache=None,
                    pos=None, prefix=""):
    """Returns (attn_out, (k, v)) — k/v for cache building in prefill;
    with ``kv_cache`` the cache, updated in place at ``pos``."""
    bq = lp.get(f"{prefix}bq")
    q, k, v = L.qkv_split(h, lp[f"{prefix}wq"], lp[f"{prefix}wk"],
                          lp[f"{prefix}wv"], bq,
                          lp.get(f"{prefix}bk"), lp.get(f"{prefix}bv"))
    if cfg.rope_theta > 0 and cfg.family != "encdec":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        T = k_cache.shape[1]
        if not 0 <= pos <= T - k.shape[1]:
            # the reference's dynamic_update_slice would clamp the start
            raise ValueError(f"decode position {pos} is outside the "
                             f"cache of {T} positions")
        k_cache[:, pos:pos + k.shape[1]] = L.cast(k, k_cache.dtype)
        v_cache[:, pos:pos + v.shape[1]] = L.cast(v, v_cache.dtype)
        o = L.decode_attention(q, k_cache, v_cache, pos)
        return L.attn_out(o, lp[f"{prefix}wo"]), (k_cache, v_cache)
    o = L.attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk)
    return L.attn_out(o, lp[f"{prefix}wo"]), (k, v)


def _mlp_block(cfg, lp, h, rng, moe: bool):
    if moe:
        raise not_ported("the MoE MLP (models/moe.py)")
    gated = cfg.act in ("silu", "geglu")
    out = L.mlp(h, lp["wi"], lp["wo_mlp"], cfg.act,
                lp.get("wg") if gated else None)
    return out, torch.zeros((), dtype=torch.float32, device=h.device)


def _decoder_layer(cfg: ArchConfig, h, lp, positions, rng, *,
                   kv_cache=None, pos=None, causal=True):
    """One decoder layer. Returns (h, new_kv, aux_loss)."""
    if cfg.family == "encdec":
        raise not_ported("the encdec decoder layer")
    moe = cfg.family == "moe"
    seq_gather = kv_cache is None and shd.prefer_seq_gather(
        cfg, h.shape[0], h.shape[1])
    a_in = _norm(cfg, h, lp["attn_norm"])
    if seq_gather and not shd.context_parallel_attention(
            None, max(cfg.n_kv_heads, 1),
            cfg.n_heads // max(cfg.n_kv_heads, 1)):
        a_in = shd.gather_seq_hint(a_in)
    attn, new_kv = _self_attention(cfg, lp, a_in, positions, causal=causal,
                                   kv_cache=kv_cache, pos=pos)
    attn = L.dropout(attn, rng, cfg.dropout_rate)
    h = h + attn
    m_in = _norm(cfg, h, lp["mlp_norm"])
    if seq_gather:
        m_in = shd.gather_seq_hint(m_in)
    mlp_rng = tstream.derive(rng, 0x4D4C50) if rng is not None else None
    out, aux = _mlp_block(cfg, lp, m_in, mlp_rng, moe)
    out = L.dropout(out, rng, cfg.dropout_rate)
    return shd.activation_hint(h + out), new_kv, aux


# ---------------------------------------------------------------------------
# decoder-only forward / prefill / decode
# ---------------------------------------------------------------------------

def _layer(params_layers: Dict[str, torch.Tensor], li: int):
    """Layer ``li``'s slice of the stacked per-layer tensors (views)."""
    return {k: v[li] for k, v in params_layers.items()}


def _embed_inputs(cfg, params, tokens, patches):
    h = L.embed(tokens, params["embed"])
    if cfg.family == "vlm" and patches is not None:
        # pad+add, as the reference (which keeps the sequence sharding)
        P = patches.shape[1]
        h = h + F.pad(patches.to(h.dtype), (0, 0, 0, h.shape[1] - P))
    return shd.activation_hint(h)


def _lm_table(cfg, params):
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def lm_forward(cfg: ArchConfig, params, tokens, *, patches=None,
               rng: Optional[tstream.ThunderStream] = None,
               return_hidden: bool = False):
    """Full forward. tokens (B, S) int32 -> (logits fp32 (B, S, V), aux);
    with ``return_hidden`` the final-norm hidden states replace logits
    (for the chunked-xent loss path that never materializes logits)."""
    h = _embed_inputs(cfg, params, tokens, patches)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device).expand(B, S)
    auxes = []
    for li in range(cfg.n_layers):
        lrng = tstream.derive(rng, li) if rng is not None else None
        h, _, aux = _decoder_layer(cfg, h, _layer(params["layers"], li),
                                   positions, lrng)
        auxes.append(aux)
    h = _norm(cfg, h, params["final_norm"])
    aux = torch.mean(torch.stack(auxes))
    if return_hidden:
        return h, aux
    return L.unembed(h, _lm_table(cfg, params)), aux


def lm_prefill(cfg: ArchConfig, params, tokens, *, patches=None):
    """Forward over S tokens building the KV cache.

    Returns (last-position logits (B, V), cache (k, v) each
    (L, B, S, K, hd))."""
    h = _embed_inputs(cfg, params, tokens, patches)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device).expand(B, S)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        h, (k, v), _ = _decoder_layer(cfg, h, _layer(params["layers"], li),
                                      positions, None)
        ks.append(k)
        vs.append(v)
    h = _norm(cfg, h, params["final_norm"])
    logits = L.unembed(h[:, -1:], _lm_table(cfg, params))[:, 0]
    return logits, (torch.stack(ks), torch.stack(vs))


def lm_decode(cfg: ArchConfig, params, cache, token, pos):
    """One decode step. token (B, 1) int32; cache (k, v) stacked (L, ...);
    pos: the current length (int or 0-dim tensor).  Returns (logits
    (B, V), cache); the cache's tensors are updated in place at ``pos``
    (the reference donates its carry to the same end)."""
    pos = int(pos)
    h = L.embed(token, params["embed"])
    B = token.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    kc_all, vc_all = cache
    for li in range(cfg.n_layers):
        h, _, _ = _decoder_layer(cfg, h, _layer(params["layers"], li),
                                 positions, None,
                                 kv_cache=(kc_all[li], vc_all[li]), pos=pos)
    h = _norm(cfg, h, params["final_norm"])
    return L.unembed(h, _lm_table(cfg, params))[:, 0], (kc_all, vc_all)


# ---------------------------------------------------------------------------
# encoder-decoder (whisper-family): not ported yet
# ---------------------------------------------------------------------------

def encdec_forward(cfg: ArchConfig, params, frames, tokens, **kw):
    raise not_ported("encdec_forward")


def encdec_prefill(cfg: ArchConfig, params, frames, tokens):
    raise not_ported("encdec_prefill")


def encdec_decode(cfg: ArchConfig, params, cache, token, pos):
    raise not_ported("encdec_decode")
