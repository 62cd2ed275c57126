"""Decoder-only LM (dense / MoE / VLM backbone) and encoder-decoder
(whisper-family) models as plain torch functions.

Parameter layout is the reference's: every per-layer tensor is stacked on
a leading "layer" axis.  The reference runs the layer body under
``lax.scan``; the port runs a Python loop over the layer index of the
same stacked ``(L, ...)`` tensors.  ``lm_decode`` and ``encdec_decode``
update their ``(L, B, T, K, hd)`` KV caches in place.

All randomness (init, dropout, router jitter) comes from named ThundeRiNG
streams.

A ``GraniteConfig`` adds GraniteMoe's scalars to the decoder-only LM in
forward, prefill and decode alike: the embedding times
``embedding_multiplier``, the attention logits times
``attention_multiplier``, each residual branch times
``residual_multiplier`` and the logits over ``logits_scaling``.  Where a
config has none, no multiply is made.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import stream as tstream
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding as shd
from repro_torch.models.common import ArchConfig, ParamFactory, unflatten


def _scalar(cfg: ArchConfig, name: str) -> Optional[float]:
    """One of ``GraniteConfig``'s scalars, None where the config has it
    not."""
    return getattr(cfg, name, None)


def _branch(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """A residual branch, times ``residual_multiplier`` if the config has
    one."""
    m = _scalar(cfg, "residual_multiplier")
    return x if m is None else x * m


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
    if cross:
        p[f"{prefix}/xattn_norm"] = pf.zeros(f"{prefix}/xattn_norm",
                                             (n_layers, D), Lx + ("embed",))
        p[f"{prefix}/xwq"] = pf.normal(f"{prefix}/xwq", (n_layers, D, K, R, hd),
                                       std, Lx + ("embed", "kv_heads", "q_rep", "head"))
        p[f"{prefix}/xwk"] = pf.normal(f"{prefix}/xwk", (n_layers, D, K, hd),
                                       std, Lx + ("embed", "kv_heads", "head"))
        p[f"{prefix}/xwv"] = pf.normal(f"{prefix}/xwv", (n_layers, D, K, hd),
                                       std, Lx + ("embed", "kv_heads", "head"))
        p[f"{prefix}/xwo"] = pf.normal(f"{prefix}/xwo", (n_layers, K, R, hd, D),
                                       std_out, Lx + ("kv_heads", "q_rep", "head", "embed"))
    p[f"{prefix}/mlp_norm"] = pf.zeros(f"{prefix}/mlp_norm", (n_layers, D),
                                       Lx + ("embed",))
    if moe:
        E = cfg.n_experts
        p[f"{prefix}/router"] = pf.normal(f"{prefix}/router", (n_layers, D, E),
                                          std, Lx + ("embed", "experts"))
        p[f"{prefix}/moe_wg"] = pf.normal(f"{prefix}/moe_wg", (n_layers, E, D, F_),
                                          std, Lx + ("experts", "embed", "f"))
        p[f"{prefix}/moe_wi"] = pf.normal(f"{prefix}/moe_wi", (n_layers, E, D, F_),
                                          std, Lx + ("experts", "embed", "f"))
        p[f"{prefix}/moe_wo"] = pf.normal(f"{prefix}/moe_wo", (n_layers, E, F_, D),
                                          std_out, Lx + ("experts", "f", "embed"))
    else:
        if cfg.act in ("silu", "geglu"):
            p[f"{prefix}/wg"] = pf.normal(f"{prefix}/wg", (n_layers, D, F_),
                                          std, Lx + ("embed", "f"))
        p[f"{prefix}/wi"] = pf.normal(f"{prefix}/wi", (n_layers, D, F_), std,
                                      Lx + ("embed", "f"))
        p[f"{prefix}/wo_mlp"] = pf.normal(f"{prefix}/wo_mlp",
                                          (n_layers, F_, D), std_out,
                                          Lx + ("f", "embed"))
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
    pf = ParamFactory(seed, device=device)
    D, V = cfg.d_model, cfg.vocab
    flat = {"embed": pf.normal("embed", (V, D), 0.02, ("vocab", "embed")),
            "enc_final_norm_w": pf.ones("enc_final_norm_w", (D,), ("embed",)),
            "enc_final_norm_b": pf.zeros("enc_final_norm_b", (D,), ("embed",)),
            "final_norm_w": pf.ones("final_norm_w", (D,), ("embed",)),
            "final_norm_b": pf.zeros("final_norm_b", (D,), ("embed",))}
    flat.update(_layer_params(pf, cfg, "enc_layers", cfg.enc_layers))
    flat.update(_layer_params(pf, cfg, "dec_layers", cfg.n_layers, cross=True))
    return unflatten(flat), dict(pf.specs)


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
    scale = _scalar(cfg, "attention_multiplier")
    kw = {} if scale is None else {"scale": scale}
    if kv_cache is not None:
        k_cache, v_cache = write_kv(kv_cache, k, v, pos)
        o = L.decode_attention(q, k_cache, v_cache, pos, **kw)
        return L.attn_out(o, lp[f"{prefix}wo"]), (k_cache, v_cache)
    o = L.attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk, **kw)
    return L.attn_out(o, lp[f"{prefix}wo"]), (k, v)


def write_kv(kv_cache, k, v, pos: int):
    """Write (B, s, K, hd) k / v into the (B, T, K, hd) caches at ``pos``,
    in place; returns the caches."""
    k_cache, v_cache = kv_cache
    T = k_cache.shape[1]
    if not 0 <= pos <= T - k.shape[1]:
        # the reference's dynamic_update_slice would clamp the start
        raise ValueError(f"decode position {pos} is outside the "
                         f"cache of {T} positions")
    k_cache[:, pos:pos + k.shape[1]] = L.cast(k, k_cache.dtype)
    v_cache[:, pos:pos + v.shape[1]] = L.cast(v, v_cache.dtype)
    return k_cache, v_cache


def _mlp_block(cfg, lp, h, rng, moe: bool, layer=None):
    if moe:
        return moe_mod.moe_mlp(cfg, h, lp["router"], lp["moe_wg"],
                               lp["moe_wi"], lp["moe_wo"], rng, layer=layer)
    gated = cfg.act in ("silu", "geglu")
    out = L.mlp(h, lp["wi"], lp["wo_mlp"], cfg.act,
                lp.get("wg") if gated else None)
    return out, torch.zeros((), dtype=torch.float32, device=h.device)


def _decoder_layer(cfg: ArchConfig, h, lp, positions, rng, *,
                   kv_cache=None, pos=None, enc_out=None, causal=True,
                   layer=None):
    """One decoder layer. Returns (h, new_kv, aux_loss).  ``enc_out``:
    the layer's cross-attention (k, v) (encdec decoder layers); ``layer``
    keys the MoE block's spans."""
    moe = cfg.family == "moe"
    if cfg.family == "encdec":   # LayerNorm with weight 1 + w, no bias
        nrm = lambda x, base: L.layer_norm(x, 1.0 + lp[base],
                                           torch.zeros_like(lp[base]),
                                           cfg.norm_eps)
    else:
        nrm = lambda x, base: _norm(cfg, x, lp[base])
    seq_gather = kv_cache is None and shd.prefer_seq_gather(
        cfg, h.shape[0], h.shape[1])
    a_in = nrm(h, "attn_norm")
    if seq_gather and not shd.context_parallel_attention(
            None, max(cfg.n_kv_heads, 1),
            cfg.n_heads // max(cfg.n_kv_heads, 1)):
        a_in = shd.gather_seq_hint(a_in)
    attn, new_kv = _self_attention(cfg, lp, a_in, positions, causal=causal,
                                   kv_cache=kv_cache, pos=pos)
    attn = L.dropout(attn, rng, cfg.dropout_rate)
    h = h + _branch(cfg, attn)
    if enc_out is not None:
        x_in = nrm(h, "xattn_norm")
        xq = torch.einsum("bsd,dkrh->bskrh", x_in, lp["xwq"].to(x_in.dtype))
        # decode attends to every encoder position: pos = enc_ctx masks
        # nothing
        xo = L.attention(xq, enc_out[0], enc_out[1], causal=False,
                         q_chunk=cfg.q_chunk) if pos is None else \
            L.decode_attention(xq, enc_out[0], enc_out[1],
                               enc_out[0].shape[1])
        h = h + L.attn_out(xo, lp["xwo"])
    m_in = nrm(h, "mlp_norm")
    if seq_gather:
        m_in = shd.gather_seq_hint(m_in)
    mlp_rng = tstream.derive(rng, 0x4D4C50) if rng is not None else None
    out, aux = _mlp_block(cfg, lp, m_in, mlp_rng, moe, layer)
    out = L.dropout(out, rng, cfg.dropout_rate)
    return shd.activation_hint(h + _branch(cfg, out)), new_kv, aux


# ---------------------------------------------------------------------------
# decoder-only forward / prefill / decode
# ---------------------------------------------------------------------------

def _layer(params_layers: Dict[str, torch.Tensor], li: int):
    """Layer ``li``'s slice of the stacked per-layer tensors (views)."""
    return {k: v[li] for k, v in params_layers.items()}


def _embed_inputs(cfg, params, tokens, patches):
    h = L.embed(tokens, params["embed"], _scalar(cfg, "embedding_multiplier"))
    if cfg.family == "vlm" and patches is not None:
        # pad+add, as the reference (which keeps the sequence sharding).
        # A negative pad would crop the patches; the reference's pad
        # refuses that, so refuse it too
        S, P = h.shape[1], patches.shape[1]
        if S < P:
            raise ValueError(f"a vlm sequence of {S} tokens is shorter than "
                             f"its patch prefix of {P}")
        h = h + F.pad(patches.to(h.dtype), (0, 0, 0, S - P))
    return shd.activation_hint(h)


def _lm_table(cfg, params):
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def lm_forward(cfg: ArchConfig, params, tokens, *, patches=None,
               rng: Optional[tstream.ThunderStream] = None,
               return_hidden: bool = False):
    """Full forward. tokens (B, S) int32 -> (logits fp32 (B, S, V), aux);
    with ``return_hidden`` the final-norm hidden states replace logits
    (for the chunked-xent loss path that never materializes logits).
    ``cfg.remat == "full"`` recomputes each layer in the backward pass."""
    h = _embed_inputs(cfg, params, tokens, patches)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device).expand(B, S)

    def body(h, lp, lrng, li):
        h, _, aux = _decoder_layer(cfg, h, lp, positions, lrng, layer=li)
        return h, aux

    auxes = []
    for li in range(cfg.n_layers):
        lrng = tstream.derive(rng, li) if rng is not None else None
        lp = _layer(params["layers"], li)
        if cfg.remat == "full":
            h, aux = L.remat(body, h, lp, lrng, li)
        else:
            h, aux = body(h, lp, lrng, li)
        auxes.append(aux)
    h = _norm(cfg, h, params["final_norm"])
    aux = torch.mean(torch.stack(auxes))
    if return_hidden:
        return h, aux
    return L.unembed(h, _lm_table(cfg, params),
                     _scalar(cfg, "logits_scaling")), aux


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
                                      positions, None, layer=li)
        ks.append(k)
        vs.append(v)
    h = _norm(cfg, h, params["final_norm"])
    logits = L.unembed(h[:, -1:], _lm_table(cfg, params),
                       _scalar(cfg, "logits_scaling"))[:, 0]
    return logits, (torch.stack(ks), torch.stack(vs))


def lm_decode(cfg: ArchConfig, params, cache, token, pos):
    """One decode step. token (B, 1) int32; cache (k, v) stacked (L, ...);
    pos: the current length (int or 0-dim tensor).  Returns (logits
    (B, V), cache); the cache's tensors are updated in place at ``pos``
    (the reference donates its carry to the same end)."""
    pos = int(pos)
    h = L.embed(token, params["embed"], _scalar(cfg, "embedding_multiplier"))
    B = token.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    kc_all, vc_all = cache
    for li in range(cfg.n_layers):
        h, _, _ = _decoder_layer(cfg, h, _layer(params["layers"], li),
                                 positions, None,
                                 kv_cache=(kc_all[li], vc_all[li]), pos=pos,
                                 layer=li)
    h = _norm(cfg, h, params["final_norm"])
    return L.unembed(h, _lm_table(cfg, params),
                     _scalar(cfg, "logits_scaling"))[:, 0], (kc_all, vc_all)


# ---------------------------------------------------------------------------
# encoder-decoder (whisper-family)
# ---------------------------------------------------------------------------

def _sinusoids(n: int, d: int, device) -> torch.Tensor:
    return torch.from_numpy(L.sinusoid_positions(n, d)).to(device)


def encode(cfg: ArchConfig, params, frames):
    """frames: (B, enc_ctx, D) precomputed conv-frontend output (stub)."""
    B, T, D = frames.shape
    h = (frames + _sinusoids(T, D, frames.device)[None]).to(L.COMPUTE_DTYPE)
    positions = torch.arange(T, dtype=torch.int32,
                             device=h.device).expand(B, T)

    def body(h, lp):
        return _decoder_layer(cfg, h, lp, positions, None, causal=False)[0]

    for li in range(cfg.enc_layers):
        lp = _layer(params["enc_layers"], li)
        h = L.remat(body, h, lp) if cfg.remat == "full" else body(h, lp)
    return L.layer_norm(h, params["enc_final_norm_w"],
                        params["enc_final_norm_b"], cfg.norm_eps)


def _dec_positions(cfg, tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device).expand(B, S)


def _layer_cross_kv(lp, enc_out):
    k = torch.einsum("btd,dkh->btkh", enc_out, lp["xwk"].to(enc_out.dtype))
    v = torch.einsum("btd,dkh->btkh", enc_out, lp["xwv"].to(enc_out.dtype))
    return k, v


def _cross_kv(cfg, params, enc_out):
    """Per-decoder-layer cross K/V: (L, B, T, K, hd) x2."""
    kvs = [_layer_cross_kv(_layer(params["dec_layers"], li), enc_out)
           for li in range(cfg.n_layers)]
    return (torch.stack([kv[0] for kv in kvs]),
            torch.stack([kv[1] for kv in kvs]))


def _dec_embed(cfg, params, tokens):
    h = L.embed(tokens, params["embed"])
    return h + _sinusoids(tokens.shape[1], cfg.d_model,
                          h.device)[None].to(h.dtype)


def _dec_final(cfg, params, h):
    return L.layer_norm(h, params["final_norm_w"], params["final_norm_b"],
                        cfg.norm_eps)


def encdec_forward(cfg: ArchConfig, params, frames, tokens, *,
                   rng: Optional[tstream.ThunderStream] = None,
                   return_hidden: bool = False):
    """Training forward: (B, T, D) frames + (B, S) tokens -> logits."""
    enc_out = encode(cfg, params, frames)
    h = shd.activation_hint(_dec_embed(cfg, params, tokens))
    positions = _dec_positions(cfg, tokens)

    def body(h, lp, lrng, enc_out):
        xkv = _layer_cross_kv(lp, enc_out)
        return _decoder_layer(cfg, h, lp, positions, lrng, enc_out=xkv)[0]

    for li in range(cfg.n_layers):
        lrng = tstream.derive(rng, li) if rng is not None else None
        lp = _layer(params["dec_layers"], li)
        h = L.remat(body, h, lp, lrng, enc_out) if cfg.remat == "full" \
            else body(h, lp, lrng, enc_out)
    h = _dec_final(cfg, params, h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if return_hidden:
        return h, aux
    return L.unembed(h, params["embed"]), aux


def encdec_prefill(cfg: ArchConfig, params, frames, tokens):
    """Returns (last logits, (self_k, self_v, cross_k, cross_v))."""
    enc_out = encode(cfg, params, frames)
    cross = _cross_kv(cfg, params, enc_out)
    del enc_out
    h = _dec_embed(cfg, params, tokens)
    positions = _dec_positions(cfg, tokens)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        h, (k, v), _ = _decoder_layer(cfg, h, _layer(params["dec_layers"], li),
                                      positions, None,
                                      enc_out=(cross[0][li], cross[1][li]))
        ks.append(k)
        vs.append(v)
    h = _dec_final(cfg, params, h)
    logits = L.unembed(h[:, -1:], params["embed"])[:, 0]
    return logits, (torch.stack(ks), torch.stack(vs)) + cross


def encdec_decode(cfg: ArchConfig, params, cache, token, pos):
    """One decode step; the self-attention caches are updated in place."""
    pos = int(pos)
    self_k, self_v, cross_k, cross_v = cache
    T = self_k.shape[2]
    if not 0 <= pos < T:
        raise ValueError(f"decode position {pos} is outside the cache of "
                         f"{T} positions")
    h = L.embed(token, params["embed"])
    # the sinusoid at position pos
    h = h + _sinusoids(T, cfg.d_model, h.device)[pos:pos + 1][None].to(h.dtype)
    positions = torch.full((token.shape[0], 1), pos, dtype=torch.int32,
                           device=h.device)
    for li in range(cfg.n_layers):
        h, _, _ = _decoder_layer(cfg, h, _layer(params["dec_layers"], li),
                                 positions, None,
                                 kv_cache=(self_k[li], self_v[li]), pos=pos,
                                 enc_out=(cross_k[li], cross_v[li]))
    h = _dec_final(cfg, params, h)
    return L.unembed(h, params["embed"])[:, 0], cache
