"""Plain reference of a GraniteMoe decoder LM (granite-3.0-3b-a800m as the
port configures it), in float32 with TF32 off, written from the
architecture's equations.  It imports nothing of the program under test.

  h = E[tokens] * embedding_multiplier
  per layer:  a = rms(h) (1 + w_attn);  q, k, v = a Wq, a Wk, a Wv
              RoPE on (q, k): pairs (2i, 2i+1) of every head dimension
              h += residual_multiplier * softmax(attention_multiplier
                   * q k^T, causal) v Wo
              m = rms(h) (1 + w_mlp)
              r = j(m) R, the router's logits; j(m) = m bf16(1 + 0.01 (2u - 1))
                  with u the top 24 bits of the layer's jitter word over
                  2^24 and bf16() rounding to bfloat16
              the top k of r (the lower expert first among equals), their
              gates softmax(r_top): every token reaches its k experts
              h += residual_multiplier * sum_j gate_j
                   (silu(m Wg[e_j]) * (m Wi[e_j])) Wo[e_j]
  logits = rms(h) (1 + w_final) E^T / logits_scaling

The jitter is the program's own (a departure from GraniteMoe, which has
none).  Its words are the ThundeRiNG counter-mode decorrelator words of a
leaf made again from the train step's seed by the plain generator
(``misrn``): the family of (0, 0xD07), then the step, then the layer, then
0x4D4C50; word i jitters element i of the layer's (tokens, d_model) input.
The aux loss is the program's: per group of tokens (``group_size``), the
Switch load balance E * sum(mean probs * top-1 share) plus 1e-3 of the
squared log-sum-exp of the router's logits, averaged over the groups and
the layers, weighted ``AUX_WEIGHT`` in the loss.

``precision`` is ``"float32"`` or the control ``"fp8"``, as in
``dense_lm``: every product's operands and the residual stream held in
float8_e4m3fn under a per-tensor scale.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import misrn
from bench.reference.dense_lm import held, mm, rms, rope

F32 = torch.float32
#: the program's router jitter and its stream's tags
JITTER = 0.01
TRAIN_PURPOSE = 0xD07
MLP_TAG = 0x4D4C50
#: the weight of the mean aux loss in the training loss
AUX_WEIGHT = 0.01


def group_size(n: int, want: int, min_groups: int = 32) -> int:
    """The aux loss's group: the largest divisor of n that is <= want and,
    where one is, leaves at least ``min_groups`` groups."""
    best = 1
    for gs in range(1, min(want, n) + 1):
        if n % gs == 0 and (n // gs >= min_groups or best == 1):
            best = gs
    return best


def jitter_leaf(step: int, layer: int, seed: int = 0) -> int:
    """The leaf offset of a train step's layer's router jitter."""
    _, h = misrn.family(seed, TRAIN_PURPOSE)
    for tag in (step & misrn.M32, layer, MLP_TAG):
        h = misrn.derive_leaf_int(h, tag)
    return h


def jitter_factor(leaf: int, shape, device) -> torch.Tensor:
    """1 + JITTER (2u - 1) for the words 0 .. n-1 of ``leaf``, rounded to
    bfloat16 as the program's jitter defines it (its factors lie on
    bfloat16's grid: 2^-8 apart below 1, 2^-7 above), held in float32."""
    n = 1
    for s in shape:
        n *= s
    c = torch.arange(n, dtype=torch.int64, device=device)
    w = misrn.deco(torch.full_like(c, misrn.s64(leaf)), c)
    u = (w >> 8).to(F32) * 2.0 ** -24
    factor = (1.0 + JITTER * (2.0 * u - 1.0)).to(torch.bfloat16).to(F32)
    return factor.reshape(shape)


def attention(arch: Dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              precision: str) -> torch.Tensor:
    """Causal attention, one sequence at a time; q (B, S, H, hd), k / v
    (B, S, K, hd) -> (B, S, H * hd)."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]               # query head j reads kv head j // rep
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    out = []
    for b in range(B):
        qh = q[b].transpose(0, 1)                          # (H, S, hd)
        kh = k[b].repeat_interleave(rep, dim=1).transpose(0, 1)
        vh = v[b].repeat_interleave(rep, dim=1).transpose(0, 1)
        logits = mm(qh, kh.transpose(-1, -2), precision) * \
            arch["attention_multiplier"]
        w = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
        out.append(mm(w, vh, precision).transpose(0, 1).reshape(S, H * hd))
    return torch.stack(out)


def moe(arch: Dict, p: Dict[str, torch.Tensor], m: torch.Tensor,
        factor: Optional[torch.Tensor], precision: str):
    """Dropless top-k MoE of (N, D) rows; returns (out (N, D), aux)."""
    N, D = m.shape
    E, k = arch["n_experts"], arch["top_k"]
    r = mm(m if factor is None else m * factor, p["router"], precision)
    _, order = torch.sort(r, dim=-1, descending=True, stable=True)
    top = order[:, :k]                                     # (N, k)
    gates = torch.softmax(r.gather(1, top), -1)
    out = torch.zeros_like(m)
    for e in range(E):
        hit = top == e                                     # (N, k)
        rows = torch.nonzero(hit.any(1))[:, 0]
        if rows.numel() == 0:
            continue
        x = m[rows]
        act = mm(x, p["moe_wg"][e], precision)
        act = act * torch.sigmoid(act) * mm(x, p["moe_wi"][e], precision)
        g = (gates * hit).sum(1)[rows]
        out = out.index_add(0, rows, g[:, None] * mm(act, p["moe_wo"][e],
                                                     precision))
    gs = group_size(N, arch.get("moe_group", 2048))
    probs = torch.softmax(r, -1).reshape(N // gs, gs, E)
    top1 = torch.nn.functional.one_hot(top[:, 0], E).to(F32)
    lb = E * torch.mean(torch.sum(probs.mean(1)
                                  * top1.reshape(N // gs, gs, E).mean(1), -1))
    z = torch.mean(torch.logsumexp(r, -1) ** 2)
    return out, lb + 1e-3 * z


def layer(arch: Dict, p: Dict[str, torch.Tensor], h: torch.Tensor,
          factor: Optional[torch.Tensor], precision: str):
    """One decoder layer; ``p`` holds the layer's own weights.  Returns
    (h, aux)."""
    B, S, D = h.shape
    H, K = arch["n_heads"], arch["n_kv_heads"]
    hd = arch.get("head_dim") or D // H
    eps, res = arch["norm_eps"], arch["residual_multiplier"]
    pos = torch.arange(S, device=h.device)
    a = rms(h, p["attn_norm"], eps)
    q = mm(a, p["wq"].reshape(D, H * hd), precision).reshape(B, S, H, hd)
    k = mm(a, p["wk"].reshape(D, K * hd), precision).reshape(B, S, K, hd)
    v = mm(a, p["wv"].reshape(D, K * hd), precision).reshape(B, S, K, hd)
    q, k = rope(q, pos, arch["rope_theta"]), rope(k, pos, arch["rope_theta"])
    o = attention(arch, q, k, v, precision)
    h = held(h + res * mm(o, p["wo"].reshape(H * hd, D), precision),
             precision)
    m = rms(h, p["mlp_norm"], eps).reshape(B * S, D)
    y, aux = moe(arch, p, m, factor, precision)
    return held(h + res * y.reshape(B, S, D), precision), aux


def hidden(arch: Dict, params: Dict, tokens: torch.Tensor,
           precision: str = "float32", step: Optional[int] = None,
           remat: bool = False):
    """Final-norm hidden states (B, S, D) of int tokens (B, S) and the
    mean aux loss; ``step`` jitters the router as train step ``step``
    does.  ``params["layers"]`` maps each name to a stacked tensor or to a
    list of per-layer tensors."""
    h = held(params["embed"][tokens.long()].to(F32)
             * arch["embedding_multiplier"], precision)
    B, S = tokens.shape
    auxes = []
    for li in range(arch["n_layers"]):
        lp = {k: v[li] for k, v in params["layers"].items()}
        factor = None if step is None else jitter_factor(
            jitter_leaf(step, li), (B * S, arch["d_model"]), h.device)
        if remat:
            h, aux = checkpoint(layer, arch, lp, h, factor, precision,
                                use_reentrant=False)
        else:
            h, aux = layer(arch, lp, h, factor, precision)
        auxes.append(aux)
    return (rms(h, params["final_norm"], arch["norm_eps"]),
            torch.stack(auxes).mean())


def table(arch: Dict, params: Dict) -> torch.Tensor:
    return params["embed"] if arch.get("tie_embeddings") else \
        params["unembed"]


def logits_at(arch: Dict, params: Dict, tokens: torch.Tensor, first: int,
              precision: str = "float32") -> torch.Tensor:
    """(B, S - first, V) float32 logits of positions first .. S-1, without
    jitter (as served)."""
    h, _ = hidden(arch, params, tokens, precision)
    return mm(h[:, first:], table(arch, params).T, precision) / \
        arch["logits_scaling"]


def loss(arch: Dict, params: Dict, tokens: torch.Tensor,
         labels: torch.Tensor, step: Optional[int], precision: str = "float32",
         chunks: int = 16) -> torch.Tensor:
    """Train step ``step``'s loss: mean next-token cross-entropy over every
    position (the logits made one sequence chunk at a time, each
    recomputed in backward) plus ``AUX_WEIGHT`` times the mean aux loss."""
    h, aux = hidden(arch, params, tokens, precision, step, remat=True)
    B, S, _ = h.shape
    n = min(chunks, S)
    while S % n:
        n -= 1
    size = S // n
    U = table(arch, params)

    def chunk_nll(hc, lc, U):
        lg = mm(hc, U.T, precision) / arch["logits_scaling"]
        return (torch.logsumexp(lg, -1)
                - lg.gather(-1, lc.long()[..., None])[..., 0]).sum()

    total = sum(checkpoint(chunk_nll, h[:, i:i + size], labels[:, i:i + size],
                           U, use_reentrant=False)
                for i in range(0, S, size))
    return total / (B * S) + AUX_WEIGHT * aux


def moe_lm_leaves(arch: Dict) -> List:
    """(path, shape) of every leaf, in the program's layout."""
    L, D, V, F = arch["n_layers"], arch["d_model"], arch["vocab"], arch["d_ff"]
    H, K, E = arch["n_heads"], arch["n_kv_heads"], arch["n_experts"]
    hd = arch.get("head_dim") or D // H
    R = H // K
    out = [("embed", (V, D)), ("final_norm", (D,))]
    if not arch.get("tie_embeddings", False):
        out.append(("unembed", (V, D)))
    return out + [("layers/attn_norm", (L, D)), ("layers/wq", (L, D, K, R, hd)),
                  ("layers/wk", (L, D, K, hd)), ("layers/wv", (L, D, K, hd)),
                  ("layers/wo", (L, K, R, hd, D)), ("layers/mlp_norm", (L, D)),
                  ("layers/router", (L, D, E)),
                  ("layers/moe_wg", (L, E, D, F)),
                  ("layers/moe_wi", (L, E, D, F)),
                  ("layers/moe_wo", (L, E, F, D))]
