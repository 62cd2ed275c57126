"""Mixture-of-Experts MLP: GShard/Switch-style routing with capacity.

Tokens are grouped, routed top-k with optional ThundeRiNG jitter, and
given (E, C) expert slots as in the reference: choice j of every token in
priority order, the slot within the chosen expert the running count of
earlier tokens routed there, choices past the capacity C dropped.

The reference moves tokens to slots and back with one-hot einsums over a
(G, gs, E, C) dispatch tensor.  Every slot holds at most one token, so
the port moves them with index gathers (``_Pick``) and gets the same
dispatched activations; the combine adds each token's k weighted expert
rows as the einsum does, in bf16 products with a bf16 result.  Both
directions of the backward pass are gathers too: no accumulating scatter,
so the gradients do not depend on the order of atomic adds.

Aux losses: load-balance (Switch) + router z-loss, returned per layer.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import stream as tstream
from repro_torch.models import layers as L
from repro_torch.models import sharding as shd
from repro_torch.models.common import ArchConfig


def _group_size(n: int, want: int = 2048, min_groups: int = 32) -> int:
    """Largest divisor of n that is <= want and (if possible) keeps
    n/gs >= min_groups so the group dim stays shardable over data axes."""
    best = 1
    for gs in range(1, min(want, n) + 1):
        if n % gs == 0:
            if n // gs >= min_groups:
                best = gs
            elif best == 1:
                best = gs
    return best


def router_probs(x: torch.Tensor, router_w: torch.Tensor,
                 rng: Optional[tstream.ThunderStream], jitter: float = 1e-2):
    """x: (G, gs, D) -> router probabilities (G, gs, E) fp32, and the
    logits."""
    if rng is not None and jitter > 0:
        bits = L.dropout_bits(rng.h, rng.ctr, tuple(x.shape), x.device)
        u = (bits >> 8).to(torch.float32) * float(np.float32(2.0 ** -24))
        x = x * (1.0 + jitter * (2.0 * u - 1.0)).to(x.dtype)
    # a float32 product of bf16 operands (layers module docstring)
    logits = torch.matmul(x.to(torch.float32),
                          router_w.to(x.dtype).to(torch.float32))
    return torch.softmax(logits, dim=-1), logits


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(probs: torch.Tensor, k: int, capacity: int):
    """Slots of the reference's dispatch.  probs: (G, gs, E).

    Returns (top_w (G, gs, k) normalized weights, top_idx (G, gs, k)
    experts, slot (G, gs, k): e * C + position within expert e, or E * C
    for a choice dropped past the capacity)."""
    G, gs, E = probs.shape
    top_w, top_idx = top_k(probs, k)
    top_w = top_w / torch.clamp(torch.sum(top_w, -1, keepdim=True), min=1e-9)
    counts = torch.zeros((G, E), dtype=torch.int64, device=probs.device)
    slots = []
    for j in range(k):
        onehot = torch.nn.functional.one_hot(top_idx[..., j], E)  # (G, gs, E)
        pos_in_e = torch.cumsum(onehot, 1) - onehot + counts[:, None, :]
        pos_j = torch.sum(pos_in_e * onehot, -1)                   # (G, gs)
        slots.append(torch.where(pos_j < capacity,
                                 top_idx[..., j] * capacity + pos_j,
                                 E * capacity))
        counts = counts + torch.sum(onehot, 1)
    return top_w, top_idx, torch.stack(slots, -1)


def _inverse(slot: torch.Tensor, n_slots: int) -> torch.Tensor:
    """slot (G, gs, k) -> (G, n_slots) the flat choice s * k + j that
    fills each slot, gs * k where none does."""
    G, gs, k = slot.shape
    inv = torch.full((G, n_slots + 1), gs * k, dtype=torch.int64,
                     device=slot.device)
    choice = torch.arange(gs * k, device=slot.device).expand(G, gs * k)
    # each kept slot is written once; the dropped ones land on the extra
    # column, which is cut off
    inv.scatter_(1, slot.reshape(G, gs * k), choice)
    return inv[:, :n_slots]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (G, n, D), idx (G, m) in [0, n] -> (G, m, D); n picks a zero row."""
    pad = torch.cat([x, x.new_zeros((x.shape[0], 1, x.shape[2]))], 1)
    return torch.gather(pad, 1, idx[..., None].expand(-1, -1, x.shape[2]))


class _Pick(torch.autograd.Function):
    """out[g, i] = x[g, idx[g, i]] (a zero row where idx = n), with the
    backward grad_x[g, r] = sum_t grad[g, back[g, r, t]] (a zero row
    where back = m): ``back`` lists where each row of x went."""

    @staticmethod
    def forward(ctx, x, idx, back):
        ctx.save_for_backward(back)
        return _gather_rows(x, idx)

    @staticmethod
    def backward(ctx, grad):
        (back,) = ctx.saved_tensors
        G, n, t = back.shape
        g = _gather_rows(grad.contiguous(), back.reshape(G, n * t))
        return g.reshape(G, n, t, -1).sum(2), None, None


def moe_mlp(cfg: ArchConfig, h: torch.Tensor, router_w, wg, wi, wo,
            rng: Optional[tstream.ThunderStream]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: (B, S, D) -> (B, S, D), aux scalar loss.

    wg/wi: (E, D, F); wo: (E, F, D).
    """
    B, S, D = h.shape
    E, k = cfg.n_experts, cfg.top_k
    h = shd.gather_seq_hint(h)
    N = B * S
    gs = _group_size(N, want=cfg.moe_group)
    G = N // gs
    x = h.reshape(G, gs, D)

    probs, logits = router_probs(x, router_w, rng)
    C = max(1, int(np.ceil(cfg.capacity_factor * k * gs / E)))
    top_w, top_idx, slot = route(probs, k, C)
    src = _inverse(slot, E * C)                     # (G, E*C) choice

    # dispatch tokens -> (G, E*C, D): slot -> token s = choice // k
    tok = torch.where(src < gs * k, src // k, gs)
    xe = _Pick.apply(x, tok, slot)
    # expert FFN over (E, G*C, D)
    xe = xe.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    gate = torch.matmul(xe, wg.to(xe.dtype))
    up = torch.matmul(xe, wi.to(xe.dtype))
    act = L.silu(gate) * up
    ye = torch.matmul(act, wo.to(xe.dtype))
    ye = ye.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
    # combine back: each token's k slots, weighted (the reference's
    # combine.astype(ye.dtype), 0 for a dropped choice)
    picked = _Pick.apply(ye, slot.reshape(G, gs * k), src[..., None])
    w = torch.where(slot < E * C, top_w, 0.0).to(ye.dtype)
    y = torch.matmul(w.reshape(N, 1, k), picked.reshape(N, k, D))

    # Switch load-balance loss + router z-loss
    density = torch.mean(probs, 1)                              # (G, E)
    top1 = torch.nn.functional.one_hot(top_idx[..., 0], E).to(torch.float32)
    frac = torch.mean(top1, 1)                                  # (G, E)
    lb = E * torch.mean(torch.sum(density * frac, -1))
    z = torch.mean(torch.logsumexp(logits, -1) ** 2)
    aux = lb + 1e-3 * z
    return y.reshape(B, S, D), aux
