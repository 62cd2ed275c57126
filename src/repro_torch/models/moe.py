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

A config with ``capacity_factor <= 0`` routes dropless instead, as
GraniteMoe does: every token reaches its top-k experts.  The N * k
(token, choice) pairs are sorted by expert (a stable sort), each expert's
rows padded to ``GROUP_ALIGN``, and the gate, up and down products run as
grouped products over the uneven row groups (``grouped_mm``: one
``torch._grouped_mm`` each on a card, a loop over the experts on the
CPU).  Dispatch, combine and both directions of their backward pass are
gathers, as above, and nothing in the block waits on the device.

With ``repro_torch.trace`` on, a call is spans ``moe.route`` (holding
``moe.jitter``), ``moe.experts`` and ``moe.combine``, keyed by the layer
and timed on the card; on the dropless path the backward pass of the
grouped products is span ``moe.experts_bwd``.  Counters, from shapes
alone, every call (a recomputation too): ``moe.calls``, ``moe.rows``
(N * k), ``moe.jitter_words`` (N * D), ``moe.dropless_calls`` and
``moe.capacity_calls``.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
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


#: Rows of each expert's group in the grouped products start at a multiple
#: of this on the dropless path.
GROUP_ALIGN = 16

#: Lists open under ``watch_drops``.
_drop_sinks: List[list] = []


@contextlib.contextmanager
def watch_drops():
    """While open, each ``moe_mlp`` call appends to the yielded list a
    0-dim int64 tensor on its device: its (token, choice) pairs that reach
    no expert row.  Nothing is read back here."""
    sink: list = []
    _drop_sinks.append(sink)
    try:
        yield sink
    finally:
        _drop_sinks.remove(sink)


def _note_drops(dropped: torch.Tensor) -> None:
    for sink in _drop_sinks:
        sink.append(dropped)


def router_probs(x: torch.Tensor, router_w: torch.Tensor,
                 rng: Optional[tstream.ThunderStream], jitter: float = 1e-2,
                 key=None):
    """x: (G, gs, D) -> router probabilities (G, gs, E) fp32, and the
    logits."""
    if rng is not None and jitter > 0:
        with trace.span("moe.jitter", key=key, device=x.device):
            bits = L.dropout_bits(rng.h, rng.ctr, tuple(x.shape), x.device)
            u = (bits >> 8).to(torch.float32) * float(np.float32(2.0 ** -24))
            x = x * (1.0 + jitter * (2.0 * u - 1.0)).to(x.dtype)
        trace.count("moe.jitter_words", x.numel())
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
            rng: Optional[tstream.ThunderStream], layer=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: (B, S, D) -> (B, S, D), aux scalar loss.

    wg/wi: (E, D, F); wo: (E, F, D).  ``layer`` keys the spans.
    """
    B, S, D = h.shape
    E, k = cfg.n_experts, cfg.top_k
    h = shd.gather_seq_hint(h)
    N = B * S
    gs = _group_size(N, want=cfg.moe_group)
    G = N // gs
    x = h.reshape(G, gs, D)
    trace.count("moe.calls")
    trace.count("moe.rows", N * k)
    if cfg.capacity_factor <= 0:
        trace.count("moe.dropless_calls")
        return _dropless(cfg, x, router_w, wg, wi, wo, rng, layer, (B, S, D))
    trace.count("moe.capacity_calls")

    with trace.span("moe.route", key=layer, device=h.device):
        probs, logits = router_probs(x, router_w, rng, key=layer)
        C = max(1, int(np.ceil(cfg.capacity_factor * k * gs / E)))
        top_w, top_idx, slot = route(probs, k, C)
        src = _inverse(slot, E * C)                     # (G, E*C) choice
        if _drop_sinks:
            _note_drops(torch.sum(slot == E * C))

        # dispatch tokens -> (G, E*C, D): slot -> token s = choice // k
        tok = torch.where(src < gs * k, src // k, gs)
        xe = _Pick.apply(x, tok, slot)
    with trace.span("moe.experts", key=layer, device=h.device):
        # expert FFN over (E, G*C, D)
        xe = xe.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
        gate = torch.matmul(xe, wg.to(xe.dtype))
        up = torch.matmul(xe, wi.to(xe.dtype))
        act = L.silu(gate) * up
        ye = torch.matmul(act, wo.to(xe.dtype))
    with trace.span("moe.combine", key=layer, device=h.device):
        ye = ye.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
        # combine back: each token's k slots, weighted (the reference's
        # combine.astype(ye.dtype), 0 for a dropped choice)
        picked = _Pick.apply(ye, slot.reshape(G, gs * k), src[..., None])
        w = torch.where(slot < E * C, top_w, 0.0).to(ye.dtype)
        y = torch.matmul(w.reshape(N, 1, k), picked.reshape(N, k, D))
    return y.reshape(B, S, D), _aux(probs, logits, top_idx, E)


def _aux(probs, logits, top_idx, E: int) -> torch.Tensor:
    """Switch load-balance loss + router z-loss over (G, gs, E) groups."""
    density = torch.mean(probs, 1)                              # (G, E)
    top1 = torch.nn.functional.one_hot(top_idx[..., 0], E).to(torch.float32)
    frac = torch.mean(top1, 1)                                  # (G, E)
    lb = E * torch.mean(torch.sum(density * frac, -1))
    z = torch.mean(torch.logsumexp(logits, -1) ** 2)
    return lb + 1e-3 * z


# ---------------------------------------------------------------------------
# dropless routing
# ---------------------------------------------------------------------------

def dropless_plan(top_idx: torch.Tensor, E: int, align: int = GROUP_ALIGN):
    """Rows of the grouped products for (N, k) chosen experts.

    The N * k choices (flat c = token * k + j) are sorted by expert,
    stably, so an expert's rows keep the choices' order; expert e's rows
    start at a multiple of ``align``.  Returns (row (N, k): the row of each
    choice; choice (M,): the flat choice of each row, N * k for a padding
    row; ends (E,) int32: each expert's last row + 1, the last expert's at
    M = N * k + E * (align - 1), so the groups cover every row).  All on
    the device, with no read-back."""
    N, k = top_idx.shape
    n = N * k
    dev = top_idx.device
    expert, order = torch.sort(top_idx.reshape(n), stable=True)
    first = torch.searchsorted(expert, torch.arange(E + 1, device=dev))
    counts = first[1:] - first[:-1]
    padded = (counts + (align - 1)) // align * align
    start = torch.cumsum(padded, 0) - padded                    # (E,)
    M = n + E * (align - 1)
    # the p-th sorted choice is number p - first[e] of its expert e
    row_sorted = start[expert] + torch.arange(n, device=dev) - first[expert]
    row = torch.empty(n, dtype=torch.int64, device=dev)
    row.scatter_(0, order, row_sorted)
    choice = torch.full((M,), n, dtype=torch.int64, device=dev)
    choice.scatter_(0, row_sorted, order)
    ends = torch.cat([(start + padded)[:-1],
                      torch.full((1,), M, dtype=torch.int64, device=dev)])
    return row.reshape(N, k), choice, ends.to(torch.int32)


def _take(x: torch.Tensor, idx: torch.Tensor, zero_row: bool
          ) -> torch.Tensor:
    """x (n, D) rows at idx; with ``zero_row`` idx = n picks a zero row."""
    if zero_row:
        x = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return x.index_select(0, idx)


class _Rows(torch.autograd.Function):
    """out[i] = x[idx[i]], with the backward grad_x[r] = sum_t
    grad[back[r, t]]: ``back`` lists where each row of x went.
    ``zero_fwd`` / ``zero_bwd``: idx = len(x) / back = len(out) picks a
    zero row."""

    @staticmethod
    def forward(ctx, x, idx, back, zero_fwd: bool, zero_bwd: bool):
        ctx.save_for_backward(back)
        ctx.zero_bwd = zero_bwd
        return _take(x, idx, zero_fwd)

    @staticmethod
    def backward(ctx, grad):
        (back,) = ctx.saved_tensors
        n, t = back.shape
        g = _take(grad.contiguous(), back.reshape(n * t), ctx.zero_bwd)
        g = g.reshape(n, t, -1).sum(1) if t > 1 else g
        return g, None, None, None, None


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor
               ) -> torch.Tensor:
    """x (M, K) times w (E, K, N), rows ends[e-1] .. ends[e] - 1 by w[e]
    (ends[-1] = M), in x's dtype: ``torch._grouped_mm`` on a card, a
    loop over the experts elsewhere."""
    if x.is_cuda:
        return torch._grouped_mm(x, w, offs=ends)
    out, lo = [], 0
    for e, hi in enumerate(ends.tolist()):
        out.append(torch.matmul(x[lo:hi], w[e]))
        lo = hi
    return torch.cat(out)


class _BwdMark(torch.autograd.Function):
    """The identity; its backward opens (``opening``) or closes span
    ``moe.experts_bwd`` in ``box``, so the span holds the backward pass
    of what lies between two marks."""

    @staticmethod
    def forward(ctx, x, box, opening: bool, key):
        ctx.box, ctx.opening, ctx.key, ctx.device = box, opening, key, \
            x.device
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.opening:
            span = trace.span("moe.experts_bwd", key=ctx.key,
                              device=ctx.device)
            ctx.box.append(span.__enter__())
        elif ctx.box:
            ctx.box.pop().__exit__(None, None, None)
        return grad, None, None, None


def _dropless(cfg: ArchConfig, x, router_w, wg, wi, wo, rng, layer, shape):
    """GraniteMoe's MoE: softmax over each token's top-k router logits
    (the top-k of the softmax, renormalized), every choice kept."""
    G, gs, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = G * gs
    dev = x.device
    with trace.span("moe.route", key=layer, device=dev):
        probs, logits = router_probs(x, router_w, rng, key=layer)
        top_w, top_idx = top_k(probs, k)
        top_w = top_w / torch.clamp(torch.sum(top_w, -1, keepdim=True),
                                    min=1e-9)
        row, choice, ends = dropless_plan(top_idx.reshape(N, k), E)
        if _drop_sinks:     # choices whose row does not hold them
            flat = row.reshape(N * k)
            _note_drops(torch.sum(choice[flat] != torch.arange(
                N * k, device=dev)))
        src = torch.where(choice < N * k, choice // k, N)    # token a row
        xe = _Rows.apply(x.reshape(N, D), src, row, True, False)
    box: list = []
    marked = trace.enabled() and torch.is_grad_enabled()
    with trace.span("moe.experts", key=layer, device=dev):
        if marked:
            xe = _BwdMark.apply(xe, box, False, layer)
        dt = xe.dtype
        gate = grouped_mm(xe, wg.to(dt), ends)
        up = grouped_mm(xe, wi.to(dt), ends)
        # silu rounded once (the reference package's op-by-op form,
        # ``layers.silu``, has no counterpart on this path)
        ye = grouped_mm(torch.nn.functional.silu(gate) * up, wo.to(dt), ends)
        if marked:
            ye = _BwdMark.apply(ye, box, True, layer)
    with trace.span("moe.combine", key=layer, device=dev):
        picked = _Rows.apply(ye, row.reshape(N * k), choice[:, None], False,
                             True)
        # weighted in float32: the router's gradient is the gates'
        # products with the expert rows, which the softmax then differences
        y = torch.matmul(top_w.reshape(N, 1, k),
                         picked.reshape(N, k, D).to(torch.float32))
    return y.reshape(shape).to(ye.dtype), _aux(probs, logits, top_idx, E)
