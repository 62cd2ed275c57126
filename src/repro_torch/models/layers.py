"""Transformer building blocks as plain torch functions.

Conventions (the reference's):
  * params are fp32; compute casts to bf16 with fp32 softmax/norm accums.
  * attention heads carry split (K, R) dims — K = kv heads, R = query
    repeats (H = K*R).
  * memory-efficient attention: a loop over query chunks with full-key
    logits per chunk (peak q_chunk x T per head) — no S x S tensor.
  * dropout is counter-addressable ThundeRiNG bits (the decorrelator member
    of the family): mask(b,s,d) depends only on (leaf h, flat element
    index).

Products the reference asks in float32 from bf16 operands
(``preferred_element_type=float32``: the attention logits and the
unembedding) upcast both operands to float32 and multiply in float32.
Every product of two bf16 values is exact in float32, so only the order
of summation differs from the reference.  (TF32 would be exact on such
operands too, but torch enables it only through a process-wide flag,
which the port leaves alone.)  Other products run in bf16 with a bf16
result, as the reference's bf16 dots do.

Eager torch does not fuse casts as XLA does under ``jit``: ``embed``
gathers rows, then casts them (the same values as casting the table
first), while weight casts stay per call, as in the reference.

Where the reference wraps a body in ``jax.checkpoint`` (each attention
query chunk, each loss chunk, each layer under ``remat="full"``), the
port wraps it in ``remat``: recomputed in the backward pass when a
gradient is recorded, a plain call otherwise (serving).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from repro_torch.core import engine, splitmix, u64
from repro_torch.core import stream as tstream
from repro_torch.core.u64 import M32

COMPUTE_DTYPE = torch.bfloat16

#: Masked attention logit (the reference's ``-1e30``).
MASK_VALUE = float(np.float32(-1e30))

#: float8_e4m3fn's largest finite value is 448; a value above 464 rounds
#: past it.  XLA's conversion gives NaN there, torch's saturates.
_F8_OVERFLOW = 464.0


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` with the reference's float8_e4m3fn overflow:
    a magnitude that rounds past 448 (and +-inf) becomes NaN, where
    torch's own conversion would saturate to +-448."""
    if dtype == torch.float8_e4m3fn and x.dtype != dtype:
        x = torch.where(x.abs() > _F8_OVERFLOW,
                        torch.full((), float("nan"), dtype=x.dtype,
                                   device=x.device), x)
    return x.to(dtype)


def _records_grad(args) -> bool:
    for a in args:
        if isinstance(a, dict):
            if _records_grad(a.values()):
                return True
        elif isinstance(a, torch.Tensor) and a.requires_grad:
            return True
    return False


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    (``jax.checkpoint``) when grad mode is on and a tensor argument (or a
    dict of them) requires grad; a plain call otherwise.  The model
    draws from counter streams, never torch's generator, so no RNG state
    is stashed."""
    if torch.is_grad_enabled() and _records_grad(args):
        return _checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False)
    return fn(*args)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.to(torch.float32))).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    c = xf - mu
    var = torch.mean(c * c, dim=-1, keepdim=True)
    out = c * torch.rsqrt(var + eps)
    return (out * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, np.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, K, R, hd) or (..., S, K, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    # insert singleton head dims between S and hd so angles rank-matches x
    for _ in range(x.ndim - angles.ndim):
        angles = angles[..., None, :]
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def sinusoid_positions(n_pos: int, d_model: int) -> np.ndarray:
    """Whisper-style sinusoidal embeddings, (n_pos, d_model) f32."""
    log_timescale = math.log(10000.0) / (d_model // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(d_model // 2, dtype=np.float32))
    ang = np.arange(n_pos, dtype=np.float32)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1)


# ---------------------------------------------------------------------------
# ThundeRiNG dropout (counter-addressable)
# ---------------------------------------------------------------------------

def dropout_bits(h: int, ctr0: int, shape: Tuple[int, ...],
                 device=None) -> torch.Tensor:
    """The 32-bit words for elements ctr0 .. ctr0+prod(shape)-1 of the
    stream with leaf offset ``h``, laid out row-major over ``shape``, as
    an int64 limb tensor (values in [0, 2**32); the port's u64
    convention), on ``device`` (the card unless given)."""
    n = int(math.prod(shape))
    flat = torch.arange(n, dtype=torch.int64,
                        device=engine.resolve_device(device))
    c_hi, c_lo = u64.split64(ctr0)
    ctr = u64.add64((torch.full_like(flat, c_hi), torch.full_like(flat, c_lo)),
                    (flat >> 32, flat & M32))
    h_hi, h_lo = u64.split64(h)
    hh = (torch.full_like(flat, h_hi), torch.full_like(flat, h_lo))
    return splitmix.ctr_decorrelator(hh, ctr).reshape(tuple(shape))


def dropout(x: torch.Tensor, stream: Optional[tstream.ThunderStream],
            rate: float) -> torch.Tensor:
    if rate <= 0.0 or stream is None:
        return x
    bits = dropout_bits(stream.h, stream.ctr, tuple(x.shape), x.device)
    thresh = int(round((1.0 - rate) * (1 << 32))) & M32
    keep = bits < thresh
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _attn_logits(q, k, scale):
    # q: (B, S, K, R, d); k: (B, T, K, d) -> (B, K, R, S, T) fp32
    return torch.einsum("bqkrd,btkd->bkrqt", q.to(torch.float32),
                        k.to(torch.float32)) * scale


def _attn_combine(w, v):
    # w: (B, K, R, S, T) f32; v: (B, T, K, d) -> (B, S, K, R, d)
    return torch.einsum("bkrqt,btkd->bqkrd", w.to(v.dtype), v)


def _logit_scale(d: int, scale: Optional[float]) -> float:
    """The attention logits' factor: ``scale``, else 1 / sqrt(d)."""
    return float(np.float32(1.0 / math.sqrt(d) if scale is None else scale))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_chunk: int = 512,
              q_offset: int = 0, scale: Optional[float] = None
              ) -> torch.Tensor:
    """Memory-efficient attention.

    q: (B, S, K, R, d); k/v: (B, T, K, d).  Returns (B, S, K, R, d).
    ``q_offset``: absolute position of q[0] (for causal masking in
    prefill-with-cache scenarios).  ``scale`` replaces 1 / sqrt(d).
    """
    B, S, K, R, d = q.shape
    T = k.shape[1]
    scale = _logit_scale(d, scale)
    qc = min(q_chunk, S)
    while S % qc:
        qc -= 1
    tpos = torch.arange(T, device=q.device)

    def chunk(qi, k, v, start):
        logits = _attn_logits(qi, k, scale)  # (B, K, R, qc, T)
        if causal:
            qpos = torch.arange(qc, device=q.device) + (start + q_offset)
            mask = tpos[None, :] <= qpos[:, None]
            logits = torch.where(mask, logits, MASK_VALUE)
        w = torch.softmax(logits, dim=-1)
        return _attn_combine(w, v)

    if qc == S:
        return chunk(q, k, v, 0)
    # remat each chunk: otherwise the backward pass keeps every chunk's
    # float32 logits, O(S^2) per layer
    return torch.cat([remat(chunk, q[:, i:i + qc], k, v, i)
                      for i in range(0, S, qc)], dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a (B, T, K, d) cache, masked to <= pos.

    q: (B, 1, K, R, d).  ``scale`` replaces 1 / sqrt(d).
    """
    d = q.shape[-1]
    T = k_cache.shape[1]
    if k_cache.dtype != q.dtype:   # e.g. f8 storage -> bf16 compute
        k_cache = k_cache.to(q.dtype)
        v_cache = v_cache.to(q.dtype)
    scale = _logit_scale(d, scale)
    logits = _attn_logits(q, k_cache, scale)  # (B, K, R, 1, T)
    mask = torch.arange(T, device=q.device) <= int(pos)
    logits = torch.where(mask, logits, MASK_VALUE)
    w = torch.softmax(logits, dim=-1)
    return _attn_combine(w, v_cache)


def qkv_split(x: torch.Tensor, wq, wk, wv, bq=None, bk=None, bv=None):
    """x: (B, S, D); wq: (D, K, R, d); wk/wv: (D, K, d)."""
    q = torch.einsum("bsd,dkrh->bskrh", x, wq.to(x.dtype))
    k = torch.einsum("bsd,dkh->bskh", x, wk.to(x.dtype))
    v = torch.einsum("bsd,dkh->bskh", x, wv.to(x.dtype))
    if bq is not None:
        q = q + bq.to(x.dtype)
        k = k + bk.to(x.dtype)
        v = v + bv.to(x.dtype)
    return q, k, v


def attn_out(o: torch.Tensor, wo) -> torch.Tensor:
    """o: (B, S, K, R, d); wo: (K, R, d, D)."""
    return torch.einsum("bskrh,krhd->bsd", o, wo.to(o.dtype))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A scalar rounded to ``like``'s dtype, as JAX rounds a weak-typed
    python constant (torch would keep a python scalar in float32)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * logistic(x), logistic as 1 / (1 + exp(-x)),
    each op rounded to x's dtype as XLA computes it (``F.silu`` rounds
    once and differs from the reference in ~40 % of bf16 outputs)."""
    one = _const(1.0, x)
    return x * (one / (one + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` op for op in x's dtype (the tanh
    form of ``F.gelu``, with the reference's roundings)."""
    inner = _const(float(np.sqrt(2 / np.pi)), x) * (
        x + _const(0.044715, x) * (x * x * x))
    return x * (_const(0.5, x) * (_const(1.0, x) + torch.tanh(inner)))


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu" or kind == "geglu_silu":
        return silu(x)
    if kind == "geglu" or kind == "gelu":
        return gelu_tanh(x)
    raise ValueError(kind)


def mlp(x: torch.Tensor, wi, wo, act: str, wg=None) -> torch.Tensor:
    """Gated (wg != None) or plain MLP.  wi/wg: (D, F); wo: (F, D)."""
    up = torch.matmul(x, wi.to(x.dtype))
    if wg is not None:
        gate = torch.matmul(x, wg.to(x.dtype))
        up = _act(gate, act) * up
    else:
        up = _act(up, act)
    return torch.matmul(up, wo.to(x.dtype))


# ---------------------------------------------------------------------------
# Embedding / unembedding / loss
# ---------------------------------------------------------------------------

def scatter_add_rows(rows: torch.Tensor, idx: torch.Tensor,
                     n: int) -> torch.Tensor:
    """(n, D) zeros with ``rows[j]`` added to row ``idx[j]``, the rows of
    one index summed in the order of j on every device.

    torch's own accumulating index-put (the backward of ``table[idx]``)
    adds duplicates with atomics on the CPU, in an order that changes
    from run to run.  Here the k-th occurrence of each index is added in
    pass k: one ``index_add_`` per pass over distinct rows, so no two
    adds meet.  The passes come from the indices on the host (one copy).
    """
    out = torch.zeros((n, rows.shape[-1]), dtype=rows.dtype,
                      device=rows.device)
    host = idx.reshape(-1).cpu().numpy()
    order = np.argsort(host, kind="stable")
    srt = host[order]
    j = np.arange(len(srt))
    run_start = np.maximum.accumulate(
        np.where(np.r_[True, srt[1:] != srt[:-1]], j, 0))
    rank = j - run_start                       # occurrence number
    by_rank = np.argsort(rank, kind="stable")
    pos = torch.from_numpy(order[by_rank]).to(rows.device)
    dst = torch.from_numpy(srt[by_rank]).to(rows.device)
    lo = 0
    for count in np.bincount(rank):
        sl = slice(lo, lo + int(count))
        out.index_add_(0, dst[sl], rows.index_select(0, pos[sl]))
        lo += int(count)
    return out


class _Gather(torch.autograd.Function):
    """``table[idx]`` with ``scatter_add_rows`` as its backward."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        return scatter_add_rows(g, idx, ctx.rows), None


def embed(tokens: torch.Tensor, table: torch.Tensor,
          multiplier: Optional[float] = None) -> torch.Tensor:
    """The rows of ``tokens``, times ``multiplier`` in float32 if given,
    in bf16."""
    rows = _Gather.apply(table, tokens.to(torch.int64))
    if multiplier is not None:
        rows = rows * multiplier
    return rows.to(COMPUTE_DTYPE)


def unembed(x: torch.Tensor, table: torch.Tensor,
            divisor: Optional[float] = None) -> torch.Tensor:
    """(B, S, D) x (V, D) -> (B, S, V) fp32 logits of the bf16 operands,
    over ``divisor`` if given."""
    t = table.to(x.dtype).to(torch.float32)
    logits = torch.matmul(x.to(torch.float32), t.T)
    return logits if divisor is None else logits / divisor


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits fp32 (B, S, V), labels (B, S)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def softmax_xent_chunked(h: torch.Tensor, table: torch.Tensor,
                         labels: torch.Tensor, n_chunks: int = 16,
                         divisor: Optional[float] = None) -> torch.Tensor:
    """Vocab-memory-bounded cross-entropy: unembed + xent evaluated one
    sequence chunk at a time, each chunk remat'd, so the (B, S, V) logits
    tensor is never materialized (peak = one (B, S/nc, V) chunk).

    h: (B, S, D) hidden states; table: (V, D); labels: (B, S) int32;
    ``divisor``: the logits' (``unembed``).
    """
    B, S, D = h.shape
    nc = min(n_chunks, S)
    while S % nc:
        nc -= 1
    sc = S // nc

    def body(hx, table, lx):
        logits = unembed(hx, table, divisor)              # (B, sc, V) fp32
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lx.to(torch.int64)[..., None])[..., 0]
        return torch.sum(logz - gold)

    # remat each chunk: otherwise the backward pass keeps each chunk's
    # logits and its float32 copy of the table
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, sc):
        total = total + remat(body, h[:, i:i + sc], table,
                              labels[:, i:i + sc])
    return total / (B * S)
