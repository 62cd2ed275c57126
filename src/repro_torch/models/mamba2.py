"""Mamba2 (SSD — state-space duality) blocks, chunked-parallel form for
training and prefill + O(1)-state decode form.  arXiv:2405.21060.

Chunked SSD: sequence split into chunks of Q; within a chunk the
quadratic (Q x Q) "attention-like" form runs as batched products; across
chunks a linear recurrence over the (H, N, P) states runs as a Python
loop over the chunk boundaries (the reference's ``lax.scan``).

Single group (G=1) for B/C as in the assigned configs.  The depthwise
causal conv runs as three separate convs (x / B / C), as the reference's.
bf16 work rounds op by op, as XLA's does (``layers.silu``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import sharding as shd
from repro_torch.models.common import ArchConfig, ParamFactory

F32 = torch.float32


def mamba_layer_params(pf: ParamFactory, cfg: ArchConfig, prefix: str,
                       n_layers: int) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    DI = cfg.d_inner
    N = cfg.ssm_state
    H = cfg.ssm_heads
    ck = cfg.ssm_conv
    std = 0.02
    std_out = std / np.sqrt(2.0 * max(cfg.n_layers, 1))
    Lx = ("layer",)
    p = {}
    p[f"{prefix}/norm"] = pf.zeros(f"{prefix}/norm", (n_layers, D),
                                   Lx + ("embed",))
    p[f"{prefix}/wz"] = pf.normal(f"{prefix}/wz", (n_layers, D, DI), std,
                                  Lx + ("embed", "ssm_inner"))
    p[f"{prefix}/wx"] = pf.normal(f"{prefix}/wx", (n_layers, D, DI), std,
                                  Lx + ("embed", "ssm_inner"))
    p[f"{prefix}/wB"] = pf.normal(f"{prefix}/wB", (n_layers, D, N), std,
                                  Lx + ("embed", "ssm_state"))
    p[f"{prefix}/wC"] = pf.normal(f"{prefix}/wC", (n_layers, D, N), std,
                                  Lx + ("embed", "ssm_state"))
    p[f"{prefix}/wdt"] = pf.normal(f"{prefix}/wdt", (n_layers, D, H), std,
                                   Lx + ("embed", "ssm_heads"))
    # dt bias: softplus^-1 of log-spaced dt in [1e-3, 1e-1]
    dts = np.exp(np.linspace(np.log(1e-3), np.log(1e-1), H,
                             dtype=np.float32))
    dtb = np.log(np.expm1(dts))
    p[f"{prefix}/dt_bias"] = pf.const(
        f"{prefix}/dt_bias",
        torch.from_numpy(np.broadcast_to(dtb, (n_layers, H)).copy()),
        Lx + ("ssm_heads",))
    a_init = np.log(np.linspace(1.0, 16.0, H, dtype=np.float32))
    p[f"{prefix}/a_log"] = pf.const(
        f"{prefix}/a_log",
        torch.from_numpy(np.broadcast_to(a_init, (n_layers, H)).copy()),
        Lx + ("ssm_heads",))
    p[f"{prefix}/d_skip"] = pf.ones(f"{prefix}/d_skip", (n_layers, H),
                                    Lx + ("ssm_heads",))
    p[f"{prefix}/conv_x_w"] = pf.normal(f"{prefix}/conv_x_w",
                                        (n_layers, ck, DI), 0.1,
                                        Lx + ("conv_k", "ssm_inner"))
    p[f"{prefix}/conv_x_b"] = pf.zeros(f"{prefix}/conv_x_b", (n_layers, DI),
                                       Lx + ("ssm_inner",))
    p[f"{prefix}/conv_B_w"] = pf.normal(f"{prefix}/conv_B_w",
                                        (n_layers, ck, N), 0.1,
                                        Lx + ("conv_k", "ssm_state"))
    p[f"{prefix}/conv_B_b"] = pf.zeros(f"{prefix}/conv_B_b", (n_layers, N),
                                       Lx + ("ssm_state",))
    p[f"{prefix}/conv_C_w"] = pf.normal(f"{prefix}/conv_C_w",
                                        (n_layers, ck, N), 0.1,
                                        Lx + ("conv_k", "ssm_state"))
    p[f"{prefix}/conv_C_b"] = pf.zeros(f"{prefix}/conv_C_b", (n_layers, N),
                                       Lx + ("ssm_state",))
    p[f"{prefix}/gnorm"] = pf.zeros(f"{prefix}/gnorm", (n_layers, DI),
                                    Lx + ("ssm_inner",))
    p[f"{prefix}/out_proj"] = pf.normal(f"{prefix}/out_proj",
                                        (n_layers, DI, D), std_out,
                                        Lx + ("ssm_inner", "embed"))
    return p


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), with no threshold (``F.softplus`` returns x past
    its threshold of 20)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over seq: x (B, S, C), w (ck, C), b (C,).

    ``tail``: (B, ck-1, C) carry-in from the previous segment
    (decode/prefill continuation); zeros when None.
    """
    ck = w.shape[0]
    if tail is None:
        xp = F.pad(x, (0, 0, ck - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], 1)
    out = torch.zeros_like(x)
    for i in range(ck):
        out = out + xp[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    return L.silu(out + b.to(x.dtype))


def _ssd_chunked(x, dt, A, B_, C_, chunk: int, h0=None):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) fp32; A: (H,) fp32 (negative);
    B_/C_: (B, S, N).  Returns (y (B, S, H, P), final state (B, H, N, P)).
    """
    B, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q
    xb = x.reshape(B, nc, Q, H, P)
    dtb = dt.reshape(B, nc, Q, H)
    Bb = B_.reshape(B, nc, Q, N).to(F32)
    Cb = C_.reshape(B, nc, Q, N).to(F32)

    dA = dtb * A                                    # (B, nc, Q, H) fp32, <=0
    cum = torch.cumsum(dA, 2)
    # within-chunk decay L[i, j] = exp(cum_i - cum_j), i >= j
    cumT = cum.transpose(2, 3)                      # (B, nc, H, Q)
    seg = cumT[..., :, None] - cumT[..., None, :]   # (B, nc, H, Q, Q)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # masked before the exp: above the diagonal seg > 0 and its exp may
    # overflow; the reference's where(tri, exp(seg), 0) has the same
    # values, but its gradient there is 0 * inf = NaN (ROADMAP C9)
    Lmat = torch.exp(torch.where(tri, seg, float("-inf")))
    del seg
    scores = torch.einsum("bcin,bcjn->bcij", Cb, Bb)
    M = scores[:, :, None] * Lmat                   # (B, nc, H, Q, Q)
    del Lmat
    xdt = xb.to(F32) * dtb[..., None]
    y_diag = torch.einsum("bchij,bcjhp->bcihp", M, xdt)
    del M

    # chunk-boundary states
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, Q, H)
    states = torch.einsum("bcjn,bcjhp->bchnp", Bb, xdt * decay_end[..., None])
    chunk_decay = torch.exp(cum[:, :, -1, :])       # (B, nc, H)

    hprev = torch.zeros((B, H, N, P), dtype=F32, device=x.device) \
        if h0 is None else h0.to(F32)
    prevs = []
    for c in range(nc):
        prevs.append(hprev)
        hprev = chunk_decay[:, c, :, None, None] * hprev + states[:, c]
    prevs = torch.stack(prevs, 1)                   # (B, nc, H, N, P)

    decay_start = torch.exp(cum)                    # (B, nc, Q, H)
    y_off = torch.einsum("bcin,bchnp->bcihp", Cb, prevs) * \
        decay_start[..., None]
    y = (y_diag + y_off).reshape(B, S, H, P)
    return y.to(x.dtype), hprev


def _in_proj(cfg: ArchConfig, lp, h):
    """The block's input projections: (x_in, z, x, B, C raw, dt fp32)."""
    x_in = L.rms_norm(h, lp["norm"], cfg.norm_eps)
    z = torch.matmul(x_in, lp["wz"].to(x_in.dtype))
    xr = torch.matmul(x_in, lp["wx"].to(x_in.dtype))
    Br = torch.matmul(x_in, lp["wB"].to(x_in.dtype))
    Cr = torch.matmul(x_in, lp["wC"].to(x_in.dtype))
    dt_raw = torch.matmul(x_in.to(F32), lp["wdt"].to(F32)) + \
        lp["dt_bias"].to(F32)
    return z, xr, Br, Cr, softplus(dt_raw)


def mamba_block(cfg: ArchConfig, lp: Dict[str, torch.Tensor], h, rng=None,
                conv_tails=None, h0=None):
    """Full-sequence mamba2 block.  h: (B, S, D).

    Returns (out (B, S, D), (final ssm state, conv tails))."""
    DI, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    ck = cfg.ssm_conv
    z, xr, Br, Cr, dt = _in_proj(cfg, lp, h)         # dt (B, S, H) fp32

    t_x = t_B = t_C = None
    if conv_tails is not None:
        t_x, t_B, t_C = conv_tails
    xc = _causal_conv(xr, lp["conv_x_w"], lp["conv_x_b"], t_x)
    Bc = _causal_conv(Br, lp["conv_B_w"], lp["conv_B_b"], t_B)
    Cc = _causal_conv(Cr, lp["conv_C_w"], lp["conv_C_b"], t_C)

    A = -torch.exp(lp["a_log"].to(F32))              # (H,)
    xh = xc.reshape(*xc.shape[:2], H, P)
    y, final = _ssd_chunked(xh, dt, A, Bc, Cc, chunk=128, h0=h0)
    y = y + xh * lp["d_skip"].to(xh.dtype)[:, None]
    y = y.reshape(*y.shape[:2], DI)
    y = L.rms_norm(y * L.silu(z), lp["gnorm"], cfg.norm_eps)
    out = torch.matmul(y, lp["out_proj"].to(y.dtype))
    if rng is not None:
        out = L.dropout(out, rng, cfg.dropout_rate)
    new_tails = (_tail_of(t_x, xr, ck), _tail_of(t_B, Br, ck),
                 _tail_of(t_C, Cr, ck))
    return shd.activation_hint(h + out), (final, new_tails)


def _tail_of(prev_tail, seq, ck):
    """Last ck-1 raw conv inputs (using the carry-in when seq is short)."""
    need = ck - 1
    if seq.shape[1] >= need:
        return seq[:, seq.shape[1] - need:]
    if prev_tail is None:
        pad = seq.new_zeros((seq.shape[0], need - seq.shape[1],
                             seq.shape[2]))
        return torch.cat([pad, seq], 1)
    keep = need - seq.shape[1]
    return torch.cat([prev_tail[:, prev_tail.shape[1] - keep:]
                      .to(seq.dtype), seq], 1)


def mamba_decode_step(cfg: ArchConfig, lp, h, state, tails):
    """One-token step.  h: (B, 1, D); state (B, H, N, P) fp32; tails: 3x
    (B, ck-1, C).  Returns (out (B, 1, D), state, tails): ``state`` and
    each tail are updated in place (the decode cache's slices)."""
    DI, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    ck = cfg.ssm_conv
    t_x, t_B, t_C = tails
    z, xr, Br, Cr, dt = _in_proj(cfg, lp, h)
    dt = dt[:, 0]                                    # (B, H)

    xc = _causal_conv(xr, lp["conv_x_w"], lp["conv_x_b"], t_x)[:, 0]
    Bc = _causal_conv(Br, lp["conv_B_w"], lp["conv_B_b"], t_B)[:, 0]
    Cc = _causal_conv(Cr, lp["conv_C_w"], lp["conv_C_b"], t_C)[:, 0]
    for tail, seq in ((t_x, xr), (t_B, Br), (t_C, Cr)):
        tail.copy_(_tail_of(tail, seq, ck))

    A = -torch.exp(lp["a_log"].to(F32))
    xh = xc.reshape(-1, H, P).to(F32)                # (B, H, P)
    dA = torch.exp(dt * A)                           # (B, H)
    contrib = torch.einsum("bn,bh,bhp->bhnp", Bc.to(F32), dt, xh)
    state.mul_(dA[..., None, None]).add_(contrib)
    del contrib
    y = torch.einsum("bn,bhnp->bhp", Cc.to(F32), state)
    y = y + xh * lp["d_skip"].to(F32)[:, None]
    y = y.reshape(-1, 1, DI).to(h.dtype)
    y = L.rms_norm(y * L.silu(z), lp["gnorm"], cfg.norm_eps)
    out = torch.matmul(y, lp["out_proj"].to(y.dtype))
    return h + out, state, tails
