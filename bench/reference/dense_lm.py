"""Plain reference of a dense decoder LM (glm4-9b as the port configures
it), in float32 with TF32 off, written from the architecture's equations.
It imports nothing of the program under test.

  h = E[tokens]
  per layer:  a = rms(h) (1 + w_attn);  q, k, v = a Wq + bq, a Wk + bk,
              a Wv + bv (the biases with ``qkv_bias``)
              RoPE on (q, k): pairs (2i, 2i+1) of every head dimension,
              angle pos / theta^(2i / hd)
              h += softmax(q k^T / sqrt(hd), causal) v Wo
              m = rms(h) (1 + w_mlp);  h += (silu(m Wg) * (m Wi)) Wo_mlp
  logits = rms(h) (1 + w_final) U^T

``precision`` selects how values are held: ``"float32"``, or ``"fp8"`` -
the control, one precision below the bfloat16 the configuration states:
as the program holds its activations (the residual stream, a product's
operands) in bfloat16, the control holds them in float8_e4m3fn, each
rounded under a per-tensor scale (its absolute maximum to 448); products,
norms and softmax run in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8_e4m3fn under a per-tensor scale; the
    gradient passes the rounding unchanged, so a backward product reads
    the rounded operand and a float32 gradient."""
    with torch.no_grad():
        s = E4M3_MAX / x.abs().amax().clamp_min(1e-30)
        q = (x * s).to(torch.float8_e4m3fn).to(F32) / s
    return x + (q - x).detach() if x.requires_grad else q


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a (..., k) @ b (k, n) in float32, operands held as ``precision``."""
    if precision == "fp8":
        a, b = fp8_round(a), fp8_round(b)
    return torch.matmul(a, b)


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * (
        1.0 + w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); pos: (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32,
                                       device=x.device) / hd)
    ang = pos.to(F32)[:, None] * inv[None, :]             # (S, hd/2)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       -1).reshape(x.shape)


def held(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An activation as ``precision`` holds it."""
    return fp8_round(x) if precision == "fp8" else x


def layer(arch: Dict, p: Dict[str, torch.Tensor], h: torch.Tensor,
          precision: str) -> torch.Tensor:
    """One decoder layer; ``p`` holds the layer's own weights."""
    B, S, D = h.shape
    H, K = arch["n_heads"], arch["n_kv_heads"]
    hd = arch.get("head_dim") or D // H
    eps = arch["norm_eps"]
    pos = torch.arange(S, device=h.device)
    a = rms(h, p["attn_norm"], eps)
    q = mm(a, p["wq"].reshape(D, H * hd), precision).reshape(B, S, H, hd)
    k = mm(a, p["wk"].reshape(D, K * hd), precision).reshape(B, S, K, hd)
    v = mm(a, p["wv"].reshape(D, K * hd), precision).reshape(B, S, K, hd)
    if arch.get("qkv_bias", False):
        q = q + p["bq"].reshape(H, hd)
        k = k + p["bk"].reshape(K, hd)
        v = v + p["bv"].reshape(K, hd)
    q, k = rope(q, pos, arch["rope_theta"]), rope(k, pos, arch["rope_theta"])
    rep = H // K                        # query head j reads kv head j // rep
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, hd)
    logits = mm(qh, kh.transpose(-1, -2), precision) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    w = torch.softmax(logits.masked_fill(~mask, float("-inf")), -1)
    o = mm(w, vh, precision).transpose(1, 2).reshape(B, S, H * hd)
    h = held(h + mm(o, p["wo"].reshape(H * hd, D), precision), precision)
    m = rms(h, p["mlp_norm"], eps)
    g = mm(m, p["wg"], precision)
    up = mm(m, p["wi"], precision)
    return held(h + mm(g * torch.sigmoid(g) * up, p["wo_mlp"], precision),
                precision)


def layer_params(params: Dict, li: int) -> Dict[str, torch.Tensor]:
    return {k: v[li] for k, v in params["layers"].items()}


def hidden(arch: Dict, params: Dict, tokens: torch.Tensor,
           precision: str = "float32", remat: bool = False) -> torch.Tensor:
    """Final-norm hidden states (B, S, D) of int tokens (B, S).
    ``params["layers"]`` maps each name to a stacked tensor or to a list of
    per-layer tensors."""
    h = held(params["embed"][tokens.long()].to(F32), precision)
    for li in range(arch["n_layers"]):
        lp = layer_params(params, li)
        if remat:
            h = checkpoint(layer, arch, lp, h, precision, use_reentrant=False)
        else:
            h = layer(arch, lp, h, precision)
    return rms(h, params["final_norm"], arch["norm_eps"])


def table(arch: Dict, params: Dict) -> torch.Tensor:
    return params["embed"] if arch.get("tie_embeddings") else \
        params["unembed"]


def logits_at(arch: Dict, params: Dict, tokens: torch.Tensor,
              first: int, precision: str = "float32") -> torch.Tensor:
    """(B, S - first, V) float32 logits of positions first .. S-1."""
    h = hidden(arch, params, tokens, precision)[:, first:]
    return mm(h, table(arch, params).T, precision)


def loss(arch: Dict, params: Dict, tokens: torch.Tensor,
         labels: torch.Tensor, precision: str = "float32",
         chunks: int = 16) -> torch.Tensor:
    """Mean next-token cross-entropy over every position, the logits made
    one sequence chunk at a time (each chunk recomputed in backward)."""
    h = hidden(arch, params, tokens, precision, remat=True)
    B, S, _ = h.shape
    n = min(chunks, S)
    while S % n:
        n -= 1
    step = S // n
    U = table(arch, params)

    def chunk_nll(hc, lc, U):
        lg = mm(hc, U.T, precision)
        return (torch.logsumexp(lg, -1)
                - lg.gather(-1, lc.long()[..., None])[..., 0]).sum()

    total = sum(checkpoint(chunk_nll, h[:, i:i + step], labels[:, i:i + step],
                           U, use_reentrant=False)
                for i in range(0, S, step))
    return total / (B * S)


def adamw_lr(opt: Dict, step: int) -> float:
    """The learning rate of 1-based ``step``: linear warm-up, then cosine
    decay to ``min_ratio`` of the peak."""
    peak, warm, total = opt["peak_lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return step * peak / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (opt["min_ratio"] + (1 - opt["min_ratio"]) * 0.5
                   * (1 + math.cos(math.pi * prog)))


def adamw_step(opt: Dict, step: int, params: List[torch.Tensor],
               grads: List[Optional[torch.Tensor]], m: List[torch.Tensor],
               v: List[torch.Tensor], chunk: int = 1 << 26) -> List[float]:
    """One AdamW step with global-norm clipping, in place; ``step`` is
    1-based.  Each gradient is dropped from ``grads`` once its leaf is
    updated, and a leaf is updated ``chunk`` elements at a time, so the
    step needs little memory beyond its arguments.  Returns the norms of
    the gradients as the optimizer got them (clipped)."""
    gn = math.sqrt(sum(float(torch.linalg.vector_norm(g)) ** 2
                       for g in grads))
    scale = min(1.0, opt["clip_norm"] / max(gn, 1e-9))
    lr = adamw_lr(opt, step)
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    norms = []
    with torch.no_grad():
        for i, (p, mi, vi) in enumerate(zip(params, m, v)):
            g_all, grads[i] = grads[i], None
            norms.append(float(torch.linalg.vector_norm(g_all)) * scale)
            pf, mf, vf, gf = (t.reshape(-1) for t in (p, mi, vi, g_all))
            for lo in range(0, pf.numel(), chunk):
                sl = slice(lo, lo + chunk)
                g = gf[sl] * scale
                mf[sl].mul_(b1).add_(g, alpha=1 - b1)
                vf[sl].mul_(b2).add_(g * g, alpha=1 - b2)
                upd = (mf[sl] / c1) / (torch.sqrt(vf[sl] / c2) + eps) \
                    + wd * pf[sl]
                pf[sl].sub_(lr * upd)
                del g, upd
            del g_all, gf
    return norms
