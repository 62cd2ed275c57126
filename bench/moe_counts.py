"""FLOPs of a MoE decoder LM's train step from its shapes, the same
whatever implements it: the products a token takes part in (q, k, v and o,
the router, k of the E experts' gated MLPs), attention over the causal
triangle, and the unembedding of every position."""
from __future__ import annotations

from typing import Dict


def expert_flops(arch: Dict, rows: int) -> float:
    """Forward FLOPs of the gate, up and down products over ``rows``
    (token, expert) rows."""
    return 2.0 * rows * 3 * arch["d_model"] * arch["d_ff"]


def forward_flops(arch: Dict, batch: int, seq: int) -> float:
    """Forward FLOPs of ``batch`` sequences of ``seq`` tokens, every
    position unembedded."""
    L, D, V = arch["n_layers"], arch["d_model"], arch["vocab"]
    H, K, E = arch["n_heads"], arch["n_kv_heads"], arch["n_experts"]
    hd = arch.get("head_dim") or D // H
    tokens = batch * seq
    proj = 2.0 * tokens * L * (2 * D * H * hd + 2 * D * K * hd)
    # QK^T and PV over the causal triangle: key j <= query i
    attn = 4.0 * batch * L * H * hd * seq * (seq + 1) / 2
    router = 2.0 * tokens * L * D * E
    experts = L * expert_flops(arch, tokens * arch["top_k"])
    return proj + attn + router + experts + 2.0 * tokens * D * V


def train_flops(arch: Dict, batch: int, seq: int) -> float:
    """A train step's forward and backward: three times the forward.
    Recomputation under remat is not counted: it is not work the step
    needs."""
    return 3.0 * forward_flops(arch, batch, seq)
