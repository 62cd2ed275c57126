"""Work counts from the algorithms' shapes, the same whatever implements
them: the bytes a kernel must move and the FLOPs of a model step."""
from __future__ import annotations

from typing import Dict


def kernel_a_bytes(samples: int) -> int:
    """Kernel A writes each u32 sample once and reads nothing of size."""
    return 4 * samples


def kernel_f_bytes(batch: int, vocab: int) -> int:
    """Kernel F reads the (batch, vocab) float32 logits once and writes
    one int32 token a row; its noise never reaches memory."""
    return 4 * batch * vocab + 4 * batch


def dense_matmul_params(arch: Dict) -> int:
    """Parameters that take part in a token's matrix products in one
    decoder layer (q, k, v, o and the gated MLP)."""
    D, H, K = arch["d_model"], arch["n_heads"], arch["n_kv_heads"]
    hd = arch.get("head_dim") or D // H
    mlp = (3 if arch.get("act", "silu") in ("silu", "geglu") else 2)
    return D * H * hd * 2 + D * K * hd * 2 + mlp * D * arch["d_ff"]


def prefill_flops(arch: Dict, batch: int, seq: int,
                  logits_rows: int = 1) -> float:
    """Forward FLOPs of a causal prefill of ``seq`` tokens, with the
    unembedding of ``logits_rows`` positions a sequence."""
    L, D, V = arch["n_layers"], arch["d_model"], arch["vocab"]
    H = arch["n_heads"]
    hd = arch.get("head_dim") or D // H
    tokens = batch * seq
    dense = 2.0 * tokens * L * dense_matmul_params(arch)
    # QK^T and PV over the causal triangle: key j <= query i
    attn = 4.0 * batch * L * H * hd * seq * (seq + 1) / 2
    return dense + attn + 2.0 * batch * logits_rows * D * V


def decode_flops(arch: Dict, batch: int, context: int) -> float:
    """Forward FLOPs of one decode step whose token attends to
    ``context`` positions (itself included)."""
    L, D, V = arch["n_layers"], arch["d_model"], arch["vocab"]
    H = arch["n_heads"]
    hd = arch.get("head_dim") or D // H
    return (2.0 * batch * L * dense_matmul_params(arch)
            + 4.0 * batch * L * H * hd * context + 2.0 * batch * D * V)


def train_flops(arch: Dict, batch: int, seq: int) -> float:
    """FLOPs of one training step's forward and backward: three times the
    forward over every position, the unembedding of every position
    included.  Recomputation under remat is not counted: it is not work
    the step needs."""
    return 3.0 * prefill_flops(arch, batch, seq, logits_rows=seq)
