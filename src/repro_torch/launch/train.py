"""The training driver's shared pieces: smoke-scale configs and the data
pipeline of a config.

Only what ``launch.serve`` imports is ported yet (``SMOKE_OVERRIDES``,
``smoke_config``, ``pipeline_for``).  ``train`` and ``main`` come with
the training substrate (``optim``, ``checkpoint``, ``FaultTolerantLoop``,
``launch.steps.make_train_step``): ROADMAP.md queue A item 6.
"""
from __future__ import annotations

from repro_torch.data import SyntheticLMPipeline
from repro_torch.models.common import ArchConfig

SMOKE_OVERRIDES = dict(n_layers=2, d_model=128, d_ff=256, vocab=512,
                       q_chunk=64, loss_chunks=4)


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    over = dict(SMOKE_OVERRIDES)
    if cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
        over.update(n_heads=4, n_kv_heads=min(4, max(cfg.n_kv_heads, 1)),
                    head_dim=32)
    if cfg.family == "moe":
        over.update(n_experts=8, top_k=2, d_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        over.update(ssm_state=16, ssm_head_dim=16)
    if cfg.family == "hybrid":
        over.update(n_layers=4, attn_every=2)
    if cfg.family == "encdec":
        over.update(enc_layers=2, enc_ctx=64)
    return cfg.scaled(**over)


def pipeline_for(cfg: ArchConfig, global_batch: int, seq_len: int,
                 seed: int, device=None) -> SyntheticLMPipeline:
    extras = {}
    if cfg.family == "vlm":
        extras["patches"] = (cfg.vision_prefix, cfg.d_model)
    if cfg.family == "encdec":
        extras["frames"] = (cfg.enc_ctx, cfg.d_model)
    return SyntheticLMPipeline(seed, cfg.vocab, global_batch, seq_len,
                               extras=extras or None, device=device)
