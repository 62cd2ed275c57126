"""End-to-end training entry point.

Integrates: ThunderStream-initialized model, deterministic ThundeRiNG
data pipeline fed through the BlockService delivery layer (leased step
windows, double-buffered batch dispatch, ledger checkpointed with the
model), AdamW in place, fault-tolerant loop with async checkpoints.  The
model trains on the card unless ``device`` / ``--device`` names another.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch glm4_9b --smoke --steps 4
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import engine
from repro_torch.data import LeasedBatchFeeder, SyntheticLMPipeline
from repro_torch.launch import steps as steps_mod
from repro_torch.models import registry
from repro_torch.models.common import ArchConfig
from repro_torch.optim import adamw_init
from repro_torch.runtime import BlockService, FaultTolerantLoop

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


def train(cfg: ArchConfig, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: str, seed: int = 0, save_every: int = 50,
          fail_at=None, log_every: int = 10, compress=None,
          use_service: bool = True, device=None):
    """Train ``steps`` steps; returns (params, opt_state, logged losses).

    ``use_service=True`` (default) feeds batches through the
    ``BlockService`` delivery layer: one leased step window per batch,
    batch ``s+1`` dispatched by a producer thread while step ``s``
    computes, and the lease ledger saved/restored with every checkpoint
    (exact mid-epoch resume, double-spend structurally rejected).
    ``use_service=False`` calls ``batch_at(step)`` before each step: the
    batch bits and losses are bit-identical either way (the batch is the
    same pure function of (seed, step)).
    """
    dev = engine.resolve_device(device)
    model = registry.build(cfg, dev)
    pipe = pipeline_for(cfg, global_batch, seq_len, seed, device=dev)
    train_step = steps_mod.make_train_step(model, seed=seed,
                                           total_steps=max(steps, 2),
                                           compress=compress)

    mgr = CheckpointManager(ckpt_dir, async_save=True)
    loop = FaultTolerantLoop(mgr, save_every=save_every, device=dev)

    feeder = None
    extra_state = on_restore = None
    if use_service:
        service = BlockService(seed, device=dev)
        feeder = LeasedBatchFeeder(pipe, service)

        def step_fn(p, o, s):
            return train_step(p, o, feeder.batch_for(s), s)

        def extra_state():
            return {"rng_ledger": service.ledger_state()}

        def on_restore(extra, start):
            feeder.reset()
            service.restore_ledger((extra or {}).get("rng_ledger"))
    else:
        def step_fn(p, o, s):
            return train_step(p, o, pipe.batch_at(s), s)

    def init_state():
        params, _ = model.init(seed)
        return params, adamw_init(params)

    losses = []

    def on_metrics(step, metrics):
        if step % log_every == 0 or step < 3:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            print(f"step {step:5d} loss {loss:.4f}", flush=True)

    t0 = time.time()
    try:
        params, opt_state = loop.run(
            init_state=init_state, step_fn=step_fn,
            num_steps=steps, fail_at=fail_at, on_metrics=on_metrics,
            extra_state=extra_state, on_restore=on_restore)
    finally:
        if feeder is not None:
            feeder.reset()
    dt = time.time() - t0
    tokens = steps * global_batch * seq_len
    print(f"done: {steps} steps, {tokens} tokens, {dt:.1f}s "
          f"({tokens / dt:.0f} tok/s)", flush=True)
    return params, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4_9b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced dims for CPU execution")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--compress", default=None, choices=[None, "bf16"])
    ap.add_argument("--no-service", action="store_true",
                    help="call batch_at(step) before each step instead of "
                         "the BlockService delivery layer")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain torch path)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    train(cfg, steps=args.steps, global_batch=args.global_batch,
          seq_len=args.seq_len, ckpt_dir=args.ckpt_dir, seed=args.seed,
          save_every=args.save_every, compress=args.compress,
          use_service=not args.no_service, device=args.device)


if __name__ == "__main__":
    main()
