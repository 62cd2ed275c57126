"""Step functions: train (fwd + bwd + AdamW) and serve (prefill / decode).

  * train_step: fwd + bwd (``torch.autograd``) + AdamW update in place,
    with the per-step ThundeRiNG substream ``rng = derive(root, step)``
    (deterministic, device-independent).
  * prefill_step / decode_step: the serving path.

The sharding plumbing of the reference (``param_sharding_tree``,
``batch_sharding``, ``opt_sharding_like``) belongs to the dry run
(ROADMAP.md queue A item 8).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import stream as tstream
from repro_torch.models import registry
from repro_torch.models.common import flatten, unflatten
from repro_torch.optim import adamw_update, cosine_schedule

F32 = torch.float32


def value_and_grad(model: registry.Model, params, batch,
                   rng: Optional[tstream.ThunderStream] = None, *,
                   param_dtype: Optional[str] = None
                   ) -> Tuple[Tuple[torch.Tensor, Dict[str, Any]], Any]:
    """((loss, metrics), float32 grads like params) of ``model.loss``.

    ``param_dtype="bf16"``: the fwd/bwd runs against a bf16 cast of the
    fp32 masters, made once per call, and the grads come back in fp32.
    The graph is freed before this returns; the params are not touched.
    """
    flat = flatten(params)
    leaves = {}
    for k, p in flat.items():
        x = p.detach()
        if param_dtype == "bf16" and x.dtype == F32:
            x = x.to(torch.bfloat16)
        leaves[k] = x.requires_grad_()
    with torch.enable_grad():
        loss, metrics = model.loss(unflatten(leaves), batch, rng)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    out = {k: g.to(F32) for k, g in zip(leaves, grads)}
    del grads, leaves
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            unflatten(out))


def make_train_step(model: registry.Model, *, seed: int = 0,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000,
                    compress: Optional[str] = None,
                    microbatches: int = 1,
                    param_dtype: Optional[str] = None):
    """fwd + bwd + AdamW on ``model.device``.  ``train_step(params,
    opt_state, batch, step)`` -> (params, opt_state, metrics), the params
    and moments updated in place.

    ``microbatches`` > 1 = gradient accumulation: the global batch is
    processed in M sequential slices, so live activation memory scales
    with B/M while the loss and update are those of the mean gradient.
    ``param_dtype="bf16"``: see ``value_and_grad``."""
    lr = cosine_schedule(peak_lr, warmup, total_steps)
    root = tstream.new_stream(seed, 0xD07, device=model.device)

    def train_step(params, opt_state, batch, step: int):
        rng = tstream.derive(root, int(step) & 0xFFFFFFFF)
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(
                model, params, batch, rng, param_dtype=param_dtype)
        else:
            M = microbatches
            slices = [{k: x.reshape(M, x.shape[0] // M, *x.shape[1:])[i]
                       for k, x in batch.items()} for i in range(M)]
            flat = None
            losses, ms = [], []
            for mb in slices:
                (l, m), g = value_and_grad(model, params, mb, rng,
                                           param_dtype=param_dtype)
                g = flatten(g)
                if flat is None:
                    flat = {k: torch.zeros_like(v) for k, v in g.items()}
                for k, v in g.items():
                    flat[k].add_(v)
                del g
                losses.append(l)
                ms.append(m)
            # a 0-dim tensor on the grads' device: CUDA divides by a
            # host scalar through its reciprocal
            m_t = torch.full((), M, dtype=F32, device=model.device)
            grads = unflatten({k: v.div_(m_t) for k, v in flat.items()})
            del flat
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                       for k in ms[0]}
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr,
                                         compress=compress)
        metrics = dict(metrics, loss=loss, step=int(step) + 1)
        return params, opt_state, metrics

    return train_step


def make_serve_fns(model: registry.Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    def decode_step(params, cache, token, pos):
        return model.decode(params, cache, token, pos)

    return prefill_step, decode_step
