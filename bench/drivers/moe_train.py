"""Training a MoE decoder LM through ``launch/steps.make_train_step``, as
``drivers/train`` trains a dense one: fwd + bwd + AdamW on float32
parameters and moments, the loss read on the host each step.

Traffic keys: ``batch``, ``seq``, ``checked_steps``.  Configuration keys:
``arch`` (a ``GraniteConfig``: GraniteMoe's scalars beside the port's
fields), ``optimizer``, ``limits.train``.

Besides ``drivers/train``'s readings the check compares
``dropped_choices``: the (token, choice) pairs of the checked steps that
reached no expert row, counted on the device by the program's MoE block
(``moe.watch_drops``) and read once after the set-up's steps.

In a traced run the driver turns the program's tracer on over the window
and keeps, in ``run.notes``, the window's steps, the device time of its
``moe.*`` spans (``moe_span_ms``) and the deltas of its ``moe.*``
counters (``moe_counters``), for the metric readers.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List

import torch

from bench import moe_weights, weights
from bench.drivers import train
from bench.drivers.train import compare, leaf_norm
from bench.harness import Check, Run
from bench.reference import dense_lm, moe_lm


class Cell(train.Cell):
    def __init__(self, run: Run):
        from repro_torch.launch import steps
        from repro_torch.models import moe, registry
        from repro_torch.models.common import GraniteConfig
        from repro_torch.optim import adamw_init
        t = run.traffic
        self.arch = dict(run.config["arch"])
        self.opt = run.config["optimizer"]
        cfg = GraniteConfig(**self.arch)
        self.B, self.S = int(t["batch"]), int(t["seq"])
        self.dev, self.seed = run.device, run.seed
        self.steps_mod = steps
        self.params = moe_weights.moe_lm(self.arch, run.seed, self.dev)
        self.model = registry.build(cfg, device=self.dev)
        self.state = adamw_init(self.params)
        self.step_fn = steps.make_train_step(
            self.model, seed=0, peak_lr=self.opt["peak_lr"],
            warmup=self.opt["warmup"], total_steps=self.opt["total_steps"])
        self.step = 0
        self.steps_done = 0
        self.attempted = self.failed = 0
        self.losses: List[float] = []
        self.batches = []
        with moe.watch_drops() as drops:
            for i in range(int(t["checked_steps"])):
                toks, loss = self._train(run)
                self.batches.append(toks.cpu())
                self.losses.append(loss)
                if i == 0:
                    self.grad_norms = {
                        k: leaf_norm(m) / (1.0 - self.opt["b1"])
                        for k, m in weights.flat(
                            self.state.m).items()}
        self.dropped = int(torch.stack(drops).sum()) if drops else 0
        flat = weights.flat(self.params)
        self.change_norms = {
            k: leaf_norm(p - moe_weights.leaf(self.arch, run.seed, k,
                                              self.dev))
            for k, p in flat.items()}

    def window(self, run: Run) -> None:
        if not run.trace:
            return super().window(run)
        from repro_torch import trace
        trace.drain()
        self.counters0 = trace.counters()
        trace.enable()
        try:
            super().window(run)
        finally:
            trace.disable()

    def end_to_end(self, run: Run) -> Dict[str, float]:
        if run.trace:
            self._drain(run)
        return super().end_to_end(run)

    def _drain(self, run: Run) -> None:
        """The window's ``moe.*`` spans and counters into ``run.notes``."""
        from repro_torch import trace
        span_ms: Dict[str, float] = {}
        for s in trace.drain():
            if s.name.startswith("moe.") and s.device_ms is not None:
                span_ms[s.name] = span_ms.get(s.name, 0.0) + s.device_ms
        now = trace.counters()
        counters = {k: v - self.counters0.get(k, 0) for k, v in now.items()
                    if k.startswith("moe.")}
        run.notes.update(moe_span_ms=span_ms, moe_counters=counters,
                         moe_steps=self.steps_done)
        print(json.dumps({"moe_span_ms": span_ms, "moe_counters": counters,
                          "steps": self.steps_done}), file=sys.stderr)

    def check(self, run: Run) -> List[Check]:
        limits = dict(run.config["limits"]["train"])
        drop_limit = limits.pop("dropped_choices")
        ref = reference_readings(self.arch, self.opt, run.seed, self.batches,
                                 self.dev)
        return compare(self, ref, limits) + [
            Check("dropped_choices", self.dropped, drop_limit)]


def reference_readings(arch: Dict, opt: Dict, seed: int,
                       batches: List[torch.Tensor], device,
                       precision: str = "float32") -> Dict:
    """The reference's losses, first clipped gradient norms and change
    norms over the same batches (each step's router jitter from its own
    leaf), from weights made again from the seed; as
    ``drivers/train.reference_readings``, with each layer's tensors held
    apart."""
    dense_lm.no_tf32()
    tree = moe_weights.moe_lm(arch, seed, device)
    names, tensors = [], []
    for k, v in weights.flat(tree).items():
        if k.startswith("layers/"):
            parts = [p.clone() for p in v.unbind(0)]
            del v
            tree["layers"][k.split("/", 1)[1]] = parts
            names += [k] * len(parts)
            tensors += parts
        else:
            names.append(k)
            tensors.append(v)
    for t in tensors:
        t.requires_grad_(True)
    m = [torch.zeros_like(t) for t in tensors]
    v = [torch.zeros_like(t) for t in tensors]
    losses, grad_sq = [], {}
    for i, toks in enumerate(batches):
        toks = toks.to(device)
        loss = moe_lm.loss(arch, tree, toks[:, :-1], toks[:, 1:], step=i,
                           precision=precision)
        grads = list(torch.autograd.grad(loss, tensors))
        losses.append(float(loss.detach()))
        del loss
        norms = dense_lm.adamw_step(opt, i + 1, tensors, grads, m, v)
        del grads
        if i == 0:
            for k, n in zip(names, norms):
                grad_sq[k] = grad_sq.get(k, 0.0) + n ** 2
    del m, v
    change_sq: Dict[str, float] = {}
    with torch.no_grad():
        for k in dict.fromkeys(names):
            p0 = moe_weights.leaf(arch, seed, k, device)
            now = [t for n, t in zip(names, tensors) if n == k]
            p = torch.stack(now) if k.startswith("layers/") else now[0]
            change_sq[k] = leaf_norm(p - p0) ** 2
            del p0, p
    return {"losses": losses,
            "grad_norms": {k: s ** 0.5 for k, s in grad_sq.items()},
            "change_norms": {k: s ** 0.5 for k, s in change_sq.items()}}
