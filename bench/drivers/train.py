"""Training through ``launch/steps.make_train_step``: fwd + bwd + AdamW on
float32 parameters and moments, the loss read on the host each step.

Traffic keys: ``batch``, ``seq``, ``checked_steps`` (the set-up's first
steps, which the reference follows).  Configuration keys: ``arch``,
``optimizer`` (the schedule ``make_train_step`` is given and the AdamW
constants the program uses), ``limits.train``.

Set-up builds one train step, with its model and optimizer state, and
drives it through its first ``checked_steps`` steps on batches of the
benchmark's generator; the window goes on with the same objects on fresh
batches.  From those first steps the driver keeps what can be compared:
each step's loss, each leaf's first gradient as the optimizer got it (its
first moment after one step over 1 - b1) and each leaf's change after the
last checked step.  ``readings`` turns them into numbers; those that the
configuration's ``limits.train`` names are compared.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

from bench import weights
from bench.harness import Check, Run
from bench.reference import dense_lm


def leaf_norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double() if t.device.type ==
                                          "cpu" else t, dtype=torch.float64))


class Cell:
    def __init__(self, run: Run):
        from repro_torch.launch import steps
        from repro_torch.models import registry
        from repro_torch.models.common import ArchConfig
        from repro_torch.optim import adamw_init
        t = run.traffic
        self.arch = dict(run.config["arch"])
        self.opt = run.config["optimizer"]
        cfg = ArchConfig(**self.arch)
        self.B, self.S = int(t["batch"]), int(t["seq"])
        self.dev, self.seed = run.device, run.seed
        self.steps_mod = steps
        self.params = weights.dense_lm(self.arch, run.seed, self.dev)
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
        for i in range(int(t["checked_steps"])):
            toks, loss = self._train(run)
            self.batches.append(toks.cpu())
            self.losses.append(loss)
            if i == 0:
                self.grad_norms = {
                    k: leaf_norm(m) / (1.0 - self.opt["b1"])
                    for k, m in weights.flat(self.state.m).items()}
        flat = weights.flat(self.params)
        self.change_norms = {
            k: leaf_norm(p - weights.leaf(self.arch, run.seed, k, self.dev))
            for k, p in flat.items()}

    def _train(self, run: Run) -> Tuple[torch.Tensor, float]:
        """One step on the next batch: the batch's tokens and the loss,
        read on the host as a trainer logs it."""
        toks = weights.tokens(self.seed, f"batch/{self.step}",
                              (self.B, self.S + 1), self.arch["vocab"],
                              self.dev)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        self.params, self.state, metrics = self.step_fn(
            self.params, self.state, batch, self.step)
        self.step += 1
        return toks, float(metrics["loss"])

    def window(self, run: Run) -> None:
        watch = (_UpdateWatch(self.steps_mod, run)
                 if run.trace and run.device.type == "cuda" else None)
        try:
            while run.elapsed() < run.seconds:
                self.attempted += 1
                with run.span("train_step"):
                    self._train(run)
                self.steps_done += 1
        finally:
            if watch is not None:
                watch.close()

    def end_to_end(self, run: Run) -> Dict[str, float]:
        run.counters["train_steps"] = self.steps_done
        return {"train_tok_per_s": self.steps_done * self.B * self.S
                / run.window_s}

    def release(self) -> None:
        del self.params, self.state, self.model, self.step_fn
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, run: Run) -> List[Check]:
        limits = run.config["limits"]["train"]
        ref = reference_readings(self.arch, self.opt, run.seed, self.batches,
                                 self.dev)
        return compare(self, ref, limits)


class _UpdateWatch:
    """CUDA events around each ``adamw_update`` the step calls."""

    def __init__(self, steps_mod, run: Run):
        self.steps_mod, self.real = steps_mod, steps_mod.adamw_update
        self.events = run.notes.setdefault("update_events", [])

        def watched(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.real(*a, **kw)
            e.record()
            self.events.append((s, e))
            return out
        steps_mod.adamw_update = watched

    def close(self) -> None:
        self.steps_mod.adamw_update = self.real


def reference_readings(arch: Dict, opt: Dict, seed: int,
                       batches: List[torch.Tensor], device,
                       precision: str = "float32") -> Dict:
    """The reference's losses, first clipped gradient norms and change
    norms over the same batches, from weights made again from the seed.
    Layers are held as separate tensors, so a layer's gradient is its
    own; the moments live beside the weights."""
    dense_lm.no_tf32()
    tree = weights.dense_lm(arch, seed, device)
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
        loss = dense_lm.loss(arch, tree, toks[:, :-1], toks[:, 1:],
                             precision)
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
            p0 = weights.leaf(arch, seed, k, device)
            now = [t for n, t in zip(names, tensors) if n == k]
            p = torch.stack(now) if k.startswith("layers/") else now[0]
            change_sq[k] = leaf_norm(p - p0) ** 2
            del p0, p
    return {"losses": losses,
            "grad_norms": {k: s ** 0.5 for k, s in grad_sq.items()},
            "change_norms": {k: s ** 0.5 for k, s in change_sq.items()}}


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> List[float]:
    """Each kept leaf's gap between the program's and the reference's
    norms, over the larger of that leaf's reference norm and the median
    leaf's."""
    med = statistics.median(ref[k] for k in keep)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep]


def readings(cell, ref: Dict) -> Dict[str, float]:
    """Every number the train cell can compare: the loss gap of the first
    step and the worst of the checked steps; the worst and the median
    leaf's gap of the first gradient's norm and of the change's norm."""
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    # leaves whose gradient is nought to rounding move under Adam by
    # round-off alone: left out by the reference's gradient, not by name
    keep = [k for k in g if g[k] >= 1e-3 * med]
    loss = [abs(a - b) / abs(b) for a, b in zip(cell.losses, ref["losses"])]
    grad = norm_gaps(cell.grad_norms, g, keep)
    change = norm_gaps(cell.change_norms, ref["change_norms"], keep)
    return {"loss1_gap": loss[0], "loss_gap": max(loss),
            "grad_gap": max(grad), "grad_median_gap": statistics.median(grad),
            "change_gap": max(change),
            "change_median_gap": statistics.median(change)}


def compare(cell: "Cell", ref: Dict, limits: Dict) -> List[Check]:
    got = readings(cell, ref)
    return [Check(k, got[k], limit) for k, limit in limits.items()]
