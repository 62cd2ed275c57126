"""AdamW with global-norm clipping and an optional gradient-compression
hook, updating the parameters and moments in place.

Optimizer state is a tree of the same structure as the params (m, v per
leaf; trees are nested dicts of tensors).  ``compress="bf16"`` rounds
gradients to bf16 before the update; the fp32 master params keep the
update numerically stable.

The reference builds every new leaf before it returns.  Eager torch
would then hold two copies of (params, m, v) at once, so the port updates
leaf by leaf, in place, with the reference's operations in its order,
each rounded on its own (no ``addcmul_``, ``lerp`` or fused optimizer,
which round differently).  So it equals the reference run op by op bit
for bit; under ``jit`` XLA:CPU contracts ``b1*m + (1-b1)*g`` and others
into FMAs, a few ULP away.  Each gradient is released once its leaf is
updated.

The step count and the scalars derived from it (learning rate, bias
corrections) are float32 values on the host, the same on every device.
A division by one of them runs against a 0-dim tensor on the leaf's
device: a CUDA tensor divided by a host scalar multiplies by its
reciprocal, which rounds differently.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, NamedTuple, \
    Optional, Tuple, Union

import torch

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor         # () int32, on the host
    m: Any                     # tree like params
    v: Any                     # tree like params


def _slots(tree: Dict[str, Any]) -> Iterator[Tuple[Dict[str, Any], str]]:
    """(dict, key) of every leaf, keys sorted at each level: the
    reference's ``jax.tree`` leaf order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _slots(tree[k])
        else:
            yield tree, k


def tree_leaves(tree: Dict[str, Any]) -> List[torch.Tensor]:
    return [d[k] for d, k in _slots(tree)]


def _map(fn: Callable, tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _sqrt_(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, in place.  The card's is;
    torch's float32 ``sqrt`` on the CPU is 1 ULP off in ~0.6 % of values
    (XLA:CPU's is exact), so the CPU takes it in float64 and rounds once,
    which is exact for a square root."""
    if t.device.type == "cpu":
        return t.copy_(torch.sqrt(t.to(torch.float64)))
    return t.sqrt_()


def adamw_init(params) -> AdamWState:
    return AdamWState(torch.zeros((), dtype=torch.int32),
                      _map(torch.zeros_like, params),
                      _map(torch.zeros_like, params))


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree)]
    return _sqrt_(torch.sum(torch.stack(leaves)))


def adamw_update(grads, state: AdamWState, params, *,
                 lr: Union[float, Callable[[torch.Tensor], torch.Tensor]],
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 compress: Optional[str] = None) -> Tuple[Any, AdamWState]:
    """One AdamW step.  ``params``, ``state.m`` and ``state.v`` are
    updated in place and returned; ``grads`` is consumed: each of its
    leaves is set to ``None`` once that leaf's update is done, so the
    gradient is freed unless the caller holds it elsewhere."""
    if compress == "bf16":
        for d, k in _slots(grads):
            d[k] = d[k].to(torch.bfloat16).to(F32)
    gnorm = global_norm(grads)
    scale = torch.clamp(torch.full_like(gnorm, clip_norm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    t = step.to(F32)
    lr_t = lr(step) if callable(lr) else torch.tensor(lr, dtype=F32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32), t)
    corr = {}
    for (gd, k), m, v, p in zip(list(_slots(grads)), tree_leaves(state.m),
                                tree_leaves(state.v), tree_leaves(params)):
        dev = p.device
        if dev not in corr:
            corr[dev] = (c1.to(dev), c2.to(dev))
        c1_d, c2_d = corr[dev]
        g = gd[k].to(F32) * scale
        gd[k] = None
        tmp = g * (1 - b1)
        m.mul_(b1).add_(tmp)                       # b1*m + (1-b1)*g
        torch.mul(g, 1 - b2, out=tmp)
        v.mul_(b2).add_(tmp.mul_(g))               # b2*v + (1-b2)*g*g
        del g
        torch.div(v, c2_d, out=tmp)
        denom = _sqrt_(tmp).add_(eps)              # sqrt(v/c2) + eps
        delta = torch.div(m, c1_d).div_(denom)     # (m/c1) / denom
        p32 = p if p.dtype == F32 else p.to(F32)
        delta.add_(torch.mul(p32, weight_decay, out=tmp))
        p32.sub_(delta.mul_(lr_t))                 # p - lr*delta
        if p32 is not p:
            p.copy_(p32)
        del tmp, denom, delta, p32
    return params, AdamWState(step, state.m, state.v)
