"""Carry the reference's parameters into the port.

The port keeps the reference's parameter paths, shapes and ``(K, R)``
head split, so the map is path for path: each float32 array becomes a
float32 tensor on the port's device.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.models import registry
from repro_torch.models.common import ArchConfig, flatten, unflatten


def params_from_reference(cfg: ArchConfig, params: Dict[str, Any],
                          device=None) -> Dict[str, Any]:
    """The port's nested params from the reference's nested dict or its
    flat ``path -> array`` dict (numpy or anything ``np.asarray`` reads).

    Raises ``ValueError`` unless the paths, shapes and dtypes are those of
    the port's own ``init`` for ``cfg``.
    """
    dev = engine.resolve_device(device)
    flat = flatten(params)
    want = flatten(registry.build(cfg, device="meta").init(0)[0])
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameter paths differ from the "
                         f"port's init: missing {missing}, unexpected {extra}")
    out = {}
    for path, ref in want.items():
        a = np.asarray(flat[path])
        if a.shape != tuple(ref.shape) or a.dtype != np.float32:
            raise ValueError(f"{cfg.name}: {path} is {a.dtype}{list(a.shape)}"
                             f", the port's init has float32"
                             f"{list(ref.shape)}")
        out[path] = torch.from_numpy(np.require(a, requirements="CW")).to(dev)
    return unflatten(out)
