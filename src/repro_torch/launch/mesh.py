"""Production mesh construction over ``engine.Mesh``.

A mesh of the port is an array of devices with axis names, in one
process (``core/engine.py``).  A device may repeat, so the production
grids (16 x 16, and 2 x 16 x 16 with a pod axis) are built on one device:
the card by default, ``meta`` for shapes alone, ``cpu`` in tests.  The
dry run resolves partition specs on such a mesh and ``generate_sharded``
hands each of its entries one column slice.
"""
from __future__ import annotations

import math
from typing import List

import torch

from repro_torch.core import engine


def _visible(device) -> List[torch.device]:
    """The visible devices of ``device``'s type: every card for ``cuda``
    without an index (the default), else that one device."""
    dev = engine.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh_auto(shape, axes, device=None) -> engine.Mesh:
    """A mesh of ``shape`` over the visible devices of ``device``'s type
    (the cards by default), one device per entry."""
    devs = _visible(device)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != len(devs):
        raise ValueError(f"make_mesh_auto: shape {shape} needs "
                         f"{math.prod(shape)} devices, {len(devs)} visible")
    return engine.Mesh.of(devs, shape, axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> engine.Mesh:
    """(16, 16) data x model single pod, or (2, 16, 16) pod x data x
    model, every entry the one ``device`` (the card by default)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = engine.resolve_device(device)
    return engine.Mesh.of([dev] * math.prod(shape), shape, axes)


def make_host_mesh(model: int = 1, device=None) -> engine.Mesh:
    """Tiny (data, model) mesh over the visible devices (tests /
    examples)."""
    n = len(_visible(device))
    if model < 1 or n % model:
        raise ValueError(
            f"make_host_mesh(model={model}): {n} local device(s) cannot "
            f"split into (data={n}/{model}, model={model}); pick a model "
            f"axis that divides the device count")
    return make_mesh_auto((n // model, model), ("data", "model"), device)


def rng_axes(mesh) -> tuple:
    """Mesh axes for the RNG block fan-out: ALL of them.

    ``engine.generate_sharded(..., axis_names=rng_axes(mesh))`` splits
    the stream axis over every entry of a production mesh.  Each shard is
    one ``generate`` of its columns from the shared root, so the fan-out
    has no collective whatever the model does with the axes.
    """
    return tuple(mesh.axis_names)
