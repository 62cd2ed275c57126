"""Sharding hints of the model code, on one device.

The reference resolves logical axes to mesh ``PartitionSpec``s and pins
activations with ``with_sharding_constraint`` inside an ambient mesh.
The port runs a model on one card with no ambient mesh, so each hint
returns what the reference returns outside a mesh: the activation
unchanged, and ``False`` for the two layout decisions.

The ``PartitionSpec`` machinery (``param_pspecs``, ``cache_pspecs``,
``batch_pspec``, ``tree_shardings``) waits for the port of
``launch/dryrun`` and the training substrate's sharded step.
"""
from __future__ import annotations

from typing import Optional


def context_parallel_attention(mesh_or_none, n_kv: int, n_rep: int) -> bool:
    """True when attention must run context-parallel on a model axis that
    divides neither the kv heads nor the query repeats; never on one
    device."""
    return False


def prefer_seq_gather(cfg, batch: int, seq: int) -> bool:
    """Whether a layer gathers its sequence-sharded activations rather
    than its model-sharded weights; there is nothing to gather on one
    device."""
    return False


def gather_seq_hint(x):
    """Layout hint at the input of head- / f-sharded products: identity
    on one device."""
    return x


def activation_hint(x, *, seq_axis: Optional[int] = 1):
    """Sequence-parallel layout hint for a (B, S, ...) activation:
    identity on one device."""
    return x
