"""Request-class channels and assignments: the journal-able provenance of
served randomness.

A served request is a pure function of its *assignment*: the channel of
its request class (one ``GenPlan`` family of the service seed), the
counter window ``[lo, lo + rows)`` leased on that channel, and the leaf
tags of the columns it was given.  ``service.audit`` journals assignments
and regenerates any response from one alone; ``slice_response`` is how a
response is read out of a generated ``(rows, len(tags))`` block.

Only this part of the reference's ``repro.service.frontend`` is ported
so far: ``class_channel``, ``Assignment`` and ``slice_response``, which
the journal and the inference tier need.  The request coalescer
(``RandRequest``, ``request_rows``, ``Coalescer``) stays in ROADMAP
queue A item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def class_channel(sampler: str, out_dtype: str) -> str:
    """Ledger/family channel name for one (sampler, dtype) request class.

    Distinct classes get distinct channels, hence distinct ``GenPlan``
    families (disjoint h-spaces of the same root seed) and independent
    counter ledgers - a uniform/float32 window can never alias a
    bits/uint32 window.
    """
    return f"service/class/{sampler}/{out_dtype}"


@dataclasses.dataclass(frozen=True)
class Assignment:
    """Where one request's samples live: the journal-able provenance.

    ``audit.replay`` needs nothing else: the plan is ``(seed,
    channel->purpose, tags, [lo, lo+rows), sampler, out_dtype)`` and the
    response is the column-major flatten of the generated
    ``(rows, len(tags))`` block truncated to ``n``.
    """
    rid: str
    tenant_id: str
    sampler: str
    out_dtype: str
    shape: Tuple[int, ...]
    channel: str
    lo: int                 # counter-window start (lease.lo)
    rows: int               # counter-window length (the batch's T)
    tags: Tuple[int, ...]   # absolute leaf tags of the assigned columns
    deco: str = "splitmix64"

    @property
    def num_samples(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n


def slice_response(block, col0: int, ncols: int, assignment_n: int,
                   shape: Tuple[int, ...]):
    """Column-major slice: columns ``[col0, col0+ncols)`` read
    top-to-bottom, first ``n`` samples, reshaped.  ``block`` is a numpy
    array or a torch tensor; the result is of the same kind."""
    cols = block[:, col0:col0 + ncols].T
    if isinstance(cols, torch.Tensor):
        flat = cols.contiguous().reshape(-1)
    else:
        flat = np.ascontiguousarray(cols).reshape(-1)
    return flat[:assignment_n].reshape(shape)
