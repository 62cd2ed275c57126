"""Deterministic mixed-traffic burst driver for RandService.

One shared implementation of "fire a burst of mixed (shape, sampler,
dtype) requests from many tenants and account for every byte", used by
``python -m repro_torch.service``, ``chip_smoke.py`` and the tests.

The request list is a pure function of ``(seed, burst, tenants,
pattern)`` and equals the JAX reference's (``repro.service.burst``), so
a burst reproduced in another process, or by the other package, needs
no coordination beyond the same four values.
"""
from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.service.frontend import RandRequest

#: the mixed request classes a burst cycles through - the full sampler
#: grammar including the distribution stages, so every burst exercises
#: shaped-request journal replay
BURST_CLASSES: Tuple[Tuple[str, str], ...] = (
    ("bits", "float32"),
    ("uniform", "float32"),
    ("uniform", "bfloat16"),
    ("normal", "float32"),
    ("bernoulli(0.25)", "float32"),
    ("exponential(1.5)", "float32"),
    ("poisson(3.5)", "bfloat16"),
    ("gamma(2.5)", "float32"),
    ("categorical[0.5,0.25,0.125,0.125]", "float32"),
)


#: adversarial traffic shapes (see ``make_requests(pattern=...)``)
BURST_PATTERNS: Tuple[str, ...] = ("mixed", "hammer", "unique")


def make_requests(*, burst: int, tenants: int, seed: int,
                  max_side: int = 64,
                  rid_prefix: str = "burst",
                  pattern: str = "mixed") -> List[RandRequest]:
    """``burst`` rid-stamped requests over ``tenants`` distinct tenant
    ids with mixed shapes (1-D and 2-D), samplers and dtypes.

    ``rid_prefix`` keeps rids unique across bursts sharing one journal
    (journaled rids may never repeat).

    ``pattern`` selects the traffic shape:
      * ``"mixed"`` - the default spread over tenants/classes/shapes,
      * ``"hammer"`` - every request from ONE tenant (one shard absorbs
        the whole burst),
      * ``"unique"`` - every request a distinct (shape, class): zero
        coalescing opportunity, every request its own quantised window.

    Example:
        >>> from repro_torch.service.burst import make_requests
        >>> reqs = make_requests(burst=3, tenants=2, seed=0)
        >>> [(r.tenant_id, r.sampler) for r in reqs]
        [('tenant/00000', 'bits'), ('tenant/00001', 'uniform'), ('tenant/00000', 'uniform')]
    """
    if pattern not in BURST_PATTERNS:
        raise ValueError(f"unknown pattern {pattern!r}; "
                         f"have {BURST_PATTERNS}")
    rng = random.Random(seed ^ 0x5EED5)
    reqs: List[RandRequest] = []
    for i in range(burst):
        sampler, dtype = BURST_CLASSES[i % len(BURST_CLASSES)]
        if pattern == "unique":
            # distinct sizes -> distinct quantised rows per request
            shape: Tuple[int, ...] = (max(1, i) * 7 + rng.randint(0, 6),)
        elif rng.random() < 0.5:
            shape = (rng.randint(1, max_side * max_side),)
        else:
            shape = (rng.randint(1, max_side), rng.randint(1, max_side))
        tenant = ("tenant/00000" if pattern == "hammer"
                  else f"tenant/{i % tenants:05d}")
        reqs.append(RandRequest(
            tenant_id=tenant, shape=shape,
            sampler=sampler, out_dtype=dtype, rid=f"{rid_prefix}/{i:06d}"))
    return reqs


def run_burst(server, requests: List[RandRequest], *,
              submit_threads: int = 0,
              timeout: Optional[float] = 120.0) -> Dict[str, Any]:
    """Submit ``requests`` and gather every response by rid.

    ``submit_threads=0`` submits in order from the calling thread
    (deterministic batching when the server was built with
    ``start=False``); ``submit_threads>0`` fans submission over a thread
    pool, which a bounded queue meets with backpressure.
    """
    if submit_threads > 0:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=submit_threads) as ex:
            futs = list(ex.map(server.submit, requests))
    else:
        futs = [server.submit(r) for r in requests]
    return {r.rid: f.result(timeout=timeout)
            for r, f in zip(requests, futs)}
