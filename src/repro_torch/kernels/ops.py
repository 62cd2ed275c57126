"""Public entry points over the engine and the fused kernels.

  * ``thundering_bulk``  (T, S) bulk MISRN block, mode "ctr"/"faithful"
  * ``fused_dropout``    dropout with the mask generated inline (kernel C)
  * ``estimate_pi``      fused Monte-Carlo pi (paper Sec. 6, app 1; kernel D)
  * ``price_option``     fused Black-Scholes MC (paper Sec. 6, app 2;
                         kernel E)

Each runs on ``cuda`` unless the caller passes ``device="cpu"`` (or, for
``fused_dropout``, a CPU tensor); without a card and without a device they
raise.  ``use_kernel=False`` takes the plain torch path of the reference's
``use_kernel=False``: the engine's ``"torch"`` oracle and the tensor
integrands of ``kernels.ref``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import trace
from repro_torch.core import engine, stream as stream_mod
from repro_torch.core.u64 import U64Pair
from repro_torch.kernels import fused_dropout as _fd
from repro_torch.kernels import mc as _mc
from repro_torch.kernels import ref


def h_table(seed: int, num_streams: int, purpose: int = 0,
            device=None) -> U64Pair:
    """(S,) even leaf offsets h_s, derived as ``stream.derive`` derives
    them (``engine.derive_leaf``), so bulk blocks and the stream API live
    in one MISRN family."""
    _, h_fam = engine.family_from_seed(seed, purpose)
    return engine.leaf_table(h_fam, num_streams, engine.resolve_device(device))


def thundering_bulk(*, seed: int, num_streams: int, num_steps: int,
                    mode: str = "ctr", offset: int = 0,
                    block_t: int = engine.DEFAULT_BLOCK_T,
                    use_kernel: bool = True, deco: str = "splitmix64",
                    backend: Optional[str] = None, sampler: str = "bits",
                    out_dtype: str = "float32", device=None) -> torch.Tensor:
    """(num_steps, num_streams) MISRN block (time-major).

    ``sampler``/``out_dtype`` select the fused output stage.  ``backend``
    names an engine backend; otherwise ``use_kernel`` picks
    ``engine.select_backend(plan)`` (True) or the ``"torch"`` oracle.
    """
    plan = engine.make_plan(seed=seed, num_streams=num_streams,
                            num_steps=num_steps, offset=offset, mode=mode,
                            deco=deco, sampler=sampler, out_dtype=out_dtype,
                            device=device)
    be = backend or (engine.select_backend(plan) if use_kernel else "torch")
    return engine.generate(plan, backend=be, block_t=block_t)


def fused_dropout(x: torch.Tensor, stream, rate: float, *, block_m: int = 8,
                  use_kernel: bool = True) -> torch.Tensor:
    """Dropout over any-shape x, the mask addressed by (stream, flat index).

    The same (stream, counter) always gives the same mask, whatever the
    tiling.  ``stream`` may also be a ``BlockService`` lease
    (``runtime.blocks``): the mask is then addressed by the lease's
    channel stream at its window start, and the window must cover
    ``fused_dropout.mask_elems(x.shape)`` elements.  The mask is computed
    on x's device.
    """
    if not isinstance(stream, stream_mod.ThunderStream):
        lease = stream
        if lease.length < _fd.mask_elems(x.shape):
            raise ValueError(
                f"lease window [{lease.lo}, {lease.hi}) is smaller than the "
                f"{_fd.mask_elems(x.shape)}-element mask for shape "
                f"{tuple(x.shape)}")
        stream = lease.stream()
    if rate <= 0.0:
        return x
    shape = x.shape
    last = shape[-1] if len(shape) >= 1 else 1
    x2 = x.reshape(x.numel() // last, last)
    if not use_kernel:
        # keep mask = the engine's bernoulli stage at p = 1 - rate: the same
        # exact host-int threshold as the kernel's keep_threshold.
        plan = engine.plan_for_stream(
            dataclasses.replace(stream, device=x.device), x.numel(),
            sampler=f"bernoulli({1.0 - rate!r})")
        keep = engine.generate_flat(plan).reshape(x2.shape)
        scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype,
                             device=x.device)
        return torch.where(keep, x2 * scale,
                           torch.zeros_like(x2)).reshape(shape)
    return _fd.fused_dropout_2d(x2, stream.h, stream.x0, stream.ctr, rate,
                                block_m=block_m).reshape(shape)


def _per_draw(total: torch.Tensor, draws: int) -> torch.Tensor:
    """``total / draws`` in float32, correctly rounded as in the reference.
    The divisor is a tensor: torch divides a CUDA tensor by a python
    scalar as a multiply by its reciprocal, which can differ in the last
    bit."""
    return total / torch.full((), draws, dtype=torch.float32,
                              device=total.device)


def _mc_plans(seed: int, num_lanes: int, draws_per_lane: int,
              purpose_x: int, purpose_y: int, offset: int, device):
    """Two engine plans (x/y coordinate families, shared root) over the
    draw window [offset, offset + draws_per_lane): the window a
    ``BlockService`` lease hands out, so repeated calls never re-spend
    randomness."""
    with trace.span("ops.mc_plans"):
        return tuple(engine.make_plan(seed=seed, num_streams=num_lanes,
                                      num_steps=draws_per_lane, purpose=p,
                                      offset=offset, device=device)
                     for p in (purpose_x, purpose_y))


def estimate_pi(*, seed: int, num_lanes: int, draws_per_lane: int,
                offset: int = 0, block_t: int = _mc.DEFAULT_BLOCK_T,
                block_s: int = _mc.DEFAULT_BLOCK_S, use_kernel: bool = True,
                device=None) -> torch.Tensor:
    """Monte-Carlo pi over num_lanes independent stream pairs (paper
    Fig. 8): 4 * hits / draws, a 0-d float32 tensor.

    The hits are the float32 sum of the int32 partials, as in the
    reference: above 2^24 hits it is no longer exact and depends on the
    order of the sum.
    """
    px, py = _mc_plans(seed, num_lanes, draws_per_lane, 1, 2, offset, device)
    if use_kernel:
        partials = _mc.pi_partials_from_plans(px, py, block_t=block_t,
                                              block_s=block_s)
    else:
        partials = ref.mc_pi_from_uniforms(
            engine.sample(px, sampler="uniform", backend="torch"),
            engine.sample(py, sampler="uniform", backend="torch"))
    inside = partials.to(torch.float32).sum()
    return _per_draw(4.0 * inside, num_lanes * draws_per_lane)


def price_option(*, seed: int, num_lanes: int, draws_per_lane: int,
                 offset: int = 0, s0: float = 100.0, strike: float = 100.0,
                 r: float = 0.05, sigma: float = 0.2, t: float = 1.0,
                 block_t: int = _mc.DEFAULT_BLOCK_T,
                 block_s: int = _mc.DEFAULT_BLOCK_S, use_kernel: bool = True,
                 device=None) -> torch.Tensor:
    """European call price via GBM Monte-Carlo (paper Fig. 9 / Table 7):
    the mean discounted payoff, a 0-d float32 tensor."""
    px, py = _mc_plans(seed, num_lanes, draws_per_lane, 3, 4, offset, device)
    if use_kernel:
        partials = _mc.option_partials_from_plans(
            px, py, s0=s0, strike=strike, r=r, sigma=sigma, t=t,
            block_t=block_t, block_s=block_s)
    else:
        partials = ref.mc_option_from_uniforms(
            engine.sample(px, sampler="uniform", backend="torch"),
            engine.sample(py, sampler="uniform", backend="torch"),
            s0, strike, r, sigma, t)
    return _per_draw(partials.sum(), num_lanes * draws_per_lane)
