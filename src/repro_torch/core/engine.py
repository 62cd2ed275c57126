"""Unified RNG engine: one backend-dispatched generation substrate.

A ``GenPlan`` describes WHAT to generate - (x0, h table, counter window,
(T, S) shape, decorrelator mode, sampler stage) - and a backend decides
HOW:

  * ``"torch"``  the plain oracles of ``repro_torch.kernels.ref`` plus the
                 sampler stage as tensor code (the reference's ref / xla),
  * ``"cuda"``   the hand-written kernels of
                 ``repro_torch.kernels.thundering_block``.

``select_backend`` picks ``"cuda"`` for every plan whose tensors lie on a
CUDA device, whatever its shape (the stream API's S = 1 included), and
``"torch"`` for CPU plans.  The two agree bit for bit on the integer and
threshold stages.

In eager PyTorch the counter is always a python int, so a plan carries
``x0`` and ``ctr`` as ints and only the (S,) leaf table as tensors (u32
limbs in int64 tensors, on the plan's device).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; without a card and
without a device they raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import lcg, sampler as sampler_mod, splitmix, u64, \
    xorshift
from repro_torch.core.u64 import M64, U64Pair

DEFAULT_BLOCK_T = 256


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: ``cuda`` by default, and never a
    silent CPU run when no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain torch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# ---------------------------------------------------------------------------
# Family / leaf-offset derivation
# ---------------------------------------------------------------------------

def family_from_seed(seed: int, purpose: int = 0) -> Tuple[int, int]:
    """(x0, h_family) python ints for a seed: the family's shared root base
    state (the paper's RSGU seed) and its even leaf offset.  ``purpose``
    selects disjoint h families over the same root."""
    x0 = splitmix.splitmix64_host(seed & M64, 0x1234)
    h = (splitmix.splitmix64_host(seed, purpose) << 1) & M64
    return x0, h


def derive_leaf(h_parent: U64Pair, tag: U64Pair) -> U64Pair:
    """Child leaf offset: splitmix64(h_parent, tag) forced even (<< 1)."""
    return u64.shl64(splitmix.splitmix64(h_parent, tag), 1)


def derive_leaf_host(h_parent: int, tag: int) -> int:
    """Python-int mirror of ``derive_leaf``."""
    return (splitmix.splitmix64_host(h_parent, tag & M64) << 1) & M64


def leaf_limbs(hs: Sequence[int], device="cpu") -> U64Pair:
    """(S,) limb tensors of python-int leaf offsets, in one copy."""
    pairs = torch.tensor([u64.split64(h) for h in hs], dtype=torch.int64,
                         device=device).reshape(-1, 2)
    return pairs[:, 0].contiguous(), pairs[:, 1].contiguous()


def leaf_table(h_family: int, num_streams: int, device="cpu") -> U64Pair:
    """(S,) even leaf offsets h_s for streams 0..S-1 of a family."""
    sid = torch.arange(num_streams, dtype=torch.int64, device=device)
    f_hi, f_lo = u64.split64(h_family)
    return derive_leaf((torch.full_like(sid, f_hi), torch.full_like(sid, f_lo)),
                       (torch.zeros_like(sid), sid))


# ---------------------------------------------------------------------------
# GenPlan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GenPlan:
    """One bulk generation request: a (T, S) block, time-major.

    x0        root base state (python int).
    h         (hi, lo) u32 limb tensors of shape (S,): leaf offsets; their
              device is the plan's device.
    num_steps T, the time extent.
    ctr       counter of row 0 (python int, mod 2**64).
    mode      "ctr" (counter decorrelator) or "faithful" (the paper's
              serial xorshift128 decorrelator).
    deco      ctr-mode hash: "splitmix64" or "fmix32".
    sampler   output stage spec (``sampler.SPEC_GRAMMAR``).
    out_dtype "float32" or "bfloat16" for the float stages.
    """
    x0: int
    h: U64Pair
    num_steps: int
    ctr: int = 0
    mode: str = "ctr"
    deco: str = "splitmix64"
    sampler: str = "bits"
    out_dtype: str = "float32"

    @property
    def num_streams(self) -> int:
        return int(self.h[0].shape[0])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_steps, self.num_streams)

    @property
    def device(self) -> torch.device:
        return self.h[0].device


def make_plan(*, seed: int, num_streams: int, num_steps: int, offset: int = 0,
              purpose: int = 0, mode: str = "ctr", deco: str = "splitmix64",
              sampler: str = "bits", out_dtype: str = "float32",
              device=None) -> GenPlan:
    """Plan for a (T, S) block of the family derived from ``seed``."""
    device = resolve_device(device)
    x0, h_fam = family_from_seed(seed, purpose)
    return GenPlan(x0=x0, h=leaf_table(h_fam, num_streams, device),
                   num_steps=num_steps, ctr=offset & M64, mode=mode,
                   deco=deco, sampler=sampler, out_dtype=out_dtype)


def plan_for_stream(stream, num_steps: int, mode: str = "ctr",
                    deco: str = "splitmix64", sampler: str = "bits",
                    out_dtype: str = "float32") -> GenPlan:
    """Plan for ``num_steps`` elements of ONE ThunderStream (S = 1)."""
    h_hi, h_lo = u64.split64(stream.h)
    h = (torch.tensor([h_hi], dtype=torch.int64, device=stream.device),
         torch.tensor([h_lo], dtype=torch.int64, device=stream.device))
    return GenPlan(x0=stream.x0, h=h, num_steps=num_steps, ctr=stream.ctr,
                   mode=mode, deco=deco, sampler=sampler, out_dtype=out_dtype)


def plan_from_arrays(x0_hi, x0_lo, h_hi, h_lo, ctr_hi, ctr_lo, *,
                     num_steps: int, mode: str = "ctr",
                     deco: str = "splitmix64", sampler: str = "bits",
                     out_dtype: str = "float32", device=None) -> GenPlan:
    """A plan from the arrays a reference ``GenPlan`` holds (uint32 limb
    scalars and (S,) limb vectors, as numpy arrays), so that a reference
    plan resumes in the port bit for bit."""
    device = resolve_device(device)

    def vec(a):
        return u64.limbs(torch.from_numpy(
            np.array(a, np.uint32).reshape(-1))).to(device)

    return GenPlan(x0=u64.join64(int(x0_hi), int(x0_lo)),
                   h=(vec(h_hi), vec(h_lo)), num_steps=int(num_steps),
                   ctr=u64.join64(int(ctr_hi), int(ctr_lo)), mode=mode,
                   deco=deco, sampler=sampler, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# Shared prep helpers
# ---------------------------------------------------------------------------

def root_and_ctr_rows(x0: int, ctr: int, num_steps: int, device="cpu"
                      ) -> Tuple[U64Pair, U64Pair]:
    """((T,) root states for ctr+1..ctr+T, (T,) per-row counters ctr+t)."""
    from repro_torch.kernels import ref
    return (lcg.root_states_vector(x0, ctr, num_steps, device=device),
            ref.counter_rows(ctr, num_steps, device))


def _lane_states(plan: GenPlan) -> np.ndarray:
    """(S, 4) xorshift128 states of substreams 0..S-1 advanced to ctr."""
    tbl = xorshift.lane_table(plan.num_streams)
    return xorshift.jump_batch(tbl, plan.ctr) if plan.ctr else tbl


def _faithful_start_states(plan: GenPlan) -> np.ndarray:
    """(S, 4) uint32 start states of the plan's substreams at ``ctr``."""
    return np.array(_lane_states(plan), np.uint32)


def _faithful_states_at(plan: GenPlan, offsets: Sequence[int]) -> np.ndarray:
    """(K, 4, S) uint32 xorshift start states at non-decreasing offsets
    relative to ``plan.ctr``: host GF(2) jumps over the whole lane table,
    one batched jump per distinct offset."""
    tbl = _lane_states(plan)
    states = np.empty((len(offsets), 4, plan.num_streams), np.uint32)
    at = 0
    for i, off in enumerate(offsets):
        if off != at:
            tbl = xorshift.jump_batch(tbl, off - at)
            at = off
        states[i] = tbl.T
    return states


def _faithful_tile_states(plan: GenPlan, block_t: int, n_tiles: int
                          ) -> np.ndarray:
    """(n_tiles, 4, S) start states of row tiles ``i * block_t``."""
    return _faithful_states_at(plan, [i * block_t for i in range(n_tiles)])


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

_BACKENDS: Dict[str, Callable] = {}


def register_backend(name: str):
    """Decorator: register fn(plan, *, block_t, out) -> (T, S)."""
    def deco(fn):
        _BACKENDS[name] = fn
        return fn
    return deco


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def _copy_out(block: torch.Tensor, out: Optional[torch.Tensor]
              ) -> torch.Tensor:
    if out is None:
        return block
    out.view(block.shape).copy_(block)
    return out


@register_backend("torch")
def _torch_backend(plan: GenPlan, *, block_t: int,
                   out: Optional[torch.Tensor]) -> torch.Tensor:
    from repro_torch.kernels import ref
    if plan.mode == "ctr":
        bits = ref.thundering_block_ctr(plan.x0, plan.h, plan.num_steps,
                                        plan.ctr, deco=plan.deco)
    elif plan.mode == "faithful":
        xs0 = u64.limbs(torch.from_numpy(
            _faithful_start_states(plan).view(np.int32))).to(plan.device)
        bits = ref.thundering_block_faithful(plan.x0, plan.h, plan.num_steps,
                                             xs0, plan.ctr)
    else:
        raise ValueError(f"unknown mode {plan.mode!r}")
    return _copy_out(sampler_mod.apply(bits, sampler_mod.parse(plan.sampler),
                                       plan.out_dtype), out)


@register_backend("cuda")
def _cuda_backend(plan: GenPlan, *, block_t: int,
                  out: Optional[torch.Tensor]) -> torch.Tensor:
    from repro_torch.kernels import thundering_block as _tb
    spec = sampler_mod.parse(plan.sampler)
    T = plan.num_steps
    if plan.mode == "ctr":
        return _tb.thundering_ctr(plan.x0, plan.ctr, T, plan.h,
                                  deco=plan.deco, sampler=spec,
                                  out_dtype=plan.out_dtype, out=out)
    if plan.mode == "faithful":
        bt = _tb.tile_rows(block_t, T)
        states = _faithful_tile_states(plan, bt, -(-T // bt))
        return _tb.thundering_faithful(
            plan.x0, plan.ctr, T, plan.h,
            _tb.states_tensor(states, plan.device), block_t=bt,
            sampler=spec, out_dtype=plan.out_dtype, out=out)
    raise ValueError(f"unknown mode {plan.mode!r}")


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def select_backend(plan: GenPlan) -> str:
    """``"cuda"`` for plans on a CUDA device (any shape), else
    ``"torch"``."""
    return "cuda" if plan.device.type == "cuda" else "torch"


def _validate_plan(plan: GenPlan) -> None:
    spec = sampler_mod.parse(plan.sampler)
    sampler_mod.result_dtype(spec, plan.out_dtype)
    if spec[0] == "normal" and plan.num_steps % 2:
        raise ValueError(
            f"sampler='normal' pairs adjacent rows (Box-Muller) and needs "
            f"an even T, got T={plan.num_steps}")
    if plan.mode not in ("ctr", "faithful"):
        raise ValueError(f"unknown mode {plan.mode!r}")
    if plan.deco not in ("splitmix64", "fmix32"):
        raise ValueError(f"unknown deco {plan.deco!r}")


def _backend_fn(plan: GenPlan, backend: Optional[str]) -> Callable:
    name = backend or select_backend(plan)
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; have {available_backends()}") from None


def generate(plan: GenPlan, *, backend: Optional[str] = None,
             block_t: int = DEFAULT_BLOCK_T,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T, S) block for ``plan``, time-major; dtype set by the sampler
    stage (``torch.uint32`` bits, float32/bfloat16, bool for bernoulli).

    ``out`` is written in place (a donated ring buffer) and returned.

    Example:
        >>> from repro_torch.core import engine
        >>> plan = engine.make_plan(seed=7, num_streams=4, num_steps=8,
        ...                         device="cpu")
        >>> blk = engine.generate(plan)
        >>> (tuple(blk.shape), blk.dtype)
        ((8, 4), torch.uint32)
    """
    _validate_plan(plan)
    return _backend_fn(plan, backend)(plan, block_t=block_t, out=out)


def sample(plan: GenPlan, *, sampler: Optional[str] = None,
           out_dtype: Optional[str] = None, backend: Optional[str] = None,
           block_t: int = DEFAULT_BLOCK_T,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``generate`` with the sampler stage overridden for this call."""
    if sampler is not None or out_dtype is not None:
        plan = dataclasses.replace(
            plan,
            sampler=plan.sampler if sampler is None else sampler,
            out_dtype=plan.out_dtype if out_dtype is None else out_dtype)
    return generate(plan, backend=backend, block_t=block_t, out=out)


def shift_plan(plan: GenPlan, delta: int) -> GenPlan:
    """The same plan ``delta`` counter steps later."""
    return dataclasses.replace(plan, ctr=(plan.ctr + int(delta)) & M64)


def generate_windows(plan: GenPlan, num_windows: int, *,
                     backend: Optional[str] = None,
                     block_t: int = DEFAULT_BLOCK_T,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(W, T, S) stack of W consecutive counter windows of ``plan``.

    Window w covers counter steps [ctr + w*T, ctr + (w+1)*T).  The
    ``"torch"`` backend stacks W ``generate`` calls on shifted plans (the
    oracle); ``"cuda"`` makes ONE launch over the W*T rows, which counter
    addressing makes the same block.
    """
    _validate_plan(plan)
    W = int(num_windows)
    if W < 1:
        raise ValueError(f"num_windows must be >= 1, got {num_windows}")
    T, S = plan.shape
    fn = _backend_fn(plan, backend)
    if fn is _torch_backend:
        stack = torch.stack([generate(shift_plan(plan, w * T),
                                      backend="torch", block_t=block_t)
                             for w in range(W)])
        return _copy_out(stack, out)
    wide = dataclasses.replace(plan, num_steps=W * T)
    return fn(wide, block_t=block_t, out=out).view(W, T, S)


def generate_flat(plan: GenPlan, *, backend: Optional[str] = None,
                  block_t: int = DEFAULT_BLOCK_T) -> torch.Tensor:
    """(T,) vector for a single-stream plan (S must be 1)."""
    if plan.num_streams != 1:
        raise ValueError(f"generate_flat needs S=1, got S={plan.num_streams}")
    return generate(plan, backend=backend, block_t=block_t)[:, 0]

