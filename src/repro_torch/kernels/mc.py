"""The paper's two case studies (Sec. 6) as fused kernels: Monte-Carlo pi
and Black-Scholes option pricing.

Generation is fused into the integrand: each lane draws x/y uniforms from
two leaf families (``hx``, ``hy``) of one shared root, the integrand runs
in registers, and only one partial per (row tile, lane) leaves the kernel.
``pi_partials`` (kernel D, ``csrc/mc.cu``) writes int32 in-circle counts,
``option_partials`` (kernel E) float32 sums of discounted call payoffs.

The partial layout is the reference's: ``(n_tiles, S)``, tile ``i``
holding rows ``[i*bt, min((i+1)*bt, T))``, with ``bt = min(block_t,
ceil8(T))`` and ``n_tiles = ceil(T / bt)``; rows past T count nothing.
``block_s`` is accepted for the reference's signature and does not change
the result.

Each wrapper takes its plain version for tensors on the CPU and launches
its kernel for CUDA tensors; the counters ``<wrapper>.launches``
(``repro_torch.trace``) count the launches and ``<plain version>.cuda_runs``
the plain versions' runs on a CUDA tensor (``trace.reset_counters(
("pi_partials", "option_partials"))`` zeroes them).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.core import lcg
from repro_torch.core.u64 import M64, U64Pair
from repro_torch.kernels import build, ref
from repro_torch.kernels.thundering_block import (check_h, finish_plain,
                                                  output_tensor, u32_device)

DEFAULT_BLOCK_T = 256
DEFAULT_BLOCK_S = 512

_APP_PI, _APP_OPTION = 0, 1


class _McOption(ctypes.Structure):
    """Mirror of ``struct McOption`` in ``csrc/mc.cu``."""
    _fields_ = [(name, ctypes.c_float)
                for name in ("s0", "strike", "drift", "vol", "disc")]


def _lib() -> ctypes.CDLL:
    lib = build.library("mc")
    if not getattr(lib, "_mc_typed", False):
        ptr, i64, u64_t, cint = (ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_uint64, ctypes.c_int)
        lib.mc_launch.argtypes = [cint, ptr, i64, cint, u64_t, u64_t, ptr,
                                  ptr, ptr, ptr, cint, i64,
                                  ctypes.POINTER(_McOption), ptr]
        lib.mc_launch.restype = cint
        lib.mc_error_string.argtypes = [cint]
        lib.mc_error_string.restype = ctypes.c_char_p
        lib._mc_typed = True
    return lib


def tile_layout(num_steps: int, block_t: int) -> Tuple[int, int]:
    """(bt, n_tiles) of the partial layout for T = ``num_steps`` rows."""
    if num_steps < 1 or block_t < 1:
        raise ValueError(f"num_steps and block_t must be >= 1, got "
                         f"{num_steps} and {block_t}")
    bt = min(int(block_t), -(-num_steps // 8) * 8)
    return bt, -(-num_steps // bt)


def _check_lanes(hx: U64Pair, hy: U64Pair) -> None:
    if check_h(hy) != check_h(hx) or hy[0].device != hx[0].device:
        raise ValueError(f"hx and hy must be (S,) limbs on one device, got "
                         f"{tuple(hx[0].shape)} on {hx[0].device} and "
                         f"{tuple(hy[0].shape)} on {hy[0].device}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _tiles(ctr: int, num_steps: int, block_t: int):
    """(rows, first counter) of each row tile of the partial layout."""
    bt, n_tiles = tile_layout(num_steps, block_t)
    return [(min(bt, num_steps - i * bt), (ctr + i * bt) & M64)
            for i in range(n_tiles)]


def pi_partials_plain(x0: int, ctr: int, num_steps: int, hx: U64Pair,
                      hy: U64Pair, *, block_t: int = DEFAULT_BLOCK_T
                      ) -> torch.Tensor:
    """Plain torch version of kernel D: the oracle ``ref.mc_pi_partial``
    of each row tile, stacked to (n_tiles, S) int32 counts."""
    if hx[0].is_cuda:
        trace.count("pi_partials_plain.cuda_runs")
    return torch.stack([ref.mc_pi_partial(x0, hx, hy, rows, c)
                        for rows, c in _tiles(ctr, num_steps, block_t)])


def option_partials_plain(x0: int, ctr: int, num_steps: int, hx: U64Pair,
                          hy: U64Pair, *, s0: float, strike: float, r: float,
                          sigma: float, t: float,
                          block_t: int = DEFAULT_BLOCK_T) -> torch.Tensor:
    """Plain torch version of kernel E: the oracle ``ref.mc_option_partial``
    of each row tile, stacked to (n_tiles, S) float32 payoff sums."""
    if hx[0].is_cuda:
        trace.count("option_partials_plain.cuda_runs")
    return torch.stack([
        ref.mc_option_partial(x0, hx, hy, rows, c, s0, strike, r, sigma, t)
        for rows, c in _tiles(ctr, num_steps, block_t)])


# ---------------------------------------------------------------------------
# Kernels D and E
# ---------------------------------------------------------------------------

def _launch(app: int, x0: int, ctr: int, num_steps: int, hx: U64Pair,
            hy: U64Pair, block_t: int, option: _McOption,
            out: Optional[torch.Tensor], dtype: torch.dtype, what: str
            ) -> torch.Tensor:
    device = hx[0].device
    if device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {device}")
    S = int(hx[0].shape[0])
    bt, n_tiles = tile_layout(num_steps, block_t)
    with trace.span("mc.launch"):
        out = output_tensor(out, n_tiles, S, dtype, device)
        limbs = [u32_device(v) for v in (*hx, *hy)]
        lib = _lib()
        with torch.cuda.device(device):
            code = lib.mc_launch(
                app, out.data_ptr(), num_steps, S, lcg.advance(x0, ctr),
                ctr & M64, *(v.data_ptr() for v in limbs), bt, n_tiles,
                ctypes.byref(option),
                torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.mc_error_string(code).decode()}")
    return out


def pi_partials(x0: int, ctr: int, num_steps: int, hx: U64Pair, hy: U64Pair,
                *, block_t: int = DEFAULT_BLOCK_T,
                block_s: int = DEFAULT_BLOCK_S,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_tiles, S) int32 in-circle counts of the draws (ux, uy), rows
    ctr .. ctr+T-1 of the families hx and hy of root base state ``x0``.

    ``out`` (a contiguous int32 tensor of n_tiles*S elements) is written
    in place and returned.
    """
    _check_lanes(hx, hy)
    if hx[0].device.type == "cpu":
        return finish_plain(pi_partials_plain(x0, ctr, num_steps, hx, hy,
                                          block_t=block_t), out)
    out = _launch(_APP_PI, x0, ctr, num_steps, hx, hy, block_t,
                  _McOption(), out, torch.int32, "pi_partials")
    trace.count("pi_partials.launches")
    return out


def option_partials(x0: int, ctr: int, num_steps: int, hx: U64Pair,
                    hy: U64Pair, *, s0: float, strike: float, r: float,
                    sigma: float, t: float, block_t: int = DEFAULT_BLOCK_T,
                    block_s: int = DEFAULT_BLOCK_S,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_tiles, S) float32 sums of discounted call payoffs
    max(s0 exp(drift + vol z) - strike, 0) e^{-rt}, z the Box-Muller
    normal of (ux, uy).  The kernel sums each tile in row order, the plain
    version in torch's order."""
    _check_lanes(hx, hy)
    if hx[0].device.type == "cpu":
        return finish_plain(option_partials_plain(
            x0, ctr, num_steps, hx, hy, s0=s0, strike=strike, r=r,
            sigma=sigma, t=t, block_t=block_t), out)
    option = _McOption(*ref.option_constants(s0, strike, r, sigma, t))
    out = _launch(_APP_OPTION, x0, ctr, num_steps, hx, hy, block_t, option,
                  out, torch.float32, "option_partials")
    trace.count("option_partials.launches")
    return out


# ---------------------------------------------------------------------------
# Plan-addressed forms
# ---------------------------------------------------------------------------

def _plan_window(px, py) -> Tuple[int, int, int]:
    """(x0, ctr, T) shared by the x and y coordinate plans.

    The plan's counter start is a leased window's ``lo``
    (``engine.make_plan(offset=...)``), so a ``BlockService`` lease of
    ``draws_per_lane`` steps maps 1:1 onto the kernel's rows.
    """
    if (px.x0, px.ctr, px.num_steps) != (py.x0, py.ctr, py.num_steps):
        raise ValueError("the x and y plans must share root, counter and T")
    for p in (px, py):
        if p.mode != "ctr" or p.deco != "splitmix64":
            raise ValueError(f"the Monte-Carlo kernels draw ctr-mode "
                             f"splitmix64 bits, got {p.mode}/{p.deco}")
    return px.x0, px.ctr, px.num_steps


def pi_partials_from_plans(px, py, *, block_t: int = DEFAULT_BLOCK_T,
                           block_s: int = DEFAULT_BLOCK_S) -> torch.Tensor:
    """``pi_partials`` addressed by two engine plans (x/y coordinate
    families of one shared root, any counter window)."""
    x0, ctr, T = _plan_window(px, py)
    return pi_partials(x0, ctr, T, px.h, py.h, block_t=block_t,
                       block_s=block_s)


def option_partials_from_plans(px, py, *, s0: float, strike: float,
                               r: float, sigma: float, t: float,
                               block_t: int = DEFAULT_BLOCK_T,
                               block_s: int = DEFAULT_BLOCK_S
                               ) -> torch.Tensor:
    """``option_partials`` addressed by two engine plans."""
    x0, ctr, T = _plan_window(px, py)
    return option_partials(x0, ctr, T, px.h, py.h, s0=s0, strike=strike,
                           r=r, sigma=sigma, t=t, block_t=block_t,
                           block_s=block_s)
