"""Dropout with the mask generated inline: it never exists in memory.

Plain dropout reads x, reads (or writes) a mask array and writes y.
ThundeRiNG's counter addressing lets kernel C (``csrc/fused_dropout.cu``)
regenerate the mask bits of any element from (leaf h, element index)
alone, so it reads x and writes y and nothing else.  Element p of the
flattened x keeps iff the ctr-mode bits at counter ``ctr0 + p`` of the
one-stream plan (x0, h) - ``stream.random_bits(stream, n)[p]`` - are
below ``keep_threshold(rate)``; kept values are x times x's dtype's
rounding of 1 / (1 - rate).

The wrapper takes the plain version (``ref.fused_dropout``) for a tensor
on the CPU and launches the kernel for a CUDA tensor; the counter
``fused_dropout_2d.launches`` (``repro_torch.trace``) counts the launches
and ``fused_dropout_2d_plain.cuda_runs`` the plain version's runs on a
card.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch import trace
from repro_torch.core import lcg, sampler
from repro_torch.core.u64 import M64
from repro_torch.kernels import build, ref

#: x dtype -> ``enum FdType`` of ``csrc/fused_dropout.cu``
DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def keep_threshold(rate: float) -> int:
    """uint32 keep threshold for a drop rate: round((1-rate) * 2**32).

    The engine's bernoulli sampler threshold at p = 1 - rate: exact
    host-int arithmetic, clamped to 2**32 - 1 so a tiny positive rate
    cannot round up to 2**32 and wrap to an all-drop threshold.
    """
    return sampler.bernoulli_threshold(1.0 - rate)


def mask_elems(shape) -> int:
    """Counter elements a dropout mask over ``shape`` consumes: the
    lease-sizing rule for a ``BlockService`` window feeding
    ``ops.fused_dropout`` (flat row-major addressing, one u32 per
    element)."""
    return math.prod(int(d) for d in shape)


def _lib() -> ctypes.CDLL:
    lib = build.library("fused_dropout")
    if not getattr(lib, "_fd_typed", False):
        ptr, u64_t, cint = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
        lib.fd_launch.argtypes = [ptr, ptr, ctypes.c_longlong, cint, u64_t,
                                  u64_t, u64_t, ctypes.c_uint32,
                                  ctypes.c_float, ptr]
        lib.fd_launch.restype = cint
        lib.fd_error_string.argtypes = [cint]
        lib.fd_error_string.restype = ctypes.c_char_p
        lib._fd_typed = True
    return lib


def fused_dropout_2d_plain(x: torch.Tensor, h: int, x0: int, ctr0: int,
                           rate: float) -> torch.Tensor:
    """Plain torch version of kernel C."""
    if x.is_cuda:
        trace.count("fused_dropout_2d_plain.cuda_runs")
    return ref.fused_dropout(x, h, x0, ctr0, rate)


def fused_dropout_2d(x: torch.Tensor, h: int, x0: int, ctr0: int,
                     rate: float, *, block_m: int = 8,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dropout on a (M, N) tensor; ``h``, ``x0``, ``ctr0`` are the stream's
    python ints.

    Element (m, n) keeps iff the bits for flat counter ctr0 + m*N + n are
    below (1-rate)*2^32.  ``block_m`` is the reference's row tile; the
    result does not depend on it.  ``out`` (a contiguous tensor of x's
    shape and dtype) is written in place and returned.
    """
    if rate <= 0.0:
        return x
    if x.dim() != 2:
        raise ValueError(f"fused_dropout_2d takes a 2-D x, got "
                         f"{tuple(x.shape)}")
    if block_m < 1:
        raise ValueError(f"block_m must be >= 1, got {block_m}")
    if x.dtype not in DTYPE_IDS:
        raise ValueError(f"fused dropout takes {sorted(map(str, DTYPE_IDS))},"
                         f" got {x.dtype}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {x.dtype} tensor of "
                         f"shape {tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        y = fused_dropout_2d_plain(x, h, x0, ctr0, rate)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dropout_2d runs on cpu or cuda, not "
                         f"{x.device}")
    x = x.contiguous()
    out = torch.empty_like(x) if out is None else out
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype).item()
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.fd_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), DTYPE_IDS[x.dtype],
            lcg.advance(x0, ctr0), ctr0 & M64, h & M64, keep_threshold(rate),
            scale, torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"fused_dropout_2d launch failed: "
                           f"{lib.fd_error_string(code).decode()}")
    trace.count("fused_dropout_2d.launches")
    return out
