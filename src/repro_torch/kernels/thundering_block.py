"""Launch wrappers of the two CUDA block generators, with their plain versions.

``thundering_ctr`` (kernel A, ``csrc/thundering_block.cu``) generates a
(rows, S) ctr-mode block; ``thundering_faithful`` (kernel B) the paper's
serial-xorshift128 block.  A stack of W consecutive counter windows is one
block of W*T consecutive rows, so the windowed forms of the reference
(``block_ctr_windows``, ``block_faithful_windows``) are the same launches
viewed as (W, T, S).

Each wrapper takes the kernel's plain version for tensors on the CPU and
launches the kernel for CUDA tensors; there is no other path.  Each adds
one to its ``launches`` count where it launches, and each plain version
counts the times it ran on a CUDA tensor (``cuda_runs``), so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import lcg, sampler as sampler_mod, u64, xorshift
from repro_torch.core.u64 import U64Pair
from repro_torch.kernels import build, ref

DECO_IDS = {"splitmix64": 0, "fmix32": 1}


class _Stage(ctypes.Structure):
    """Mirror of ``struct Stage`` in ``csrc/sampler_stage.cuh``."""
    _fields_ = [("kind", ctypes.c_int), ("out_type", ctypes.c_int),
                ("f0", ctypes.c_float), ("f1", ctypes.c_float),
                ("f2", ctypes.c_float), ("thresh", ctypes.c_uint32),
                ("flag", ctypes.c_int), ("n_table", ctypes.c_int),
                ("table_f", ctypes.c_void_p), ("table_i", ctypes.c_void_p)]


def _lib() -> ctypes.CDLL:
    lib = build.library("thundering_block")
    if not getattr(lib, "_tb_typed", False):
        ptr, i64, u64_t, cint = (ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_uint64, ctypes.c_int)
        lib.tb_ctr_launch.argtypes = [ptr, i64, cint, u64_t, u64_t, ptr, ptr,
                                      cint, ctypes.POINTER(_Stage), ptr]
        lib.tb_ctr_launch.restype = cint
        lib.tb_faithful_launch.argtypes = [ptr, i64, cint, u64_t, ptr, ptr,
                                           ptr, cint, cint,
                                           ctypes.POINTER(_Stage), ptr]
        lib.tb_faithful_launch.restype = cint
        lib.tb_error_string.argtypes = [cint]
        lib.tb_error_string.restype = ctypes.c_char_p
        lib._tb_typed = True
    return lib


def _check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.tb_error_string(code).decode()}")


@functools.lru_cache(maxsize=64)
def _stage(spec, out_dtype: str, device: torch.device):
    """(_Stage record, device tables it points into) for a parsed spec;
    cached, so the tables outlive every launch that reads them."""
    kind, out_type, f0, f1, f2, thresh, flag, tf, ti = \
        sampler_mod.stage_params(spec, out_dtype)
    keep = [torch.tensor(tf or [0.0], dtype=torch.float32, device=device),
            torch.tensor(ti or [0], dtype=torch.int32, device=device)]
    rec = _Stage(kind, out_type, f0, f1, f2, thresh, flag, len(tf),
                 keep[0].data_ptr(), keep[1].data_ptr())
    return rec, keep


def u32_device(x: torch.Tensor) -> torch.Tensor:
    """u32 limb tensor -> contiguous int32 tensor of the same bits."""
    return x.to(torch.int32).contiguous()


def check_h(h: U64Pair) -> int:
    if h[0].dim() != 1 or h[0].shape != h[1].shape:
        raise ValueError(f"h limbs must be two (S,) tensors, got "
                         f"{tuple(h[0].shape)} and {tuple(h[1].shape)}")
    if h[0].device != h[1].device:
        raise ValueError("h limbs lie on different devices")
    return int(h[0].shape[0])


def output_tensor(out: Optional[torch.Tensor], rows: int, S: int,
                  dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if out is None:
        return torch.empty((rows, S), dtype=dtype, device=device)
    if (out.dtype != dtype or out.device != device
            or out.numel() != rows * S or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous {dtype} tensor of {rows * S} elements "
            f"on {device}, got {out.dtype} {tuple(out.shape)} on "
            f"{out.device}")
    return out


def finish_plain(block: torch.Tensor, out: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if out is None:
        return block
    output_tensor(out, block.shape[0], block.shape[1], block.dtype,
                  block.device)
    out.view(block.shape).copy_(block)
    return out


def _check_stage_rows(spec, rows: int) -> None:
    if spec[0] == "normal" and rows % 2:
        raise ValueError(f"sampler='normal' pairs adjacent rows and needs "
                         f"an even row count, got {rows}")


# ---------------------------------------------------------------------------
# Kernel A: ctr mode
# ---------------------------------------------------------------------------

def thundering_ctr_plain(x0: int, ctr: int, rows: int, h: U64Pair, *,
                         deco: str = "splitmix64",
                         sampler=("bits", None),
                         out_dtype: str = "float32") -> torch.Tensor:
    """Plain torch version of kernel A: the (rows, S) sampled block."""
    if h[0].is_cuda:
        thundering_ctr_plain.cuda_runs += 1
    bits = ref.thundering_block_ctr(x0, h, rows, ctr, deco=deco)
    return sampler_mod.apply(bits, sampler, out_dtype)


thundering_ctr_plain.cuda_runs = 0


def thundering_ctr(x0: int, ctr: int, rows: int, h: U64Pair, *,
                   deco: str = "splitmix64", sampler=("bits", None),
                   out_dtype: str = "float32",
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(rows, S) block, element (t, s) = XSH_RR(root(ctr+t+1) + h_s) ^
    deco(h_s, ctr+t) through the sampler stage ``sampler`` (a parsed spec).

    ``x0`` is the family's root base state and ``ctr`` the first row's
    counter (python ints); ``h`` the (S,) leaf offsets as u32 limbs.
    ``out`` (any contiguous tensor of rows*S elements of the stage's
    dtype) is written in place and returned.
    """
    S = check_h(h)
    if deco not in DECO_IDS:
        raise ValueError(f"unknown deco {deco!r}")
    _check_stage_rows(sampler, rows)
    device = h[0].device
    if device.type == "cpu":
        return finish_plain(thundering_ctr_plain(
            x0, ctr, rows, h, deco=deco, sampler=sampler,
            out_dtype=out_dtype), out)
    if device.type != "cuda":
        raise ValueError(f"thundering_ctr runs on cpu or cuda, not {device}")
    dtype = sampler_mod.result_dtype(sampler, out_dtype)
    out = output_tensor(out, rows, S, dtype, device)
    h_hi, h_lo = u32_device(h[0]), u32_device(h[1])
    rec, _ = _stage(sampler, out_dtype, device)
    lib = _lib()
    with torch.cuda.device(device):
        code = lib.tb_ctr_launch(
            out.data_ptr(), rows, S, lcg.advance(x0, ctr), ctr & u64.M64,
            h_hi.data_ptr(), h_lo.data_ptr(), DECO_IDS[deco],
            ctypes.byref(rec), torch.cuda.current_stream(device).cuda_stream)
    _check(lib, code, "thundering_ctr")
    thundering_ctr.launches += 1
    return out


thundering_ctr.launches = 0


# ---------------------------------------------------------------------------
# Kernel B: faithful mode
# ---------------------------------------------------------------------------

def tile_rows(block_t: int, rows: int) -> int:
    """Row-tile height of kernel B: ``block_t`` capped at the (even-padded)
    row count and rounded down to an even number, so Box-Muller row pairs
    never straddle a tile."""
    bt = min(int(block_t), rows + (rows & 1))
    return max(2, bt - bt % 2)


def thundering_faithful_plain(x0: int, ctr: int, rows: int, h: U64Pair,
                              states: torch.Tensor, *, block_t: int,
                              sampler=("bits", None),
                              out_dtype: str = "float32") -> torch.Tensor:
    """Plain torch version of kernel B: each row tile restarts the
    xorshift128 chain from its own start state in ``states``."""
    if h[0].is_cuda:
        thundering_faithful_plain.cuda_runs += 1
    roots = lcg.root_states_vector(x0, ctr, rows, device=h[0].device)
    perm = ref.leaf_outputs(roots, h)
    st = u64.limbs(states)
    x, y, z, w = (st[:, i, :] for i in range(4))
    outs = []
    for _ in range(block_t):
        x, y, z, w = xorshift.step_xyzw(x, y, z, w)
        outs.append(w)
    deco = torch.stack(outs, 1).reshape(-1, perm.shape[1])[:rows]
    return sampler_mod.apply(perm ^ deco, sampler, out_dtype)


thundering_faithful_plain.cuda_runs = 0


def thundering_faithful(x0: int, ctr: int, rows: int, h: U64Pair,
                        states: torch.Tensor, *, block_t: int,
                        sampler=("bits", None), out_dtype: str = "float32",
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(rows, S) faithful-mode block: XSH_RR(root + h_s) ^ w_s(t), w the
    xorshift128 substream of stream s.

    ``states``: (n_tiles, 4, S) 32-bit tensor, the substream state of every
    stream at the first row of each ``block_t``-row tile (``block_t`` even,
    ``n_tiles = ceil(rows / block_t)``).
    """
    S = check_h(h)
    _check_stage_rows(sampler, rows)
    if block_t < 2 or block_t % 2:
        raise ValueError(f"block_t must be even and >= 2, got {block_t}")
    n_tiles = -(-rows // block_t)
    if tuple(states.shape) != (n_tiles, 4, S):
        raise ValueError(f"states must be ({n_tiles}, 4, {S}), got "
                         f"{tuple(states.shape)}")
    device = h[0].device
    if states.device != device:
        raise ValueError("states and h lie on different devices")
    if device.type == "cpu":
        return finish_plain(thundering_faithful_plain(
            x0, ctr, rows, h, states, block_t=block_t, sampler=sampler,
            out_dtype=out_dtype), out)
    if device.type != "cuda":
        raise ValueError(f"thundering_faithful runs on cpu or cuda, "
                         f"not {device}")
    if states.dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"states must be 32-bit, got {states.dtype}")
    dtype = sampler_mod.result_dtype(sampler, out_dtype)
    out = output_tensor(out, rows, S, dtype, device)
    states = states.contiguous()
    h_hi, h_lo = u32_device(h[0]), u32_device(h[1])
    rec, _ = _stage(sampler, out_dtype, device)
    lib = _lib()
    with torch.cuda.device(device):
        code = lib.tb_faithful_launch(
            out.data_ptr(), rows, S, lcg.advance(x0, ctr), h_hi.data_ptr(),
            h_lo.data_ptr(), states.data_ptr(), n_tiles, block_t,
            ctypes.byref(rec), torch.cuda.current_stream(device).cuda_stream)
    _check(lib, code, "thundering_faithful")
    thundering_faithful.launches += 1
    return out


thundering_faithful.launches = 0


def states_tensor(states: np.ndarray, device) -> torch.Tensor:
    """Host (K, 4, S) uint32 start states -> 32-bit tensor on ``device``
    (int64 limbs on the CPU, the int32 bit pattern on a card)."""
    t = torch.from_numpy(np.ascontiguousarray(states, np.uint32)
                         .view(np.int32))
    device = torch.device(device)
    if device.type == "cpu":
        return u64.limbs(t)
    return t.to(device, non_blocking=False)


def reset_counts() -> None:
    """Set every launch and plain-run count to zero."""
    thundering_ctr.launches = 0
    thundering_faithful.launches = 0
    thundering_ctr_plain.cuda_runs = 0
    thundering_faithful_plain.cuda_runs = 0
