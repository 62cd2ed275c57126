"""Launch wrappers of the two CUDA block generators and of the leaf table,
with their plain versions.

``thundering_ctr`` (kernel A, ``csrc/thundering_block.cu``) generates a
(rows, S) ctr-mode block; ``thundering_faithful`` (kernel B) the paper's
serial-xorshift128 block.  A stack of W consecutive counter windows is one
block of W*T consecutive rows, so the windowed forms of the reference
(``block_ctr_windows``, ``block_faithful_windows``) are the same launches
viewed as (W, T, S).  ``leaf_table`` writes a family's (S,) leaf offsets,
the table of every plan (``engine.leaf_table``), in one launch.

Each wrapper takes the kernel's plain version for tensors on the CPU and
launches the kernel for CUDA tensors; there is no other path.  Each adds
one to the counter ``<wrapper>.launches`` (``repro_torch.trace``) where it
launches, and each plain version counts the times it ran on a CUDA tensor
(``<plain version>.cuda_runs``), so a run can show that its main path went
through the kernels; ``trace.reset_counters(("thundering_",
"leaf_table"))`` zeroes them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import lcg, sampler as sampler_mod, splitmix, u64, \
    xorshift
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
        lib.tb_tile_states_launch.argtypes = [ptr, ptr, ptr, ptr, cint,
                                              u64_t, i64, cint, ptr]
        lib.tb_tile_states_launch.restype = cint
        lib.tb_leaf_table_launch.argtypes = [ptr, cint, u64_t, ptr]
        lib.tb_leaf_table_launch.restype = cint
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


def limb_words(x: torch.Tensor) -> torch.Tensor:
    """u32 limb tensor as the contiguous int64 words kernels A and B read;
    a plan's own limbs pass as they are, with no conversion launch."""
    if x.dtype == torch.int64 and x.is_contiguous():
        return x
    return u64.limbs(x).contiguous()


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
# Leaf table
# ---------------------------------------------------------------------------

def leaf_table_plain(h_family: int, S: int, device="cpu") -> U64Pair:
    """Plain torch version of the leaf-table kernel:
    ``splitmix.derive_leaf(h_family, s)`` for s < S in u32-limb
    arithmetic on ``device``."""
    if torch.device(device).type == "cuda":
        trace.count("leaf_table_plain.cuda_runs")
    sid = torch.arange(S, dtype=torch.int64, device=device)
    f_hi, f_lo = u64.split64(h_family)
    return splitmix.derive_leaf(
        (torch.full_like(sid, f_hi), torch.full_like(sid, f_lo)),
        (torch.zeros_like(sid), sid))


def leaf_table(h_family: int, S: int, device="cpu") -> U64Pair:
    """(hi, lo) u32 limb tensors (int64, shape (S,)) of the even leaf
    offsets h_s = splitmix64(h_family, s) << 1 of streams 0..S-1.  On a
    card one launch writes both rows of a (2, S) buffer; elsewhere the
    plain version runs."""
    device = torch.device(device)
    if device.type != "cuda":
        return leaf_table_plain(h_family, S, device)
    buf = torch.empty((2, S), dtype=torch.int64, device=device)
    if S > 0:
        lib = _lib()
        with torch.cuda.device(buf.device):
            code = lib.tb_leaf_table_launch(
                buf.data_ptr(), S, h_family & u64.M64,
                torch.cuda.current_stream(buf.device).cuda_stream)
        _check(lib, code, "leaf_table")
        trace.count("leaf_table.launches")
    return buf[0], buf[1]


# ---------------------------------------------------------------------------
# Kernel A: ctr mode
# ---------------------------------------------------------------------------

def thundering_ctr_plain(x0: int, ctr: int, rows: int, h: U64Pair, *,
                         deco: str = "splitmix64",
                         sampler=("bits", None),
                         out_dtype: str = "float32") -> torch.Tensor:
    """Plain torch version of kernel A: the (rows, S) sampled block."""
    if h[0].is_cuda:
        trace.count("thundering_ctr_plain.cuda_runs")
    bits = ref.thundering_block_ctr(x0, h, rows, ctr, deco=deco)
    return sampler_mod.apply(bits, sampler, out_dtype)


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
    h_hi, h_lo = limb_words(h[0]), limb_words(h[1])
    rec, _ = _stage(sampler, out_dtype, device)
    lib = _lib()
    with torch.cuda.device(device):
        code = lib.tb_ctr_launch(
            out.data_ptr(), rows, S, lcg.advance(x0, ctr), ctr & u64.M64,
            h_hi.data_ptr(), h_lo.data_ptr(), DECO_IDS[deco],
            ctypes.byref(rec), torch.cuda.current_stream(device).cuda_stream)
    _check(lib, code, "thundering_ctr")
    trace.count("thundering_ctr.launches")
    return out


# ---------------------------------------------------------------------------
# Kernel B: faithful mode
# ---------------------------------------------------------------------------

def tile_rows(block_t: int, rows: int) -> int:
    """Row-tile height of kernel B: ``block_t`` capped at the (even-padded)
    row count and rounded down to an even number, so Box-Muller row pairs
    never straddle a tile."""
    bt = min(int(block_t), rows + (rows & 1))
    return max(2, bt - bt % 2)


def host_lanes(lanes: torch.Tensor) -> np.ndarray:
    """(4, S) 32-bit lane states (int64 limbs or int32 bit patterns, any
    device) -> (S, 4) uint32 on the host."""
    return u64.limbs(lanes.cpu()).numpy().astype(np.uint32).T.copy()


def _check_lanes(lanes: torch.Tensor, S: int, device: torch.device) -> None:
    if tuple(lanes.shape) != (4, S):
        raise ValueError(f"lanes must be (4, {S}), got {tuple(lanes.shape)}")
    if lanes.device != device:
        raise ValueError("lanes and h lie on different devices")


def thundering_faithful_plain(x0: int, ctr: int, rows: int, h: U64Pair,
                              lanes: torch.Tensor, *, block_t: int,
                              sampler=("bits", None),
                              out_dtype: str = "float32") -> torch.Tensor:
    """Plain torch version of kernel B: each row tile restarts the
    xorshift128 chain from its own start state, jumped on the host with
    ``xorshift.jump_batch`` (independent of the card's jump)."""
    if h[0].is_cuda:
        trace.count("thundering_faithful_plain.cuda_runs")
    n_tiles = -(-rows // block_t)
    tbl = xorshift.jump_batch(host_lanes(lanes), ctr & u64.M64)
    states = states_tensor(xorshift.states_at(
        tbl, [i * block_t for i in range(n_tiles)]), "cpu").to(h[0].device)
    roots = lcg.root_states_vector(x0, ctr, rows, device=h[0].device)
    perm = ref.leaf_outputs(roots, h)
    x, y, z, w = (states[:, i, :] for i in range(4))
    outs = []
    for _ in range(block_t):
        x, y, z, w = xorshift.step_xyzw(x, y, z, w)
        outs.append(w)
    deco = torch.stack(outs, 1).reshape(-1, perm.shape[1])[:rows]
    return sampler_mod.apply(perm ^ deco, sampler, out_dtype)


def faithful_tile_states(lanes: torch.Tensor, ctr: int, block_t: int,
                         n_tiles: int) -> torch.Tensor:
    """(n_tiles, 4, S) start states of kernel B's row tiles: the (4, S)
    lane table ``lanes`` (substreams at their start) advanced by
    ``ctr + i * block_t`` steps for tile i.  On a card the GF(2) jump kernels
    of ``csrc/thundering_block.cu`` write them; on the CPU the plain torch
    jump ``xorshift.jump_tensor`` does."""
    S = int(lanes.shape[1])
    _check_lanes(lanes, S, lanes.device)
    if lanes.device.type == "cpu":
        n_hi, n_lo = (torch.tensor(v, dtype=torch.int64)[:, None]
                      for v in zip(*(u64.split64(ctr + i * block_t)
                                     for i in range(n_tiles))))
        st = xorshift.jump_tensor(u64.limbs(lanes).T[None], n_hi, n_lo)
        return st.transpose(1, 2).contiguous()
    return _tile_states_cuda(_lib(), lanes, ctr, block_t, n_tiles)


def _tile_states_cuda(lib: ctypes.CDLL, lanes: torch.Tensor, ctr: int,
                      block_t: int, n_tiles: int) -> torch.Tensor:
    device = lanes.device
    S = int(lanes.shape[1])
    states = torch.empty((n_tiles, 4, S), dtype=torch.int32, device=device)
    scratch = torch.empty((4, S), dtype=torch.int32, device=device) \
        if ctr & u64.M64 else states
    with torch.cuda.device(device):
        code = lib.tb_tile_states_launch(
            states.data_ptr(), lanes.data_ptr(), scratch.data_ptr(),
            pow2_tables(device).data_ptr(), S, ctr & u64.M64, block_t,
            n_tiles, torch.cuda.current_stream(device).cuda_stream)
    _check(lib, code, "thundering_faithful tile states")
    return states


def thundering_faithful(x0: int, ctr: int, rows: int, h: U64Pair,
                        lanes: torch.Tensor, *, block_t: int,
                        sampler=("bits", None), out_dtype: str = "float32",
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(rows, S) faithful-mode block: XSH_RR(root + h_s) ^ w_s(t), w the
    xorshift128 substream of stream s.

    ``lanes``: the (4, S) 32-bit lane table at substream start
    (``lane_states``); the kernel's row tiles of ``block_t`` rows (even)
    start from it advanced by ``ctr + i * block_t`` steps, jumped on the
    card by the launch itself (``faithful_tile_states``).
    """
    S = check_h(h)
    _check_stage_rows(sampler, rows)
    if block_t < 2 or block_t % 2:
        raise ValueError(f"block_t must be even and >= 2, got {block_t}")
    device = h[0].device
    _check_lanes(lanes, S, device)
    if device.type == "cpu":
        return finish_plain(thundering_faithful_plain(
            x0, ctr, rows, h, lanes, block_t=block_t, sampler=sampler,
            out_dtype=out_dtype), out)
    if device.type != "cuda":
        raise ValueError(f"thundering_faithful runs on cpu or cuda, "
                         f"not {device}")
    if lanes.dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"lanes must be 32-bit, got {lanes.dtype}")
    dtype = sampler_mod.result_dtype(sampler, out_dtype)
    out = output_tensor(out, rows, S, dtype, device)
    n_tiles = -(-rows // block_t)
    h_hi, h_lo = limb_words(h[0]), limb_words(h[1])
    rec, _ = _stage(sampler, out_dtype, device)
    lib = _lib()
    states = _tile_states_cuda(lib, lanes.contiguous(), ctr, block_t,
                               n_tiles)
    with torch.cuda.device(device):
        code = lib.tb_faithful_launch(
            out.data_ptr(), rows, S, lcg.advance(x0, ctr), h_hi.data_ptr(),
            h_lo.data_ptr(), states.data_ptr(), n_tiles, block_t,
            ctypes.byref(rec), torch.cuda.current_stream(device).cuda_stream)
    _check(lib, code, "thundering_faithful")
    trace.count("thundering_faithful.launches")
    return out


def states_tensor(states: np.ndarray, device) -> torch.Tensor:
    """Host (..., S) uint32 states -> 32-bit tensor on ``device`` (int64
    limbs on the CPU, the int32 bit pattern on a card)."""
    t = torch.from_numpy(np.ascontiguousarray(states, np.uint32)
                         .view(np.int32))
    device = torch.device(device)
    if device.type == "cpu":
        return u64.limbs(t)
    return t.to(device, non_blocking=False)


@functools.lru_cache(maxsize=16)
def lane_states(num_streams: int, device) -> torch.Tensor:
    """The (4, S) lane table of substreams 0..S-1 at their start
    (``xorshift.lane_table``, built once on the host per S) on ``device``,
    uploaded once and kept."""
    return states_tensor(xorshift.lane_table(num_streams).T.copy(), device)


@functools.lru_cache(maxsize=8)
def pow2_tables(device) -> torch.Tensor:
    """The GF(2) matrices M**(2**k), k < 64, as (64, 32, 16, 4) nibble
    tables (``xorshift._pow2_nibble_tables``) on a card: 512 KiB, uploaded
    once."""
    return states_tensor(xorshift._pow2_nibble_tables(64), device)
