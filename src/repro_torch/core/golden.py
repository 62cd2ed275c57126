"""Numpy uint64 golden model of ThundeRiNG.

The oracle of the port, independent of the u32-limb code paths: native
uint64 arithmetic through the paper's pipeline

  root LCG -> leaf add h_i -> XSH-RR permutation -> XOR decorrelator

All functions are intentionally slow and simple.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core import lcg as _lcg
from repro_torch.core import splitmix as _sm
from repro_torch.core import xorshift as _xs

M64 = (1 << 64) - 1


def lcg_seq(x0: int, n: int, a: int = _lcg.MULTIPLIER,
            c: int = _lcg.DEFAULT_INCREMENT) -> np.ndarray:
    """Root states x_1..x_n (the state after each transition), uint64."""
    out = np.empty(n, np.uint64)
    x = x0 & M64
    for i in range(n):
        x = (a * x + c) & M64
        out[i] = x
    return out


def xsh_rr(state: np.ndarray) -> np.ndarray:
    """PCG XSH-RR 64->32 on a uint64 array."""
    state = state.astype(np.uint64)
    xorshifted = (((state >> np.uint64(18)) ^ state) >> np.uint64(27)).astype(
        np.uint32)
    rot = (state >> np.uint64(59)).astype(np.uint32)
    return (xorshifted >> rot) | (xorshifted << ((np.uint32(32) - rot)
                                                 & np.uint32(31)))


def xorshift_seq(words: Tuple[int, int, int, int], n: int) -> np.ndarray:
    """n successive 32-bit outputs of xorshift128 from the given state."""
    out = np.empty(n, np.uint32)
    x, y, z, w = words
    for i in range(n):
        x, y, z, w = _xs.step_words(x, y, z, w)
        out[i] = w
    return out


def thundering_block(x0: int, h: np.ndarray, n_steps: int,
                     a: int = _lcg.MULTIPLIER,
                     c: int = _lcg.DEFAULT_INCREMENT,
                     mode: str = "faithful",
                     xs_seed: Tuple[int, int, int, int] = _xs.DEFAULT_SEED,
                     offset: int = 0) -> np.ndarray:
    """Golden (num_streams, n_steps) uint32 block.

    mode="faithful": decorrelator = xorshift128 substream per stream
      (substream i spaced 2**64, advanced ``offset`` extra steps).
    mode="ctr": decorrelator = splitmix64(h ^ const, offset + t).
    """
    num_streams = len(h)
    A, C = _lcg.lcg_skip(offset, a, c)
    roots = lcg_seq((A * (x0 & M64) + C) & M64, n_steps, a, c)
    out = np.empty((num_streams, n_steps), np.uint32)
    for s in range(num_streams):
        leaf = (roots + np.uint64(int(h[s]) & M64)) & np.uint64(M64)
        permuted = xsh_rr(leaf)
        if mode == "faithful":
            st = _xs.substream_state(xs_seed, s)
            if offset:
                st = _xs.jump(st, offset)
            deco = xorshift_seq(st, n_steps)
        elif mode == "ctr":
            deco = np.array(
                [_sm.ctr_decorrelator_host(int(h[s]), offset + t)
                 for t in range(n_steps)], np.uint32)
        else:
            raise ValueError(mode)
        out[s] = permuted ^ deco
    return out


def pcg32_seq(initstate: int, initseq: int, n: int) -> np.ndarray:
    """Reference pcg32 (O'Neill): a known-answer cross-check that the LCG
    + XSH-RR pipeline matches the published algorithm."""
    a = _lcg.MULTIPLIER
    inc = ((initseq << 1) | 1) & M64
    state = (inc + initstate) & M64
    state = (state * a + inc) & M64
    out = np.empty(n, np.uint32)
    for i in range(n):
        old = state
        state = (state * a + inc) & M64
        out[i] = xsh_rr(np.array([old], np.uint64))[0]
    return out
