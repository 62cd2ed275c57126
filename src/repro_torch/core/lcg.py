"""Linear congruential root generator with ThundeRiNG state sharing.

The paper's root/leaf decomposition (Sec. 3.3):

  root transition   x_{n+1} = (a * x_n + c)      mod 2**64      (1 multiply)
  leaf transition   w_n^i   = (x_n + h_i)        mod 2**64      (1 add each)

Even leaf offsets ``h_i`` with odd ``a`` and ``c`` keep every leaf stream
at full period (Hull-Dobell).  Jump-ahead (Brown 1994) expresses any
future root state as one affine map ``x_{n+t} = A_t x_n + C_t``.

In eager PyTorch a plan's counter is always a python int, so the jumps
that the reference traces through a 64-step loop collapse into host
arithmetic here; only the per-row expansion runs on tensors.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import u64
from repro_torch.core.u64 import U64Pair

# PCG64 / Knuth MMIX multiplier, as used by the paper (Sec. 5.1.2).
MULTIPLIER = 6364136223846793005
# PCG64 reference increment (odd: the paper's c = 54 is pcg32's stream id).
DEFAULT_INCREMENT = 1442695040888963407
MODULUS_BITS = 64


def lcg_skip(n: int, a: int = MULTIPLIER, c: int = DEFAULT_INCREMENT
             ) -> Tuple[int, int]:
    """Brown's O(log n) jump-ahead: (A, C) with x_{k+n} = A*x_k + C."""
    m = 1 << 64
    A, C = 1, 0
    cur_a, cur_c = a % m, c % m
    n = int(n)
    while n > 0:
        if n & 1:
            A = (A * cur_a) % m
            C = (C * cur_a + cur_c) % m
        cur_c = ((cur_a + 1) * cur_c) % m
        cur_a = (cur_a * cur_a) % m
        n >>= 1
    return A, C


def advance(x: int, n: int) -> int:
    """Root state ``n`` steps after ``x`` (host python ints)."""
    A, C = lcg_skip(n)
    return (A * x + C) & u64.M64


@functools.lru_cache(maxsize=None)
def block_affine_constants(block_len: int, a: int = MULTIPLIER,
                           c: int = DEFAULT_INCREMENT):
    """(A_t, C_t) for t in [0, block_len) as numpy uint32 limb arrays
    (A_hi, A_lo, C_hi, C_lo), each of shape (block_len,)."""
    out = np.empty((4, block_len), np.uint32)
    A, C = 1, 0
    for t in range(block_len):
        out[:, t] = (*u64.split64(A), *u64.split64(C))
        A, C = (a * A) & u64.M64, (a * C + c) & u64.M64
    return tuple(out)


def root_states_vector(x0: int, ctr: int, n: int, block: int = 256,
                       device="cpu") -> U64Pair:
    """Root states for positions ctr+1 .. ctr+n as (hi, lo) limbs of (n,).

    Two-level jump-ahead as in the reference: block starts are host
    jumps, and within a block one vector multiply-add by the
    ``block_affine_constants`` table gives each row.
    """
    q = -(-n // block)
    base = advance(x0, ctr)
    step_a, step_c = lcg_skip(block)
    starts = []
    x = base
    for _ in range(q):
        starts.append(u64.split64(x))
        x = (step_a * x + step_c) & u64.M64
    st = torch.tensor(starts, dtype=torch.int64, device=device).reshape(q, 2)
    A_hi, A_lo, C_hi, C_lo = (
        torch.from_numpy(v[1:].astype(np.int64)).to(device)
        for v in block_affine_constants(block + 1))
    states = u64.add64(
        u64.mul64((A_hi[None, :], A_lo[None, :]),
                  (st[:, 0:1], st[:, 1:2])),
        (C_hi[None, :], C_lo[None, :]))
    return states[0].reshape(-1)[:n], states[1].reshape(-1)[:n]


def xsh_rr(state: U64Pair) -> torch.Tensor:
    """PCG XSH-RR output permutation (O'Neill 2014), the paper's Sec. 3.4:
    ``ror32(uint32(((s >> 18) ^ s) >> 27), s >> 59)``."""
    x = u64.xor64(u64.shr64(state, 18), state)
    xorshifted = u64.shr64(x, 27)[1]
    rot = state[0] >> 27
    return u64.ror32(xorshifted, rot)


def truncate_hi(state: U64Pair) -> torch.Tensor:
    """Plain truncation output (Eq. 4), the un-permuted baseline: the high
    32 bits of the state."""
    return state[0]
