"""xorshift128 decorrelator (Marsaglia 2003) with GF(2) jump-ahead.

ThundeRiNG (Sec. 3.2.3) decorrelates the LCG leaf streams by XORing each
with a substream of one xorshift128 generator, substreams spaced 2**64
steps apart so that no two overlap (Sec. 5.1.2).  xorshift128 is
F2-linear: the 128-bit state advances by a fixed bit matrix ``M``, and a
jump by N steps is a product with ``M**N``.  The matrices and jumps are
host-side numpy and python-int code (the paper's "compile time",
Sec. 4.2); ``step_xyzw`` is the per-row step on u32 limb tensors, and
``jump_tensor`` the plain torch form of a jump over a tensor of states
(the reference's ``jump_traced``; the card runs it in
``csrc/thundering_block.cu``).

State layout: (x, y, z, w) four uint32 words; the output is the new ``w``.
Bit k of the flattened 128-bit state is bit (k % 32) of word (k // 32).
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.u64 import M32

# Default seed from Marsaglia's paper.
DEFAULT_SEED = (123456789, 362436069, 521288629, 88675123)

STATE_WORDS = 4
STATE_BITS = 128


def step_words(x: int, y: int, z: int, w: int) -> Tuple[int, int, int, int]:
    """One xorshift128 step on python ints."""
    t = (x ^ (x << 11)) & M32
    x, y, z = y, z, w
    w = (w ^ (w >> 19)) ^ (t ^ (t >> 8))
    return x, y, z, w & M32


def step_xyzw(x, y, z, w):
    """One step on four u32 limb tensors (int64 holding u32 values)."""
    t = (x ^ (x << 11)) & M32
    new_w = (w ^ (w >> 19)) ^ (t ^ (t >> 8))
    return y, z, w, new_w


# ----------------------------------------------------------------------------
# GF(2) linear algebra (host side, exact).  A 128x128 bit matrix is a list
# of 128 column ints: column j = M @ e_j.  M @ v = XOR of columns at v's
# set bits.
# ----------------------------------------------------------------------------

def _state_to_int(words: Tuple[int, int, int, int]) -> int:
    v = 0
    for k, word in enumerate(words):
        v |= (int(word) & M32) << (32 * k)
    return v


def _int_to_state(v: int) -> Tuple[int, int, int, int]:
    return tuple((v >> (32 * k)) & M32 for k in range(4))


def _matvec(cols: List[int], v: int) -> int:
    out = 0
    while v:
        lsb = v & -v
        out ^= cols[lsb.bit_length() - 1]
        v ^= lsb
    return out


def _matmul(a_cols: List[int], b_cols: List[int]) -> List[int]:
    """(A @ B): column j of the result = A @ (column j of B)."""
    return [_matvec(a_cols, bj) for bj in b_cols]


@functools.lru_cache(maxsize=None)
def step_matrix() -> Tuple[int, ...]:
    """The xorshift128 transition as 128 column ints."""
    return tuple(_state_to_int(step_words(*_int_to_state(1 << j)))
                 for j in range(STATE_BITS))


@functools.lru_cache(maxsize=None)
def matrix_pow2(k: int) -> Tuple[int, ...]:
    """M**(2**k) as column ints, by repeated squaring (cached)."""
    if k == 0:
        return step_matrix()
    prev = list(matrix_pow2(k - 1))
    return tuple(_matmul(prev, prev))


def jump(words: Tuple[int, int, int, int], n: int) -> Tuple[int, int, int, int]:
    """Advance a state by n steps via the binary decomposition of n."""
    v = _state_to_int(words)
    k = 0
    n = int(n)
    while n:
        if n & 1:
            v = _matvec(list(matrix_pow2(k)), v)
        n >>= 1
        k += 1
    return _int_to_state(v)


def substream_state(words: Tuple[int, int, int, int], i: int,
                    log2_spacing: int = 64) -> Tuple[int, int, int, int]:
    """Start state of substream i: base advanced by i * 2**log2_spacing."""
    return jump(words, i << log2_spacing)


@functools.lru_cache(maxsize=None)
def lane_table(num_lanes: int, seed: Tuple[int, int, int, int] = DEFAULT_SEED,
               log2_spacing: int = 64) -> np.ndarray:
    """Start states for lanes 0..num_lanes-1, shape (num_lanes, 4) uint32:
    lane i is substream i, one matvec by J = M**(2**64) per lane."""
    J = list(matrix_pow2(log2_spacing))
    out = np.empty((num_lanes, 4), np.uint32)
    v = _state_to_int(seed)
    for i in range(num_lanes):
        out[i] = np.array(_int_to_state(v), np.uint32)
        v = _matvec(J, v)
    out.flags.writeable = False   # cached: shared by every caller
    return out


@functools.lru_cache(maxsize=None)
def _packed_pow2_matrices(max_log2: int = 64) -> np.ndarray:
    """M**(2**k) for k in [0, max_log2) as packed rows, shape
    (max_log2, 128, 4) uint32: output bit r = parity(row_r & state)."""
    out = np.empty((max_log2, STATE_BITS, STATE_WORDS), np.uint32)
    for k in range(max_log2):
        rows = [0] * STATE_BITS
        for j, col in enumerate(matrix_pow2(k)):
            c = col
            while c:
                lsb = c & -c
                rows[lsb.bit_length() - 1] |= 1 << j
                c ^= lsb
        for r in range(STATE_BITS):
            for wd in range(STATE_WORDS):
                out[k, r, wd] = (rows[r] >> (32 * wd)) & M32
    return out


@functools.lru_cache(maxsize=None)
def _pow2_nibble_tables(max_log2: int = 64) -> np.ndarray:
    """M**(2**k) for k in [0, max_log2) as nibble tables, shape
    (max_log2, 32, 16, 4) uint32: entry [k, p, v] is M**(2**k) applied to
    the state whose only set bits are v << 4p, the XOR of columns 4p + b for
    the set bits b of v.  A matvec is then 32 lookups and their XOR (the
    card's jump kernels read this form)."""
    cols = np.array([[_int_to_state(c) for c in matrix_pow2(k)]
                     for k in range(max_log2)], np.uint32)
    cols = cols.reshape(max_log2, 32, 4, STATE_WORDS)          # [k, p, b, w]
    v = np.arange(16)
    out = np.zeros((max_log2, 32, 16, STATE_WORDS), np.uint32)
    for b in range(4):
        out[:, :, (v >> b) & 1 == 1, :] ^= cols[:, :, b, None, :]
    return out


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _popcount_u32(a: np.ndarray) -> np.ndarray:
    if hasattr(np, "bitwise_count"):  # numpy >= 2.0
        return np.bitwise_count(a)
    return _POPCOUNT8[a.view(np.uint8)].reshape(a.shape + (4,)).sum(-1)


def _matvec_batch(mat: np.ndarray, states: np.ndarray) -> np.ndarray:
    """One packed GF(2) matvec over a whole (S, 4) state table."""
    acc = mat[None, :, :] & states[:, None, :]                   # (S, 128, 4)
    parity = _popcount_u32(acc).astype(np.uint32).sum(-1) & 1    # (S, 128)
    bits = parity.reshape(states.shape[0], 4, 32).astype(np.uint32)
    return (bits << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)


def jump_batch(states: np.ndarray, n: int) -> np.ndarray:
    """Advance a whole (S, 4) uint32 state table by n steps at once: one
    packed-matrix matvec per set bit of n, over all S lanes together."""
    states = np.asarray(states, np.uint32)
    mats = _packed_pow2_matrices(64)
    n = int(n)
    k = 0
    while n:
        if n & 1:
            states = _matvec_batch(mats[k], states)
        n >>= 1
        k += 1
    return states


def states_at(states: np.ndarray, offsets: Sequence[int]) -> np.ndarray:
    """(K, 4, S) uint32: an (S, 4) state table advanced by each of the
    non-decreasing ``offsets``, one ``jump_batch`` per distinct offset."""
    tbl = np.asarray(states, np.uint32)
    out = np.empty((len(offsets), STATE_WORDS, tbl.shape[0]), np.uint32)
    at = 0
    for i, off in enumerate(offsets):
        if off != at:
            tbl = jump_batch(tbl, off - at)
            at = off
        out[i] = tbl.T
    return out


@functools.lru_cache(maxsize=None)
def _pow2_matrix_limbs() -> torch.Tensor:
    return torch.from_numpy(_packed_pow2_matrices(64).astype(np.int64))


def _matvec_limbs(mat: torch.Tensor, states: torch.Tensor) -> torch.Tensor:
    """One packed GF(2) matvec of (..., 4) limb states: output bit r is the
    parity of row_r & state, the parity of the xor of its four words."""
    acc = mat & states[..., None, :]                              # (..., 128, 4)
    x = acc[..., 0] ^ acc[..., 1] ^ acc[..., 2] ^ acc[..., 3]      # (..., 128)
    for shift in (16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    bits = (x & 1).reshape(x.shape[:-1] + (STATE_WORDS, 32))
    return (bits << torch.arange(32, device=bits.device)).sum(-1)


def jump_tensor(states: torch.Tensor, n_hi, n_lo) -> torch.Tensor:
    """Advance (..., 4) xorshift128 states, u32 limbs in int64, by the
    64-bit count (n_hi, n_lo): ints, or limb tensors that broadcast
    against ``states.shape[:-1]`` (one count per state).

    The semantics of the reference's ``jump_traced``: 64 conditional
    packed matvecs by M**(2**k), k = 0..63, each applied where bit k of the
    count is set.  Plain torch on any device; used to check the card's jump.
    """
    mats = _pow2_matrix_limbs().to(states.device)
    n_hi = torch.as_tensor(n_hi, dtype=torch.int64, device=states.device)
    n_lo = torch.as_tensor(n_lo, dtype=torch.int64, device=states.device)
    for k in range(64):
        bit = ((n_lo >> k) if k < 32 else (n_hi >> (k - 32))) & 1
        if not bool(bit.any()):
            continue
        jumped = _matvec_limbs(mats[k], states)
        states = torch.where((bit == 1)[..., None], jumped, states)
    return states
