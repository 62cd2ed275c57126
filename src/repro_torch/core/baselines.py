"""Baseline PRNGs the paper compares against (Table 1 / 5 / 6), in torch.

All in the port's u32-limb arithmetic (``core.u64``: each 32-bit limb in
an int64 tensor) on the caller's device, the card unless ``device="cpu"``,
bit for bit the reference's:

  * philox4x32-10  (Salmon et al. 2011)    - counter-based, crush-resistant
  * xoroshiro128** (Blackman & Vigna 2018) - sequential, crush-resistant
  * pcg_xsh_rs_64  (O'Neill 2014)          - sequential LCG + XSH-RS
  * raw_lcg        (truncation output only) - the paper's correlation
    strawman (Table 3 "LCG Baseline")

The sequential generators step S parallel instances at once in a loop
over steps (the reference's ``lax.scan``); the raw LCG's shared root is a
closed-form jump per row (``lcg.root_states_vector``); philox is a map
over counters.  Each block generator returns ``(num_streams, num_steps)``
``torch.uint32``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import engine, lcg, splitmix, u64
from repro_torch.core.u64 import M32, U64Pair

# ----------------------------------------------------------------------------
# Philox 4x32-10
# ----------------------------------------------------------------------------

_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85


def philox4x32(counter: Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor],
               key: Tuple[torch.Tensor, torch.Tensor], rounds: int = 10):
    """Philox4x32 block: 4 u32 limb outputs per (counter, key)."""
    c0, c1, c2, c3 = (u64.limbs(c) for c in counter)
    k0, k1 = (u64.limbs(k) for k in key)
    m0 = torch.full_like(c0, _PHILOX_M0)
    m1 = torch.full_like(c2, _PHILOX_M1)
    for _ in range(rounds):
        hi0, lo0 = u64.mul32_wide(m0, c0)
        hi1, lo1 = u64.mul32_wide(m1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & M32
        k1 = (k1 + _PHILOX_W1) & M32
    return c0, c1, c2, c3


def philox_bits(seed: int, num_streams: int, num_steps: int,
                device=None) -> torch.Tensor:
    """(num_streams, num_steps) uint32; stream = key, step block = counter."""
    assert num_steps % 4 == 0, "philox emits 4 words per block"
    device = engine.resolve_device(device)
    nblk = num_steps // 4
    sid = torch.arange(num_streams, dtype=torch.int64, device=device)[:, None]
    blk = torch.arange(nblk, dtype=torch.int64, device=device)[None, :]
    zeros = torch.zeros_like(sid * blk)
    c = (blk + zeros, zeros, zeros, zeros)
    key = (sid + zeros, torch.full_like(zeros, seed & M32))
    out = torch.stack(philox4x32(c, key), dim=-1)
    return u64.to_u32(out.reshape(num_streams, num_steps))


# ----------------------------------------------------------------------------
# xoroshiro128**
# ----------------------------------------------------------------------------

def _rotl64_or(x: U64Pair, k: int) -> U64Pair:
    a = u64.shl64(x, k)
    b = u64.shr64(x, 64 - k)
    return a[0] | b[0], a[1] | b[1]


def _seeded(seed: int, index: torch.Tensor) -> U64Pair:
    """splitmix64(seed, index) for every stream index."""
    return splitmix.splitmix64(u64.const64(seed, index.device),
                               (torch.zeros_like(index), index))


def xoroshiro_step(s0: U64Pair, s1: U64Pair):
    """One xoroshiro128** step -> (new_s0, new_s1, out32).

    out64 = rotl(s0 * 5, 7) * 9; the high 32 bits are emitted.
    """
    five = u64.const64(5, s0[0].device)
    nine = u64.const64(9, s0[0].device)
    r = u64.mul64(_rotl64_or(u64.mul64(s0, five), 7), nine)
    s1x = u64.xor64(s1, s0)
    new_s0 = u64.xor64(u64.xor64(_rotl64_or(s0, 24), s1x), u64.shl64(s1x, 16))
    new_s1 = _rotl64_or(s1x, 37)
    return new_s0, new_s1, r[0]


def xoroshiro_bits(seed: int, num_streams: int, num_steps: int,
                   device=None) -> torch.Tensor:
    """(num_streams, num_steps), streams seeded by splitmix64."""
    device = engine.resolve_device(device)
    sid = torch.arange(num_streams, dtype=torch.int64, device=device)
    s0 = _seeded(seed, sid)
    s1 = splitmix.splitmix64(s0, (torch.zeros_like(sid), (sid + 7) & M32))
    outs = []
    for _ in range(num_steps):
        s0, s1, out = xoroshiro_step(s0, s1)
        outs.append(out)
    return u64.to_u32(torch.stack(outs, dim=1))


# ----------------------------------------------------------------------------
# PCG XSH-RS 64/32 (multistream via odd increments)
# ----------------------------------------------------------------------------

def _shr64_dyn32(x: U64Pair, n: torch.Tensor) -> torch.Tensor:
    """low 32 bits of (x >> n) for per-element 0 < n < 32."""
    hi, lo = x
    return ((lo >> n) | (hi << (32 - n))) & M32


def pcg_xsh_rs_out(state: U64Pair) -> torch.Tensor:
    """XSH-RS output: uint32((state ^ (state >> 22)) >> (22 + (state >> 61)))."""
    x = u64.xor64(state, u64.shr64(state, 22))
    count = (state[0] >> 29) + 22  # state>>61 == hi>>29
    return _shr64_dyn32(x, count)


def pcg_xsh_rs_bits(seed: int, num_streams: int, num_steps: int,
                    device=None) -> torch.Tensor:
    device = engine.resolve_device(device)
    sid = torch.arange(num_streams, dtype=torch.int64, device=device)
    s = _seeded(seed, sid)
    # per-stream odd increment (multistream)
    inc = splitmix.splitmix64(s, (torch.zeros_like(sid), sid ^ 0xDECAF))
    inc = (inc[0], inc[1] | 1)
    a = u64.const64(lcg.MULTIPLIER, device)
    outs = []
    for _ in range(num_steps):
        outs.append(pcg_xsh_rs_out(s))
        s = u64.add64(u64.mul64(a, s), inc)
    return u64.to_u32(torch.stack(outs, dim=1))


# ----------------------------------------------------------------------------
# Raw LCG (correlation strawman)
# ----------------------------------------------------------------------------

def raw_lcg_bits(seed: int, num_streams: int, num_steps: int,
                 permute: bool = False, h_mode: str = "adjacent",
                 device=None) -> torch.Tensor:
    """Increment-parameterized LCG streams with NO decorrelation (and
    optionally no permutation): the paper's Table 3/4 ablation baselines.

    Streams share the root x_{t+1} = a x_t + c (x_0 = seed | 1) and differ
    only in the leaf offset h; step t emits XSH-RR (``permute``) or the
    high word of x_{t+1} + h.

    ``h_mode``:
      * "adjacent" - h = 2i (tiny adjacent offsets), the paper's Table 3
        "LCG Baseline" worst case;
      * "spread" - h derived by splitmix64 (even), ThundeRiNG's own offset
        derivation, isolating the decorrelator's contribution.
    """
    device = engine.resolve_device(device)
    sid = torch.arange(num_streams, dtype=torch.int64, device=device)
    if h_mode == "adjacent":
        h = (sid >> 31, (sid << 1) & M32)  # h = 2i, even
    elif h_mode == "spread":
        h = u64.shl64(_seeded(seed, sid), 1)  # even
    else:
        raise ValueError(h_mode)
    r_hi, r_lo = lcg.root_states_vector(seed | 1, 0, num_steps,
                                        device=device)
    leaf = u64.add64((r_hi[:, None], r_lo[:, None]),
                     (h[0][None, :], h[1][None, :]))
    out = lcg.xsh_rr(leaf) if permute else lcg.truncate_hi(leaf)
    return u64.to_u32(out.T.contiguous())
