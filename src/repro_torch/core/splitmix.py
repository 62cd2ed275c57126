"""SplitMix64 and the counter decorrelators, on u32 limbs.

SplitMix64 derives leaf offsets (``derive_leaf``) and serves as
the counter-mode decorrelator: ``splitmix64(h ^ K, counter)`` replaces the
paper's serial xorshift128 substream with a pure function of
(stream, position), keeping the two constraints of Sec. 3.2.3 (a family
unrelated to the LCG, disjoint inputs per stream).  ``fmix32`` is the
cheaper 32-bit variant.  The ``_host`` functions mirror each on python
ints.
"""
from __future__ import annotations

import torch

from repro_torch.core import u64
from repro_torch.core.u64 import M32, U64Pair

GAMMA = 0x9E3779B97F4A7C15
MIX1 = 0xBF58476D1CE4E5B9
MIX2 = 0x94D049BB133111EB
CTR_KEY = 0xD1B54A32D192ED03


def _const(value: int, like: torch.Tensor) -> U64Pair:
    """``value`` as 0-dim limbs on ``like``'s device, filled there: a copy
    from the host would wait for a card's queue to drain."""
    hi, lo = u64.split64(value)
    return (torch.full((), hi, dtype=torch.int64, device=like.device),
            torch.full((), lo, dtype=torch.int64, device=like.device))


def mix64(z: U64Pair) -> U64Pair:
    """The splitmix64 finalizer: z -> mixed 64-bit value."""
    z = u64.xor64(z, u64.shr64(z, 30))
    z = u64.mul64(z, _const(MIX1, z[0]))
    z = u64.xor64(z, u64.shr64(z, 27))
    z = u64.mul64(z, _const(MIX2, z[0]))
    return u64.xor64(z, u64.shr64(z, 31))


def splitmix64(seed: U64Pair, index: U64Pair) -> U64Pair:
    """mix64(seed + (index + 1) * GAMMA): pure counter-addressable."""
    one = _const(1, index[0])
    step = u64.mul64(u64.add64(index, one), _const(GAMMA, index[0]))
    return mix64(u64.add64(seed, step))


def mix64_host(z: int) -> int:
    """Python-int mirror of mix64."""
    m = u64.M64
    z &= m
    z ^= z >> 30
    z = (z * MIX1) & m
    z ^= z >> 27
    z = (z * MIX2) & m
    z ^= z >> 31
    return z


def splitmix64_host(seed: int, index: int) -> int:
    return mix64_host((seed + ((index + 1) * GAMMA)) & u64.M64)


def derive_leaf(h_parent: U64Pair, tag: U64Pair) -> U64Pair:
    """Child leaf offset: splitmix64(h_parent, tag) forced even (<< 1)."""
    return u64.shl64(splitmix64(h_parent, tag), 1)


def derive_leaf_host(h_parent: int, tag: int) -> int:
    """Python-int mirror of ``derive_leaf``."""
    return (splitmix64_host(h_parent, tag & u64.M64) << 1) & u64.M64


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer (2 multiplies) on a u32 limb."""
    x = x ^ (x >> 16)
    x = u64.mul32_lo(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = u64.mul32_lo(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def ctr_decorrelator32(h: U64Pair, counter: U64Pair) -> torch.Tensor:
    """Cheap 32-bit counter decorrelator: fmix32 of the counter folded
    into a seed word built from the 64-bit leaf offset."""
    hh, hl = h
    ch, cl = counter
    seed = hl ^ (((hh << 16) | (hh >> 16)) & M32)
    x = (seed + u64.mul32_lo(cl, 0x9E3779B9)
         + u64.mul32_lo(ch, 0x85EBCA77)) & M32
    return fmix32(x)


def ctr_decorrelator32_host(h: int, counter: int) -> int:
    hh, hl = (h >> 32) & M32, h & M32
    ch, cl = (counter >> 32) & M32, counter & M32
    seed = hl ^ (((hh << 16) | (hh >> 16)) & M32)
    x = (seed + cl * 0x9E3779B9 + ch * 0x85EBCA77) & M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    x ^= x >> 16
    return x


def ctr_decorrelator(h: U64Pair, counter: U64Pair) -> torch.Tensor:
    """Counter-mode decorrelator output (32 bits): the two halves of
    splitmix64(h ^ K, counter) XORed together."""
    z = splitmix64(u64.xor64(h, _const(CTR_KEY, h[0])), counter)
    return z[0] ^ z[1]


def ctr_decorrelator_host(h: int, counter: int) -> int:
    z = splitmix64_host(h ^ CTR_KEY, counter)
    return ((z >> 32) ^ z) & M32
