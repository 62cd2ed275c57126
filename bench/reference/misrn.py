"""Plain reference of the MISRN generator (ThundeRiNG, FPGA '21) in ctr mode.

Written from the generator's published definition, in plain torch on int64
tensors, whose additions and products wrap modulo 2**64 on the CPU and the
card alike.  It imports nothing of the program under test.

  root LCG    x_{n+1} = a x_n + c  (mod 2**64),  a, c of PCG64
  leaf        w = x_{ctr+1} + h_s  (mod 2**64),  h_s even
  permutation XSH-RR(w) (O'Neill 2014)
  decorrelator (ctr mode) splitmix64(h_s ^ K, ctr), its two halves XORed
  word        XSH-RR(w) ^ decorrelator, a u32

A family comes from a seed and a purpose by splitmix64; stream s of a family
has the leaf offset ``derive_leaf(h_family, s)``.
"""
from __future__ import annotations

import hashlib
import math
from typing import Tuple

import torch

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1
A_LCG = 6364136223846793005
C_LCG = 1442695040888963407
GAMMA = 0x9E3779B97F4A7C15
MIX1 = 0xBF58476D1CE4E5B9
MIX2 = 0x94D049BB133111EB
CTR_KEY = 0xD1B54A32D192ED03
FAMILY_ROOT_TAG = 0x1234
TINY_F32 = 1.1754943508222875e-38


def s64(v: int) -> int:
    """A u64 python int as the int64 holding the same bits."""
    v &= M64
    return v - (1 << 64) if v >> 63 else v


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the u64 bits in an int64 tensor."""
    return (x >> k) & ((1 << (64 - k)) - 1)


# -- host (python int) forms -------------------------------------------------

def mix64_int(z: int) -> int:
    z &= M64
    z ^= z >> 30
    z = (z * MIX1) & M64
    z ^= z >> 27
    z = (z * MIX2) & M64
    return z ^ (z >> 31)


def splitmix64_int(seed: int, index: int) -> int:
    return mix64_int(seed + (index + 1) * GAMMA)


def lcg_jump(n: int) -> Tuple[int, int]:
    """(A, C) with x_{k+n} = A x_k + C (mod 2**64)."""
    A, C, a, c = 1, 0, A_LCG, C_LCG
    while n > 0:
        if n & 1:
            A, C = (A * a) & M64, (C * a + c) & M64
        c, a = ((a + 1) * c) & M64, (a * a) & M64
        n >>= 1
    return A, C


def family(seed: int, purpose: int) -> Tuple[int, int]:
    """(x0, h_family) of a seed and purpose."""
    x0 = splitmix64_int(seed & M64, FAMILY_ROOT_TAG)
    h = (splitmix64_int(seed, purpose) << 1) & M64
    return x0, h


def name_tag(name: str) -> int:
    """The 64-bit tag of a name: blake2s-64 of its UTF-8 bytes, little
    endian (a channel's purpose)."""
    return int.from_bytes(hashlib.blake2s(name.encode("utf-8"),
                                          digest_size=8).digest(), "little")


def tenant_tag(tenant: str, region_bits: int = 16) -> int:
    """Slot 0 of a tenant's region: its name tag, low bits cleared."""
    return (name_tag(tenant) >> region_bits) << region_bits


def derive_leaf_int(h_parent: int, tag: int) -> int:
    return (splitmix64_int(h_parent, tag & M64) << 1) & M64


# -- tensor forms -------------------------------------------------------------

def mix64(z: torch.Tensor) -> torch.Tensor:
    z = z ^ _srl(z, 30)
    z = z * s64(MIX1)
    z = z ^ _srl(z, 27)
    z = z * s64(MIX2)
    return z ^ _srl(z, 31)


def splitmix64(seed: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return mix64(seed + (index + 1) * s64(GAMMA))


def leaves(h_family: int, streams: torch.Tensor) -> torch.Tensor:
    """(n,) int64 leaf offsets of the given stream indices of a family."""
    return splitmix64(torch.full_like(streams, s64(h_family)), streams) << 1


def roots(x0: int, counters: torch.Tensor) -> torch.Tensor:
    """Root state x_{c+1} for each counter c (int64 tensor, c >= 0), by a
    binary jump of 64 steps."""
    n = counters + 1
    x = torch.full_like(counters, s64(x0))
    for k in range(64):
        A, C = lcg_jump(1 << k)
        bit = ((n >> k) & 1).bool()
        x = torch.where(bit, x * s64(A) + s64(C), x)
    return x


def xsh_rr(state: torch.Tensor) -> torch.Tensor:
    x = _srl(_srl(state, 18) ^ state, 27) & M32
    rot = _srl(state, 59)
    return ((x >> rot) | (x << ((32 - rot) & 31))) & M32


def deco(h: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    z = splitmix64(h ^ s64(CTR_KEY), counters)
    return (_srl(z, 32) ^ z) & M32


def words(root: torch.Tensor, counters: torch.Tensor,
          h: torch.Tensor) -> torch.Tensor:
    """u32 words (as int64) of leaf offsets ``h`` at ``counters`` whose
    root states are ``root``; the three broadcast together."""
    return xsh_rr(root + h) ^ deco(h, counters)


def block(x0: int, h: torch.Tensor, lo: int, rows: int) -> torch.Tensor:
    """(rows, S) words of counters lo .. lo+rows-1 for the leaves ``h``."""
    c = torch.arange(lo, lo + rows, dtype=torch.int64, device=h.device)
    return words(roots(x0, c)[:, None], c[:, None], h[None, :])


def uniform(w: torch.Tensor) -> torch.Tensor:
    """U[0, 1) of a word's top 24 bits, exact in float64."""
    return (w >> 8).to(torch.float64) * 2.0 ** -24


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Standard normal (cos branch) of two uniforms, in their dtype."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, TINY_F32)))
    return r * torch.cos(2.0 * math.pi * u2)


def gumbel(w: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel of a word, in float64."""
    u = torch.clamp_min(uniform(w), TINY_F32)
    return -torch.log(-torch.log(u))
