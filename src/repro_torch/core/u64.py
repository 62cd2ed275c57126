"""Unsigned 64-bit arithmetic on pairs of 32-bit limbs, as torch tensors.

PyTorch cannot add, shift or compare ``uint32`` tensors on the CPU, so the
plain path holds each 32-bit limb in an ``int64`` tensor whose value lies
in ``[0, 2**32)``; every helper masks its results back into that range.
A u64 value ``x`` is the pair ``(x_hi, x_lo)`` with
``x = x_hi * 2**32 + x_lo``.

A 32x32 product does not fit a signed int64, so ``mul32_wide`` keeps the
16-bit half-limb decomposition of the reference: each partial product of
two 16-bit values fits with room to spare.  The CUDA kernels use native
``unsigned long long`` instead; the results are identical.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor
U64Pair = Tuple[Tensor, Tensor]

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
MASK16 = 0xFFFF


def split64(value: int) -> Tuple[int, int]:
    """Split a python int (mod 2**64) into (hi, lo) python ints."""
    value &= M64
    return (value >> 32) & M32, value & M32


def join64(hi, lo) -> int:
    """(hi, lo) ints -> python int."""
    return (int(hi) << 32) | int(lo)


def const64(value: int, device="cpu") -> U64Pair:
    """Python int -> (hi, lo) 0-dim int64 limb tensors."""
    hi, lo = split64(value)
    return (torch.tensor(hi, dtype=torch.int64, device=device),
            torch.tensor(lo, dtype=torch.int64, device=device))


def limbs(x) -> Tensor:
    """Any integer tensor or array of u32 values -> int64 limb tensor."""
    if not isinstance(x, Tensor):
        x = torch.as_tensor(x)
    if x.dtype in (torch.int32, torch.uint32):
        # reinterpret the 32-bit pattern, then widen without sign
        x = x.view(torch.int32).to(torch.int64) & M32
    return x.to(torch.int64)


def to_u32(x: Tensor) -> Tensor:
    """int64 limb tensor -> ``torch.uint32`` tensor of the same values."""
    return x.to(torch.uint32)


def mul32_lo(a: Tensor, b) -> Tensor:
    """(a * b) mod 2**32 for limbs: the wrapping uint32 multiply."""
    a_lo = a & MASK16
    a_hi = a >> 16
    return ((a_lo * b) + (((a_hi * b) & MASK16) << 16)) & M32


def mul32_wide(a: Tensor, b: Tensor) -> U64Pair:
    """Full 32x32 -> 64 bit product via 16-bit half-limbs."""
    a_lo = a & MASK16
    a_hi = a >> 16
    b_lo = b & MASK16
    b_hi = b >> 16
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> 16) + (lh & MASK16) + (hl & MASK16)
    lo = (ll & MASK16) | ((mid & MASK16) << 16)
    hi = (hh + (lh >> 16) + (hl >> 16) + (mid >> 16)) & M32
    return hi, lo


def add64(a: U64Pair, b: U64Pair) -> U64Pair:
    """(a + b) mod 2**64."""
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & M32, lo & M32


def mul64(a: U64Pair, b: U64Pair) -> U64Pair:
    """(a * b) mod 2**64."""
    ah, al = a
    bh, bl = b
    hi, lo = mul32_wide(al, bl)
    hi = (hi + mul32_lo(al, bh) + mul32_lo(ah, bl)) & M32
    return hi, lo


def xor64(a: U64Pair, b: U64Pair) -> U64Pair:
    return a[0] ^ b[0], a[1] ^ b[1]


def shr64(a: U64Pair, n: int) -> U64Pair:
    """Logical right shift by a static amount 0 <= n < 64."""
    ah, al = a
    if n == 0:
        return ah, al
    if n < 32:
        return ah >> n, ((al >> n) | (ah << (32 - n))) & M32
    return torch.zeros_like(ah), ah >> (n - 32)


def shl64(a: U64Pair, n: int) -> U64Pair:
    """Logical left shift by a static amount 0 <= n < 64."""
    ah, al = a
    if n == 0:
        return ah, al
    if n < 32:
        return ((ah << n) | (al >> (32 - n))) & M32, (al << n) & M32
    return (al << (n - 32)) & M32, torch.zeros_like(al)


def ror32(x: Tensor, r: Tensor) -> Tensor:
    """Rotate right a u32 limb by a per-element amount in [0, 31]."""
    r = r & 31
    return ((x >> r) | (x << ((32 - r) & 31))) & M32
