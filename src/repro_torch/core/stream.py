"""ThunderStream: the framework-facing MISRN API.

A ``ThunderStream`` is one logical random sequence of ThundeRiNG's stream
space: a shared root base state ``x0`` (one per family, the paper's RSGU),
a per-stream even leaf offset ``h`` (the paper's SOU) and a counter.
Value t of the stream is

  out_t = XSH_RR(A(t+1) x0 + C(t+1) + h) XOR decorrelator(h, t)

so every element is counter-addressable, and column s of a bulk block is
``random_bits`` of the stream derived with tag s.  Every draw goes through
``engine`` as a (N, 1) plan; on a card that is one launch of the ctr
kernel, spread over row tiles.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.u64 import M64


@dataclasses.dataclass(frozen=True)
class ThunderStream:
    """One ThundeRiNG stream: python-int state and the device it draws on.

    Example:
        >>> from repro_torch.core import stream
        >>> s = stream.new_stream(0, device="cpu")
        >>> s.ctr
        0
    """
    x0: int
    h: int
    ctr: int
    device: torch.device


def new_stream(seed: int, stream_id: int = 0, device=None) -> ThunderStream:
    """The root stream of a family, from a python-int seed."""
    x0, h = engine.family_from_seed(seed, stream_id)
    return ThunderStream(x0, h, 0, engine.resolve_device(device))


def derive(stream: ThunderStream, tag: int) -> ThunderStream:
    """fold_in: child stream with a fresh even leaf offset; counter reset."""
    return dataclasses.replace(
        stream, h=engine.derive_leaf_host(stream.h, int(tag)), ctr=0)


def split(stream: ThunderStream, num: int) -> List[ThunderStream]:
    """``num`` independent child streams."""
    return [derive(stream, i + 0x517CC1B7) for i in range(num)]


def advance(stream: ThunderStream, count: int) -> ThunderStream:
    """Advance the counter by ``count`` elements (advancing is slicing)."""
    return dataclasses.replace(stream, ctr=(stream.ctr + int(count)) & M64)


# ----------------------------------------------------------------------------
# Generation
# ----------------------------------------------------------------------------

def _numel(shape) -> int:
    return int(math.prod(shape)) if shape else 1


def _dtype_name(dtype: torch.dtype) -> str:
    return {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]


def random_bits(stream: ThunderStream, shape: Tuple[int, ...]
                ) -> torch.Tensor:
    """``torch.uint32`` bits of the given shape: elements ctr..ctr+N-1."""
    plan = engine.plan_for_stream(stream, _numel(shape))
    return engine.generate_flat(plan).reshape(shape)


def uniforms(stream: ThunderStream, shape=(), dtype=torch.float32
             ) -> torch.Tensor:
    """U[0, 1) samples via the fused uniform stage (element i is the
    transform of stream element ctr + i)."""
    plan = engine.plan_for_stream(stream, _numel(shape), sampler="uniform",
                                  out_dtype=_dtype_name(dtype))
    return engine.generate_flat(plan).reshape(shape)


def normals(stream: ThunderStream, shape=(), dtype=torch.float32
            ) -> torch.Tensor:
    """Standard normals via the fused Box-Muller stage; pairs elements
    (2k, 2k+1), so an odd count draws one extra element and drops it."""
    n = _numel(shape)
    plan = engine.plan_for_stream(stream, n + (n & 1), sampler="normal",
                                  out_dtype=_dtype_name(dtype))
    return engine.generate_flat(plan)[:n].reshape(shape)


def uniform(stream: ThunderStream, shape=(), dtype=torch.float32,
            minval=0.0, maxval=1.0) -> torch.Tensor:
    """U[minval, maxval) floats built from the top 24 bits."""
    u = uniforms(stream, shape, torch.float32)
    return (minval + u * (maxval - minval)).to(dtype)


#: XLA's single-precision inverse-erf polynomial (``ErfInv32``): the
#: coefficients for w < 5 and for w >= 5, highest degree first.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erf_inv32(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, the reference's ``lax.erf_inv``.

    XLA's ``ErfInv32`` in float32 tensor ops: w = -log1p(-x*x), shifted
    to w - 2.5 below 5 and sqrt(w) - 3 above, a degree-8 Horner
    polynomial in w, times x.  Each Horner step is a separate multiply and
    add, so no fused multiply-add can be contracted on any device.  For
    |x| < 1 only (the callers clamp); torch's own ``erfinv`` is more
    accurate near +-1 and up to ~90 ULP away from this form there.
    """
    x = x.to(torch.float32)
    w = torch.neg(torch.log1p(torch.neg(torch.mul(x, x))))
    lt = w < 5.0
    w = torch.where(lt, torch.sub(w, 2.5), torch.sub(torch.sqrt(w), 3.0))

    def coef(i: int) -> torch.Tensor:
        return torch.where(lt, torch.tensor(_ERFINV_W_LT_5[i], dtype=x.dtype,
                                            device=x.device),
                           torch.tensor(_ERFINV_W_GE_5[i], dtype=x.dtype,
                                        device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = torch.add(coef(i), torch.mul(p, w))
    return torch.mul(p, x)


def normal(stream: ThunderStream, shape=(), dtype=torch.float32
           ) -> torch.Tensor:
    """Standard normal via inverse-erf of U(-1, 1) (``erf_inv32``)."""
    u = uniform(stream, shape, torch.float32, -1.0, 1.0)
    tiny = np.float32(1e-7)
    u = torch.clamp(u, float(np.float32(-1.0) + tiny),
                    float(np.float32(1.0) - tiny))
    return (float(np.sqrt(np.float32(2.0))) * erf_inv32(u)).to(dtype)


def bernoulli(stream: ThunderStream, p, shape=()) -> torch.Tensor:
    """Boolean mask with P(True) = p.

    A python ``p`` uses the exact threshold round(p * 2**32) in the fused
    stage; a tensor ``p`` is clamped to [0, 1] and converted at float32.
    """
    if isinstance(p, (bool, int, float)):
        plan = engine.plan_for_stream(stream, _numel(shape),
                                      sampler=f"bernoulli({float(p)!r})")
        return engine.generate_flat(plan).reshape(shape)
    bits = random_bits(stream, shape).to(torch.int64)
    p32 = torch.clamp(torch.as_tensor(p, dtype=torch.float32,
                                      device=bits.device), 0.0, 1.0)
    # 4294967040 = 2**32 - 256, the largest float32 below 2**32
    thresh = torch.clamp(p32 * 2.0 ** 32, 0.0, 4294967040.0).to(torch.int64)
    return torch.where(p32 >= 1.0, True, bits < thresh)


def gumbel(stream: ThunderStream, shape=(), dtype=torch.float32
           ) -> torch.Tensor:
    """Standard Gumbel samples (for gumbel-max categorical sampling)."""
    u = uniform(stream, shape, torch.float32)
    tiny = float(np.float32(1e-20))
    return (-torch.log(-torch.log(u + tiny) + tiny)).to(dtype)


def categorical(stream: ThunderStream, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """Gumbel-max sampling along ``axis``."""
    g = gumbel(stream, tuple(logits.shape), logits.dtype)
    return torch.argmax(logits + g, dim=axis)
