"""Probability-integral-transform reduction: shaped samples -> words.

The Crush-lite battery (``repro_torch.quality.crush``) and the inter-stream
cross-battery (``repro_torch.quality.cross``) consume uint32 word blocks; the
distribution stages (``repro_torch.core.sampler``) emit exponential / Poisson
/ gamma / categorical samples.  This module closes the loop: the PIT
maps each sample through its own CDF back to U[0, 1) — exactly uniform
when the sampler is correct — and packs the result into uint32 words the
existing batteries can test at full discriminating power.

  * **Continuous** stages (exponential, gamma): ``u = F(x)`` in float64,
    quantized to the top 24 bits (the samplers' native uniform
    resolution); the low 8 word bits come from an INDEPENDENT bits draw
    (``v_bits``) so every bit of the word is testable:
    ``word = (floor(u * 2**24) << 8) | (v_bits >> 24)``.
  * **Discrete** stages (poisson, categorical): the randomized PIT of
    Brockwell (2007): ``u = F(k-1) + V * p(k)`` with ``V`` uniform from
    ``v_bits`` — exactly U[0, 1) when the sampled pmf is correct;
    ``word = floor(u * 2**32)``.

A correct sampler therefore yields words indistinguishable from the raw
generator's, and a FLAWED upstream generator (the ``ablation/raw_lcg``
baseline pushed through ``exponential``) still fails the cross-battery
THROUGH the transform — the PIT preserves inter-stream correlation
rather than laundering it.

The gamma CDF needs the regularized lower incomplete gamma function
P(a, x); scipy is not a dependency of this repo, so it is hand-rolled in
vectorized float64 numpy — power series for ``x < a + 1``, modified
Lentz continued fraction for the complement above (Numerical Recipes
6.2) — accurate to ~1e-14, far below the 2**-24 quantization.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from repro_torch.core import sampler as sampler_mod

#: iteration caps for the incomplete-gamma series / continued fraction
#: (both converge in tens of terms for the battery's shape range k <= ~64)
_ITMAX = 800
_EPS = 1e-15


def _gamma_p_series(a: float, x: np.ndarray) -> np.ndarray:
    """P(a, x) by the power series (valid and fast for x < a + 1)."""
    ap = a
    total = np.full_like(x, 1.0 / a)
    term = total.copy()
    for _ in range(_ITMAX):
        ap += 1.0
        term = term * x / ap
        total = total + term
        if np.all(np.abs(term) < np.abs(total) * _EPS):
            break
    return total * np.exp(-x + a * np.log(x) - math.lgamma(a))


def _gamma_q_lentz(a: float, x: np.ndarray) -> np.ndarray:
    """Q(a, x) = 1 - P(a, x) by modified Lentz continued fraction
    (valid and fast for x >= a + 1)."""
    tiny = 1e-300
    b = x + 1.0 - a
    c = np.full_like(x, 1.0 / tiny)
    d = 1.0 / np.where(b == 0.0, tiny, b)
    h = d.copy()
    for i in range(1, _ITMAX + 1):
        an = -i * (i - a)
        b = b + 2.0
        d = an * d + b
        d = np.where(np.abs(d) < tiny, tiny, d)
        c = b + an / c
        c = np.where(np.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        delta = d * c
        h = h * delta
        if np.all(np.abs(delta - 1.0) < _EPS):
            break
    return h * np.exp(-x + a * np.log(x) - math.lgamma(a))


def regularized_gamma_p(shape: float, x: np.ndarray) -> np.ndarray:
    """Regularized lower incomplete gamma P(shape, x) — the Gamma(shape,
    scale 1) CDF — vectorized float64, no scipy.

    Example:
        >>> import numpy as np
        >>> from repro_torch.quality import pit
        >>> # P(1, x) is the exponential CDF 1 - exp(-x)
        >>> x = np.array([0.5, 2.0, 10.0])
        >>> bool(np.allclose(pit.regularized_gamma_p(1.0, x),
        ...                  -np.expm1(-x), atol=1e-13))
        True
        >>> # median of Gamma(2.5) is near 2.1759
        >>> float(np.round(pit.regularized_gamma_p(2.5,
        ...                np.array([2.17586]))[0], 4))
        0.5
    """
    a = float(shape)
    if not (a > 0.0):
        raise ValueError(f"shape must be > 0, got {shape!r}")
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros(x.shape, dtype=np.float64)
    pos = x > 0.0
    small = pos & (x < a + 1.0)
    large = pos & ~small
    if small.any():
        out[small] = _gamma_p_series(a, x[small])
    if large.any():
        out[large] = 1.0 - _gamma_q_lentz(a, x[large])
    return np.clip(out, 0.0, 1.0)


def continuous_cdf(kind: str, param, x: np.ndarray) -> np.ndarray:
    """Float64 CDF of a continuous distribution stage at ``x``."""
    x = np.asarray(x, dtype=np.float64)
    if kind == "exponential":
        return -np.expm1(-float(param) * np.maximum(x, 0.0))
    if kind == "gamma":
        # two-parameter sugar: Gamma(k, theta) CDF is P(k, x / theta)
        shape, scale = param if isinstance(param, tuple) else (param, 1.0)
        return regularized_gamma_p(float(shape), x / float(scale))
    if kind == "gumbel":
        return np.exp(-np.exp(-x))
    raise ValueError(f"not a continuous stage: {kind!r}")


def discrete_cdf_table(kind: str, param) -> np.ndarray:
    """Cumulative pmf table F(0..K-1) in float64 for a discrete stage.

    For poisson the support is truncated exactly where the sampler's
    threshold ladder stops (``sampler.poisson_thresholds``), then
    renormalized so the randomized PIT of the truncated law is exactly
    uniform — the battery tests the law the kernel actually implements.

    Example:
        >>> from repro_torch.quality import pit
        >>> [round(float(f), 4) for f in pit.discrete_cdf_table(
        ...     "categorical", (1.0, 1.0, 2.0))]
        [0.25, 0.5, 1.0]
    """
    if kind == "poisson":
        rate = float(param)
        n = len(sampler_mod.poisson_thresholds(rate))
        if n == 0:
            return np.array([1.0])
        k = np.arange(n + 1, dtype=np.float64)
        logpmf = k * math.log(rate) - rate - np.array(
            [math.lgamma(v + 1.0) for v in k])
        cdf = np.cumsum(np.exp(logpmf))
        return cdf / cdf[-1]
    if kind == "categorical":
        w = np.asarray(param, dtype=np.float64)
        cdf = np.cumsum(w)
        return cdf / cdf[-1]
    raise ValueError(f"not a discrete stage: {kind!r}")


def pit_words(samples: np.ndarray, spec, v_bits: np.ndarray) -> np.ndarray:
    """Reduce distribution-stage ``samples`` to battery-ready uint32.

    ``spec`` is a sampler spec string or parsed ``(kind, param)`` pair
    from ``sampler.parse``; ``v_bits`` is a same-shape uint32 block from
    an INDEPENDENT draw (a different engine purpose), consumed as the
    randomization of the discrete PIT and as the low 8 bits of the
    continuous words.  Returns a uint32 array of ``samples.shape``.

    Example:
        >>> import numpy as np
        >>> from repro_torch.quality import pit
        >>> x = np.array([0.1, 1.0, 5.0], dtype=np.float32)
        >>> v = np.zeros(3, dtype=np.uint32)
        >>> w = pit.pit_words(x, "exponential(1.0)", v)
        >>> (w.dtype, w.shape)
        (dtype('uint32'), (3,))
        >>> # words order like the CDF: monotone in x
        >>> bool((np.diff(w.astype(np.int64)) > 0).all())
        True
    """
    kind, param = sampler_mod.parse(spec) if isinstance(spec, str) else spec
    if kind not in sampler_mod.DISTRIBUTION_KINDS:
        raise ValueError(
            f"not a distribution stage: {kind!r}; "
            f"have {sampler_mod.DISTRIBUTION_KINDS}")
    x = np.asarray(samples, dtype=np.float64)
    v = np.asarray(v_bits)
    if v.dtype != np.uint32 or v.shape != x.shape:
        raise ValueError(
            f"v_bits must be uint32 of shape {x.shape}, got "
            f"{v.dtype}/{v.shape}")
    if kind in ("exponential", "gamma", "gumbel"):
        u = continuous_cdf(kind, param, x)
        j = np.minimum(np.floor(u * 2.0 ** 24),
                       2.0 ** 24 - 1.0).astype(np.uint32)
        return (j << np.uint32(8)) | (v >> np.uint32(24))
    cdf = discrete_cdf_table(kind, param)
    k = np.clip(np.rint(x).astype(np.int64), 0, len(cdf) - 1)
    lo = np.where(k > 0, cdf[np.maximum(k - 1, 0)], 0.0)
    p = cdf[k] - lo
    vv = v.astype(np.float64) * 2.0 ** -32
    u = lo + vv * p
    return np.minimum(np.floor(u * 2.0 ** 32),
                      2.0 ** 32 - 1.0).astype(np.uint32)
