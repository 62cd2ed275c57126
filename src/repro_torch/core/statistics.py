"""Statistical randomness battery (numpy, host-side).

TestU01/PractRand are C suites we cannot link here; this module implements
the *reportable analogues* used by the paper's evaluation tables:

  Table 2 analogue — per-stream battery: monobit, byte chi-square, runs,
                     lag-k serial correlation, spectral DC check.
  Table 3 analogue — inter-stream pairwise Pearson / Spearman / Kendall.
  Table 4 analogue — Hamming-weight dependency (correlation of popcounts of
                     consecutive / cross-stream outputs).

Every function takes uint32 arrays and returns plain floats; thresholds are
chosen for the sample sizes used in tests/benchmarks (see callers).

This module is also the home of the *p-value primitives* shared with the
Crush-lite battery (``repro_torch.quality``): the regularized incomplete gamma
function, exact chi-square / normal / Poisson tail probabilities, and the
Kolmogorov-Smirnov uniformity aggregate used for TestU01-style two-level
testing.  numpy-only — no scipy in this container.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np


def to_unit(x: np.ndarray) -> np.ndarray:
    return (x.astype(np.uint64) >> np.uint64(8)).astype(np.float64) * 2.0 ** -24


# ---------------------------------------------------------------------------
# p-value primitives (shared with repro_torch.quality)
# ---------------------------------------------------------------------------

def _gammainc_series_p(a: float, x: float) -> float:
    """P(a, x) by series expansion (valid branch: x < a + 1)."""
    ap, term, total = a, 1.0 / a, 1.0 / a
    for _ in range(1000):
        ap += 1.0
        term *= x / ap
        total += term
        if abs(term) < abs(total) * 1e-16:
            break
    return min(1.0, total * math.exp(-x + a * math.log(x) - math.lgamma(a)))


def _gammainc_cf_q(a: float, x: float) -> float:
    """Q(a, x) by modified-Lentz continued fraction (branch: x >= a + 1)."""
    tiny = 1e-300
    b = x + 1.0 - a
    c = 1.0 / tiny
    d = 1.0 / b
    h = d
    for i in range(1, 1000):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        if abs(d) < tiny:
            d = tiny
        c = b + an / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-16:
            break
    return min(1.0, math.exp(-x + a * math.log(x) - math.lgamma(a)) * h)


def gammainc_lower(a: float, x: float) -> float:
    """Regularized lower incomplete gamma P(a, x) (Numerical Recipes 6.2).

    Series expansion for x < a + 1, continued fraction otherwise; accurate
    to ~1e-12 over the ranges the battery uses (a up to a few thousand).
    """
    if x < 0 or a <= 0:
        raise ValueError(f"gammainc_lower needs x >= 0, a > 0; got a={a} x={x}")
    if x == 0.0:
        return 0.0
    if x < a + 1.0:
        return _gammainc_series_p(a, x)
    return max(0.0, 1.0 - _gammainc_cf_q(a, x))


def gammainc_upper(a: float, x: float) -> float:
    """Regularized upper incomplete gamma Q(a, x) = 1 - P(a, x).

    Each branch evaluates the representation that is accurate for its
    tail, so Q keeps full relative precision where P saturates at 1.
    """
    if x < a + 1.0:
        return max(0.0, 1.0 - gammainc_lower(a, x))
    return _gammainc_cf_q(a, x)


def chi2_sf(chi2: float, dof: int) -> float:
    """Exact survival function of the chi-square distribution."""
    if dof <= 0:
        raise ValueError(f"chi2_sf needs dof > 0, got {dof}")
    if chi2 <= 0.0:
        return 1.0
    return gammainc_upper(dof / 2.0, chi2 / 2.0)


def normal_sf(z: float) -> float:
    """Survival function of the standard normal, Phi(-z)."""
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def poisson_cdf(k: int, lam: float) -> float:
    """P(X <= k) for X ~ Poisson(lam); Q(k+1, lam) by the gamma identity."""
    if k < 0:
        return 0.0
    return gammainc_upper(k + 1.0, lam)


def poisson_two_sided(k: int, lam: float) -> float:
    """Two-sided Poisson p-value: 2 * min(P(X <= k), P(X >= k)), clipped.

    The aggregate used for the counting tests (birthday spacings,
    collision) where the per-block statistic is a small Poisson count:
    the battery sums counts over blocks so the second level is a single
    Poisson tail instead of a KS over coarsely discrete p-values.
    """
    lo = poisson_cdf(k, lam)
    hi = 1.0 - poisson_cdf(k - 1, lam)
    return float(min(1.0, 2.0 * min(lo, hi)))


def kolmogorov_pvalue(d: float, n: int) -> float:
    """P(D_n >= d) for the one-sample KS statistic (Stephens' correction)."""
    if n <= 0:
        return 1.0
    if d <= 0.0:
        return 1.0
    rn = math.sqrt(n)
    k = (rn + 0.12 + 0.11 / rn) * d
    total = 0.0
    for j in range(1, 101):
        term = 2.0 * (-1.0) ** (j - 1) * math.exp(-2.0 * j * j * k * k)
        total += term
        if abs(term) < 1e-16:
            break
    return float(min(1.0, max(0.0, total)))


def ks_uniform_pvalue(pvalues: np.ndarray) -> float:
    """Second-level TestU01 aggregate: KS test of p-values against U(0,1).

    Given the first-level p-values of one test over many blocks/streams,
    returns the p-value of the hypothesis that they are uniform — small
    when the per-block statistics are collectively biased even if no
    single block fails outright.
    """
    p = np.sort(np.asarray(pvalues, dtype=np.float64))
    n = p.size
    if n == 0:
        return 1.0
    i = np.arange(1, n + 1, dtype=np.float64)
    d_plus = float(np.max(i / n - p))
    d_minus = float(np.max(p - (i - 1.0) / n))
    return kolmogorov_pvalue(max(d_plus, d_minus), n)


def monobit_fraction(bits: np.ndarray) -> float:
    """Fraction of one-bits; ideal 0.5."""
    bits = np.ascontiguousarray(bits)
    pop = np.unpackbits(bits.view(np.uint8))
    return float(pop.mean())


def byte_chi2_pvalue(bits: np.ndarray) -> float:
    """Chi-square uniformity over byte values; returns p-value.

    Empty input returns 1.0 (nothing to reject); short inputs are legal —
    the exact chi-square tail keeps the p-value meaningful (if weak)
    where the old Wilson-Hilferty normal approximation degraded.
    """
    bits = np.ascontiguousarray(bits)
    if bits.size == 0:
        return 1.0
    counts = np.bincount(bits.view(np.uint8), minlength=256)
    n = counts.sum()
    expected = n / 256.0
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    return chi2_sf(chi2, 255)


def runs_statistic(bits: np.ndarray) -> float:
    """Normalized runs-test z-score on the bit sequence (ideal ~0)."""
    b = np.unpackbits(np.ascontiguousarray(bits).view(np.uint8)).astype(np.int8)
    n = b.size
    pi = b.mean()
    runs = 1 + int((b[1:] != b[:-1]).sum())
    expected = 2 * n * pi * (1 - pi) + 1
    var = 2 * n * pi * (1 - pi) * (2 * n * pi * (1 - pi) - 1) / max(n - 1, 1)
    return float((runs - expected) / np.sqrt(max(var, 1e-12)))


def lag_autocorr(bits: np.ndarray, lag: int = 1) -> float:
    u = to_unit(bits)
    a = u[:-lag] - u[:-lag].mean()
    b = u[lag:] - u[lag:].mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / max(denom, 1e-30))


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    """Centered correlation with a zero-variance guard: a constant input
    carries no linear relationship, so the correlation is 0.0 (not NaN)."""
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    if denom == 0.0:
        return 0.0
    return float((a * b).sum() / denom)


def pearson(x: np.ndarray, y: np.ndarray) -> float:
    """Pearson correlation of the unit-mapped values; 0.0 for constant
    input (zero-variance guard)."""
    return _corr(to_unit(x), to_unit(y))


def spearman(x: np.ndarray, y: np.ndarray) -> float:
    """Spearman rank correlation; 0.0 for n < 2 or constant ranks."""
    if min(len(x), len(y)) < 2:
        return 0.0
    rx = np.argsort(np.argsort(x, kind="stable")).astype(np.float64)
    ry = np.argsort(np.argsort(y, kind="stable")).astype(np.float64)
    return _corr(rx, ry)


def kendall(x: np.ndarray, y: np.ndarray, max_n: int = 1500) -> float:
    """Kendall tau-a on a subsample (O(n^2)); 0.0 for n < 2 (no pairs)."""
    n = min(len(x), len(y), max_n)
    if n < 2:
        return 0.0
    xs = x[:n].astype(np.int64)
    ys = y[:n].astype(np.int64)
    dx = np.sign(xs[:, None] - xs[None, :])
    dy = np.sign(ys[:, None] - ys[None, :])
    iu = np.triu_indices(n, 1)
    concordant = (dx[iu] * dy[iu]).sum()
    total = n * (n - 1) // 2
    return float(concordant / total)


def hamming_weight_dependency(bits: np.ndarray) -> float:
    """Correlation between popcounts of consecutive outputs (HWD-lite).

    The full Blackman-Vigna HWD test counts generated numbers until an
    anomaly; with fixed host budgets we instead report |corr| of adjacent
    popcounts (ideal 0; the paper's LCG-without-decorrelation shows a
    strong positive value here).
    """
    bits = np.ascontiguousarray(bits)
    pc = np.unpackbits(bits.view(np.uint8)).reshape(bits.size, 32).sum(axis=1)
    pc = pc.astype(np.float64)
    a = pc[:-1] - pc[:-1].mean()
    b = pc[1:] - pc[1:].mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / max(denom, 1e-30))


def interleave(streams: np.ndarray) -> np.ndarray:
    """Round-robin interleave (num_streams, n) -> (num_streams*n,) — the
    inter-stream testing method of Li et al. adopted by the paper."""
    return streams.T.reshape(-1)


def intra_stream_report(bits: np.ndarray) -> Dict[str, float]:
    return {
        "monobit": monobit_fraction(bits),
        "byte_chi2_p": byte_chi2_pvalue(bits),
        "runs_z": runs_statistic(bits),
        "lag1_autocorr": lag_autocorr(bits, 1),
        "lag7_autocorr": lag_autocorr(bits, 7),
        "hwd": hamming_weight_dependency(bits),
    }


def inter_stream_report(streams: np.ndarray) -> Dict[str, float]:
    """Max pairwise stats over all stream pairs plus interleaved battery."""
    k = streams.shape[0]
    max_p = max_s = max_k = 0.0
    for i in range(k):
        for j in range(i + 1, k):
            max_p = max(max_p, abs(pearson(streams[i], streams[j])))
            max_s = max(max_s, abs(spearman(streams[i], streams[j])))
            max_k = max(max_k, abs(kendall(streams[i], streams[j])))
    inter = interleave(streams)
    rep = {"max_pearson": max_p, "max_spearman": max_s, "max_kendall": max_k,
           "interleaved_hwd": hamming_weight_dependency(inter),
           "interleaved_monobit": monobit_fraction(inter),
           "interleaved_chi2_p": byte_chi2_pvalue(inter)}
    return rep
