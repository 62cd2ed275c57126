"""Crush-lite: the per-block statistical tests of the quality battery.

Each test here is a vectorized numpy implementation of a TestU01
SmallCrush / NIST SP 800-22 style test, scaled to fixed host budgets.
Every function takes one *block* — a 1-D uint32 word sequence (one
stream column of an engine ``(T, S)`` draw) — and returns a first-level
result: either a p-value (chi-square family) or a raw count with its
Poisson mean (counting family), which ``repro_torch.quality.battery``
aggregates across blocks TestU01-style:

  * chi-square family (``gap``, ``serial``, ``matrix_rank``,
    ``spectral``, ``longest_run``): one p-value per block, second level
    = Kolmogorov-Smirnov uniformity of the per-block p-values
    (``statistics.ks_uniform_pvalue``).
  * counting family (``birthday_spacings``, ``collision``): the
    per-block statistic is a small Poisson count whose p-value is too
    discrete for a KS aggregate, so the second level SUMS the counts
    over blocks and takes one two-sided Poisson tail — the same move
    TestU01 makes for its Poisson-distributed statistics.

Test sizes (number of birthdays, urn counts, gap category cut) are pure
functions of the block length, so a profile fixes the whole battery
shape and the report regenerates byte-identically.

References: Marsaglia's birthday spacings / collision (Diehard; Knuth
TAoCP 3.3.2), the NIST SP 800-22 rank / spectral / longest-run tests
with the published class probabilities, and L'Ecuyer & Simard's TestU01
two-level methodology (the Bakiri et al. FPGA survey in PAPERS.md shows
why the F2-linear-sensitive rank test belongs in the battery).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core import statistics as st

# ---------------------------------------------------------------------------
# counting family: first level returns (count, poisson_mean)
# ---------------------------------------------------------------------------

_POISSON_TARGET = 8.0  # per-block Poisson mean the sizes aim for


def birthday_sizes(n_words: int) -> Tuple[int, int]:
    """(num_birthdays m, log2 days) with collision mean m^3/(4d) ~ 8."""
    m = n_words
    # d = 2**b days; pick b so lambda = m^3 / 2**(b+2) lands nearest 8
    b = int(round(3 * np.log2(m) - 2 - np.log2(_POISSON_TARGET)))
    return m, max(8, min(32, b))


def birthday_spacings(words: np.ndarray) -> Tuple[int, float]:
    """Marsaglia birthday spacings: (collision count, Poisson mean).

    m "birthdays" are the top b bits of the words; among the sorted
    spacings, values occurring more than once are collisions, which are
    asymptotically Poisson(m^3 / 4d) for d = 2**b days.
    """
    m, b = birthday_sizes(words.size)
    days = (words[:m] >> np.uint32(32 - b)).astype(np.uint64)
    spacings = np.sort(np.diff(np.sort(days)))
    collisions = int((np.diff(spacings) == 0).sum())
    lam = float(m) ** 3 / (4.0 * 2.0 ** b)
    return collisions, lam


def collision_sizes(n_words: int) -> Tuple[int, int]:
    """(num_throws m, log2 urns) with collision mean m^2/(2d) ~ 8."""
    m = n_words
    b = int(round(2 * np.log2(m) - 1 - np.log2(_POISSON_TARGET)))
    return m, max(8, min(32, b))


def collision(words: np.ndarray) -> Tuple[int, float]:
    """Knuth collision test: throw m balls into d = 2**b urns; the number
    of collisions is asymptotically Poisson(m^2 / 2d) for sparse tables.
    Returns (collision count, Poisson mean)."""
    m, b = collision_sizes(words.size)
    urns = words[:m] >> np.uint32(32 - b)
    collisions = int(m - np.unique(urns).size)
    lam = float(m) ** 2 / (2.0 * 2.0 ** b)
    return collisions, lam


# ---------------------------------------------------------------------------
# chi-square family: first level returns a p-value per block
# ---------------------------------------------------------------------------

def gap(words: np.ndarray, p: float = 0.125) -> float:
    """Knuth gap test: lengths of gaps between visits to [0, p).

    Gap lengths are geometric(p); counts over categories 0..t and >t are
    chi-squared against the exact geometric probabilities, with t set so
    the tail category keeps an expected count >= ~5.
    """
    u = words.astype(np.float64) * 2.0 ** -32
    hits = np.flatnonzero(u < p)
    if hits.size < 2:
        return 1.0  # not enough events for a gap spectrum at this size
    gaps = np.diff(hits) - 1
    n = gaps.size
    # t: geometric tail q**t * n >= 5  =>  t = log(5/n) / log(q)
    q = 1.0 - p
    t = max(1, int(np.log(5.0 / n) / np.log(q)))
    counts = np.bincount(np.minimum(gaps, t), minlength=t + 1)
    probs = p * q ** np.arange(t + 1, dtype=np.float64)
    probs[t] = q ** t  # tail: P(gap >= t)
    expected = probs * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    return st.chi2_sf(chi2, t)


def serial(words: np.ndarray) -> float:
    """Serial (overlapping-free) pair test on 4-bit nibbles: chi-square of
    non-overlapping (nibble, nibble) pairs over 256 cells — sensitive to
    sequential dependence that plain frequency tests miss."""
    nib = _nibbles(words)
    pairs = (nib[0::2].astype(np.int32) << 4) | nib[1::2]
    n = pairs.size
    counts = np.bincount(pairs, minlength=256)
    expected = n / 256.0
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    return st.chi2_sf(chi2, 255)


def _nibbles(words: np.ndarray) -> np.ndarray:
    b = np.ascontiguousarray(words).view(np.uint8)
    return np.stack([b >> 4, b & 0x0F], axis=-1).reshape(-1)


# NIST SP 800-22 3.5: rank distribution of random 32x32 GF(2) matrices
_RANK_P32 = 0.2887880950866024   # prod_{j=0..31} (1 - 2**(j-32))
_RANK_P31 = 0.5775761901732048   # 2 * p32 (exact for m = q = 32)
_RANK_PLO = 1.0 - _RANK_P32 - _RANK_P31


def gf2_rank32(rows: np.ndarray) -> int:
    """Rank over GF(2) of one 32x32 bit matrix given as 32 uint32 rows."""
    rows = [int(r) for r in rows]
    rank = 0
    for col in range(31, -1, -1):
        bit = 1 << col
        pivot = next((i for i in range(rank, len(rows)) if rows[i] & bit),
                     None)
        if pivot is None:
            continue
        rows[rank], rows[pivot] = rows[pivot], rows[rank]
        piv = rows[rank]
        for i in range(len(rows)):
            if i != rank and rows[i] & bit:
                rows[i] ^= piv
        rank += 1
        if rank == 32:
            break
    return rank


def matrix_rank(words: np.ndarray) -> float:
    """Binary matrix rank over GF(2): 32 consecutive words form a 32x32
    bit matrix; ranks are chi-squared against the exact asymptotic
    {<=30, 31, 32} distribution.  The battery's F2-linearity detector —
    an undecorrelated xorshift/LFSR output fails it where every weak
    moment test passes (Bakiri et al.)."""
    n_mat = words.size // 32
    if n_mat < 8:
        return 1.0
    mats = words[: n_mat * 32].reshape(n_mat, 32)
    ranks = np.array([gf2_rank32(m) for m in mats])
    counts = np.array([(ranks <= 30).sum(), (ranks == 31).sum(),
                       (ranks == 32).sum()], dtype=np.float64)
    expected = np.array([_RANK_PLO, _RANK_P31, _RANK_P32]) * n_mat
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    return st.chi2_sf(chi2, 2)


def spectral(words: np.ndarray) -> float:
    """NIST discrete Fourier transform test on the bit expansion: the
    fraction of DFT peaks below the 95% threshold should be 0.95; the
    deviation is normally distributed under the null."""
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8))
    x = 2.0 * bits.astype(np.float64) - 1.0
    n = x.size
    mags = np.abs(np.fft.rfft(x))[: n // 2]
    threshold = np.sqrt(np.log(1.0 / 0.05) * n)
    n0 = 0.95 * n / 2.0
    n1 = float((mags < threshold).sum())
    d = (n1 - n0) / np.sqrt(n * 0.95 * 0.05 / 4.0)
    return 2.0 * st.normal_sf(abs(d))


# NIST SP 800-22 3.4: longest-run-of-ones class probabilities for
# M = 128-bit subblocks, classes {<=4, 5, 6, 7, 8, >=9}
_LONGEST_RUN_PI = np.array([0.1174, 0.2430, 0.2493, 0.1752, 0.1027, 0.1124])


def longest_run(words: np.ndarray) -> float:
    """NIST longest-run-of-ones: longest 1-run per 128-bit subblock,
    chi-squared over the published class probabilities."""
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8))
    n_sub = bits.size // 128
    if n_sub < 16:
        return 1.0
    sub = bits[: n_sub * 128].reshape(n_sub, 128)
    cur = np.zeros(n_sub, dtype=np.int32)
    best = np.zeros(n_sub, dtype=np.int32)
    for j in range(128):
        cur = np.where(sub[:, j] == 1, cur + 1, 0)
        best = np.maximum(best, cur)
    classes = np.clip(best, 4, 9) - 4
    counts = np.bincount(classes, minlength=6).astype(np.float64)
    expected = _LONGEST_RUN_PI * n_sub
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    return st.chi2_sf(chi2, 5)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

# name -> (fn, aggregation): "ks" tests return a per-block p-value;
# "poisson" tests return (count, mean) summed over blocks.
CHI2_TESTS: Dict[str, object] = {
    "gap": gap,
    "serial": serial,
    "matrix_rank": matrix_rank,
    "spectral": spectral,
    "longest_run": longest_run,
}

POISSON_TESTS: Dict[str, object] = {
    "birthday_spacings": birthday_spacings,
    "collision": collision,
}

ALL_TESTS = tuple(sorted(CHI2_TESTS)) + tuple(sorted(POISSON_TESTS))
