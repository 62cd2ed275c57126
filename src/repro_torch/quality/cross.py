"""Inter-stream cross-battery: the decorrelation claim at real power.

The paper's Tables 3/4 argument is that cheap decorrelation makes
*unlimited* streams pairwise independent; a per-stream battery cannot see
the failure mode (each raw-LCG stream looks fine alone — the correlation
lives BETWEEN streams).  Two instruments:

  * **Pairwise-correlation sweep** (Table 3 at power): the full S x S
    Pearson correlation matrix of an (S, T) block via one Gram matmul.
    Under the null each off-diagonal r * sqrt(T) is ~N(0, 1); the
    statistic is max |z| with a Bonferroni-corrected p-value over all
    S(S-1)/2 pairs.  Raw LCG streams show r ~ 0.998 => p ~ 0.
  * **Interleaved-pair battery** (the Li et al. inter-stream method the
    paper adopts, Table 4): adjacent stream pairs are round-robin
    interleaved and each interleave is pushed through a sub-battery
    (serial, longest-run, Hamming-weight-dependency z-test); per-pair
    p-values aggregate by KS uniformity.  Permutation-only ablations
    pass the sweep yet fail here — interleaving exposes the shared-root
    Hamming-weight dependency the permutation cannot remove.

All statistics are numpy over a host block; the battery driver feeds it
blocks drawn through ``engine.generate_sharded``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import statistics as st
from repro_torch.quality import crush


#: row-block edge of the blocked Gram sweep — 2048 f64-normalized rows
#: per block keep every partial Gram product under ~32 MB, so the sweep
#: scales to the full profile's S = 2**14 without materializing an
#: S x S matrix; for S <= SWEEP_BLOCK the computation is the single
#: full-matrix product, byte-identical to the unblocked form (the
#: committed fast-profile report does not move).
SWEEP_BLOCK = 2048


def _unit_rows(streams: np.ndarray) -> np.ndarray:
    """Center and L2-normalize each row of an (s, T) uint32 block in
    float64 (constant rows normalize to zero => r := 0 for their
    pairs)."""
    u = st.to_unit(streams)
    u -= u.mean(axis=1, keepdims=True)
    norms = np.sqrt((u * u).sum(axis=1))
    norms[norms == 0.0] = 1.0
    u /= norms[:, None]
    return u


def pairwise_sweep(streams: np.ndarray, *,
                   block: int = SWEEP_BLOCK) -> Dict[str, float]:
    """Pairwise Pearson sweep over (S, T) streams via blocked Gram
    products.

    Returns max |r|, its z-score ``|r| * sqrt(T)``, and the
    Bonferroni-corrected two-sided p-value over all pairs (conservative,
    exact enough at the battery's sizes: the null max |z| sits near the
    corrected 5% point by the extreme-value approximation).

    The correlation matrix is swept in ``block x block`` tiles (only the
    upper block triangle, off-diagonal entries only on diagonal tiles),
    tracking the running max |r| — O(S**2 T) flops but O(block * T)
    resident floats, which is what lets the scheduled ``full`` profile
    push S to 2**14.  For ``S <= block`` this is one full-matrix product
    and the result is bit-identical to the historical unblocked sweep.
    """
    s_count, t = streams.shape
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    n_pairs = s_count * (s_count - 1) // 2
    max_abs_r = 0.0
    # same unit mapping as the Table 3 pairwise functions (power-of-two
    # scale, so the correlations are bit-identical to the raw-shift form)
    for i0 in range(0, s_count, block):
        ui = _unit_rows(streams[i0:i0 + block])
        for j0 in range(i0, s_count, block):
            uj = ui if j0 == i0 else _unit_rows(streams[j0:j0 + block])
            gram = ui @ uj.T
            if j0 == i0:
                iu = np.triu_indices(gram.shape[0], 1)
                tile = gram[iu]
            else:
                tile = gram.ravel()
            if tile.size:
                max_abs_r = max(max_abs_r, float(np.abs(tile).max()))
    z = max_abs_r * np.sqrt(t)
    p = min(1.0, n_pairs * 2.0 * st.normal_sf(z))
    return {"n_pairs": n_pairs, "max_abs_r": max_abs_r, "max_z": float(z),
            "p": float(p)}


def hwd_pvalue(words: np.ndarray) -> float:
    """Hamming-weight dependency as a p-value: correlation of adjacent
    popcounts, z = r * sqrt(n), two-sided normal tail.  The full
    Blackman-Vigna HWD test runs to first anomaly; at fixed budgets the
    z-test is the same detector with a calibrated false-positive rate.
    """
    r = st.hamming_weight_dependency(words)
    n = words.size - 1
    if n < 2:
        return 1.0
    return 2.0 * st.normal_sf(abs(r) * np.sqrt(n))


#: sub-battery applied to each interleaved pair (name -> fn(words) -> p)
PAIR_TESTS = {
    "serial": crush.serial,
    "longest_run": crush.longest_run,
    "hwd": hwd_pvalue,
}


def interleaved_pair_battery(streams: np.ndarray,
                             max_pairs: int = 32) -> Dict[str, Dict]:
    """Interleave adjacent stream pairs (2k, 2k+1) and run ``PAIR_TESTS``
    on each interleave; per-test results carry the per-pair p-values,
    their KS-uniformity aggregate, and the minimum.
    """
    s_count = streams.shape[0]
    n_pairs = min(max_pairs, s_count // 2)
    per_test: Dict[str, list] = {name: [] for name in PAIR_TESTS}
    for k in range(n_pairs):
        inter = st.interleave(streams[2 * k: 2 * k + 2])
        for name, fn in PAIR_TESTS.items():
            per_test[name].append(float(fn(inter)))
    out: Dict[str, Dict] = {}
    for name, ps in per_test.items():
        arr = np.array(ps)
        out[name] = {"n_pairs": n_pairs,
                     "p_ks": st.ks_uniform_pvalue(arr),
                     "p_min": float(arr.min())}
    return out


def run_cross(streams: np.ndarray, *, alpha: float = 1e-4,
              hard: float = 1e-9, max_pairs: int = 32) -> Dict:
    """The full cross-battery on (S, T) streams -> report fragment.

    Fails when the pairwise sweep rejects at ``alpha`` or any
    interleaved-pair test's KS aggregate rejects at ``alpha`` (or shows
    a single-pair p-value below ``hard``).
    """
    sweep = pairwise_sweep(streams)
    pairs = interleaved_pair_battery(streams, max_pairs=max_pairs)
    tests = {"pairwise_sweep": dict(sweep, agg="bonferroni",
                                    ok=sweep["p"] >= alpha)}
    for name, rep in pairs.items():
        ok = rep["p_ks"] >= alpha and rep["p_min"] >= hard
        tests[f"interleaved/{name}"] = dict(rep, agg="ks", ok=ok)
    return {"num_streams": int(streams.shape[0]),
            "num_steps": int(streams.shape[1]),
            "tests": tests,
            "ok": all(t["ok"] for t in tests.values())}
