"""Render a battery report into markdown.

``python -m repro_torch.quality.render`` reads a battery report (the
reference's schema, so a report of either package) and writes:

  * a quality page - the full per-generator / per-test table
    (default ``build/quality_torch/quality.md``),
  * with ``--experiments FILE``, the summary block between the
    ``<!-- QUALITY:BEGIN -->`` / ``<!-- QUALITY:END -->`` markers of FILE.

Rendering is a pure function of the JSON.  The defaults stay under the
ignored ``build/`` directory: the repository's own ``docs/quality.md``
and ``EXPERIMENTS.md`` are rendered from the reference's committed report.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List

QUALITY_BEGIN = "<!-- QUALITY:BEGIN (generated by repro.quality.render) -->"
DEFAULT_DIR = "build/quality_torch"
QUALITY_END = "<!-- QUALITY:END -->"

_GENERATED_HEADER = (
    "<!-- GENERATED FILE — do not edit by hand.\n"
    "     Regenerate with:\n"
    "       PYTHONPATH=src python -m repro_torch.quality --profile {profile}\n"
    "     (the PyTorch port's battery; see repro_torch.quality). -->")


def _fmt_p(p: float) -> str:
    if p >= 1e-3:
        return f"{p:.3f}"
    return f"{p:.2e}"


def _verdict(ok: bool) -> str:
    return "pass" if ok else "**FAIL**"


def _summary_rows(report: Dict) -> List[str]:
    rows = ["| generator | delivery | expected | verdict | as expected |",
            "|---|---|---|---|---|"]
    for g in report["generators"]:
        rows.append(
            f"| `{g['name']}` | {g['delivery']} | {g['expect']} "
            f"| {_verdict(g['ok'])} | {'yes' if g['as_expected'] else 'NO'} |")
    return rows


def _intra_rows(g: Dict) -> List[str]:
    intra = g["intra"]
    rows = [f"Intra-stream battery — {intra['num_blocks']} stream blocks of "
            f"{intra['block_words']} words, two-level aggregation:",
            "",
            "| test | aggregate | p | min block p | ok |",
            "|---|---|---|---|---|"]
    for name, t in sorted(intra["tests"].items()):
        if t["agg"] == "ks":
            rows.append(f"| {name} | KS over {t['n_blocks']} block p-values "
                        f"| {_fmt_p(t['p_ks'])} | {_fmt_p(t['p_min'])} "
                        f"| {_verdict(t['ok'])} |")
        else:
            rows.append(f"| {name} | Poisson sum: {t['count']} obs vs "
                        f"{t['mean']:.1f} expected | {_fmt_p(t['p'])} | — "
                        f"| {_verdict(t['ok'])} |")
    return rows


def _cross_rows(g: Dict) -> List[str]:
    cross = g["cross"]
    rows = [f"Inter-stream cross-battery — S={cross['num_streams']} streams "
            f"x {cross['num_steps']} steps:",
            "",
            "| test | detail | p | ok |",
            "|---|---|---|---|"]
    for name, t in sorted(cross["tests"].items()):
        if name == "pairwise_sweep":
            detail = (f"max abs r = {t['max_abs_r']:.4g} over "
                      f"{t['n_pairs']} pairs (Bonferroni)")
            p = t["p"]
        else:
            detail = (f"KS over {t['n_pairs']} interleaved pairs, "
                      f"min p = {_fmt_p(t['p_min'])}")
            p = t["p_ks"]
        rows.append(f"| {name} | {detail} | {_fmt_p(p)} | {_verdict(t['ok'])} |")
    return rows


def render_quality_md(report: Dict) -> str:
    """The quality page of a battery report (pure function)."""
    a = report["alpha"]
    lines = [
        _GENERATED_HEADER.format(profile=report["profile"]),
        "",
        "# Quality — the Crush-lite battery report",
        "",
        f"Suite `{report['suite']}`, profile `{report['profile']}`, seed "
        f"`{report['seed']}`.  Verdict thresholds: KS aggregate alpha "
        f"{a['ks']:g}, Poisson alpha {a['poisson']:g}, cross-battery alpha "
        f"{a['cross']:g}, hard single-block floor {a['hard']:g}.",
        "",
        "The battery draws blocks through the repo's real delivery "
        "surfaces (`engine.generate` on every backend, the "
        "`generate_sharded` mesh fan-out, leased `BlockService` windows) "
        "and runs TestU01-SmallCrush-style tests with two-level "
        "aggregation; the inter-stream cross-battery reproduces the "
        "paper's Table 3/4 ablation ordering at discriminating power. "
        "The `dist/*` rows push the fused distribution stages "
        "(exponential, poisson, gamma, categorical) through the same "
        "machinery by reducing shaped samples back to uniform words with "
        "the probability integral transform (`repro_torch.quality.pit`) — "
        "see `docs/rng-engine.md` for the generator architecture and "
        "`src/repro_torch/quality/` for the test implementations.",
        "",
        f"**Overall: {'OK — every generator behaves as expected' if report['ok'] else 'NOT AS EXPECTED'}.**",
        "",
        "## Summary",
        "",
    ]
    lines += _summary_rows(report)
    lines += ["", "The `ablation/*` rows MUST fail: they are the paper's "
                  "Table 3/4 strawmen (shared-root LCG streams without "
                  "decorrelation, with and without output permutation), "
                  "plus the same raw-LCG source pushed through the "
                  "exponential stage and the PIT — proving the "
                  "distribution transform does not launder a flawed "
                  "source; the battery demonstrating their failure is "
                  "what gives the `thundering/*` and `dist/*` passes "
                  "evidential weight.", ""]
    for g in report["generators"]:
        sampler = g.get("sampler", "bits")
        stage = ("" if sampler == "bits"
                 else f", sampler `{sampler}` via PIT")
        lines += [f"## `{g['name']}`", "",
                  f"Delivery: {g['delivery']} (mode `{g['mode']}`, deco "
                  f"`{g['deco']}`, backend `{g['backend']}`{stage}); "
                  f"expected to "
                  f"{g['expect']}, verdict {_verdict(g['ok'])}.", ""]
        if g["intra"] is not None:
            lines += _intra_rows(g) + [""]
        if g["cross"] is not None:
            lines += _cross_rows(g) + [""]
    lines += [
        "## Reading the report",
        "",
        "* **Two-level testing** (TestU01): each chi-square-family test "
        "yields one p-value per stream block; the second level is a "
        "Kolmogorov-Smirnov test of those p-values against U(0,1). "
        "Counting-family tests (birthday spacings, collision) sum their "
        "Poisson counts across blocks into one two-sided tail.",
        "* **matrix_rank** is the F2-linearity detector (Bakiri et al.): "
        "GF(2) rank of 32x32 bit matrices against the exact asymptotic "
        "distribution.",
        "* **pairwise_sweep** sweeps the S x S Pearson matrix in blocked "
        "Gram tiles (scales to S = 2**14 in the `full` profile) and "
        "Bonferroni-corrects the largest |r|.",
        "* **dist/** generators draw shaped samples (fused in-kernel "
        "distribution stages) and reduce them to uniform words via the "
        "probability integral transform — exact CDF inversion for "
        "continuous stages, Brockwell randomized PIT for discrete ones "
        "— so every word-level test applies unchanged.",
        "* **interleaved/** tests interleave adjacent stream pairs "
        "(the Li et al. inter-stream method the paper adopts) and run "
        "serial / longest-run / Hamming-weight-dependency per pair.",
        "",
    ]
    return "\n".join(lines)


def render_experiments_block(report: Dict) -> str:
    """The EXPERIMENTS.md summary block (between the QUALITY markers)."""
    lines = [
        QUALITY_BEGIN,
        f"Crush-lite battery (`repro_torch.quality`, profile `{report['profile']}`, "
        f"seed `{report['seed']}`) — CPU run of this container; regenerated "
        "by CI, full tables in [docs/quality.md](docs/quality.md):",
        "",
    ]
    lines += _summary_rows(report)
    lines += [
        "",
        f"Overall: **{'as expected' if report['ok'] else 'NOT as expected'}** "
        "— thundering passes in both decorrelator modes on all three "
        "backends (and through leased/sharded delivery), the fused "
        "distribution stages pass PIT-reduced on every backend, and the "
        "raw-LCG / permutation-only / raw-LCG-through-exponential "
        "ablations fail the inter-stream cross-battery, reproducing the "
        "paper's Table 3/4 ordering through the transform layer.",
        QUALITY_END,
    ]
    return "\n".join(lines)


def patch_experiments(text: str, report: Dict) -> str:
    """Replace the marker-delimited quality block in EXPERIMENTS.md."""
    block = render_experiments_block(report)
    begin = text.find(QUALITY_BEGIN)
    end = text.find(QUALITY_END)
    if begin == -1 or end == -1:
        raise ValueError(
            f"EXPERIMENTS.md is missing the {QUALITY_BEGIN!r} / "
            f"{QUALITY_END!r} markers")
    return text[:begin] + block + text[end + len(QUALITY_END):]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=f"{DEFAULT_DIR}/QUALITY_report.json")
    ap.add_argument("--quality-md", default=f"{DEFAULT_DIR}/quality.md")
    ap.add_argument("--experiments", default=None,
                    help="a markdown file whose QUALITY markers get the "
                         "summary block (none by default)")
    args = ap.parse_args(argv)
    with open(args.report) as f:
        report = json.load(f)
    qmd = pathlib.Path(args.quality_md)
    qmd.parent.mkdir(parents=True, exist_ok=True)
    qmd.write_text(render_quality_md(report))
    if args.experiments is None:
        print(f"rendered {qmd}")
        return 0
    exp = pathlib.Path(args.experiments)
    exp.write_text(patch_experiments(exp.read_text(), report))
    print(f"rendered {qmd} + quality section of {exp}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
