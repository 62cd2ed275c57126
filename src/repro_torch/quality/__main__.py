"""``python -m repro_torch.quality`` - run the battery, then render it.

    python -m repro_torch.quality --profile tiny --device cpu
    python -m repro_torch.quality --profile fast          # on a card

Writes the report and its rendered page under ``build/quality_torch/``
(an ignored directory) unless ``--out`` names another report path; the
page goes beside the report.  The repository's ``QUALITY_report.json``,
``docs/quality.md`` and ``EXPERIMENTS.md`` are the reference's and are
never written by default.
"""
import argparse
import sys
from pathlib import Path

from repro_torch.quality import battery, render


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="fast",
                    choices=sorted(battery.PROFILES))
    ap.add_argument("--seed", type=int, default=battery.DEFAULT_SEED)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--generators", default=None,
                    help="comma-separated generator names")
    ap.add_argument("--out",
                    default=f"{battery.DEFAULT_OUT_DIR}/QUALITY_report.json")
    args = ap.parse_args(argv)
    extra = ["--device", args.device] if args.device else []
    if args.generators:
        extra += ["--generators", args.generators]
    rc = battery.main(["--profile", args.profile, "--seed", str(args.seed),
                       "--out", args.out, *extra])
    # render from the report just written, beside it
    render.main(["--report", args.out, "--quality-md",
                 str(Path(args.out).with_name("quality.md"))])
    return rc


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
