"""Card tests of the benchmark: each control at its cell's own size comes
out as not correct while the program's readings pass, and a short run of
every cell is correct.  They skip without a CUDA card.

  python -m pytest -m gpu bench/tests/test_card.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import controls, harness  # noqa: E402

pytestmark = pytest.mark.gpu
SPEC = harness.with_held(harness.load_spec())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the benchmark measures the card only")
    return "cuda"


def _limits(workload):
    """The cell's limits, by its traffic's driver; the bulk cell's word
    comparison is exact."""
    _, config, traffic = harness.cell_files(SPEC, workload)
    return config["limits"].get(traffic["driver"],
                                {"word_mismatches": 0.0})


@pytest.mark.parametrize("workload", sorted(controls.CELLS))
def test_control_fails_where_the_program_passes(card, workload):
    out = controls.CELLS[workload](SPEC, 2 ** 31 + 101, 12.0, card)
    limits = _limits(workload)
    assert all(out["program"][k] <= v for k, v in limits.items()), out
    assert any(out["control"][k] > v for k, v in limits.items()), out


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_short_run_is_correct(card, workload):
    r = harness.run_cell(SPEC, workload, seed=2 ** 31 + 202, seconds=12.0,
                         trace=False, device=card)
    assert r["correct"], r["checks"]
