"""CPU tests of the per-layer metrics that read the program's own counters
(``repro_torch.trace``): a small traced run of the cell that reports them,
and a program without the counters, which reads nothing.

  python -m pytest bench/tests
"""
from __future__ import annotations

import sys

from bench import harness
from bench.tests.test_bench import FULL, run_small


def test_leaf_tables_per_call_reads_two_in_a_traced_apps_run():
    from repro_torch import trace
    trace.reset_counters(("engine.leaf_tables", "blocks.apps"))
    r = run_small("mc-apps", trace=True)
    assert r["correct"], r["checks"]
    got = r["metrics"]["leaf_tables_per_call"]
    assert got == {"value": 2.0, "unit": "tables/call"}
    assert "leaf_tables_per_call" not in run_small("mc-apps")["metrics"]


def test_leaf_tables_per_call_reads_nothing_without_the_counters(
        monkeypatch):
    import repro_torch
    read = harness.metric_reader("leaf_tables_per_call")
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert read(None) is None


def test_only_the_apps_cell_lists_it():
    cells = [w["name"] for w in FULL["workloads"]
             if any(m["name"] == "leaf_tables_per_call"
                    for m in harness.cell_metrics(FULL, w["name"],
                                                  "per_layer"))]
    assert cells == ["mc-apps"]
