"""CPU tests of the MoE train cell ``granite-moe-train``: its entries and
counts, a small run sound (traced and not), planted faults and the two
controls not correct.

  python -m pytest bench/tests/test_moe_train.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness, moe_counts, moe_weights  # noqa: E402

SPEC = harness.load_spec()
CELL = "granite-moe-train"
CONF = json.loads((BENCH / "configs" / "granite-moe-3b-a800m.json")
                  .read_text())
ARCH = CONF["arch"]
# granite's form at a small width: wide enough that a sound run's bf16
# readings sit under the cell's limits
SMALL = dict(ARCH, name="granite-small", n_layers=2, d_model=256, n_heads=8,
             n_kv_heads=2, d_ff=128, vocab=512, n_experts=8, top_k=4,
             moe_group=32, attention_multiplier=1 / 32)
SIZE = dict(traffic_overrides=dict(batch=4, seq=32),
            config_overrides=dict(arch=SMALL))
SEED = 2 ** 31 + 77


def run_small(seed=SEED, trace=False, seconds=0.3):
    kw = {k: dict(v) for k, v in SIZE.items()}
    return harness.run_cell(SPEC, CELL, seed=seed, seconds=seconds,
                            trace=trace, device="cpu", **kw)


def test_entries_and_files():
    cell = harness.find(SPEC["workloads"], CELL, "workload")
    conf = harness.find(SPEC["configs"], cell["config"], "configuration")
    assert cell["chips"] == 1 and conf["reduced"] == []
    assert CONF["run"] == CONF["published"]       # nothing cut
    pub = CONF["published"]
    assert (ARCH["n_layers"], ARCH["d_model"], ARCH["d_ff"], ARCH["vocab"],
            ARCH["n_experts"], ARCH["top_k"], ARCH["n_heads"],
            ARCH["n_kv_heads"]) == (
        pub["num_hidden_layers"], pub["hidden_size"],
        pub["intermediate_size"], pub["vocab_size"],
        pub["num_local_experts"], pub["num_experts_per_tok"],
        pub["num_attention_heads"], pub["num_key_value_heads"])
    for key in ("embedding_multiplier", "attention_multiplier",
                "residual_multiplier", "logits_scaling"):
        assert ARCH[key] == pub[key]
    assert ARCH["tie_embeddings"] is pub["tie_word_embeddings"] is True
    assert ARCH["capacity_factor"] <= 0          # dropless
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    assert traffic == dict(driver="moe_train", batch=8, seq=2048,
                           checked_steps=3)
    names = {m["name"] for m in harness.cell_metrics(SPEC, CELL,
                                                     "per_layer")}
    assert names == {"mfu.moe_train", "moe_ms", "moe_jitter_ms",
                     "moe_experts_roofline", "idle_pct.moe_train",
                     "peak_gib.moe_train"}
    assert CONF["limits"]["train"]["dropped_choices"] == 0


def test_granite_flops_and_parameters_at_the_cells_shape():
    L, T = 32, 8 * 2048
    # per layer and token: q and o 1536 x 1536 each, k and v 1536 x 512
    # each, the router 1536 x 40, 8 experts' 3 x 1536 x 512
    proj = 2 * T * L * (2 * 1536 * 1536 + 2 * 1536 * 512)
    attn = 4 * 8 * L * 24 * 64 * (2048 * 2049 // 2)
    router = 2 * T * L * 1536 * 40
    experts = 2 * T * L * 8 * 3 * 1536 * 512
    unembed = 2 * T * 1536 * 49155
    fwd = proj + attn + router + experts + unembed
    assert moe_counts.forward_flops(ARCH, 8, 2048) == fwd
    assert moe_counts.train_flops(ARCH, 8, 2048) == 3 * fwd
    assert 95e12 < 3 * fwd < 98e12
    from bench.reference.moe_lm import moe_lm_leaves
    n = sum(torch.Size(s).numel() for _, s in moe_lm_leaves(ARCH))
    assert 3.29e9 < n < 3.31e9                    # tied: one vocab table


def test_weights_are_the_programs_layout_and_made_alone():
    from repro_torch.models import transformer
    from repro_torch.models.common import GraniteConfig, flatten
    tree = moe_weights.moe_lm(SMALL, 3, "cpu")
    _, specs = transformer.init_lm(GraniteConfig(**SMALL), 0, "meta")
    flat = flatten(tree)
    assert set(flat) == set(specs)
    for k, v in flat.items():
        assert torch.equal(v, moe_weights.leaf(SMALL, 3, k, "cpu")), k


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(trace):
    r = run_small(trace=trace)
    assert r["correct"], r["checks"]
    assert r["checks"]["dropped_choices"]["value"] == 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in harness.cell_metrics(SPEC, CELL, kind)}
    assert set(r["metrics"]) <= names
    if not trace:
        assert set(r["metrics"]) == names


def test_metric_readers_read_the_drivers_notes():
    run = harness.Run(workload=CELL, seed=1, seconds=1.0, trace=True,
                      device=torch.device("cpu"), cell={}, config=CONF,
                      traffic={"batch": 8, "seq": 2048})
    run.t0, run.t1 = 0.0, 10.0
    for name in ("moe_ms", "moe_jitter_ms", "moe_experts_roofline",
                 "mfu.moe_train"):
        assert harness.metric_reader(name)(run) is None   # nothing to read
    run.counters["train_steps"] = 2
    run.notes.update(moe_steps=2, moe_counters={"moe.rows": 10 ** 6},
                     moe_span_ms={"moe.route": 30.0, "moe.jitter": 20.0,
                                  "moe.experts": 10.0, "moe.combine": 4.0,
                                  "moe.experts_bwd": 6.0})
    assert harness.metric_reader("moe_ms")(run) == 25.0
    assert harness.metric_reader("moe_jitter_ms")(run) == 10.0
    roof = 100 * 2 * 10 ** 6 * 3 * 1536 * 512 / 0.010 / 989e12
    assert harness.metric_reader("moe_experts_roofline")(run) == \
        pytest.approx(roof)
    mfu = 100 * 2 * moe_counts.train_flops(ARCH, 8, 2048) / 10.0 / 989e12
    assert harness.metric_reader("mfu.moe_train")(run) == pytest.approx(mfu)


def _wrap(monkeypatch, mod, name, make):
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))


def fault_a_dropped_choice(mp):
    """The plan gives one choice's row to a padding row."""
    from repro_torch.models import moe

    def make(real):
        def plan(top_idx, E, *a, **kw):
            row, choice, ends = real(top_idx, E, *a, **kw)
            choice = choice.clone()
            choice[row[0, 0]] = row.numel()
            return row, choice, ends
        return plan
    _wrap(mp, moe, "dropless_plan", make)


def fault_state_unchanged(mp):
    from repro_torch.launch import steps
    _wrap(mp, steps, "adamw_update",
          lambda real: lambda grads, state, params, **kw: (params, state))


def fault_half_left_out(mp):
    from repro_torch.launch import steps

    def make(real):
        def vg(model, params, batch, *a, **kw):
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return real(model, params, half, *a, **kw)
        return vg
    _wrap(mp, steps, "value_and_grad", make)


@pytest.mark.parametrize("fault", [fault_a_dropped_choice,
                                   fault_state_unchanged,
                                   fault_half_left_out],
                         ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = run_small()
    assert not r["correct"], r["checks"]


def test_controls_are_not_correct_small():
    """The fp8 reference and the program's capacity routing each read past
    a limit that the program passes."""
    from bench import controls_moe
    out = controls_moe.train(SPEC, SEED, "cpu", **SIZE)
    limits = CONF["limits"]["train"]
    assert all(out["program"][k] <= v for k, v in limits.items()), out
    for control in ("fp8", "capacity"):
        assert any(out[control][k] > v for k, v in limits.items()), \
            (control, out)
    assert out["capacity"]["dropped_choices"] > 0
