"""CPU tests of the benchmark: its data against the contract's rules, the
import rules, the work counts, discovery by name, the plain references
against the port at small sizes, and every cell's comparison, sound and
with its timed path broken underneath.

  python -m pytest bench/tests
"""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import counts, harness, weights  # noqa: E402
from bench.reference import dense_lm, misrn  # noqa: E402

SPEC = harness.load_spec()
#: with the cells held out of BENCHMARK.json, which the tests drive still
FULL = harness.with_held(SPEC)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
PROGRAM_AND_JAX = {"repro_torch", "repro", "jax", "jaxlib", "flax"}

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=256, act="silu",
            rope_theta=10000.0, norm_eps=1.5625e-7, qkv_bias=True)
SMALL = dict(TINY, d_model=256, d_ff=512, vocab=512)
# glm4-9b's model width, one layer and a small vocabulary: its logits
# spread as the cell's do (0.02 x sqrt(4096))
WIDE = dict(TINY, n_layers=1, d_model=4096, n_heads=32, n_kv_heads=2,
            d_ff=512, vocab=1024)
# wide enough that a sound run's bf16 readings sit under the cell's limits
TRAIN = dict(SMALL, n_heads=8)
SIZES = {
    "misrn-bulk": dict(traffic_overrides=dict(
        block_len=64, fuse=2, depth=2, warm_blocks=2, samples=4),
        config_overrides=dict(num_streams=32)),
    "mc-apps": dict(traffic_overrides=dict(lanes=32, draws=128)),
    "glm4-decode": dict(traffic_overrides=dict(
        batch=4, prompt=8, gen=6, check_sequences=4),
        config_overrides=dict(arch=WIDE)),
    "glm4-train": dict(traffic_overrides=dict(batch=4, seq=32),
                       config_overrides=dict(arch=TRAIN)),
}


# a window long enough to finish a round of the decode cell on the CPU
SECONDS = {"glm4-decode": 5.0}


def run_small(workload, seed=2 ** 31 + 5, seconds=None, trace=False,
              **extra):
    seconds = SECONDS.get(workload, 0.5) if seconds is None else seconds
    kw = {k: dict(v) for k, v in SIZES[workload].items()}
    for k, v in extra.items():
        kw.setdefault(k, {}).update(v)
    return harness.run_cell(FULL, workload, seed=seed, seconds=seconds,
                            trace=trace, device="cpu", **kw)


# ---------------------------------------------------------------------------
# BENCHMARK.json against the contract's rules
# ---------------------------------------------------------------------------

def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32
    files = [w for w in cmd if "/" in w]
    assert all(any(f.startswith(p + "/") for p in SPEC["paths"])
               for f in files)
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("spec", [SPEC, FULL], ids=["spec", "held"])
def test_names_units_and_entry_keys(spec):
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        names.append(("config", c["name"]))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        names.append(("cell", w["name"]))
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            allowed = {"name", "unit", "better", "source", "workloads"}
            allowed |= ({"bound"} if kind == "end_to_end"
                        else {"layer", "moves"})
            assert set(m) <= allowed and allowed - set(m) <= {"workloads"}
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(("metric", m["name"]))
    assert len(names) == len(set(names))
    for text in ([c["why"] for c in spec["configs"]]
                 + [c["source"] for c in spec["configs"]]
                 + [w["why"] for w in spec["workloads"]]
                 + [m["layer"] for m in spec["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}


@pytest.mark.parametrize("spec", [SPEC, FULL], ids=["spec", "held"])
def test_metric_sources_bounds_and_files(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert callable(harness.metric_reader(m["name"]))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # one layer, one name, letter for letter
    by_module = {}
    for m in spec["per_layer"]:
        by_module.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values())


@pytest.mark.parametrize("spec", [SPEC, FULL], ids=["spec", "held"])
def test_every_cell_reports_setup_another_e2e_and_a_layer(spec):
    for w in spec["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(spec, w["name"],
                                                       "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(spec, w["name"], "per_layer")


@pytest.mark.parametrize("spec", [SPEC, FULL], ids=["spec", "held"])
def test_per_layer_cells_report_the_metric_they_move(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        assert m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("spec", [SPEC, FULL], ids=["spec", "held"])
def test_models_report_a_step_mfu_beside_their_rooflines(spec):
    per = spec["per_layer"]
    for m in per:
        if m["name"].endswith("_roofline"):
            cells = set(m["workloads"])
            decode_like = {"glm4-decode", "glm4-train"} & cells
            if decode_like:
                assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                           and cells <= set(o["workloads"]) for o in per)


# ---------------------------------------------------------------------------
# Imports
# ---------------------------------------------------------------------------

def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_loaded({"repro_torch", "repro_torch.core",
                                     "jaxtyping", "reproduce"}) == []
    assert harness.forbidden_loaded({"repro.core", "jax._src", "flax"}) == [
        "flax", "jax._src", "repro.core"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    for name in _imports(path):
        top = name.split(".", 1)[0]
        assert top not in PROGRAM_AND_JAX, name
        assert not name.startswith(("bench.drivers", "bench.metrics")), name


def test_no_bench_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".", 1)[0] not in ("jax", "jaxlib", "flax",
                                                 "repro"), (path, name)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from bench.tests import test_bench as t\n"
        "from bench import harness\n"
        "for w in ('misrn-bulk', 'mc-apps', 'glm4-decode', 'glm4-train'):\n"
        "    t.run_small(w, seconds=0.2, trace=True)\n"
        "for n in [m['name'] for m in t.FULL['per_layer']]:\n"
        "    harness.metric_reader(n)\n"
        "import bench.controls\n"
        "assert 'repro_torch' in sys.modules\n"
        "print('BAD', harness.forbidden_loaded())\n"
        % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "misrn-bulk",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


# ---------------------------------------------------------------------------
# Work counts, hand-worked
# ---------------------------------------------------------------------------

GLM = json.loads((BENCH / "configs" / "glm4-9b.json").read_text())["arch"]
GLM16 = json.loads((BENCH / "configs" / "glm4-9b-l16.json").read_text())[
    "arch"]


def test_kernel_bytes():
    # a launch of 4 fused blocks of 16384 rows x 16384 streams of u32: 4 GiB
    assert counts.kernel_a_bytes(4 * 16384 * 16384) == 4 * 2 ** 30
    # 64 rows of 151552 float32 logits read, 64 int32 tokens written
    assert counts.kernel_f_bytes(64, 151552) == 38_797_312 + 256


def test_glm4_flops_at_the_cells_shapes():
    # per layer: q and o 4096 x 4096 each, k and v 4096 x 256 each, the
    # gated MLP 3 x 4096 x 13696
    per_layer = 2 * 16_777_216 + 2 * 1_048_576 + 3 * 56_098_816
    assert counts.dense_matmul_params(GLM) == per_layer == 203_948_032
    # a decode step at batch 64 attending to 300 positions
    want = (2 * 64 * 40 * 203_948_032 + 4 * 64 * 40 * 32 * 128 * 300
            + 2 * 64 * 4096 * 151552)
    assert counts.decode_flops(GLM, 64, 300) == want
    # a prefill of 64 x 256: the causal triangle holds 256 * 257 / 2 pairs
    want = (2 * 64 * 256 * 40 * 203_948_032
            + 4 * 64 * 40 * 32 * 128 * (256 * 257 // 2)
            + 2 * 64 * 4096 * 151552)
    assert counts.prefill_flops(GLM, 64, 256) == want
    # a train step at 8 x 256 over 16 layers, every position unembedded
    fwd = (2 * 8 * 256 * 16 * 203_948_032
           + 4 * 8 * 16 * 32 * 128 * (256 * 257 // 2)
           + 2 * 8 * 256 * 4096 * 151552)
    assert counts.train_flops(GLM16, 8, 256) == 3 * fwd
    assert 47e12 < 3 * fwd < 49e12


# ---------------------------------------------------------------------------
# Discovery by name
# ---------------------------------------------------------------------------

def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    conf = json.loads((BENCH / "configs" / "misrn-s16k.json").read_text())
    conf.update(name="misrn-probe", num_streams=24)
    (bench / "configs" / "misrn-probe.json").write_text(json.dumps(conf))
    (bench / "traffic" / "bulk-probe.json").write_text(json.dumps(dict(
        driver="bulk", block_len=32, fuse=2, depth=1, warm_blocks=1,
        samples=3)))
    (bench / "metrics" / "probe_blocks.py").write_text(
        "def read(run):\n    return float(len(run.spans['next']))\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(name="misrn-probe", source="test",
                                file="bench/configs/misrn-probe.json",
                                reduced=[], why="probe"))
    spec["workloads"].append(dict(name="probe", config="misrn-probe",
                                  traffic="bulk-probe", chips=1, why="p"))
    spec["end_to_end"][0]["workloads"].append("probe")
    spec["per_layer"].append(dict(
        name="probe_blocks", unit="blocks", better="higher",
        source="host_clock", layer="delivery: runtime/blocks.py",
        moves="gsample_per_s", workloads=["probe"]))
    r = harness.run_cell(spec, "probe", seed=3, seconds=0.2, trace=True,
                         device="cpu", root=tmp_path, bench=bench)
    assert r["correct"] and r["metrics"]["probe_blocks"]["value"] > 0


# ---------------------------------------------------------------------------
# The plain references against the port, small, on the CPU
# ---------------------------------------------------------------------------

def test_misrn_reference_equals_the_port_bit_for_bit():
    from repro_torch.core import engine
    seed, S, T, lo = 2 ** 33 + 1234567, 37, 21, (1 << 41) + 9
    plan = engine.make_plan(seed=seed, num_streams=S, num_steps=T,
                            offset=lo, purpose=5, device="cpu")
    port = engine.generate(plan).to(torch.int64) & misrn.M32
    x0, h = misrn.family(seed, 5)
    ref = misrn.block(x0, misrn.leaves(h, torch.arange(S)), lo, T)
    assert torch.equal(port, ref)


def test_mc_reference_matches_the_port_apps():
    from bench.drivers.mc import reference_answer
    from repro_torch.kernels import ops
    conf = json.loads((BENCH / "configs" / "misrn-s16k.json").read_text())
    o = conf["apps"]["option"]
    pi = float(ops.estimate_pi(seed=41, num_lanes=16, draws_per_lane=64,
                               offset=128, device="cpu"))
    ref = reference_answer(conf, "pi", 41, 16, 64, lo=128, device="cpu")
    assert abs(pi - ref) <= 4 * 2 ** -23 * ref
    price = float(ops.price_option(
        seed=41, num_lanes=16, draws_per_lane=64, offset=64, s0=o["s0"],
        strike=o["strike"], r=o["r"], sigma=o["sigma"], t=o["t"],
        device="cpu"))
    ref = reference_answer(conf, "option", 41, 16, 64, lo=64, device="cpu")
    assert abs(price - ref) <= 1e-5 * ref


def test_dense_reference_matches_the_port_forward():
    from repro_torch.models import transformer
    from repro_torch.models.common import ArchConfig
    params = weights.dense_lm(SMALL, 7, "cpu")
    toks = weights.tokens(7, "t", (2, 12), SMALL["vocab"], "cpu")
    port, _ = transformer.lm_forward(ArchConfig(**SMALL), params, toks)
    ref = dense_lm.logits_at(SMALL, params, toks, 0)
    # bf16 activations against float32: ~1 % of the logits' spread
    err = (port - ref).abs().max() / ref.std()
    assert err < 0.05, float(err)
    low = dense_lm.logits_at(SMALL, params, toks, 0, "fp8")
    assert (low - ref).abs().max() / ref.std() > err


def test_dense_reference_loss_and_grads_match_the_port():
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.models.common import ArchConfig
    params = weights.dense_lm(TINY, 8, "cpu")
    toks = weights.tokens(8, "b", (2, 17), TINY["vocab"], "cpu")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    model = registry.build(ArchConfig(**TINY), device="cpu")
    (loss, _), grads = steps.value_and_grad(model, params, batch)
    flat = {k: v.clone().requires_grad_(True)
            for k, v in weights.flat(params).items()}
    tree = {"embed": flat["embed"], "final_norm": flat["final_norm"],
            "unembed": flat["unembed"],
            "layers": {k.split("/")[1]: v for k, v in flat.items()
                       if k.startswith("layers/")}}
    ref = dense_lm.loss(TINY, tree, batch["tokens"], batch["labels"])
    ref_g = torch.autograd.grad(ref, list(flat.values()))
    assert abs(float(loss) - float(ref)) < 1e-3 * float(ref)
    for (k, g_ref), g in zip(flat.items(), ref_g):
        g_port = weights.flat(grads)[k]
        rel = (g_port - g).norm() / g.norm().clamp_min(1e-12)
        assert rel < 0.05, (k, float(rel))


# ---------------------------------------------------------------------------
# Every cell, sound and with its timed path broken underneath
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", sorted(SIZES))
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(workload, trace):
    r = run_small(workload, trace=trace)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in harness.cell_metrics(FULL, workload, kind)}
    assert set(r["metrics"]) <= names
    if not trace:
        assert set(r["metrics"]) == names


def _wrap(monkeypatch, mod, name, make):
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name, make(real))


def fault_bulk_state_unchanged(mp):
    from repro_torch.core import engine
    first = {}

    def make(real):
        def gen(plan, n, **kw):
            first.setdefault("ctr", plan.ctr)
            import dataclasses
            return real(dataclasses.replace(plan, ctr=first["ctr"]), n, **kw)
        return gen
    _wrap(mp, engine, "generate_windows", make)


def fault_bulk_half_left_out(mp):
    from repro_torch.core import engine

    def make(real):
        def gen(plan, n, out=None, **kw):
            full = real(plan, n, **kw)
            if out is None:
                return full
            half = full.shape[1] // 2
            out.view(full.shape)[:, :half].copy_(full[:, :half])
            return out
        return gen
    _wrap(mp, engine, "generate_windows", make)


def fault_bulk_answer_altered(mp):
    from repro_torch.core import engine

    def make(real):
        def gen(*a, **kw):
            out = real(*a, **kw)
            out[..., 0] ^= 1
            return out
        return gen
    _wrap(mp, engine, "generate_windows", make)


def fault_mc_answer_altered(mp):
    from repro_torch.kernels import ops

    def make(real):
        return lambda **kw: real(**kw) * (1 + 1e-3)
    _wrap(mp, ops, "estimate_pi", make)


def fault_mc_half_left_out(mp):
    from repro_torch.kernels import ops

    def make(real):
        return lambda num_lanes, **kw: real(num_lanes=num_lanes // 2, **kw)
    _wrap(mp, ops, "price_option", make)


def fault_mc_state_unchanged(mp):
    from repro_torch.kernels import ops
    for name in ("estimate_pi", "price_option"):
        _wrap(mp, ops, name,
              lambda real: lambda offset=0, **kw: real(offset=0, **kw))


def fault_decode_token_altered(mp):
    from repro_torch.launch import serve

    def make(real):
        def pick(self, step, logits):
            return (real(self, step, logits) + 1) % logits.shape[-1]
        return pick
    _wrap(mp, serve.TokenPicker, "pick", make)


def fault_decode_state_unchanged(mp):
    """Each decode step hands back the first step's logits and the cache
    as it got it: the state never moves."""
    from repro_torch.models import transformer
    first = {}

    def make(real):
        def decode(cfg, params, cache, token, pos):
            if "logits" not in first:
                first["logits"] = real(cfg, params, cache, token, pos)[0]
            return first["logits"], cache
        return decode
    _wrap(mp, transformer, "lm_decode", make)


def fault_decode_half_left_out(mp):
    from repro_torch.models import transformer

    def make(real):
        def decode(cfg, params, cache, token, pos):
            logits, cache = real(cfg, params, cache, token, pos)
            half = logits.shape[0] // 2
            return torch.cat([logits[:half], logits[:half]])[
                :logits.shape[0]], cache
        return decode
    _wrap(mp, transformer, "lm_decode", make)


def fault_train_state_unchanged(mp):
    from repro_torch.launch import steps
    _wrap(mp, steps, "adamw_update",
          lambda real: lambda grads, state, params, **kw: (params, state))


def fault_train_half_left_out(mp):
    from repro_torch.launch import steps

    def make(real):
        def vg(model, params, batch, *a, **kw):
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return real(model, params, half, *a, **kw)
        return vg
    _wrap(mp, steps, "value_and_grad", make)


FAULTS = {
    "misrn-bulk": [fault_bulk_state_unchanged, fault_bulk_half_left_out,
                   fault_bulk_answer_altered],
    "mc-apps": [fault_mc_answer_altered, fault_mc_half_left_out,
                fault_mc_state_unchanged],
    "glm4-decode": [fault_decode_token_altered, fault_decode_state_unchanged,
                    fault_decode_half_left_out],
    "glm4-train": [fault_train_state_unchanged, fault_train_half_left_out],
}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, fs in FAULTS.items() for f in fs],
    ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    r = run_small(workload)
    assert not r["correct"], r["checks"]


def test_controls_are_not_correct_small():
    """Each control, at a small size, fails a number the program passes
    (decode's fp8 control is held at the cell's own size, in the card
    tests: at a small width its logits barely move the gap)."""
    from bench import controls
    b = controls.bulk(FULL, 21, 0.3, "cpu", **SIZES["misrn-bulk"])
    assert b["control"]["word_mismatches"] > 0
    assert b["program"]["word_mismatches"] == 0
    conf = json.loads((BENCH / "configs" / "misrn-s16k.json").read_text())
    m = controls.mc(FULL, 22, 0.3, "cpu",
                    traffic_overrides=dict(lanes=64, draws=512))
    for k, limit in conf["limits"]["mc"].items():
        assert m["control"][k] > limit > m["program"][k], (k, m)
    t = controls.train(FULL, 23, 0.0, "cpu", **SIZES["glm4-train"])
    _, config, _ = harness.cell_files(FULL, "glm4-train")
    limits = config["limits"]["train"]
    assert all(t["program"][k] <= v for k, v in limits.items()), t
    assert any(t["control"][k] > v for k, v in limits.items()), t
