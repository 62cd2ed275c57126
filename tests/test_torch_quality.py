"""The port's statistics, baselines and quality battery against the
reference's, on the CPU.

Every array is made from a numpy seed and goes through both packages:
``repro_torch.core.statistics``, ``quality.crush`` / ``cross`` / ``pit``
must give the reference's numbers exactly (they are its numpy code),
``core.baselines`` its bits, and ``run_battery("tiny", device="cpu")``
the reference's ``intra`` / ``cross`` dicts on every mapped row.  The
rows whose words pass a transcendental stage (exponential, gamma, the
raw LCG through the exponential stage) compare their verdicts only: the
port's float32 ``log`` is within the reference's ULP slack, not bit-equal,
and the PIT words move with it.  The raw-LCG row is also held stage by
stage: its bits exactly, its exponential samples within the slack, its
PIT words exactly where the samples agree.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import baselines as j_baselines
from repro.core import lcg as j_lcg
from repro.core import statistics as j_st
from repro.quality import battery as j_battery
from repro.quality import cross as j_cross
from repro.quality import crush as j_crush
from repro.quality import pit as j_pit
from repro.quality import render as j_render
from repro_torch.core import baselines as t_baselines
from repro_torch.core import lcg as t_lcg
from repro_torch.core import statistics as t_st
from repro_torch.core import u64
from repro_torch.quality import battery as t_battery
from repro_torch.quality import cross as t_cross
from repro_torch.quality import crush as t_crush
from repro_torch.quality import pit as t_pit
from repro_torch.quality import render as t_render

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _words(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# statistics, crush, cross, pit: the reference's numbers
# ---------------------------------------------------------------------------

STAT_CASES = {
    "to_unit": lambda st, w: st.to_unit(w[0]),
    "gammainc_lower": lambda st, w: [st.gammainc_lower(a, x)
                                     for a in (0.5, 3.0, 40.0)
                                     for x in (0.1, 2.5, 60.0)],
    "gammainc_upper": lambda st, w: [st.gammainc_upper(a, x)
                                     for a in (0.5, 3.0, 40.0)
                                     for x in (0.1, 2.5, 60.0)],
    "chi2_sf": lambda st, w: [st.chi2_sf(c, d) for c in (0.5, 12.0, 300.0)
                              for d in (1, 7, 255)],
    "normal_sf": lambda st, w: [st.normal_sf(z) for z in (-3.0, 0.0, 5.5)],
    "poisson": lambda st, w: [(st.poisson_cdf(k, 8.0),
                               st.poisson_two_sided(k, 8.0))
                              for k in (0, 3, 8, 30)],
    "kolmogorov_pvalue": lambda st, w: [st.kolmogorov_pvalue(d, n)
                                        for d in (0.01, 0.2)
                                        for n in (10, 1000)],
    "ks_uniform_pvalue": lambda st, w: st.ks_uniform_pvalue(
        st.to_unit(w[0][:64])),
    "monobit_fraction": lambda st, w: st.monobit_fraction(w[0]),
    "byte_chi2_pvalue": lambda st, w: st.byte_chi2_pvalue(w[0]),
    "runs_statistic": lambda st, w: st.runs_statistic(w[0]),
    "lag_autocorr": lambda st, w: st.lag_autocorr(w[0], 3),
    "pearson": lambda st, w: st.pearson(w[0], w[1]),
    "spearman": lambda st, w: st.spearman(w[0], w[1]),
    "kendall": lambda st, w: st.kendall(w[0][:300], w[1][:300]),
    "hamming_weight_dependency": lambda st, w:
        st.hamming_weight_dependency(w[0]),
    "interleave": lambda st, w: st.interleave(w[:, :64]),
    "intra_stream_report": lambda st, w: st.intra_stream_report(w[0]),
    "inter_stream_report": lambda st, w: st.inter_stream_report(w[:, :512]),
}


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.mark.parametrize("name", sorted(STAT_CASES))
def test_statistics_equal_reference(name):
    w = _words((4, 2048), seed=1)
    assert _same(STAT_CASES[name](t_st, w), STAT_CASES[name](j_st, w))


@pytest.mark.parametrize("name", sorted(j_crush.CHI2_TESTS)
                         + sorted(j_crush.POISSON_TESTS))
def test_crush_tests_equal_reference(name):
    tests = {**t_crush.CHI2_TESTS, **t_crush.POISSON_TESTS}
    ref = {**j_crush.CHI2_TESTS, **j_crush.POISSON_TESTS}
    for seed in (2, 3):
        w = _words(4096, seed)
        assert _same(tests[name](w), ref[name](w))
    assert t_crush.ALL_TESTS == j_crush.ALL_TESTS


def test_cross_battery_equals_reference():
    streams = _words((64, 1024), seed=4)
    kw = dict(alpha=1e-4, hard=1e-9, max_pairs=8)
    assert _same(t_cross.run_cross(streams, **kw),
                 j_cross.run_cross(streams, **kw))
    assert _same(t_cross.pairwise_sweep(streams),
                 j_cross.pairwise_sweep(streams))
    assert t_cross.SWEEP_BLOCK == j_cross.SWEEP_BLOCK


@pytest.mark.parametrize("spec", ["exponential(1.5)", "gamma(2.5)",
                                  "gamma(3.0,0.5)", "gumbel",
                                  "poisson(3.5)",
                                  "categorical[0.5,0.25,0.125,0.125]"])
def test_pit_equals_reference(spec):
    rng = np.random.default_rng(5)
    if spec.startswith(("poisson", "categorical")):
        x = rng.integers(0, 9, size=(64, 16)).astype(np.float32)
    elif spec == "gumbel":
        x = rng.gumbel(size=(64, 16)).astype(np.float32)
    else:
        x = rng.gamma(2.0, size=(64, 16)).astype(np.float32)
    v = _words((64, 16), seed=6)
    assert np.array_equal(t_pit.pit_words(x, spec, v),
                          j_pit.pit_words(x, spec, v))
    kind = spec.split("(")[0].split("[")[0]
    if kind in ("poisson", "categorical"):
        param = j_pit.sampler_mod.parse(spec)[1]
        assert np.array_equal(t_pit.discrete_cdf_table(kind, param),
                              j_pit.discrete_cdf_table(kind, param))
    else:
        param = j_pit.sampler_mod.parse(spec)[1]
        assert np.array_equal(t_pit.continuous_cdf(kind, param, x),
                              j_pit.continuous_cdf(kind, param, x))


# ---------------------------------------------------------------------------
# baselines: the reference's bits
# ---------------------------------------------------------------------------

BASELINES = [
    ("philox_bits", (5, 7, 16), {}),
    ("philox_bits", (2 ** 33 + 9, 3, 8), {}),
    ("xoroshiro_bits", (5, 7, 13), {}),
    ("pcg_xsh_rs_bits", (2 ** 40 + 3, 7, 13), {}),
    ("raw_lcg_bits", (12345, 9, 300), {}),
    ("raw_lcg_bits", (77, 6, 10), {"permute": True}),
    ("raw_lcg_bits", (77, 6, 10), {"h_mode": "spread"}),
    ("raw_lcg_bits", (2 ** 64 - 2, 5, 40), {"permute": True,
                                            "h_mode": "spread"}),
]


@pytest.mark.parametrize("name,args,kw", BASELINES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(BASELINES)])
def test_baselines_bit_equal_reference(name, args, kw):
    got = getattr(t_baselines, name)(*args, **kw, device=CPU)
    want = np.asarray(getattr(j_baselines, name)(*args, **kw))
    assert got.dtype == torch.uint32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


def test_baselines_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    for name, args, kw in BASELINES[::3]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(t_baselines, name)(*args, **kw)


def test_baseline_steps_and_truncate_hi_equal_reference():
    import jax.numpy as jnp
    rng = np.random.default_rng(8)
    hi = rng.integers(0, 2 ** 32, 32, dtype=np.uint64)
    lo = rng.integers(0, 2 ** 32, 32, dtype=np.uint64)
    t_state = (torch.from_numpy(hi.astype(np.int64)),
               torch.from_numpy(lo.astype(np.int64)))
    j_state = (jnp.asarray(hi.astype(np.uint32)),
               jnp.asarray(lo.astype(np.uint32)))
    assert np.array_equal(t_lcg.truncate_hi(t_state).numpy(),
                          np.asarray(j_lcg.truncate_hi(j_state)))
    assert np.array_equal(t_baselines.pcg_xsh_rs_out(t_state).numpy(),
                          np.asarray(j_baselines.pcg_xsh_rs_out(j_state)))
    t_next = t_baselines.xoroshiro_step(t_state, t_state[::-1])
    j_next = j_baselines.xoroshiro_step(j_state, j_state[::-1])
    for a, b in zip((*t_next[0], *t_next[1], t_next[2]),
                    (*j_next[0], *j_next[1], j_next[2])):
        assert np.array_equal(a.numpy(), np.asarray(b))
    c = tuple(torch.from_numpy(v.astype(np.int64)) for v in (hi, lo, lo, hi))
    k = (t_state[1], t_state[0])
    jc = tuple(jnp.asarray(v.astype(np.uint32)) for v in (hi, lo, lo, hi))
    got = t_baselines.philox4x32(c, k, rounds=7)
    want = j_baselines.philox4x32(jc, (j_state[1], j_state[0]), rounds=7)
    for a, b in zip(got, want):
        assert np.array_equal(u64.to_u32(a).numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# the battery
# ---------------------------------------------------------------------------

#: port row -> the reference row drawing the same words
MAPPED = {
    "thundering/ctr/torch": "thundering/ctr/ref",
    "thundering/ctr/leased": "thundering/ctr/xla",
    "thundering/faithful/torch": "thundering/faithful/xla",
    "thundering/ctr-fmix32/torch": "thundering/ctr-fmix32/xla",
    "thundering/ctr/sharded": "thundering/ctr/sharded",
    "thundering/faithful/sharded": "thundering/faithful/sharded",
    "thundering/ctr/service": "thundering/ctr/service",
    "dist/exponential/torch": "dist/exponential/xla",
    "dist/poisson/torch": "dist/poisson/xla",
    "dist/gamma/torch": "dist/gamma/xla",
    "dist/categorical/torch": "dist/categorical/xla",
    "ablation/raw_lcg": "ablation/raw_lcg",
    "ablation/no_deco": "ablation/no_deco",
    "ablation/raw_lcg_pit": "ablation/raw_lcg_pit",
}
#: rows whose words pass a transcendental stage: verdicts only.  The
#: raw-LCG PIT row is held stage by stage in
#: ``test_ablation_raw_lcg_pit_stage_within_slack``.
VERDICT_ONLY = ("dist/exponential/torch", "dist/gamma/torch",
                "ablation/raw_lcg_pit")


@pytest.fixture(scope="module")
def tiny_reports():
    port = t_battery.run_battery("tiny", device=CPU)
    ref = j_battery.run_battery("tiny", generators=sorted(MAPPED.values()))
    return port, {g["name"]: g for g in ref["generators"]}


def test_battery_cpu_rows_are_the_mapped_rows(tiny_reports):
    port, _ = tiny_reports
    names = [g["name"] for g in port["generators"]]
    assert sorted(names) == sorted(MAPPED)
    assert port["ok"] and all(g["as_expected"] for g in port["generators"])
    assert all(g["backend"] in ("torch", "-") for g in port["generators"])


@pytest.mark.parametrize("name", sorted(MAPPED))
def test_battery_tiny_row_equals_reference(tiny_reports, name):
    port, ref = tiny_reports
    got = next(g for g in port["generators"] if g["name"] == name)
    want = ref[MAPPED[name]]
    for key in ("expect", "ok", "as_expected", "mode", "sampler"):
        assert got[key] == want[key], key
    for part in ("intra", "cross"):
        assert (got[part] is None) == (want[part] is None), part
        if got[part] is None:
            continue
        if name in VERDICT_ONLY:
            assert got[part]["ok"] == want[part]["ok"]
        else:
            assert got[part] == want[part], part


def test_ablation_raw_lcg_pit_stage_within_slack():
    """The raw-LCG PIT row, stage by stage at the tiny cross size: the
    raw-LCG words equal the reference's, the exponential stage is within
    the 8-ULP slack, and the PIT words differ only where the stage's
    float32 samples do (the PIT is the reference's numpy code)."""
    import jax.numpy as jnp
    from repro.core import sampler as j_sampler
    from repro_torch.core import sampler as t_sampler
    prof = j_battery.PROFILES["tiny"]
    seed, t, s = j_battery.DEFAULT_SEED, prof.cross_t, prof.cross_s
    bits = np.ascontiguousarray(np.asarray(
        j_baselines.raw_lcg_bits(seed, s, t)).T)
    t_bits = t_baselines.raw_lcg_bits(seed, s, t, device=CPU).T.contiguous()
    assert np.array_equal(t_bits.numpy(), bits)
    spec = "exponential(1.0)"
    want = np.asarray(j_sampler.apply(jnp.asarray(bits),
                                      j_sampler.parse(spec), "float32"))
    got = t_sampler.apply(u64.limbs(t_bits), t_sampler.parse(spec),
                          "float32")
    err = float(t_sampler.ulp_error(got, torch.from_numpy(want.copy())).max())
    same = got.numpy().view(np.int32) == want.view(np.int32)
    t_words = t_battery._ablation_pit_block(seed, t, s, torch.device(CPU))
    j_words = j_battery._ablation_pit_block(seed, t, s)
    print(f"raw-LCG exponential stage at ({t}, {s}): max ulp_error {err}; "
          f"{int((~same).sum())} of {same.size} samples and "
          f"{int((t_words != j_words).sum())} PIT words differ")
    assert err <= 8.0
    assert np.array_equal(t_words[same], j_words[same])


def test_battery_report_schema_and_rendering_cross_packages(tiny_reports):
    port, _ = tiny_reports
    ref = j_battery.run_battery("tiny", generators=["ablation/raw_lcg"])
    for key in ("schema", "suite", "profile", "seed", "alpha", "sizes",
                "tests"):
        assert port[key] == ref[key], key
    assert t_battery.report_json(ref) == j_battery.report_json(ref)
    text = t_battery.report_json(port)
    assert json.loads(text) == port
    assert set(port["generators"][0]) == set(ref["generators"][0])
    # either package's renderer renders either report
    for rep in (port, ref):
        assert "Crush-lite battery report" in j_render.render_quality_md(rep)
        assert "Crush-lite battery report" in t_render.render_quality_md(rep)
        assert t_render.render_experiments_block(rep).startswith(
            t_render.QUALITY_BEGIN)


def test_battery_cuda_row_on_cpu_raises():
    with pytest.raises(ValueError, match="CUDA device"):
        t_battery.run_battery("tiny", device=CPU,
                              generators=["thundering/ctr/cuda"])
    with pytest.raises(ValueError, match="unknown generators"):
        t_battery.run_battery("tiny", device=CPU, generators=["nope"])
    cuda_rows = [c.name for c in t_battery.battery_configs()
                 if c.backend == "cuda"]
    twins = {n.replace("/cuda", "/torch") for n in cuda_rows}
    assert twins <= {c.name for c in t_battery.battery_configs()}
    assert len(cuda_rows) == 7


def test_battery_sharded_row_pads_over_four_shards():
    mesh = t_battery.sharded_mesh(torch.device(CPU))
    assert mesh.devices.size == t_battery.SHARDS == 4
    block = t_battery._sharded_block(3, 16, 10, "faithful", "splitmix64",
                                     torch.device(CPU))
    want = t_battery._engine_block(3, 16, 10, "faithful", "splitmix64",
                                   "torch", torch.device(CPU))
    assert np.array_equal(block, want)


def test_quality_cli_writes_under_its_out_dir(tmp_path):
    out = tmp_path / "q" / "QUALITY_report.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.quality", "--profile", "tiny",
         "--device", "cpu", "--generators",
         "thundering/ctr/torch,ablation/no_deco", "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(out.read_text())
    assert [g["name"] for g in rep["generators"]] == [
        "thundering/ctr/torch", "ablation/no_deco"]
    assert (out.parent / "quality.md").exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["q"]
    assert t_battery.DEFAULT_OUT_DIR.startswith("build/")
