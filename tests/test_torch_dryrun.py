"""The port's dry run (launch/{analysis,mesh,dryrun}.py, the partition
specs of models/sharding.py and launch/steps.py, configs.input_specs)
against the reference's, on the CPU.

Everything here is exact:
  * the HLO text parsers return the reference's bytes on the same text;
  * partition specs equal the reference's ``PartitionSpec``s entry by
    entry, for all ten configs on the 16x16 and 2x16x16 meshes (the
    reference reads only ``mesh.axis_names`` and ``mesh.devices.shape``,
    so it takes a stand-in mesh object; the port resolves on
    ``make_production_mesh(device="meta")``);
  * input shapes and dtypes, parameter counts, active counts and model
    flops equal the reference's on every runnable cell;
  * the port's argument bytes per device equal XLA's
    ``argument_size_in_bytes`` on a forced 8-device host platform (one
    subprocess: this process must keep one jax device);
  * ``rng_fanout_cell`` on the CPU equals one ``generate`` bit for bit;
  * ``service_cell`` on the CPU serves the reference's burst: every
    integer / threshold response bit-identical to the reference's (one
    digest over them), every normal / exponential / gamma response
    within the port's 8 ULP of it (the log / trig stages are not
    bit-equal across frameworks, ROADMAP.md § C), the same ledger
    windows, and a bit-identical replay.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host
devices when imported; it is imported only after this process's jax
backend has started, and the variable is restored at once, so no later
subprocess of this worker inherits it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.launch import analysis as j_analysis
from repro.launch import mesh as j_mesh
from repro.models import registry as j_registry
from repro.models import sharding as j_sharding
from repro.models.common import flatten as j_flatten
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, input_specs,
                                 shape_skipped)
from repro_torch.core import engine, sampler
from repro_torch.launch import analysis, dryrun, mesh, steps
from repro_torch.models import registry, sharding
from repro_torch.models.common import flatten

ROOT = Path(__file__).resolve().parents[1]
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
# reference dtype name -> the port's dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "float8_e4m3fn": torch.float8_e4m3fn}
LOG_STAGES = ("normal", "exponential", "gamma")
ULP_SLACK = 8.0
# the tiny glm4 of tests/test_dryrun.py, served at batch 8, context 32
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=256, q_chunk=16, loss_chunks=2)
TINY_B, TINY_S = 8, 32

ARGS_PROG = textwrap.dedent(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch import steps as steps_mod
    from repro.launch.mesh import make_mesh_auto
    from repro.models import registry
    mesh = make_mesh_auto((4, 2), ("data", "model"))
    cfg = get_config("glm4_9b").scaled(**{TINY!r})
    model = registry.build(cfg)
    holder = {{}}
    def initf():
        p, s = model.init(0)
        holder["specs"] = s
        return p
    params = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
        if s.dtype == jnp.float32 else s, jax.eval_shape(initf))
    pshard, _ = steps_mod.param_sharding_tree(model, params, holder["specs"],
                                              mesh, "serve")
    prefill_step, decode_step = steps_mod.make_serve_fns(model)
    B, S = {TINY_B}, {TINY_S}
    sds = jax.ShapeDtypeStruct
    out = {{"devices": len(jax.devices())}}
    with mesh:
        batch = {{"tokens": sds((B, S), jnp.int32)}}
        bs = steps_mod.batch_sharding(cfg, batch, mesh)
        c = jax.jit(prefill_step, in_shardings=(pshard, bs)).lower(
            params, batch).compile()
        out["prefill"] = c.memory_analysis().argument_size_in_bytes
        dec = {{"token": sds((B, 1), jnp.int32),
               "cache": jax.eval_shape(lambda: model.init_cache(B, S)),
               "pos": sds((), jnp.int32)}}
        bs = steps_mod.batch_sharding(cfg, dec, mesh)
        c = jax.jit(decode_step, in_shardings=(
            pshard, bs["cache"], bs["token"], bs["pos"])).lower(
            params, dec["cache"], dec["token"], dec["pos"]).compile()
        out["decode"] = c.memory_analysis().argument_size_in_bytes
    print(json.dumps(out))
""")

SERVICE_PROG = textwrap.dedent("""
    import json, sys
    import jax
    import numpy as np
    jax.devices()                   # the backend starts with one device
    import repro.service.burst as burst
    import repro.launch.dryrun as dryrun
    got = {}
    real = burst.run_burst
    def run_burst(*a, **k):
        out = real(*a, **k)
        got.update(out)
        return out
    burst.run_burst = run_burst
    rep = dryrun.service_cell()
    with open(sys.argv[1], "w") as f:
        json.dump({rid: [str(np.asarray(a).dtype), list(np.shape(a)),
                         np.asarray(a).tobytes().hex()]
                   for rid, a in got.items()}, f)
    print(json.dumps(rep))
""")


def _env():
    return {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
            "JAX_PLATFORMS": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def ref_procs(tmp_path_factory):
    """The two reference subprocesses, started with the module so they
    run beside its in-process tests: XLA's argument sizes on 8 forced
    host devices, and the reference's ``service_cell`` burst."""
    path = tmp_path_factory.mktemp("dryrun") / "responses.json"
    procs = {
        "args": subprocess.Popen([sys.executable, "-c", ARGS_PROG],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 env=_env(), cwd=ROOT),
        "service": subprocess.Popen([sys.executable, "-c", SERVICE_PROG,
                                     str(path)], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True,
                                    env=_env(), cwd=ROOT)}
    yield procs, path
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


def _result(proc, timeout):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun`` imported without leaking its XLA_FLAGS."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as d
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return d


@pytest.fixture(scope="module")
def ref_models():
    """arch -> (reference model, abstract params, logical specs)."""
    out = {}
    for arch in ARCH_IDS:
        model = j_registry.build(j_get_config(arch))
        holder = {}

        def initf():
            p, s = model.init(0)
            holder["specs"] = s
            return p
        out[arch] = (model, jax.eval_shape(initf), holder["specs"])
    return out


@pytest.fixture(scope="module")
def port_models():
    """arch -> (meta model, meta params, logical specs)."""
    out = {}
    for arch in ARCH_IDS:
        model = registry.build(get_config(arch), "meta")
        params, specs = model.init(0)
        out[arch] = (model, params, specs)
    return out


def _stand_in(multi_pod):
    shape, axes = MESHES[multi_pod]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _runnable(arch):
    cfg = get_config(arch)
    return [s for s in SHAPES if shape_skipped(cfg, s) is None]


def _spec(p):
    return tuple(p)


# ---------------------------------------------------------------------------
# launch/analysis.py
# ---------------------------------------------------------------------------

def _generated_hlo():
    lines = []
    for i, dt in enumerate(sorted(analysis._DTYPE_BYTES)):
        op = analysis._COLLECTIVES[i % len(analysis._COLLECTIVES)]
        lines.append(f"%c.{i} = {dt}[{i + 1},3] {op}(%x), replica_groups={{}}")
        lines.append(f"  %s.{i} = ({dt}[{i}], u32[], f32[2,{i + 2}]) "
                     f"{op}-start(%y.{i})")
        lines.append(f"%d.{i} = ({dt}[{i}], u32[]) {op}-done(%s.{i})")
        lines.append(f"%n.{i} = {dt}[7,{i}]{{1,0}} add(%a, %b)")
        lines.append(f"ROOT tuple.{i} = ({dt}[], token[], {dt}[0]) "
                     f"tuple(%p)")
    return "\n".join(lines)


def _compiled_hlo():
    fns = [(lambda x: jnp.tanh(x) @ x.T, (jnp.ones((8, 4), jnp.float32),)),
           (lambda x, y: (x.astype(jnp.bfloat16) * y).sum(0),
            (jnp.ones((5, 3), jnp.int32), jnp.ones((5, 3), jnp.bfloat16))),
           (lambda x: jnp.cumsum(x, 1) > 2, (jnp.ones((2, 9), jnp.uint8),))]
    return "\n".join(jax.jit(f).lower(*a).compile().as_text()
                     for f, a in fns)


@pytest.mark.parametrize("source", ["test_dryrun", "compiled", "generated"])
def test_hlo_parsers_equal_reference(source):
    text = {"test_dryrun": lambda: (ROOT / "tests" / "test_dryrun.py")
            .read_text(),
            "compiled": _compiled_hlo, "generated": _generated_hlo}[source]()
    got = analysis.collective_bytes(text)
    assert got == j_analysis.collective_bytes(text)
    if source == "generated":
        assert got["total"] > 0 and all(got[k] > 0
                                        for k in analysis._COLLECTIVES)
    for line in text.splitlines():
        assert analysis._shape_bytes(line) == j_analysis._shape_bytes(line)
    assert analysis._DTYPE_BYTES == j_analysis._DTYPE_BYTES
    assert analysis._COLLECTIVES == j_analysis._COLLECTIVES


def test_hardware_model_is_one_h100():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.ICI_BW) == \
        (989e12, 3.35e12, 450e9)


# ---------------------------------------------------------------------------
# launch/mesh.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_repeats_one_device(multi_pod):
    shape, axes = MESHES[multi_pod]
    for dev in ("meta", "cpu"):
        m = mesh.make_production_mesh(multi_pod=multi_pod, device=dev)
        assert m.devices.shape == shape and m.axis_names == axes
        assert {d.type for d in m.devices.flat} == {dev}
        assert mesh.rng_axes(m) == axes
        assert sharding.mesh_axis_sizes(m) == \
            j_sharding.mesh_axis_sizes(_stand_in(multi_pod))


def test_host_mesh_equals_reference_and_raises_its_text():
    m = mesh.make_host_mesh(device="cpu")
    ref = j_mesh.make_host_mesh()
    assert m.devices.shape == ref.devices.shape
    assert m.axis_names == tuple(ref.axis_names)
    with pytest.raises(ValueError) as want:
        j_mesh.make_host_mesh(model=2)
    with pytest.raises(ValueError) as got:
        mesh.make_host_mesh(model=2, device="cpu")
    assert "cannot split" in str(got.value)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh.make_mesh_auto((2, 2), ("data", "model"), device="cpu")


# ---------------------------------------------------------------------------
# partition specs, input specs, counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_equal_reference(arch, multi_pod, ref_models,
                                      port_models):
    j_model, j_params, j_specs = ref_models[arch]
    model, params, specs = port_models[arch]
    assert specs == dict(j_specs)
    j_flat = j_flatten(j_params)
    flat = flatten(params)
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in j_flat.items()}
    m = mesh.make_production_mesh(multi_pod=multi_pod, device="meta")
    for mode in ("train", "serve"):
        want = j_sharding.param_pspecs(j_specs, j_flat, _stand_in(multi_pod),
                                       mode)
        got = sharding.param_pspecs(specs, flat, m, mode)
        assert got == {k: _spec(v) for k, v in want.items()}, mode
        tree, spec_tree = steps.param_sharding_tree(model, params, specs, m,
                                                    mode)
        assert flatten(tree) == got and flatten(spec_tree) == got
        opt = steps.opt_sharding_like(tree, m)
        assert opt.step == () and opt.m is tree and opt.v is tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_batch_and_input_specs_equal_reference(arch, ref_models,
                                                     port_models):
    j_model = ref_models[arch][0]
    model = port_models[arch][0]
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    for shape in _runnable(arch):
        want = j_input_specs(j_cfg, shape, j_model)
        got = input_specs(cfg, shape, model)
        assert list(got) == list(want)
        for name in want:
            w = jax.tree.leaves(want[name])
            g = list(dryrun._leaves(got[name]))
            assert [tuple(x.shape) for x in g] == [tuple(x.shape) for x in w]
            assert [x.dtype for x in g] == \
                [DTYPES[str(np.dtype(x.dtype))] for x in w], (shape, name)
            assert all(x.device.type == "meta" for x in g)
        for mp in (False, True):
            j_m, m = _stand_in(mp), mesh.make_production_mesh(
                multi_pod=mp, device="meta")
            B = SHAPES[shape].global_batch
            assert sharding.batch_pspec(m, B) == \
                _spec(j_sharding.batch_pspec(j_m, B))
            bs = steps.batch_sharding(cfg, got, m)
            if "cache" in want:
                ref = j_sharding.cache_pspecs(j_cfg, want["cache"], j_m)
                assert sharding.cache_pspecs(cfg, got["cache"], m) == \
                    tuple(_spec(p) for p in ref)
                assert bs["cache"] == tuple(_spec(p) for p in ref)
                assert bs["pos"] == ()
            for name, t in got.items():
                if name not in ("cache", "pos"):
                    assert bs[name] == _spec(j_sharding.batch_pspec(
                        j_m, B)) + (None,) * (t.dim() - 1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_and_model_flops_equal_reference(arch, ref_dryrun,
                                                ref_models, port_models):
    j_params = ref_models[arch][1]
    params = port_models[arch][1]
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    n = dryrun.count_params(params)
    assert n == ref_dryrun.count_params(j_params)
    act = dryrun.active_params(cfg, params)
    assert act == ref_dryrun.active_params(j_cfg, j_params)
    assert dryrun.np_prod((2, 16, 16)) == ref_dryrun.np_prod((2, 16, 16))
    for shape in SHAPES:
        assert dryrun.model_flops_from_counts(cfg, act, shape) == \
            ref_dryrun.model_flops_from_counts(j_cfg, act, shape)


# ---------------------------------------------------------------------------
# launch/dryrun.py
# ---------------------------------------------------------------------------

def test_argument_bytes_equal_xla_on_forced_devices(ref_procs):
    want = _result(ref_procs[0]["args"], timeout=120)
    assert want["devices"] == 8
    cfg = get_config("glm4_9b").scaled(**TINY)
    model = registry.build(cfg, "meta")
    m = engine.Mesh.of(["meta"] * 8, (4, 2), ("data", "model"))
    tok = torch.empty((TINY_B, TINY_S), dtype=torch.int32, device="meta")
    pre = dryrun.argument_bytes(model, {"tokens": tok}, m, "prefill",
                                torch.bfloat16)
    dec = dryrun.argument_bytes(
        model, {"token": tok[:, :1], "cache": model.init_cache(TINY_B,
                                                               TINY_S),
                "pos": tok[0, 0]}, m, "decode", torch.bfloat16)
    assert (pre["total"], dec["total"]) == (want["prefill"], want["decode"])
    assert dec["cache"] > 0 and pre["cache"] == 0 and pre["opt_state"] == 0


def test_train_argument_bytes_hold_adamw_state(port_models):
    model = port_models["gemma_7b"][0]
    m = mesh.make_production_mesh(device="meta")
    specs = input_specs(model.cfg, "train_4k", model)
    got = dryrun.argument_bytes(model, specs, m, "train")
    serve = dryrun.argument_bytes(model, specs, m, "train", torch.bfloat16)
    assert got["opt_state"] == 2 * got["params"] + 4
    assert 2 * serve["params"] == got["params"]
    assert got["inputs"] == 2 * 256 // 16 * 4096 * 4 + 4
    assert got["total"] == sum(v for k, v in got.items() if k != "total")


REPORT_KEYS = {"arch", "shape", "kind", "mesh", "chips", "lower_s",
               "compile_s", "n_params", "n_params_active", "memory",
               "cost_raw", "collectives_raw", "hlo_lines", "cost_fit",
               "roofline"}
NULL_KEYS = ("lower_s", "compile_s", "cost_raw", "collectives_raw",
             "hlo_lines", "cost_fit")
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s",
                 "model_flops_total", "model_flops_per_chip",
                 "useful_flops_ratio", "bottleneck"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "generated_code_size_in_bytes", "total_bytes_per_device"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lower_cell_reports_reference_keys(arch):
    cfg = get_config(arch)
    for shape in SHAPES:
        for mp in (False, True):
            rep = dryrun.lower_cell(arch, shape, multi_pod=mp)
            if shape_skipped(cfg, shape):
                assert rep == {"arch": arch, "shape": shape,
                               "skipped": shape_skipped(cfg, shape)}
                continue
            assert REPORT_KEYS <= set(rep) and rep["note"]
            assert all(rep[k] is None for k in NULL_KEYS)
            assert set(rep["memory"]) == MEMORY_KEYS
            assert {k for k, v in rep["memory"].items() if v is None} == \
                MEMORY_KEYS - {"argument_size_in_bytes"}
            r = rep["roofline"]
            assert set(r) == ROOFLINE_KEYS
            assert r["collective_s"] is None and \
                r["useful_flops_ratio"] is None
            args = rep["memory"]["argument_size_in_bytes"]
            assert args == rep["arguments"]["total"] > 0
            assert r["memory_s"] == args / analysis.HBM_BW
            assert r["compute_s"] == r["model_flops_per_chip"] / \
                analysis.PEAK_FLOPS
            assert r["bottleneck"] in ("compute_s", "memory_s")
            assert rep["chips"] == (512 if mp else 256)
            json.dumps(rep)


def test_cli_covers_every_cell_of_both_meshes(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.setattr(sys, "argv", ["dryrun", "--all", "--both-meshes",
                                      "--out", str(tmp_path)])
    dryrun.main()
    lines = capsys.readouterr().out.splitlines()
    n_run = sum(len(_runnable(a)) for a in ARCH_IDS)
    assert sum(ln.startswith("[OK] ") for ln in lines) == 2 * n_run
    assert sum(ln.startswith("[SKIP] ") for ln in lines) == \
        2 * (len(ARCH_IDS) * len(SHAPES) - n_run)
    assert len(lines) == 2 * len(ARCH_IDS) * len(SHAPES)
    assert all("args/dev=" in ln for ln in lines if ln.startswith("[OK]"))
    assert len(list(tmp_path.glob("*.json"))) == len(lines)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rng_fanout_cell_equals_generate_on_cpu(multi_pod):
    rep = dryrun.rng_fanout_cell(multi_pod=multi_pod, num_streams=96,
                                 num_steps=8, device="cpu")
    n = 512 if multi_pod else 256
    assert rep["chips"] == n and rep["axes"] == list(MESHES[multi_pod][1])
    for s, size in (("bits", 4), ("uniform", 2)):
        assert rep[s]["equal_to_generate"] is True
        assert rep[s]["shards"] == n
        assert rep[s]["bytes_per_shard"] == 8 * 1 * size
        assert set(rep[s]["collective_bytes"]) == \
            set(analysis._COLLECTIVES) | {"total"}
        assert not any(rep[s]["collective_bytes"].values())


def _as_tensor(dtype, shape, raw_hex):
    raw = np.frombuffer(bytes.fromhex(raw_hex), dtype=np.uint8).copy()
    t = torch.from_numpy(raw).view(DTYPES.get(dtype) or getattr(torch, dtype))
    return t.reshape(shape)


def test_service_cell_on_cpu_serves_the_reference_burst(ref_procs,
                                                        monkeypatch):
    from repro_torch.service import burst
    from repro_torch.service.audit import response_digest
    got = {}
    real = burst.run_burst

    def run_burst(*a, **k):
        out = real(*a, **k)
        got.update(out)
        return out
    monkeypatch.setattr(burst, "run_burst", run_burst)
    rep = dryrun.service_cell(device="cpu")
    procs, path = ref_procs
    ref = _result(procs["service"], timeout=240)
    want = {rid: _as_tensor(*v) for rid, v in
            json.loads(path.read_text()).items()}
    assert rep["replay_ok"] and ref["replay_ok"]
    assert rep["ledger_windows"] == ref["ledger_windows"]
    assert rep["stats"]["requests_served"] == rep["burst"] == 192
    assert sorted(got) == sorted(want)
    reqs = {r.rid: r for r in burst.make_requests(burst=192, tenants=96,
                                                  seed=11)}
    exact = []
    for rid, w in want.items():
        g = got[rid]
        g = g if isinstance(g, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(g))
        assert g.dtype == w.dtype and g.shape == w.shape, rid
        if reqs[rid].sampler.split("(")[0] in LOG_STAGES:
            assert float(sampler.ulp_error(g, w).max()) <= ULP_SLACK, rid
        else:
            exact.append(rid)
    assert len(exact) > len(want) // 2
    assert response_digest({r: got[r] for r in exact}) == \
        response_digest({r: want[r] for r in exact})


def test_dryrun_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (mesh.make_production_mesh,
                 lambda: mesh.make_host_mesh(),
                 lambda: dryrun.service_cell(burst=4, tenants=2),
                 lambda: dryrun.rng_fanout_cell(num_streams=4,
                                                num_steps=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
