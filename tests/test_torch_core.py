"""The port's arithmetic cores and sampler stages against the reference.

Inputs come from a numpy seed and pass between the packages as numpy
arrays; the reference runs on JAX's CPU backend.  Integer paths and the
transcendental-free stages must agree bit for bit.  Stages that use log,
sin or cos are held to 8 units of ``sampler.ulp_error`` (the spacing at
max(|x|, 1)), the reference's own slack; measured on these inputs the
largest gaps are 3 (normal), 2 (exponential), 7 (gamma) and 1 (gumbel).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import golden as j_golden
from repro.core import lcg as j_lcg
from repro.core import sampler as j_sampler
from repro.core import splitmix as j_splitmix
from repro.core import u64 as j_u64
from repro.core import xorshift as j_xorshift
from repro_torch.core import golden as t_golden
from repro_torch.core import lcg as t_lcg
from repro_torch.core import sampler as t_sampler
from repro_torch.core import splitmix as t_splitmix
from repro_torch.core import u64 as t_u64
from repro_torch.core import xorshift as t_xorshift

ROOT = Path(__file__).resolve().parents[1]
M64 = (1 << 64) - 1


def _u64_values(n, seed=0):
    """Random u64 values with the edges that carry: 0, 2**32 - 1, 2**32,
    2**64 - 1 and values that straddle the limbs."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 2 ** 63, n, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, n, dtype=np.uint64)
    edges = np.array([0, 2 ** 32 - 1, 2 ** 32, M64, 2 ** 63, 2 ** 32 + 7],
                     np.uint64)
    return np.concatenate([edges, v])


def _limbs_np(v):
    return ((v >> np.uint64(32)).astype(np.uint32),
            (v & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _t(pair):
    return tuple(t_u64.limbs(torch.from_numpy(p.view(np.int32)))
                 for p in pair)


def _j(pair):
    return tuple(jnp.asarray(p) for p in pair)


def _eq(t_out, j_out):
    if isinstance(t_out, tuple):
        return all(_eq(a, b) for a, b in zip(t_out, j_out))
    return np.array_equal(t_out.numpy().astype(np.uint64),
                          np.asarray(j_out).astype(np.uint64))


# ---------------------------------------------------------------------------
# u64 / lcg / splitmix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["add64", "mul64", "xor64"])
def test_u64_binary_ops_match_reference(op):
    a, b = _u64_values(300, 1), _u64_values(300, 2)[::-1].copy()
    got = getattr(t_u64, op)(_t(_limbs_np(a)), _t(_limbs_np(b)))
    want = getattr(j_u64, op)(_j(_limbs_np(a)), _j(_limbs_np(b)))
    assert _eq(got, want)
    exact = {"add64": a + b, "mul64": a * b, "xor64": a ^ b}[op]
    assert _eq(got, _limbs_np(exact))


@pytest.mark.parametrize("n", [0, 1, 18, 31, 32, 33, 59, 63])
def test_u64_shifts_match_reference(n):
    a = _limbs_np(_u64_values(200, 3))
    assert _eq(t_u64.shr64(_t(a), n), j_u64.shr64(_j(a), n))
    assert _eq(t_u64.shl64(_t(a), n), j_u64.shl64(_j(a), n))


def test_u64_mul32_wide_and_ror32():
    a, b = _limbs_np(_u64_values(300, 4))
    ta, tb = _t((a, b))
    assert _eq(t_u64.mul32_wide(ta, tb), j_u64.mul32_wide(a, b))
    assert _eq(t_u64.mul32_lo(ta, tb), a * b)
    r = (b & np.uint32(31))
    assert _eq(t_u64.ror32(ta, t_u64.limbs(torch.from_numpy(r.view(np.int32)))),
               j_u64.ror32(a, r))


@pytest.mark.parametrize("n", [0, 1, 7, 256, 12345, 2 ** 32 + 7, M64])
def test_lcg_skip_matches_reference(n):
    assert t_lcg.lcg_skip(n) == j_lcg.lcg_skip(n)


def test_block_affine_constants_match_reference():
    for got, want in zip(t_lcg.block_affine_constants(300),
                         j_lcg.block_affine_constants(300)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("ctr", [0, 12345, 2 ** 32 + 7])
@pytest.mark.parametrize("n", [1, 9, 300])
def test_root_states_vector_matches_reference(ctr, n):
    """Against the reference golden root sequence at every (ctr, n), and
    against the reference's own jump-ahead vector at the largest."""
    x0 = 0x0123456789ABCDEF
    got = t_lcg.root_states_vector(x0, ctr, n)
    A, C = j_lcg.lcg_skip(ctr)
    assert _eq(got, _limbs_np(j_golden.lcg_seq((A * x0 + C) & M64, n)))
    if (ctr, n) == (2 ** 32 + 7, 300):
        want = j_lcg.root_states_vector(
            j_u64.const64(x0),
            tuple(jnp.asarray(v) for v in j_u64.const64(ctr)), n)
        assert _eq(got, want)


def test_xsh_rr_matches_reference():
    s = _limbs_np(_u64_values(400, 5))
    assert _eq(t_lcg.xsh_rr(_t(s)), j_lcg.xsh_rr(_j(s)))


def test_splitmix_functions_match_reference():
    h = _limbs_np(_u64_values(300, 6))
    c = _limbs_np(_u64_values(300, 7))
    assert _eq(t_splitmix.mix64(_t(h)), j_splitmix.mix64(_j(h)))
    assert _eq(t_splitmix.splitmix64(_t(h), _t(c)),
               j_splitmix.splitmix64(_j(h), _j(c)))
    assert _eq(t_splitmix.ctr_decorrelator(_t(h), _t(c)),
               j_splitmix.ctr_decorrelator(_j(h), _j(c)))
    assert _eq(t_splitmix.ctr_decorrelator32(_t(h), _t(c)),
               j_splitmix.ctr_decorrelator32(_j(h), _j(c)))
    assert _eq(t_splitmix.fmix32(_t(h)[1]), j_splitmix.fmix32(h[1]))
    for hv, cv in zip(_u64_values(20, 8).tolist(), _u64_values(20, 9).tolist()):
        assert t_splitmix.splitmix64_host(hv, cv) == \
            j_splitmix.splitmix64_host(hv, cv)
        assert t_splitmix.ctr_decorrelator_host(hv, cv) == \
            j_splitmix.ctr_decorrelator_host(hv, cv)
        assert t_splitmix.ctr_decorrelator32_host(hv, cv) == \
            j_splitmix.ctr_decorrelator32_host(hv, cv)


# ---------------------------------------------------------------------------
# xorshift / golden
# ---------------------------------------------------------------------------

def test_xorshift_tables_and_jumps_match_reference():
    assert t_xorshift.step_matrix() == j_xorshift.step_matrix()
    assert t_xorshift.matrix_pow2(5) == j_xorshift.matrix_pow2(5)
    tbl = t_xorshift.lane_table(37)
    assert np.array_equal(tbl, j_xorshift.lane_table(37))
    for n in (1, 256, 12345, 2 ** 32 + 7):
        assert np.array_equal(t_xorshift.jump_batch(tbl, n),
                              j_xorshift.jump_batch(tbl, n))
    st = tuple(int(v) for v in tbl[3])
    assert t_xorshift.jump(st, 999) == j_xorshift.jump(st, 999)


def test_xorshift_step_matches_reference():
    rng = np.random.default_rng(10)
    w = rng.integers(0, 2 ** 32, (4, 50), dtype=np.uint64).astype(np.uint32)
    got = t_xorshift.step_xyzw(*(t_u64.limbs(torch.from_numpy(r.view(np.int32)))
                                 for r in w))
    want = j_xorshift.step_xyzw(*(jnp.asarray(r) for r in w))
    assert _eq(tuple(got), tuple(want))


@pytest.mark.parametrize("mode", ["ctr", "faithful"])
def test_golden_matches_reference_golden(mode):
    h = _u64_values(5, 11) & np.uint64(M64 - 1)
    for off in (0, 2 ** 32 + 7):
        assert np.array_equal(
            t_golden.thundering_block(0xDEADBEEF, h, 12, mode=mode,
                                      offset=off),
            j_golden.thundering_block(0xDEADBEEF, h, 12, mode=mode,
                                      offset=off))
    assert np.array_equal(t_golden.pcg32_seq(42, 54, 8),
                          j_golden.pcg32_seq(42, 54, 8))


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "bits", "uniform", "normal", "gumbel", "bernoulli(0.25)",
    "exponential(1.5)", "poisson(0.0)", "gamma(2.5)", "gamma(2.5, 0.5)",
    "categorical[1,1,2]", "categorical[ 0.5 , 0.5 ]"])
def test_parse_accepts_like_reference(text):
    assert t_sampler.parse(text) == j_sampler.parse(text)


@pytest.mark.parametrize("bad", [
    "gamma", "gamma()", "gamma(0.5)", "gamma(nan)", "exponential(0)",
    "exponential(-1)", "poisson(-0.5)", "poisson(33)", "poisson(two)",
    "categorical[]", "categorical[1,-2]", "categorical[0,0]",
    "categorical[" + ",".join(["1"] * 65) + "]", "exponential[1.5]",
    "weibull(2.0)", "gamma(2.0,0)", "gamma(0.5,1.0)"])
def test_parse_rejects_with_reference_text(bad):
    with pytest.raises(ValueError) as want:
        j_sampler.parse(bad)
    with pytest.raises(ValueError) as got:
        t_sampler.parse(bad)
    assert str(got.value) == str(want.value)
    assert t_sampler.SPEC_GRAMMAR == j_sampler.SPEC_GRAMMAR


def test_host_constants_match_reference():
    for p in (0.0, 1e-9, 0.25, 0.5, 1 - 1e-12, 1.0):
        assert t_sampler.bernoulli_threshold(p) == \
            j_sampler.bernoulli_threshold(p)
    for r in (0.0, 0.5, 3.5, 10.0, 32.0):
        assert t_sampler.poisson_thresholds(r) == \
            j_sampler.poisson_thresholds(r)
    for k in (1.0, 1.5, 2.5, 4.0, 100.0):
        assert t_sampler.gamma_mt_constants(k) == \
            j_sampler.gamma_mt_constants(k)
    for w in ((1.0,), (0.5, 0.25, 0.25), (0.5, 0.25, 0.125, 0.125),
              tuple(float(i % 7) for i in range(1, 64))):
        assert t_sampler.alias_table(w) == j_sampler.alias_table(w)


def _stage_bits():
    rng = np.random.default_rng(12)
    b = rng.integers(0, 2 ** 32, (64, 96), dtype=np.uint64).astype(np.uint32)
    b[0, :6] = [0, 1, 255, 256, 0xFFFFFF00, 0xFFFFFFFF]
    return b


def _as_float_np(t):
    return t.float().numpy()


EXACT = ["bits", "uniform", "bernoulli(0.3)", "bernoulli(0.0)",
         "bernoulli(1.0)", "poisson(3.5)", "poisson(25.0)",
         "categorical[0.5,0.25,0.125,0.125]", "categorical[3.0]"]
ULP = ["normal", "exponential(1.5)", "gamma(2.5)", "gamma(1.0)",
       "gamma(3.0,0.5)", "gumbel"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", EXACT + ULP)
def test_apply_matches_reference(spec, dtype):
    bits = _stage_bits()
    want = j_sampler.apply(jnp.asarray(bits), j_sampler.parse(spec), dtype)
    got = t_sampler.apply(t_u64.limbs(torch.from_numpy(bits.view(np.int32))),
                          t_sampler.parse(spec), dtype)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    if got.dtype in (torch.uint32, torch.bool):
        assert np.array_equal(got.numpy(), want)
        return
    assert got.dtype == t_sampler.FLOAT_DTYPES[dtype]
    if spec in EXACT:
        raw = torch.int32 if dtype == "float32" else torch.int16
        assert np.array_equal(got.view(raw).numpy(),
                              want.view(np.int32 if dtype == "float32"
                                        else np.int16))
    else:
        ref = torch.from_numpy(want.astype(np.float32)).to(got.dtype)
        assert float(t_sampler.ulp_error(got, ref).max()) <= 8.0


def test_stage_params_cover_every_stage():
    for spec in EXACT + ULP:
        for dtype in ("float32", "bfloat16"):
            rec = t_sampler.stage_params(t_sampler.parse(spec), dtype)
            assert rec[0] == t_sampler.STAGE_IDS[t_sampler.parse(spec)[0]]
    rec = t_sampler.stage_params(t_sampler.parse("poisson(3.5)"))
    assert rec[7] == list(j_sampler.poisson_thresholds(3.5))


def test_result_dtype_and_bad_dtype():
    assert t_sampler.result_dtype(("bits", None)) == torch.uint32
    assert t_sampler.result_dtype(("bernoulli", 0.5)) == torch.bool
    assert t_sampler.result_dtype(("poisson", 2.0), "bfloat16") == \
        torch.bfloat16
    with pytest.raises(ValueError, match="unknown out_dtype"):
        t_sampler.result_dtype(("uniform", None), "float16")


# ---------------------------------------------------------------------------
# isolation: the port never loads JAX or the reference package
# ---------------------------------------------------------------------------

PORT_MODULES = [
    "repro_torch", "repro_torch.core", "repro_torch.core.u64",
    "repro_torch.core.lcg", "repro_torch.core.splitmix",
    "repro_torch.core.xorshift", "repro_torch.core.golden",
    "repro_torch.core.sampler", "repro_torch.core.engine",
    "repro_torch.core.stream", "repro_torch.kernels",
    "repro_torch.kernels.ref", "repro_torch.kernels.build",
    "repro_torch.kernels.thundering_block", "repro_torch.kernels.mc",
    "repro_torch.kernels.fused_dropout", "repro_torch.kernels.ops",
    "repro_torch.runtime", "repro_torch.runtime.blocks",
    "repro_torch.runtime.fault", "repro_torch.service",
    "repro_torch.service.tenants", "repro_torch.service.frontend",
    "repro_torch.service.audit", "repro_torch.inference",
    "repro_torch.inference.kernels",
    "repro_torch.inference.kernels.gumbel_argmax",
    "repro_torch.inference.sampling", "repro_torch.inference.slots",
    "repro_torch.inference.scheduler", "repro_torch.inference.harness",
    "repro_torch.core.statistics", "repro_torch.core.baselines",
    "repro_torch.quality", "repro_torch.quality.crush",
    "repro_torch.quality.cross", "repro_torch.quality.pit",
    "repro_torch.quality.battery", "repro_torch.quality.render",
    "repro_torch.quality.__main__", "repro_torch.service.burst",
    "repro_torch.service.server", "repro_torch.service.transport",
    "repro_torch.service.fleet", "repro_torch.service.__main__",
    "repro_torch.configs", "repro_torch.configs.base",
    *(f"repro_torch.configs.{a}" for a in (
        "gemma_7b", "glm4_9b", "qwen15_32b", "granite_34b", "qwen2_vl_72b",
        "granite_moe_3b", "olmoe_1b_7b", "mamba2_2p7b", "zamba2_7b",
        "whisper_small")),
    "repro_torch.models", "repro_torch.models.common",
    "repro_torch.models.sharding", "repro_torch.models.layers",
    "repro_torch.models.transformer", "repro_torch.models.registry",
    "repro_torch.models.convert", "repro_torch.data",
    "repro_torch.data.pipeline", "repro_torch.launch",
    "repro_torch.launch.train", "repro_torch.launch.steps",
    "repro_torch.launch.serve", "repro_torch.optim",
    "repro_torch.optim.adamw", "repro_torch.optim.schedule",
    "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint"]


def test_port_imports_neither_jax_nor_reference():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'ml_dtypes'))\n"
            "assert not bad, bad\n"
            "from repro_torch.runtime.blocks import BlockService\n"
            "svc = BlockService(seed=1, device='cpu')\n"
            "svc.open('c', num_streams=3); svc.take('c', 4)\n"
            "from repro_torch.kernels import ops\n"
            "from repro_torch.runtime import blocks\n"
            "import torch\n"
            "blocks.estimate_pi(svc, num_lanes=8, draws_per_lane=16)\n"
            "blocks.price_option(svc, num_lanes=8, draws_per_lane=16)\n"
            "svc.open('d')\n"
            "ops.fused_dropout(torch.ones(4, 8), svc.lease('d', 32), 0.5)\n"
            "from repro_torch.inference import GumbelMaxSampler, ActiveSeq\n"
            "s = GumbelMaxSampler.standalone(seed=2, vocab=16, capacity=2, "
            "device='cpu')\n"
            "a = [ActiveSeq(slot=0, seq_id='q', tenant_id='q', "
            "tag=s.registry.register('q').tag(0), position=0)]\n"
            "assert s.sample_step(0, torch.zeros(2, 16), a).shape == (2,)\n"
            "from repro_torch.core import engine\n"
            "mesh = engine.Mesh.of(['cpu'] * 3, (3,), ('streams',))\n"
            "ms = BlockService(seed=1, mesh=mesh, device='cpu')\n"
            "ms.open('m', num_streams=5, mode='faithful'); ms.take('m', 4)\n"
            "from repro_torch.service import Coalescer, RandRequest, "
            "TenantRegistry\n"
            "Coalescer(svc, TenantRegistry()).flush("
            "[RandRequest('t', (3,), rid='r')])\n"
            "from repro_torch.quality import run_battery\n"
            "run_battery('tiny', device='cpu', generators=["
            "'thundering/ctr/service', 'ablation/raw_lcg_pit'])\n"
            "from repro_torch.service import RandServer, ServerConfig\n"
            "srv = RandServer(seed=2, config=ServerConfig(max_batch=2, "
            "hot_classes=(('bits', 'float32'),), pool_rows=8, "
            "pool_cols=4), device='cpu')\n"
            "assert srv.request('t', (5,)).shape == (5,)\n"
            "assert srv.request('t', (3,), 'uniform', 'bfloat16').dtype == "
            "torch.bfloat16\n"
            "assert srv.shutdown()\n"
            "from repro_torch.configs import get_config\n"
            "from repro_torch.launch import serve, train\n"
            "toks, _ = serve.serve(train.smoke_config(get_config("
            "'qwen2_vl_72b')).scaled(vision_prefix=4), batch=2, "
            "prompt_len=4, gen=3, temperature=0.8, device='cpu')\n"
            "assert toks.shape == (2, 3)\n"
            "import tempfile\n"
            "from repro_torch.runtime import FaultTolerantLoop\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    p, o, l = train.train(train.smoke_config(get_config("
            "'gemma_7b')), steps=1, global_batch=2, seq_len=8, ckpt_dir=d, "
            "save_every=1, device='cpu')\n"
            "assert int(o.step) == 1 and len(l) == 1\n"
            "assert not {'jax', 'repro', 'ml_dtypes'} & set(sys.modules)\n"
            "print('isolated')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_chip_smoke_imports_neither_jax_nor_reference():
    import re
    src = (ROOT / "chip_smoke.py").read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    assert imports, "no imports found"
    for mod in imports:
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.core import engine, stream
    from repro_torch.runtime.blocks import BlockService
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.make_plan(seed=1, num_streams=2, num_steps=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.new_stream(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockService(seed=1)
    from repro_torch.kernels import ops
    for call in (lambda: ops.estimate_pi(seed=1, num_lanes=2,
                                         draws_per_lane=4),
                 lambda: ops.price_option(seed=1, num_lanes=2,
                                          draws_per_lane=4),
                 lambda: ops.thundering_bulk(seed=1, num_streams=2,
                                             num_steps=4),
                 lambda: ops.h_table(1, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """``train``, the train CLI, ``make_train_step`` (through the model it
    steps), the checkpoint loader and the loop's restore default to the
    card and raise without one; ``device="cpu"`` runs them on the CPU."""
    from repro_torch.checkpoint import CheckpointManager, load_checkpoint, \
        save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import FaultTolerantLoop
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = train.smoke_config(get_config("glm4_9b"))
    kw = dict(steps=1, global_batch=2, seq_len=8, save_every=1)
    save_checkpoint(str(tmp_path / "c"), 1, {"x": torch.ones(2)})
    loop = FaultTolerantLoop(CheckpointManager(str(tmp_path / "c")))
    for call in (
            lambda: train.train(cfg, ckpt_dir=str(tmp_path / "a"), **kw),
            lambda: train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                                str(tmp_path / "b")]),
            lambda: steps.make_train_step(registry.build(cfg)),
            lambda: load_checkpoint(str(tmp_path / "c")),
            lambda: loop._restore_or_init(lambda: None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()
    m = registry.build(cfg, "cpu")
    step = steps.make_train_step(m)
    params, _ = m.init(0)
    batch = train.pipeline_for(cfg, 2, 8, 0, device="cpu").batch_at(0)
    _, opt, met = step(params, adamw_init(params), batch, 0)
    assert int(opt.step) == 1 and met["step"] == 1
    tree, step_n, _ = load_checkpoint(str(tmp_path / "c"), device="cpu")
    assert step_n == 1 and tree["x"].device.type == "cpu"
    _, _, losses = train.train(cfg, ckpt_dir=str(tmp_path / "d"),
                               device="cpu", **kw)
    assert len(losses) == 1
