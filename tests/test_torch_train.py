"""The port's training path (``launch.steps.make_train_step``,
``launch.train.train`` / ``main``, remat, the deterministic embedding
backward) against the reference's, on the CPU.

Tolerances, measured on these inputs and stated per case:
  * losses within ``LOSS_ATOL`` = 0.02, the forward's logit tolerance
    (``tests/test_torch_models.py``); the train step's measured 8e-6,
    ``train``'s four logged losses 2e-5.
  * gradients, per leaf: max |port - reference| <= 2^-5 of the leaf's
    largest reference gradient (measured at most 1.25e-2, the embedding)
    and the RMS difference <= 2^-6 of the reference's RMS (at most
    8.7e-3).  bf16 activations round at different places in the two
    frameworks; their gradients are bf16 values.
  * one AdamW step on those gradients: each element's new value within
    2 * lr + 2 ULP of the reference's (a gradient near zero may change
    sign), and, wherever the reference's gradient g is at least twice the
    gradient tolerance (so its relative error is below 1/2), within
    lr * eps / |g * scale| + 2 ULP: the first step's update is
    g / (|g| + eps) after clipping by ``scale``, which moves by at most
    that much.
Inside the port every comparison is bit for bit: a resumed run, the
service and ``--no-service`` paths, ``remat`` on and off, repeated
embedding backward passes.
"""
from __future__ import annotations

import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import stream as j_stream
from repro.launch import steps as j_steps
from repro.launch import train as j_train
from repro.models import registry as j_registry
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import stream as t_stream
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import convert
from repro_torch.models import layers as tL
from repro_torch.models import registry as t_registry
from repro_torch.models.common import flatten
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule

CPU = "cpu"
LOSS_ATOL = 0.02
GRAD_MAX_REL, GRAD_RMS_REL = 2.0 ** -5, 2.0 ** -6
STEP_LR, EPS = 1e-2, 1e-8        # the step's peak lr; AdamW's eps
TRAIN_KW = dict(steps=4, global_batch=2, seq_len=32, seed=1, save_every=2,
                log_every=1)


def _cfgs(arch, **over):
    return (j_train.smoke_config(j_get_config(arch)).scaled(**over),
            t_train.smoke_config(t_get_config(arch)).scaled(**over))


def _np_flat(tree):
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in flatten(tree).items()}


def _bits_equal(a, b):
    fa, fb = _np_flat(a), _np_flat(b)
    assert set(fa) == set(fb)
    return all(np.array_equal(fa[k].view(np.uint8), fb[k].view(np.uint8))
               for k in fa)


@pytest.fixture(scope="module")
def ref_setup():
    """Per arch: the reference's model, jitted init params, a batch, and
    its ((loss, metrics), grads) at step 0's rng."""
    out = {}
    jrng = j_stream.derive(j_stream.new_stream(0, 0xD07), jnp.uint32(0))
    for arch in ("glm4_9b", "gemma_7b"):
        jc, tc = _cfgs(arch)
        jm = j_registry.build(jc)
        jp = jax.jit(lambda m=jm: m.init(3)[0])()
        jb = j_train.pipeline_for(jc, 4, 128, 5).batch_at(0)
        vg = jax.jit(jax.value_and_grad(
            lambda p, m=jm, b=jb: m.loss(p, b, jrng), has_aux=True))(jp)
        out[arch] = (jc, tc, jm, jp, jb, vg)
    return out


def _torch_batch(jb):
    return {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


# ---------------------------------------------------------------------------
# make_train_step against the reference on carried-over parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["glm4_9b", "gemma_7b"])
def test_loss_and_gradients_match_reference(arch, ref_setup):
    jc, tc, jm, jp, jb, ((jl, jmet), jg) = ref_setup[arch]
    tm = t_registry.build(tc, CPU)
    tp = convert.params_from_reference(tc, jp, device=CPU)
    trng = t_stream.derive(t_stream.new_stream(0, 0xD07, device=CPU), 0)
    (tl, tmet), tg = t_steps.value_and_grad(tm, tp, _torch_batch(jb), trng)
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    assert set(tmet) == set(jmet)
    want, got = _np_flat(jax.tree.map(np.asarray, jg)), _np_flat(tg)
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == np.float32 and g.shape == w.shape, k
        d = g.astype(np.float64) - w
        assert np.abs(d).max() <= GRAD_MAX_REL * np.abs(w).max(), k
        assert np.sqrt(np.mean(d ** 2)) <= GRAD_RMS_REL * np.sqrt(
            np.mean(np.square(w, dtype=np.float64))), k
    # the params are read, never written
    assert _bits_equal(tp, convert.params_from_reference(tc, jp, device=CPU))


@pytest.mark.parametrize("arch,kw", [
    ("glm4_9b", {}), ("gemma_7b", {}),
    ("gemma_7b", dict(microbatches=2, param_dtype="bf16"))])
def test_train_step_matches_reference(arch, kw, ref_setup):
    jc, tc, jm, jp, jb, (_, jg) = ref_setup[arch]
    tm = t_registry.build(tc, CPU)
    args = dict(seed=0, peak_lr=STEP_LR, warmup=1, total_steps=10, **kw)
    jstep = jax.jit(j_steps.make_train_step(jm, **args))
    jp1, jo1, jmet = jstep(jp, j_adamw.adamw_init(jp), jb, jnp.int32(0))
    tp = convert.params_from_reference(tc, jp, device=CPU)
    tstep = t_steps.make_train_step(tm, **args)
    tp1, to1, tmet = tstep(tp, adamw_init(tp), _torch_batch(jb), 0)
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= LOSS_ATOL
    assert tmet["step"] == int(jmet["step"]) == 1 and int(to1.step) == 1
    scale = min(1.0, 1.0 / float(j_adamw.global_norm(jg)))
    p0, g0 = _np_flat(jax.tree.map(np.asarray, jp)), \
        _np_flat(jax.tree.map(np.asarray, jg))
    want, got = _np_flat(jax.tree.map(np.asarray, jp1)), _np_flat(tp1)
    for k, w in want.items():
        d = np.abs(got[k].astype(np.float64) - w)
        ulp = np.spacing(np.maximum(np.abs(w), np.abs(p0[k])))
        assert (d <= 2 * STEP_LR + 2 * ulp).all(), k
        gs = np.abs(g0[k]) * scale
        firm = np.abs(g0[k]) >= 2 * GRAD_MAX_REL * np.abs(g0[k]).max()
        assert firm.any(), k
        assert (d[firm] <= STEP_LR * EPS / gs[firm] + 2 * ulp[firm]).all(), k


def test_train_step_is_value_and_grad_then_adamw():
    _, tc = _cfgs("glm4_9b")
    tm = t_registry.build(tc, CPU)
    batch = t_train.pipeline_for(tc, 2, 64, 3, device=CPU).batch_at(0)
    p1, _ = tm.init(0)
    p2, _ = tm.init(0)
    step = t_steps.make_train_step(tm, seed=4, peak_lr=STEP_LR, warmup=1)
    p1, o1, met = step(p1, adamw_init(p1), batch, 0)
    rng = t_stream.derive(t_stream.new_stream(4, 0xD07, device=CPU), 0)
    (loss, _), g = t_steps.value_and_grad(tm, p2, batch, rng)
    p2, o2 = adamw_update(g, adamw_init(p2), p2,
                          lr=cosine_schedule(STEP_LR, 1, 10_000))
    assert float(met["loss"]) == float(loss)
    assert _bits_equal(p1, p2) and _bits_equal(o1.m, o2.m)


# ---------------------------------------------------------------------------
# bit-identity inside the port
# ---------------------------------------------------------------------------

def test_remat_full_and_none_give_bit_equal_gradients():
    _, tc = _cfgs("gemma_7b")
    batch = t_train.pipeline_for(tc, 2, 256, 3, device=CPU).batch_at(0)
    out = {}
    for remat in ("full", "none"):
        m = t_registry.build(tc.scaled(remat=remat), CPU)
        params, _ = m.init(0)
        out[remat] = t_steps.value_and_grad(m, params, batch)
    (l1, _), g1 = out["full"]
    (l2, _), g2 = out["none"]
    assert float(l1) == float(l2) and _bits_equal(g1, g2)


def test_remat_leaves_the_forward_unchanged():
    _, tc = _cfgs("glm4_9b")
    m = t_registry.build(tc, CPU)
    params, _ = m.init(0)
    batch = t_train.pipeline_for(tc, 2, 128, 3, device=CPU).batch_at(0)
    with torch.no_grad():
        want, _ = m.forward(params, batch)
    grad_params = {k: ({kk: vv.detach().requires_grad_()
                        for kk, vv in v.items()} if isinstance(v, dict)
                       else v.detach().requires_grad_())
                   for k, v in params.items()}
    got, _ = m.forward(grad_params, batch)      # remat'd layers and chunks
    assert got.requires_grad
    assert torch.equal(got.detach(), want)


def test_embedding_backward_is_deterministic_and_ordered():
    rng = np.random.default_rng(0)
    V, D = 512, 64
    w = np.arange(1, V + 1) ** -1.1
    toks = torch.from_numpy(np.searchsorted(np.cumsum(w) / w.sum(),
                                            rng.random((8, 256)))
                            .clip(0, V - 1).astype(np.int32))
    g = torch.from_numpy(rng.normal(0, 1, (8, 256, D)).astype(np.float32)
                         ).to(torch.bfloat16)
    table = torch.from_numpy(rng.normal(0, 1, (V, D)).astype(np.float32))
    want = torch.zeros(V, D)                     # in order of occurrence
    for j, t in enumerate(toks.reshape(-1).tolist()):
        want[t] += g.reshape(-1, D)[j].float()
    for _ in range(5):
        t = table.clone().requires_grad_()
        (got,) = torch.autograd.grad(tL.embed(toks, t), t, g)
        assert torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(tL.embed(toks, table),
                           table[toks.long()].to(torch.bfloat16))


def test_train_resumes_bit_identically_after_failure(tmp_path):
    _, tc = _cfgs("glm4_9b")
    kw = dict(TRAIN_KW, steps=5)
    p1, o1, l1 = t_train.train(tc, ckpt_dir=str(tmp_path / "a"), fail_at=3,
                               device=CPU, **kw)
    p2, o2, l2 = t_train.train(tc, ckpt_dir=str(tmp_path / "b"), device=CPU,
                               **kw)
    assert _bits_equal(p1, p2) and _bits_equal(o1.m, o2.m) \
        and _bits_equal(o1.v, o2.v)
    assert int(o1.step) == int(o2.step) == 5
    assert [s for s, _ in l1] == [0, 1, 2, 2, 3, 4]   # resumed at step 2
    assert dict(l1) == dict(l2)


def test_train_service_path_bit_identical_to_no_service(tmp_path):
    _, tc = _cfgs("gemma_7b")
    runs = {}
    for use_service in (True, False):
        runs[use_service] = t_train.train(
            tc, ckpt_dir=str(tmp_path / str(use_service)),
            use_service=use_service, device=CPU, **TRAIN_KW)
    (p1, _, l1), (p2, _, l2) = runs[True], runs[False]
    assert l1 == l2 and _bits_equal(p1, p2)


# ---------------------------------------------------------------------------
# train() and the CLI against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_train(tmp_path_factory):
    """The reference's 4-step run, and a directory holding only its step-2
    checkpoint (what a run cut after step 2 leaves)."""
    jc, _ = _cfgs("glm4_9b")
    d4 = tmp_path_factory.mktemp("ref4")
    run4 = j_train.train(jc, ckpt_dir=str(d4), **TRAIN_KW)
    d2 = tmp_path_factory.mktemp("ref2")
    shutil.copytree(d4 / "step_00000002", d2 / "step_00000002")
    return run4, d2


def test_train_losses_match_reference(tmp_path, ref_train):
    (jp, _, jl), _ = ref_train
    _, tc = _cfgs("glm4_9b")
    tp, _, tl = t_train.train(tc, ckpt_dir=str(tmp_path), device=CPU,
                              **TRAIN_KW)
    assert [s for s, _ in tl] == [s for s, _ in jl] == [0, 1, 2, 3]
    assert max(abs(a - b) for (_, a), (_, b) in zip(tl, jl)) <= LOSS_ATOL


def test_port_resumes_a_reference_checkpoint(ref_train):
    (jp, jo, jl), d2 = ref_train
    _, tc = _cfgs("glm4_9b")
    tp, to, tl = t_train.train(tc, ckpt_dir=str(d2), device=CPU, **TRAIN_KW)
    assert [s for s, _ in tl] == [2, 3]           # resumed at step 2
    assert max(abs(a - dict(jl)[s]) for s, a in tl) <= LOSS_ATOL
    assert int(to.step) == int(jo.step) == 4
    # steps 2 and 3 each move an element by at most 2 lr more than the
    # reference's (train's schedule: peak 3e-4, warmup 100)
    lr = cosine_schedule(3e-4, 100, 4)
    bound = 2 * (float(lr(3)) + float(lr(4))) + 1e-6
    want = _np_flat(jax.tree.map(np.asarray, jp))
    for k, g in _np_flat(tp).items():
        assert np.abs(g - want[k]).max() <= bound, k
    from repro_torch.checkpoint import load_checkpoint
    _, step, extra = load_checkpoint(str(d2), device=CPU)
    assert step == 4 and extra["rng_ledger"]["channels"]["data/batches"][
        "committed"] == [[0, 4]]


def test_cli_on_the_cpu_prints_the_in_process_losses(tmp_path, capsys):
    t_train.main(["--device", "cpu", "--arch", "glm4_9b", "--smoke",
                  "--steps", "3", "--global-batch", "2", "--seq-len", "32",
                  "--seed", "1", "--save-every", "2", "--ckpt-dir",
                  str(tmp_path / "cli")])
    cli = capsys.readouterr().out
    _, tc = _cfgs("glm4_9b")
    t_train.train(tc, steps=3, global_batch=2, seq_len=32, seed=1,
                  save_every=2, ckpt_dir=str(tmp_path / "lib"), device=CPU)
    lib = capsys.readouterr().out
    lines = re.findall(r"^step .*$", cli, re.M)
    assert len(lines) == 3 and lines == re.findall(r"^step .*$", lib, re.M)
    assert "done: 3 steps, 192 tokens" in cli
    assert sorted(p.name for p in (tmp_path / "cli").iterdir()) == [
        "step_00000002", "step_00000003"]
