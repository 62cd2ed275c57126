"""The port's optimizer (``repro_torch.optim``) against the reference's
``repro.optim``, on the CPU, and the reference's own optimizer tests
(``tests/test_substrate.py``) mirrored.

Tolerances, stated per case (``ULP`` = float32 units in the last place):
  * ``cosine_schedule``: bit-equal through the warmup; within 1 ULP over
    the first quarter of the decay and within 5 ULP over all of it.  Both
    evaluate the same float32 ops; the cosines differ in their last bit
    in ~5 % of steps (XLA:CPU's own ``cos``), and ``1 + cos`` amplifies
    that where it cancels, late in the decay.
  * ``global_norm``: within 2 ULP (the order of float32 summation).
  * ``adamw_update`` against the reference run op by op (eagerly):
    bit-equal, parameters and moments, over 5 steps at a large learning
    rate without clipping.  With clipping the scale comes from a float32
    sum whose order differs (``global_norm``), so the jitted comparison
    below covers it.
  * ``adamw_update`` against the jitted reference after 5 steps of the
    reference's default schedule: within ``ADAMW_ULP`` = 5 ULP of the
    larger of each parameter's magnitudes before and after (at most 4.5
    measured, with bf16 compression and clipping; 99.6 % bit-equal).
    XLA:CPU contracts ``b1*m + (1-b1)*g`` and others into FMAs where the
    port rounds each op.  The moments carry the same absolute error,
    held relative to the leaf's largest moment.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro.optim import schedule as j_schedule
from repro_torch.optim import AdamWState, adamw_init, adamw_update, \
    cosine_schedule
from repro_torch.optim import adamw as t_adamw

ADAMW_ULP = 5
SHAPES = {"a": (64, 33), "b": {"c": (17,), "d": (8, 8, 5)}, "e": (3, 1001)}


def _ordered(a) -> np.ndarray:
    i = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(2 ** 31) - i, i)


def _ulp(a, b) -> np.ndarray:
    return np.abs(_ordered(a) - _ordered(b))


def _tree(rng, shapes, scale):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return rng.normal(0, scale, shapes).astype(np.float32)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# schedule and norm against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 100, 10_000),
                                                (1.0, 10, 100),
                                                (0.1, 0, 50)])
def test_cosine_schedule_matches_reference(peak, warmup, total):
    steps = np.arange(0, total + 20)
    want = np.asarray(j_schedule.cosine_schedule(peak, warmup, total)(
        jnp.asarray(steps, jnp.int32)), np.float32)
    lr = cosine_schedule(peak, warmup, total)
    got = lr(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    d = _ulp(got, want)
    assert not d[:warmup].any()
    assert d[:warmup + (total - warmup) // 4].max() <= 1
    assert d.max() <= 5
    one = lr(7)                       # a python int gives the same value
    assert one.shape == () and one.view(torch.int32) == \
        torch.from_numpy(got[7:8]).view(torch.int32)[0]


def test_global_norm_matches_reference():
    tree = _tree(np.random.default_rng(1), SHAPES, 3.0)
    want = np.float32(j_adamw.global_norm(_jax(tree)))
    got = t_adamw.global_norm(_torch(tree))
    assert got.dtype == torch.float32 and got.shape == ()
    assert _ulp(got.numpy(), want).max() <= 2


# ---------------------------------------------------------------------------
# adamw_update against the jitted reference
# ---------------------------------------------------------------------------

def _run_both(update, clip_norm, compress, lr_args, steps=5, seed=7):
    rng = np.random.default_rng(seed)
    p0 = _tree(rng, SHAPES, 0.05)
    j_lr = j_schedule.cosine_schedule(*lr_args)
    t_lr = cosine_schedule(*lr_args)
    jp, jo = _jax(p0), j_adamw.adamw_init(_jax(p0))
    tp = _torch(p0)
    to = adamw_init(tp)
    for _ in range(steps):
        g = _tree(rng, SHAPES, 1.0)
        jp, jo = update(_jax(g), jo, jp, j_lr)
        tp, to = adamw_update(_torch(g), to, tp, lr=t_lr,
                              clip_norm=clip_norm, compress=compress)
    assert int(to.step) == int(jo.step) == steps
    assert to.step.dtype == torch.int32
    return _flat(p0), (jp, jo), (tp, to)


@pytest.mark.parametrize("compress", [None, "bf16"])
def test_adamw_update_equals_reference_op_by_op(compress):
    def eager(g, o, p, lr):
        return j_adamw.adamw_update(g, o, p, lr=lr, clip_norm=1e4,
                                    compress=compress)
    _, (jp, jo), (tp, to) = _run_both(eager, 1e4, compress, (1e-2, 2, 20))
    for jt, tt in ((jp, tp), (jo.m, to.m), (jo.v, to.v)):
        want, got = _flat(jt), _flat(tt)
        assert set(want) == set(got)
        for k in want:
            assert np.array_equal(got[k].view(np.int32),
                                  want[k].view(np.int32)), k


@pytest.mark.parametrize("clip_norm", [1.0, 1e4])     # clipping on / off
@pytest.mark.parametrize("compress", [None, "bf16"])
def test_adamw_update_within_ulp_of_jitted_reference(clip_norm, compress):
    upd = jax.jit(lambda g, o, p: j_adamw.adamw_update(
        g, o, p, lr=j_schedule.cosine_schedule(3e-4, 100, 10_000),
        clip_norm=clip_norm, compress=compress))
    p0, (jp, jo), (tp, to) = _run_both(lambda g, o, p, lr: upd(g, o, p),
                                       clip_norm, compress,
                                       (3e-4, 100, 10_000))
    want, got = _flat(jp), _flat(tp)
    assert set(want) == set(got)
    same = 0
    for k in want:
        mag = np.maximum(np.abs(want[k]), np.abs(p0[k]))
        err = np.abs(got[k].astype(np.float64) - want[k])
        assert (err <= ADAMW_ULP * np.spacing(mag)).all(), k
        same += int((err == 0).sum())
    assert same >= 0.99 * sum(v.size for v in want.values())
    for jt, tt in ((jo.m, to.m), (jo.v, to.v)):
        for k, w in _flat(jt).items():
            g = _flat(tt)[k]
            assert np.abs(g - w).max() <= 2 ** -20 * np.abs(w).max(), k


def test_adamw_updates_in_place_and_consumes_grads():
    rng = np.random.default_rng(3)
    p = _torch(_tree(rng, SHAPES, 0.05))
    opt = adamw_init(p)
    ids = [id(v) for v in t_adamw.tree_leaves(p)]
    w_a, m_a = p["a"], opt.m["a"]
    before = w_a.clone()
    grads = _torch(_tree(rng, SHAPES, 1.0))
    p2, opt2 = adamw_update(grads, opt, p, lr=1e-2)
    assert p2 is p and p2["a"] is w_a and opt2.m["a"] is m_a
    assert not torch.equal(w_a, before)
    assert all(v is None for v in t_adamw.tree_leaves(grads))
    assert [id(v) for v in t_adamw.tree_leaves(p)] == ids
    assert int(opt.step) == 0 and int(opt2.step) == 1


def test_leaf_order_is_the_references():
    tree = {"b": {"z": 1, "a": 2}, "a": 3, "layers": {"wo_mlp": 4,
                                                      "wo": 5}}
    assert t_adamw.tree_leaves(tree) == jax.tree.leaves(tree)


# ---------------------------------------------------------------------------
# the reference's own optimizer tests (tests/test_substrate.py), mirrored
# ---------------------------------------------------------------------------

def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    lr = cosine_schedule(0.1, 5, 200)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}          # grad of sum(w ** 2)
        params, opt = adamw_update(grads, opt, params, lr=lr,
                                   weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.5


def test_adamw_clipping():
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    grads = {"w": torch.tensor([1e6, 1e6, 1e6])}
    p2, opt = adamw_update(grads, opt, params, lr=0.001, clip_norm=1.0,
                           weight_decay=0.0)
    assert bool(torch.isfinite(p2["w"]).all())


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(t_adamw.global_norm(t)) == pytest.approx(5.0)


def test_bf16_gradient_compression_changes_little():
    g = torch.linspace(0.1, 1.0, 64)
    p1, _ = adamw_update({"w": g.clone()}, adamw_init({"w": torch.ones(64)}),
                         {"w": torch.ones(64)}, lr=0.01, compress=None,
                         weight_decay=0.0)
    p2, _ = adamw_update({"w": g.clone()}, adamw_init({"w": torch.ones(64)}),
                         {"w": torch.ones(64)}, lr=0.01, compress="bf16",
                         weight_decay=0.0)
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), atol=1e-3)


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, 10, 100)
    assert float(lr(torch.tensor(0))) == 0.0
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0)
    assert float(lr(torch.tensor(100))) == pytest.approx(0.1, abs=1e-5)


def test_state_is_a_named_tuple_like_the_references():
    assert AdamWState._fields == j_adamw.AdamWState._fields
    st = adamw_init({"w": torch.ones(2)})
    assert st.step.shape == () and st.step.device.type == "cpu"
