"""The port's checkpoints (``repro_torch.checkpoint``) and fault-tolerant
loop (``repro_torch.runtime.fault.FaultTolerantLoop``) against the
reference's, on the CPU.

The on-disk format is the reference's: for the same tree both packages
write the same ``.npy`` bytes and manifest, and each loads what the other
wrote - float32 and int32 leaves, a bfloat16 leaf (stored as its 16-bit
words), the optimizer tree and the lease ledger in ``extra``.  Every
comparison is bit for bit.  The reference's own checkpoint tests
(``tests/test_substrate.py``) are mirrored.
"""
from __future__ import annotations

import filecmp
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro.optim import adamw as j_adamw
from repro.runtime import fault as j_fault
from repro.runtime.blocks import BlockService as JBlockService
from repro_torch.checkpoint import CheckpointManager, load_checkpoint, \
    save_checkpoint
from repro_torch.checkpoint import checkpoint as t_ckpt
from repro_torch.optim import adamw_init
from repro_torch.runtime import FaultTolerantLoop, SimulatedFailure
from repro_torch.runtime import fault as t_fault
from repro_torch.runtime.blocks import BlockService as TBlockService

CPU = "cpu"


def _trees(seed=0):
    """The same train-state tree for both packages: float32 params, a
    bfloat16 leaf, the optimizer tree (int32 0-dim step), and the lease
    ledger of a data channel that has delivered 3 steps."""
    rng = np.random.default_rng(seed)
    p = {"embed": rng.normal(0, 1, (16, 8)).astype(np.float32),
         "layers": {"wq": rng.normal(0, 1, (2, 8, 4)).astype(np.float32),
                    "norm": np.zeros((2, 8), np.float32)}}
    half = rng.normal(0, 1, (5, 3)).astype(np.float32)
    j_tree = {"params": jax.tree.map(jnp.asarray, p),
              "half": jnp.asarray(half, jnp.bfloat16)}
    jo = j_adamw.adamw_init(j_tree["params"])
    j_tree["opt"] = j_fault._opt_to_tree(jo._replace(step=jnp.int32(3)))

    def t(x):
        return torch.from_numpy(np.array(x, copy=True))
    t_params = jax.tree.map(t, p)
    t_tree = {"params": t_params,
              "half": t(half).to(torch.bfloat16)}
    to = adamw_init(t_params)
    t_tree["opt"] = t_fault._opt_to_tree(to._replace(
        step=torch.tensor(3, dtype=torch.int32)))
    svc_j, svc_t = JBlockService(seed=1), TBlockService(seed=1, device=CPU)
    for svc in (svc_j, svc_t):
        svc.open("data/batches", num_streams=1)
        svc.take("data/batches", 3)
    extra_j = {"rng_ledger": svc_j.ledger_state()}
    extra_t = {"rng_ledger": svc_t.ledger_state()}
    assert extra_j == extra_t
    return j_tree, t_tree, extra_t


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _same_trees(got, want):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k in w:
        a, b = _as_np(g[k]), _as_np(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("via_manager", [False, True])
def test_same_files_as_the_reference(tmp_path, via_manager):
    j_tree, t_tree, extra = _trees()
    if via_manager:
        j_ckpt.CheckpointManager(str(tmp_path / "j")).save(4, j_tree, extra)
        CheckpointManager(str(tmp_path / "t")).save(4, t_tree, extra)
    else:
        j_ckpt.save_checkpoint(str(tmp_path / "j"), 4, j_tree, extra)
        save_checkpoint(str(tmp_path / "t"), 4, t_tree, extra)
    jd, td = tmp_path / "j" / "step_00000004", tmp_path / "t" / "step_00000004"
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td))
    assert "half.npy" in names and "opt__step.npy" in names
    match, mismatch, errors = filecmp.cmpfiles(jd, td, names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)


def test_port_loads_the_references_checkpoint(tmp_path):
    j_tree, t_tree, extra = _trees(1)
    j_ckpt.save_checkpoint(str(tmp_path), 6, j_tree, extra)
    tree, step, got_extra = load_checkpoint(str(tmp_path), device=CPU)
    assert step == 6 and got_extra == extra
    assert tree["half"].dtype == torch.bfloat16
    assert tree["opt"]["step"].dtype == torch.int32
    _same_trees(tree, t_tree)
    opt = t_fault._opt_from_tree(tree["opt"])
    assert int(opt.step) == 3 and opt.step.shape == ()
    assert opt.step.device.type == "cpu"
    svc = TBlockService(seed=1, device=CPU)
    svc.open("data/batches", num_streams=1)
    svc.restore_ledger(got_extra["rng_ledger"])
    assert svc.take("data/batches", 1).shape == (1, 1)
    assert svc.ledger_state()["channels"]["data/batches"]["committed"] == \
        [[0, 4]]


def test_reference_loads_the_ports_checkpoint(tmp_path):
    j_tree, t_tree, extra = _trees(2)
    save_checkpoint(str(tmp_path), 9, t_tree, extra)
    tree, step, got_extra = j_ckpt.load_checkpoint(str(tmp_path))
    assert step == 9 and got_extra == extra
    assert tree["half"].dtype == ml_dtypes.bfloat16
    _same_trees(tree, j_tree)
    opt = j_fault._opt_from_tree(tree["opt"])
    assert int(opt.step) == 3


# ---------------------------------------------------------------------------
# the reference's own checkpoint tests (tests/test_substrate.py), mirrored
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 3, tree)
    loaded, step, extra = load_checkpoint(str(tmp_path), device=CPU)
    assert step == 3 and extra == {}
    assert torch.equal(loaded["a"], torch.arange(6).reshape(2, 3))
    assert loaded["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(loaded["b"]["c"], tree["b"]["c"])


def test_checkpoint_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.tensor([s])})
    assert mgr.latest() == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(7, {"x": torch.arange(10)})
    mgr.wait()
    tree, step, _ = mgr.restore(device=CPU)
    assert step == 7 and torch.equal(tree["x"], torch.arange(10))


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(3)})
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_elastic_restore_places_on_the_device_asked(tmp_path):
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    save_checkpoint(str(tmp_path), 1, tree)
    loaded, _, _ = load_checkpoint(str(tmp_path), device=CPU)
    assert loaded["w"].device.type == "cpu"
    assert torch.equal(loaded["w"], tree["w"])
    meta, _, _ = load_checkpoint(str(tmp_path), device="meta")
    assert meta["w"].device.type == "meta" and meta["w"].shape == (8, 8)


# ---------------------------------------------------------------------------
# atomicity, snapshots and errors
# ---------------------------------------------------------------------------

def test_a_torn_save_leaves_the_latest_checkpoint(tmp_path):
    save_checkpoint(str(tmp_path), 2, {"x": torch.ones(3)})
    torn = tmp_path / "step_00000004.tmp"     # a save cut before its rename
    torn.mkdir()
    (torn / "x.npy").write_bytes(b"partial")
    (tmp_path / "step_00000005").mkdir()      # no manifest: not a checkpoint
    assert t_ckpt.latest_step(str(tmp_path)) == 2
    tree, step, _ = load_checkpoint(str(tmp_path), device=CPU)
    assert step == 2 and torch.equal(tree["x"], torch.ones(3))
    save_checkpoint(str(tmp_path), 4, {"x": torch.zeros(3)})  # replaces .tmp
    assert t_ckpt.latest_step(str(tmp_path)) == 4
    assert not torn.exists()
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"), device=CPU)


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    w = torch.arange(1 << 16, dtype=torch.float32)
    mgr.save(1, {"w": w, "opt": {"step": torch.tensor(1, dtype=torch.int32)}})
    w.mul_(-1)                      # the next step updates in place
    mgr.wait()
    tree, _, _ = mgr.restore(device=CPU)
    assert torch.equal(tree["w"], torch.arange(1 << 16, dtype=torch.float32))


def test_a_failed_async_save_raises_from_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.directory = str(blocker)    # every write below it fails
    mgr.save(1, {"x": torch.ones(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                      # reported once


def test_non_dict_trees_save_as_numbered_leaves(tmp_path):
    tree = (torch.ones(2), [torch.zeros(3, dtype=torch.int32)])
    save_checkpoint(str(tmp_path / "t"), 1, tree)
    j_ckpt.save_checkpoint(str(tmp_path / "j"), 1,
                           (jnp.ones(2), [jnp.zeros(3, jnp.int32)]))
    got, _, _ = load_checkpoint(str(tmp_path / "t"), device=CPU)
    want, _, _ = j_ckpt.load_checkpoint(str(tmp_path / "j"))
    assert set(got) == set(want) == {"leaf_0", "leaf_1"}
    _same_trees(got, want)


# ---------------------------------------------------------------------------
# FaultTolerantLoop
# ---------------------------------------------------------------------------

def test_fault_tolerant_loop_resumes_to_the_same_state(tmp_path):
    def run(d, fail_at):
        box = {}

        def init_state():
            w = {"w": torch.zeros(4)}
            box["p"] = w
            return w, adamw_init(w)

        def step_fn(p, o, s):
            p["w"].add_(float(s + 1))
            box["p"] = p
            return p, o._replace(step=o.step + 1), {"loss": float(s)}

        restores, metrics = [], []
        loop = FaultTolerantLoop(CheckpointManager(str(d), async_save=True),
                                 save_every=2, device=CPU)
        params, opt = loop.run(
            init_state=init_state, step_fn=step_fn, num_steps=6,
            fail_at=fail_at, on_metrics=lambda s, m: metrics.append(s),
            extra_state=lambda: {"sum": float(box["p"]["w"][0])},
            on_restore=lambda extra, start: restores.append((extra, start)))
        return params, opt, restores, metrics

    p1, o1, r1, m1 = run(tmp_path / "a", fail_at=3)
    p2, o2, r2, m2 = run(tmp_path / "b", fail_at=None)
    assert torch.equal(p1["w"], p2["w"]) and float(p2["w"][0]) == 21.0
    assert int(o1.step) == int(o2.step) == 6
    assert r2 == [(None, 0)]
    assert r1 == [(None, 0), ({"sum": 3.0}, 2)]     # restored at step 2
    assert m1 == [0, 1, 2, 2, 3, 4, 5] and m2 == list(range(6))
    assert sorted(os.listdir(tmp_path / "a")) == [
        "step_00000002", "step_00000004", "step_00000006"]


def test_fault_tolerant_loop_gives_up_after_max_restarts(tmp_path):
    calls = []

    def step_fn(p, o, s):
        calls.append(s)
        raise SimulatedFailure("always")

    loop = FaultTolerantLoop(CheckpointManager(str(tmp_path)),
                             max_restarts=2, device=CPU)
    with pytest.raises(SimulatedFailure):
        loop.run(init_state=lambda: ({"w": torch.zeros(1)},
                                     adamw_init({"w": torch.zeros(1)})),
                 step_fn=step_fn, num_steps=3)
    assert calls == [0, 0, 0]


def test_opt_tree_round_trip_matches_the_references():
    opt = adamw_init({"w": torch.ones(2)})._replace(
        step=torch.tensor(5, dtype=torch.int32))
    tree = t_fault._opt_to_tree(opt)
    assert set(tree) == set(j_fault._opt_to_tree(
        j_adamw.adamw_init({"w": jnp.ones(2)})))
    back = t_fault._opt_from_tree(dict(tree, step=torch.tensor([5])))
    assert back.step.shape == () and back.step.dtype == torch.int32
    assert int(back.step) == 5 and back.m is tree["m"]
