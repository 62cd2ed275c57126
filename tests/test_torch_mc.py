"""The port's Monte-Carlo apps (``kernels/mc.py``, ``kernels/ops.py``,
leased ``runtime.blocks`` entry points) against the reference.

The reference's Pallas kernels run in interpret mode on JAX's CPU backend,
as ``repro``'s own tests run them; on the CPU the port's wrappers run their
plain versions.  Pi partials and estimates must agree exactly (integer
counts; totals below 2^24, where the float32 sum is exact in any order).
Option partials and prices are held to a relative 1e-5, measured against
the largest partial of the array: torch and XLA sum in their own orders,
and torch-CPU exp/log/cos differ from XLA:CPU's by a few ULP (ROADMAP
section C).  The largest gap seen on these
inputs is 5.2e-7 of the largest partial.
"""
import numpy as np
import pytest
import torch

from repro.core import engine as j_engine
from repro.kernels import mc as j_mc
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.runtime import blocks as j_blocks
from repro_torch.core import engine as t_engine
from repro_torch.core import sampler as t_sampler
from repro_torch.kernels import mc as t_mc
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.runtime import blocks as t_blocks
from repro_torch.runtime.blocks import BlockService

CPU = "cpu"
HIGH = 2 ** 32 + 12345
OPTION = dict(s0=100.0, strike=100.0, r=0.05, sigma=0.2, t=1.0)
RTOL = 1e-5

# (T, S, block_t, counter offset): several tiles with a ragged last one,
# one tile of 200 rows, and counters past 2^32.
CASES = [(37, 130, 8, 0), (200, 130, 256, HIGH), (37, 130, 8, HIGH)]


def _plans(T, S, off, purposes, seed=3):
    j = [j_engine.make_plan(seed=seed, num_streams=S, num_steps=T,
                            purpose=p, offset=off) for p in purposes]
    t = [t_engine.make_plan(seed=seed, num_streams=S, num_steps=T,
                            purpose=p, offset=off, device=CPU)
         for p in purposes]
    return j, t


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


@pytest.mark.parametrize("T,S,bt,off", CASES)
def test_pi_partials_match_reference(T, S, bt, off):
    (jx, jy), (tx, ty) = _plans(T, S, off, (1, 2))
    want = np.asarray(j_mc.pi_partials_from_plans(jx, jy, block_t=bt,
                                                  interpret=True))
    got = t_mc.pi_partials_from_plans(tx, ty, block_t=bt)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert got.shape == (t_mc.tile_layout(T, bt)[1], S)


@pytest.mark.parametrize("T,S,bt,off", CASES[:2])
def test_option_partials_match_reference(T, S, bt, off):
    (jx, jy), (tx, ty) = _plans(T, S, off, (3, 4))
    want = j_mc.option_partials_from_plans(jx, jy, block_t=bt,
                                           interpret=True, **OPTION)
    got = t_mc.option_partials_from_plans(tx, ty, block_t=bt, **OPTION)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("T,bt,want", [(37, 8, (8, 5)), (200, 256, (200, 1)),
                                       (4096, 256, (256, 16)),
                                       (1, 256, (8, 1)), (16, 5, (5, 4))])
def test_tile_layout_matches_reference_padding(T, bt, want):
    assert t_mc.tile_layout(T, bt) == want


def test_tile_layout_rejects_empty():
    with pytest.raises(ValueError, match=">= 1"):
        t_mc.tile_layout(0, 8)


def test_block_s_does_not_change_partials():
    (_, _), (tx, ty) = _plans(40, 130, 0, (1, 2))
    a = t_mc.pi_partials_from_plans(tx, ty, block_t=16, block_s=128)
    b = t_mc.pi_partials_from_plans(tx, ty, block_t=16, block_s=512)
    assert torch.equal(a, b)


def test_plans_must_share_window():
    (_, _), (tx, ty) = _plans(40, 8, 0, (1, 2))
    shifted = t_engine.shift_plan(ty, 1)
    with pytest.raises(ValueError, match="share root"):
        t_mc.pi_partials_from_plans(tx, shifted)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_estimate_pi_matches_reference(use_kernel):
    kw = dict(seed=6, num_lanes=130, draws_per_lane=37, block_t=8)
    got = t_ops.estimate_pi(**kw, use_kernel=use_kernel, device=CPU)
    assert got.dtype == torch.float32 and got.dim() == 0
    for j_kernel in (True, False):
        want = np.float32(j_ops.estimate_pi(**kw, use_kernel=j_kernel))
        assert np.float32(got.item()) == want


@pytest.mark.parametrize("use_kernel", [True, False])
def test_price_option_matches_reference(use_kernel):
    kw = dict(seed=6, num_lanes=130, draws_per_lane=37, offset=HIGH)
    want = float(j_ops.price_option(**kw))
    got = t_ops.price_option(**kw, use_kernel=use_kernel, device=CPU)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(got.item() - want) <= RTOL * abs(want)


def test_mc_oracles_match_reference():
    T, S, off = 24, 16, HIGH
    (jx, jy), (tx, ty) = _plans(T, S, off, (1, 2))
    want = np.asarray(j_ref.mc_pi_partial(jx.x0, jx.h, jy.h, T, jx.ctr))
    got = t_ref.mc_pi_partial(tx.x0, tx.h, ty.h, T, tx.ctr)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, t_mc.pi_partials(tx.x0, tx.ctr, T, tx.h, ty.h,
                                             block_t=T)[0])
    args = (OPTION["s0"], OPTION["strike"], OPTION["r"], OPTION["sigma"],
            OPTION["t"])
    want = j_ref.mc_option_partial(jx.x0, jx.h, jy.h, T, jx.ctr, *args)
    got = t_ref.mc_option_partial(tx.x0, tx.h, ty.h, T, tx.ctr, *args)
    _close(got.numpy(), want)


def test_option_constants_are_float32():
    s0, k, drift, vol, disc = t_ref.option_constants(100.0, 95.0, 0.05, 0.2,
                                                     0.5)
    for v in (s0, k, drift, vol, disc):
        assert float(np.float32(v)) == v
    assert drift == float(np.float32((0.05 - 0.02) * 0.5))
    assert vol == float(np.float32(0.2) * np.sqrt(np.float32(0.5)))
    assert abs(disc - np.exp(-0.025)) < 1e-7


def test_leased_apps_take_disjoint_windows():
    svc = BlockService(seed=11, device=CPU)
    kw = dict(num_lanes=128, draws_per_lane=64)
    e1 = t_blocks.estimate_pi(svc, **kw)
    e2 = t_blocks.estimate_pi(svc, **kw)
    assert e1.item() != e2.item()
    assert svc.ledger_state()["channels"]["mc/pi"]["committed"] == [[0, 128]]
    assert e2.item() == t_ops.estimate_pi(seed=11, offset=64, device=CPU,
                                          **kw).item()
    ref = j_blocks.BlockService(seed=11)
    assert np.float32(j_blocks.estimate_pi(ref, **kw)) == np.float32(
        e1.item())
    p1 = t_blocks.price_option(svc, **kw)
    p2 = t_blocks.price_option(svc, **kw)
    assert p1.item() != p2.item()
    assert svc.ledger_state()["channels"]["mc/option"]["committed"] == \
        [[0, 128]]


def test_leased_app_releases_on_failure():
    svc = BlockService(seed=11, device=CPU)
    with pytest.raises(ValueError, match="block_t"):
        t_blocks.price_option(svc, num_lanes=4, draws_per_lane=8, block_t=0)
    assert svc.ledger_state()["channels"]["mc/option"]["committed"] == []
    assert svc.lease("mc/option", 8).lo == 0


@pytest.mark.parametrize("sampler,exact", [("bits", True), ("uniform", True),
                                           ("normal", False)])
def test_thundering_bulk_matches_reference(sampler, exact):
    kw = dict(seed=9, num_streams=130, num_steps=40, offset=HIGH,
              sampler=sampler)
    want = np.asarray(j_ops.thundering_bulk(**kw, use_kernel=False))
    for use_kernel in (True, False):
        got = t_ops.thundering_bulk(**kw, use_kernel=use_kernel, device=CPU)
        if exact:
            assert np.array_equal(got.numpy(), want)
        else:
            ulp = t_sampler.ulp_error(got, torch.from_numpy(want.copy()))
            assert float(ulp.max()) <= 8.0


def test_h_table_matches_reference():
    got = t_ops.h_table(5, 33, purpose=2, device=CPU)
    want = j_ops.h_table(5, 33, purpose=2)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
