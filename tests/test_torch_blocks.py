"""The port's BlockService, ledger and producer against the reference.

Blocks taken from the port equal the reference's for the same seed and
channel name; a ledger snapshot taken by the reference restores into the
port and re-leases the same windows; the producer (fused, donated, with
a short tail) yields exactly the per-window blocks.
"""
import threading

import numpy as np
import pytest
import torch

from repro.runtime import blocks as j_blocks
from repro_torch.runtime import blocks as t_blocks
from repro_torch.runtime.blocks import BlockService, LeaseError

CPU = "cpu"


def _svc(seed=5, **open_kw):
    svc = BlockService(seed=seed, device=CPU)
    svc.open("c", **{"num_streams": 7, **open_kw})
    return svc


def test_channel_purpose_matches_reference():
    for name in ("c", "mc/pi", "train/dropout", "smoke/bulk", ""):
        assert t_blocks.channel_purpose(name) == \
            j_blocks.channel_purpose(name)


@pytest.mark.parametrize("open_kw", [
    {}, {"sampler": "uniform"}, {"sampler": "normal", "out_dtype": "bfloat16"},
    {"mode": "faithful"}, {"deco": "fmix32", "sampler": "bernoulli(0.25)"},
    {"sampler": "poisson(3.5)"}])
def test_take_matches_reference(open_kw):
    js = j_blocks.BlockService(seed=5)
    js.open("c", **{"num_streams": 7, **open_kw})
    ts = _svc(**open_kw)
    for length in (10, 6):
        want = np.asarray(js.take("c", length))
        got = ts.take("c", length)
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16).numpy().view(np.uint16)
            want = want.view(np.uint16)
        else:
            got = got.numpy()
        assert np.array_equal(got, want), (open_kw, length)
    assert ts.ledger_state() == js.ledger_state()


def test_lease_accounting_and_overlap():
    svc = _svc()
    a = svc.lease("c", 4)
    b = svc.lease("c", 4)
    assert (a.lo, a.hi, b.lo, b.hi) == (0, 4, 4, 8)
    with pytest.raises(LeaseError, match="overlaps"):
        svc.lease("c", 2, at=3)
    a.commit()
    b.release()
    assert svc.ledger_state()["channels"]["c"] == {"committed": [[0, 4]],
                                                   "floor": 0}
    assert svc.lease("c", 3).lo == 4
    with pytest.raises(LeaseError, match="not reserved"):
        svc.commit(a)
    with pytest.raises(KeyError, match="not open"):
        svc.lease("nope", 1)
    with pytest.raises(ValueError, match="positive"):
        svc.lease("c", 0)
    with pytest.raises(LeaseError, match="u64"):
        svc.lease("c", 8, at=(1 << 64) - 4)


def test_lease_many_is_all_or_nothing():
    svc = _svc()
    svc.lease("c", 2, at=10).commit()
    with pytest.raises(LeaseError):
        svc.lease_many("c", 4, 3, at=2)      # third window hits [10, 12)
    assert svc.ledger_state()["channels"]["c"]["committed"] == [[10, 12]]
    leases = svc.lease_many("c", 4, 3)
    assert [(l.lo, l.hi) for l in leases] == [(12, 16), (16, 20), (20, 24)]


def test_reference_ledger_snapshot_restores_into_port():
    js = j_blocks.BlockService(seed=9)
    js.open("c", num_streams=4)
    for n in (5, 3, 8):
        js.take("c", n)
    js.lease("c", 4, at=100).commit()
    js.fence("c", 50)
    snap = js.ledger_state()
    ts = BlockService(seed=9, device=CPU)
    ts.open("c", num_streams=4)
    ts.take("c", 2)
    ts.restore_ledger(snap)
    assert ts.ledger_state() == snap
    assert ts.lease("c", 4).lo == js.lease("c", 4).lo == 104
    with pytest.raises(LeaseError, match="floor"):
        ts.lease("c", 2, at=20)
    # replay of a committed window regenerates the same bytes
    assert np.array_equal(ts.regenerate("c", 5, 3).numpy(),
                          np.asarray(js.regenerate("c", 5, 3)))


def test_restore_ledger_replays_windows():
    svc = _svc()
    svc.take("c", 4)
    snap = svc.ledger_state()
    first = svc.take("c", 6)
    svc.restore_ledger(snap)
    assert torch.equal(svc.take("c", 6), first)
    svc.restore_ledger(None)
    assert svc.ledger_state()["channels"]["c"]["committed"] == []


def test_release_channel_fences_and_refuses_live_leases():
    svc = _svc()
    live = svc.lease("c", 4)
    with pytest.raises(LeaseError, match="live"):
        svc.release("c")
    live.commit()
    assert svc.release("c") == 4
    svc.open("c", num_streams=7)
    assert svc.lease("c", 1).lo == 4


def test_lease_plan_and_stream_match_block():
    svc = _svc()
    lease = svc.lease("c", 9)
    block = svc.generate(lease)
    from repro_torch.core import engine, stream
    assert torch.equal(engine.generate(lease.plan()), block)
    col = stream.random_bits(lease.stream(4), (9,))
    assert torch.equal(col, block[:, 4])


def test_generate_many_equals_per_window_and_checks_contiguity():
    svc = _svc()
    leases = svc.lease_many("c", 5, 3)
    stack = svc.generate_many(leases)
    for w, lease in enumerate(leases):
        assert torch.equal(stack[w], svc.generate(lease))
    with pytest.raises(ValueError, match="contiguous"):
        svc.generate_many([leases[0], leases[2]])


def _take_blocks(seed, n, length, **open_kw):
    svc = _svc(seed, **open_kw)
    return [svc.take("c", length) for _ in range(n)]


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("fuse,count", [(1, 5), (2, 5), (4, 5), (3, 7)])
def test_producer_equals_per_window_take(fuse, count, donate):
    """count % fuse == 1 leaves a one-window tail (fuse 2 and 4 at 5,
    fuse 3 at 7)."""
    want = _take_blocks(5, count, 6)
    svc = _svc()
    with svc.producer("c", 6, depth=2, count=count, fuse=fuse,
                      donate=donate, check_ring=True) as prod:
        got = [(lease.lo, blk.clone()) for lease, blk in prod]
    assert [lo for lo, _ in got] == [6 * i for i in range(count)]
    for (_, blk), ref in zip(got, want):
        assert torch.equal(blk, ref)
    assert svc.ledger_state()["channels"]["c"]["committed"] == \
        [[0, 6 * count]]


def test_producer_start_pins_first_window():
    svc = _svc()
    with svc.producer("c", 4, count=2, start=40) as prod:
        lows = [lease.lo for lease, _ in prod]
    assert lows == [40, 44]


def test_producer_close_releases_unconsumed_reservations():
    svc = _svc()
    prod = svc.producer("c", 4, depth=2, fuse=2, donate=True)
    lease, _ = next(prod)
    prod.close()
    assert not prod._thread.is_alive()
    state = svc.ledger_state()["channels"]["c"]
    assert state["committed"] == [[lease.lo, lease.hi]]
    assert svc.lease("c", 4).lo >= lease.hi


def test_producer_surfaces_errors():
    svc = _svc()
    svc.lease("c", 4, at=8).commit()
    with pytest.raises(LeaseError):
        with svc.producer("c", 4, count=4, start=0) as prod:
            for _ in prod:
                pass


def test_producer_ring_is_reused_without_allocation():
    svc = _svc()
    ptrs = set()
    with svc.producer("c", 4, depth=1, count=9, donate=True,
                      check_ring=True) as prod:
        for _, blk in prod:
            ptrs.add(blk.data_ptr())
    assert len(ptrs) <= 3          # depth + 2 buffers


def test_service_is_thread_safe_under_concurrent_leases():
    svc = _svc()
    got = []

    def worker():
        for _ in range(50):
            lease = svc.lease("c", 1)
            lease.commit()
            got.append(lease.lo)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert sorted(got) == list(range(400))


# ---------------------------------------------------------------------------
# BlockService(mesh=): plan-channel windows through generate_sharded
# ---------------------------------------------------------------------------

def _mesh_svc(shape=(3,), names=("streams",), **kw):
    from repro_torch.core import engine
    mesh = engine.Mesh.of([CPU] * int(np.prod(shape)), shape, names)
    return BlockService(seed=5, mesh=mesh, device=CPU, **kw)


@pytest.mark.parametrize("open_kw", [{}, {"mode": "faithful"},
                                     {"sampler": "uniform",
                                      "out_dtype": "bfloat16"},
                                     {"deco": "fmix32"}])
@pytest.mark.parametrize("shape,names", [((3,), ("streams",)),
                                         ((2, 2), ("hosts", "streams"))])
def test_mesh_service_windows_match_reference(shape, names, open_kw):
    js = j_blocks.BlockService(seed=5)
    js.open("c", **{"num_streams": 7, **open_kw})
    ts = _mesh_svc(shape, names)
    assert ts.axis_names == names
    ts.open("c", **{"num_streams": 7, **open_kw})
    for length in (4, 6, 2, 8):
        got, want = ts.take("c", length), js.take("c", length)
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16).numpy().view(np.uint16)
            want = np.asarray(want).view(np.uint16)
        assert np.array_equal(np.asarray(got), np.asarray(want))
    assert ts.ledger_state() == js.ledger_state()
    lease = ts.lease("c", 4)
    one = ts.generate_many([lease])
    assert one.shape[0] == 1
    assert torch.equal(one[0].view(torch.uint8),
                       ts.regenerate("c", lease.lo, 4).view(torch.uint8))


def test_mesh_service_rejects_fused_and_donated_windows():
    svc = _mesh_svc()
    svc.open("c", num_streams=5)
    for kw in ({"fuse": 2}, {"donate": True}):
        with pytest.raises(ValueError, match="mesh-less"):
            svc.producer("c", 4, **kw)
    leases = svc.lease_many("c", 4, 2)
    with pytest.raises(ValueError, match="mesh=None"):
        svc.generate_many(leases)
    with pytest.raises(ValueError, match="mesh=None"):
        svc.generate(leases[0], retired=torch.empty(4, 5,
                                                    dtype=torch.uint32))
    with svc.producer("c", 4, count=2, start=8) as prod:
        blocks = [blk for _, blk in prod]
    assert [tuple(b.shape) for b in blocks] == [(4, 5), (4, 5)]
    js = j_blocks.BlockService(seed=5, mesh=None)
    js.open("c", num_streams=5)
    assert np.array_equal(blocks[1].numpy(),
                          np.asarray(js.regenerate("c", 12, 4)))
