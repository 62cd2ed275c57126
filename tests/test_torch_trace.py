"""The port's tracer (``repro_torch.trace``): spans off and on, parents per
thread, the clock, counters by prefix, and the spans the instrumented
paths emit on the CPU - block delivery, the leased apps' plans and leaf
tables, and a train step."""
from __future__ import annotations

import sys
import threading
import time

import pytest
import torch

from repro_torch import trace
from repro_torch.runtime import blocks
from repro_torch.runtime.blocks import BlockService


@pytest.fixture
def fresh(monkeypatch):
    """A tracer of the test's own: no counters, no records, off, and off
    again afterwards."""
    monkeypatch.setattr(trace, "_counters", {})
    monkeypatch.setattr(trace, "_records", [])
    monkeypatch.setattr(trace, "_on", False)
    yield trace
    trace.disable()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing_and_creates_no_event(fresh, monkeypatch):
    def no_event(*a, **kw):
        raise AssertionError("a disabled span made a CUDA event")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert not trace.enabled()
    a = trace.span("a", key=1, device=torch.device("cuda", 0))
    assert a is trace.span("b") is trace._OFF
    with a as sp:
        sp.key = 7
        assert sp.key is None
    assert trace.drain() == []


def test_nesting_gives_parents_per_thread(fresh):
    trace.enable()
    ready, done = threading.Event(), threading.Event()

    def worker():
        with trace.span("w.outer"):
            ready.set()
            with trace.span("w.inner", key="k"):
                done.wait(10)

    with trace.span("m.outer") as outer:
        t = threading.Thread(target=worker, name="worker-1")
        t.start()
        assert ready.wait(10)
        with trace.span("m.inner") as inner:
            done.set()
        t.join(10)
    assert not t.is_alive()
    got = _by_name(trace.drain())
    assert trace.drain() == []
    (mo,), (mi,) = got["m.outer"], got["m.inner"]
    (wo,), (wi,) = got["w.outer"], got["w.inner"]
    assert (mo, mi) == (outer, inner)
    assert mo.parent is None and mi.parent == mo.id
    assert wo.parent is None and wi.parent == wo.id and wi.key == "k"
    assert mo.thread == mi.thread == threading.current_thread().name
    assert wo.thread == wi.thread == "worker-1"
    assert len({mo.id, mi.id, wo.id, wi.id}) == 4


def test_spans_are_on_perf_counter_ns(fresh):
    trace.enable()
    t0 = time.perf_counter_ns()
    with trace.span("a", device="cpu"):
        time.sleep(0.002)
    t1 = time.perf_counter_ns()
    (s,) = trace.drain()
    assert t0 <= s.start_ns < s.end_ns <= t1
    assert s.ms >= 2.0 and s.device_ms is None


def test_drain_resolves_device_time(fresh, monkeypatch):
    class Event:
        def record(self, stream):
            self.at = (stream, time.perf_counter())

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return (end.at[1] - self.at[1]) * 1e3
    seen = []

    def events(device):
        seen.append(device)
        return Event(), Event(), "stream"
    monkeypatch.setattr(trace, "_events", events)
    trace.enable()
    with trace.span("a", device="cuda:0") as a:
        time.sleep(0.002)
    with trace.span("b"):
        pass
    assert a.device_ms is None
    a2, b = trace.drain()
    assert a2 is a and seen == ["cuda:0"]
    assert a.device_ms >= 2.0 and b.device_ms is None


def test_reset_counters_by_prefix(fresh):
    for name in ("a.x", "a.y", "ab.z", "b.z"):
        trace.count(name)
    trace.count("a.x", 4)
    assert trace.counters() == {"a.x": 5, "a.y": 1, "ab.z": 1, "b.z": 1}
    snap = trace.counters()
    trace.count("b.z")
    assert snap["b.z"] == 1 and trace.counter("b.z") == 2
    trace.reset_counters("a.")
    assert trace.counters() == {"ab.z": 1, "b.z": 2}
    assert trace.counter("a.x") == 0
    trace.reset_counters(("ab", "c"))
    assert trace.counters() == {"b.z": 2}
    trace.reset_counters()
    assert trace.counters() == {}


def test_counters_lose_no_update_across_threads(fresh):
    n_threads, n = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [trace.count("shared") for _ in range(n)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert trace.counter("shared") == n_threads * n


def test_producer_launches_on_its_own_thread_keyed_by_lease(fresh):
    svc = BlockService(seed=3, device="cpu")
    svc.open("p", num_streams=4)
    trace.enable()
    with svc.producer("p", 8, count=6, fuse=2, donate=True) as prod:
        los = [lease.lo for lease, _ in prod]
    trace.disable()
    got = _by_name(trace.drain())
    me = threading.current_thread().name
    assert los == [0, 8, 16, 24, 32, 40]
    launch, nxt = got["blocks.launch"], got["blocks.next"]
    assert [s.key for s in launch] == [0, 16, 32]
    assert {s.thread for s in launch} == {"blocks:p"}
    # the last call meets the end of the stream: no lease, no key
    assert [s.key for s in nxt] == los + [None]
    assert {s.thread for s in nxt} == {me}
    assert {s.key for s in launch} <= {s.key for s in nxt}
    assert [s.key for s in got["blocks.ring_wait"]] == [0, 16, 32]
    assert [s.key for s in got["blocks.put_wait"]] == [0, 16, 32]
    for name in ("blocks.ring_wait", "blocks.launch", "blocks.put_wait"):
        assert all(s.thread == "blocks:p" and s.parent is None
                   for s in got[name])


def test_leased_app_spans_and_leaf_table_count(fresh):
    svc = BlockService(seed=2, device="cpu")
    blocks.estimate_pi(svc, num_lanes=8, draws_per_lane=16)   # opens
    before = trace.counter("engine.leaf_tables")
    apps = trace.counter("blocks.apps")
    trace.enable()
    blocks.estimate_pi(svc, num_lanes=8, draws_per_lane=16)
    trace.disable()
    assert trace.counter("engine.leaf_tables") == before + 2
    assert trace.counter("blocks.apps") == apps + 1
    got = _by_name(trace.drain())
    (app,), (plans,) = got["blocks.app"], got["ops.mc_plans"]
    tables = got["engine.leaf_table"]
    assert app.key == 16 and app.parent is None
    assert plans.parent == app.id
    assert len(tables) == 2 and all(t.parent == plans.id for t in tables)
    assert app.start_ns <= plans.start_ns < plans.end_ns <= app.end_ns


def test_train_step_spans(fresh, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = train.smoke_config(get_config("glm4_9b")).scaled(
            n_layers=1, d_model=32, d_ff=64, vocab=64)
        model = registry.build(cfg, "cpu")
        params, _ = model.init(0)
        batch = train.pipeline_for(cfg, 2, 8, 3, device="cpu").batch_at(0)
        updates = []
        real = steps.adamw_update

        def watched(*a, **kw):     # looked up at call time, as wrappers need
            updates.append(trace.enabled())
            return real(*a, **kw)
        monkeypatch.setattr(steps, "adamw_update", watched)
        step = steps.make_train_step(model, seed=4)
        trace.enable()
        params, opt, met = step(params, adamw_init(params), batch, 5)
        trace.disable()
    finally:
        torch.set_num_threads(n)
    assert updates == [True] and met["step"] == 6
    got = _by_name(trace.drain())
    (st,), (fb,), (up,) = got["train.step"], got["train.fwd_bwd"], \
        got["train.update"]
    assert st.key == fb.key == up.key == 5 and st.parent is None
    assert fb.parent == up.parent == st.id
    assert st.start_ns <= fb.start_ns < fb.end_ns <= up.start_ns \
        < up.end_ns <= st.end_ns
    assert fb.device_ms is None and up.device_ms is None
