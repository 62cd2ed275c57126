"""The port's serving tier (``repro_torch.service.{burst,server}`` and
``python -m repro_torch.service``) against the reference
``repro.service``, on the CPU.

The burst driver's requests are the reference's.  A deterministic burst
(``start=False``: the whole burst is enqueued before the dispatch loop
starts, so batches are count-based) served by both packages' servers,
with and without standing pools, writes byte-identical journals, counts
the same engine calls, leases and pool hits, and returns the same bytes
for the integer and threshold classes; the log-based classes (normal,
exponential, gamma) agree within the reference's 8-ULP slack
(``sampler.ulp_error``; ROADMAP section C, "Known divergences").  A
server restarts over a journal written by either package: pools resume
mid-block at the same column, auto rids continue past the journaled
ones, and journaled windows are fenced.
"""
import dataclasses
import doctest
import os
import shutil
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.service import audit as j_audit
from repro.service import burst as j_burst
from repro.service import server as j_server
from repro_torch.core import sampler as t_sampler
from repro_torch.runtime import blocks as t_blocks
from repro_torch.service import audit as t_audit
from repro_torch.service import burst as t_burst
from repro_torch.service import fleet as t_fleet
from repro_torch.service import frontend as t_frontend
from repro_torch.service import server as t_server
from repro_torch.service import transport as t_transport

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
ULP_SLACK = 8.0
LOG_STAGES = ("normal", "exponential", "gamma")
HOT = (("bits", "float32"), ("uniform", "float32"))


def _config(mod, hot, **kw):
    base = dict(max_batch=32, max_delay_s=0.25, hot_classes=hot,
                pool_rows=64, pool_cols=16)
    base.update(kw)
    return mod.ServerConfig(**base)


def _serve(mod, reqs, *, journal, config, seed=0, **kw):
    """Serve ``reqs`` deterministically; (responses, stats, server)."""
    srv = mod.RandServer(seed, config=config, journal=journal, start=False,
                         **kw)
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    out = {r.rid: f.result(timeout=120) for r, f in zip(reqs, futs)}
    stats = srv.stats()
    assert srv.shutdown(timeout=60)
    return out, stats, srv


def _is_log_stage(sampler):
    return sampler.split("(")[0] in LOG_STAGES


def _assert_same_response(got, want, sampler):
    """Port response ``got`` against reference ``want``: bit equality for
    the integer and threshold classes, 8 ULP for the log stages."""
    want = np.asarray(want)
    if isinstance(got, torch.Tensor):
        assert str(want.dtype) == "bfloat16"
        w = torch.from_numpy(want.view(np.int16).copy()).view(torch.bfloat16)
    else:
        assert got.dtype == want.dtype
        w = torch.from_numpy(want.copy())
        got = torch.from_numpy(np.array(got))
    assert tuple(got.shape) == tuple(w.shape)
    if _is_log_stage(sampler):
        assert float(t_sampler.ulp_error(got, w).max()) <= ULP_SLACK
    elif got.dtype == torch.bfloat16:
        assert torch.equal(got.view(torch.int16), w.view(torch.int16))
    else:
        assert np.array_equal(got.numpy().view(np.uint8),
                              w.numpy().view(np.uint8))


# ---------------------------------------------------------------------------
# burst driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("burst,tenants,seed", [(1, 1, 0), (97, 5, 3),
                                                (512, 1024, 12345)])
@pytest.mark.parametrize("pattern", ["mixed", "hammer", "unique"])
def test_make_requests_equals_reference(pattern, burst, tenants, seed):
    got = t_burst.make_requests(burst=burst, tenants=tenants, seed=seed,
                                pattern=pattern)
    want = j_burst.make_requests(burst=burst, tenants=tenants, seed=seed,
                                 pattern=pattern)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert t_burst.BURST_CLASSES == j_burst.BURST_CLASSES
    assert t_burst.BURST_PATTERNS == j_burst.BURST_PATTERNS
    with pytest.raises(ValueError):
        t_burst.make_requests(burst=1, tenants=1, seed=0, pattern="x")


# ---------------------------------------------------------------------------
# one deterministic burst through both servers
# ---------------------------------------------------------------------------

BURST, TENANTS = 192, 64


@pytest.fixture(scope="module")
def bursts(tmp_path_factory):
    """Both packages' servers over the same burst, without and with
    pools: {"none" | "pools": {"ref"|"port": (responses, stats,
    journal path)}}."""
    out = {}
    for label, hot in (("none", ()), ("pools", HOT)):
        d = tmp_path_factory.mktemp(f"burst_{label}")
        runs = {}
        for name, mod_s, mod_a, mod_b, kw in (
                ("ref", j_server, j_audit, j_burst, {}),
                ("port", t_server, t_audit, t_burst, {"device": CPU})):
            path = str(d / f"{name}.jsonl")
            reqs = mod_b.make_requests(burst=BURST, tenants=TENANTS, seed=0)
            resp, stats, _ = _serve(mod_s, reqs, journal=mod_a.Journal(path),
                                    config=_config(mod_s, hot), **kw)
            runs[name] = (resp, stats, path)
        out[label] = runs
    return out


POOLS = ["none", "pools"]


@pytest.mark.parametrize("pools", POOLS)
def test_server_journal_is_the_references_byte_for_byte(bursts, pools):
    ref, port = bursts[pools]["ref"], bursts[pools]["port"]
    raw = Path(port[2]).read_bytes()
    assert raw == Path(ref[2]).read_bytes()
    kinds = {t_audit.Journal(port[2], readonly=True).entries[0]["kind"]}
    assert kinds == {"batch"}                  # group commit
    assert raw.count(b"\n") == BURST // 32     # one record per microbatch


@pytest.mark.parametrize("pools", POOLS)
def test_server_stats_equal_reference(bursts, pools):
    ref, port = bursts[pools]["ref"][1], bursts[pools]["port"][1]
    for key in ("requests_served", "requests_failed", "engine_calls",
                "lease_calls", "pool_requests", "calls_per_request",
                "fill_ratio", "tenants"):
        assert port[key] == ref[key], key
    assert port["requests_served"] == BURST
    assert (port["pool_requests"] > 0) == (pools == "pools")


@pytest.mark.parametrize("pools", POOLS)
def test_server_responses_equal_reference(bursts, pools):
    ref, port = bursts[pools]["ref"][0], bursts[pools]["port"][0]
    reqs = t_burst.make_requests(burst=BURST, tenants=TENANTS, seed=0)
    assert sorted(port) == sorted(ref)
    kinds = set()
    for r in reqs:
        _assert_same_response(port[r.rid], ref[r.rid], r.sampler)
        kinds.add(r.klass)
    assert kinds == set(t_burst.BURST_CLASSES)


@pytest.mark.parametrize("pools", POOLS)
def test_server_journals_replay_across_packages(bursts, pools):
    """The port replays its own journal bit for bit and the reference's
    to the reference's responses (the reference replaying the port's
    journals is ``tests/test_torch_fleet.py``'s; the journals are the
    same bytes)."""
    resp, _, path = bursts[pools]["port"]
    mine = t_audit.replay(path, seed=0, device=CPU)
    assert t_audit.response_digest(mine) == t_audit.response_digest(resp)
    t_audit.verify_ledger_disjoint(t_audit.Journal(path, readonly=True))
    ref_resp, _, ref_path = bursts[pools]["ref"]
    theirs = t_audit.replay(ref_path, seed=0, device=CPU)
    reqs = t_burst.make_requests(burst=BURST, tenants=TENANTS, seed=0)
    for r in reqs:
        _assert_same_response(theirs[r.rid], ref_resp[r.rid], r.sampler)


# ---------------------------------------------------------------------------
# restart over the other package's journal
# ---------------------------------------------------------------------------

def _restart_requests(mod_b, mod_f, prefix, seed, n):
    reqs = mod_b.make_requests(burst=n, tenants=16, seed=seed,
                               rid_prefix=prefix)
    # auto-rid pool requests of one column each: the pools end mid-block
    return reqs + [mod_f.RandRequest(tenant_id="auto", shape=(40,),
                                     sampler="bits") for _ in range(3)]


PACKAGES = {"ref": (j_server, j_audit, j_burst, {}),
            "port": (t_server, t_audit, t_burst, {"device": CPU})}


def _frontend(name):
    from repro.service import frontend as j_frontend
    return j_frontend if name == "ref" else t_frontend


def test_restart_over_the_other_packages_journal(tmp_path):
    """Each package writes the first part of a burst (the same journal
    bytes), then each restarts over the OTHER's journal: the port over
    the reference's, the reference over the port's."""
    first = {}
    for name, (mod_s, mod_a, mod_b, kw) in PACKAGES.items():
        first[name] = tmp_path / f"first_{name}.jsonl"
        _serve(mod_s, _restart_requests(mod_b, _frontend(name), "one", 3, 48),
               journal=mod_a.Journal(str(first[name])),
               config=_config(mod_s, HOT, max_batch=16), **kw)
    assert first["port"].read_bytes() == first["ref"].read_bytes()
    seen = {}
    for name, other in (("port", "ref"), ("ref", "port")):
        mod_s, mod_a, mod_b, kw = PACKAGES[name]
        path = str(tmp_path / f"{name}.jsonl")
        shutil.copy(first[other], path)
        srv = mod_s.RandServer(0, config=_config(mod_s, HOT, max_batch=16),
                               journal=mod_a.Journal(path), start=False, **kw)
        cursors = {k: (p._lease and p._lease.lo, p._col)
                   for k, p in srv._pools.items()}
        ledger = srv.ledger_state()["channels"]
        floors = {c: ledger[c]["floor"] for c in sorted(ledger)}
        ch = mod_s.pool_channel("bits", "float32")
        with pytest.raises(Exception, match="floor"):
            srv.block_service.lease(ch, 8, at=0)
        reqs = _restart_requests(mod_b, _frontend(name), "two", 4, 24)
        futs = [srv.submit(r) for r in reqs]
        auto_rid = srv._next_rid()
        srv.start()
        resp = {}
        for r, f in zip(reqs, futs):
            resp[r.rid or f"auto/{len(resp)}"] = f.result(timeout=120)
        assert srv.shutdown(timeout=60)
        seen[name] = (cursors, floors, auto_rid, resp, reqs)
    port, ref = seen["port"], seen["ref"]
    # the pools re-entered the journaled block mid-way, at the same column
    assert port[0] == ref[0]
    assert port[0][("bits", "float32")][1] > 0
    assert port[1] == ref[1] and all(f > 0 for f in port[1].values())
    # 3 journaled auto rids + 3 new ones: the next is r00000007
    assert port[2] == ref[2] == "r00000007"
    for rid, want in ref[3].items():
        req = next((r for r in ref[4] if r.rid == rid), None)
        _assert_same_response(port[3][rid], want,
                              req.sampler if req else "bits")
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    t_audit.verify_ledger_disjoint(
        t_audit.Journal(str(tmp_path / "port.jsonl"), readonly=True))


# ---------------------------------------------------------------------------
# server semantics (port alone)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("klass", [("uniform", "bfloat16"),
                                   ("bernoulli(0.25)", "float32")])
def test_pool_donation_serves_identical_responses(klass):
    """A donated pool's ring buffer is overwritten by later windows: the
    served columns must be copies, equal to an undonated pool's."""
    reqs = [t_frontend.RandRequest(tenant_id=f"t{i % 5}",
                                   shape=(3 + i % 20 * 5,),
                                   sampler=klass[0], out_dtype=klass[1],
                                   rid=f"d/{i:03d}") for i in range(60)]
    outs = []
    for donate in (False, True):
        cfg = _config(t_server, (klass,), max_batch=8, pool_rows=16,
                      pool_cols=8, pool_depth=2, pool_donate=donate)
        out, stats, _ = _serve(t_server, reqs, journal=t_audit.Journal(),
                               config=cfg, device=CPU)
        assert stats["pool_requests"] == 60
        outs.append(t_audit.response_digest(out))
    assert outs[0] == outs[1]


def test_pool_columns_equal_regenerate_of_their_window():
    cfg = _config(t_server, HOT, max_batch=4, pool_rows=32, pool_cols=8)
    journal = t_audit.Journal()
    reqs = [t_frontend.RandRequest(tenant_id="a", shape=(20 + i,),
                                   sampler="uniform", rid=f"p/{i}")
            for i in range(12)]
    out, _, _ = _serve(t_server, reqs, journal=journal, config=cfg,
                       device=CPU)
    svc = t_blocks.BlockService(0, device=CPU)
    ch = t_server.pool_channel("uniform", "float32")
    svc.open(ch, num_streams=8, sampler="uniform", out_dtype="float32")
    for e in journal.requests():
        assert e["channel"] == ch
        block = svc.regenerate(ch, e["lo"], e["rows"]).numpy()
        cols = block[:, e["tags"]].T.reshape(-1)[:len(out[e["rid"]])]
        assert np.array_equal(cols, out[e["rid"]])


def test_graceful_drain_serves_queued_then_refuses():
    srv = t_server.RandServer(1, config=t_server.ServerConfig(max_batch=4),
                              start=False, device=CPU)
    futs = [srv.submit(t_frontend.RandRequest("a", (8,))) for _ in range(10)]
    assert srv.shutdown(timeout=60)
    assert all(f.result(timeout=1).shape == (8,) for f in futs)
    with pytest.raises(t_server.ServiceClosed):
        srv.submit(t_frontend.RandRequest("a", (8,)))
    assert srv.stats()["requests_served"] == 10


def test_backpressure_from_threads_serves_every_request_once():
    cfg = t_server.ServerConfig(max_batch=16, max_delay_s=0.001,
                                queue_depth=8, hot_classes=HOT,
                                pool_rows=64, pool_cols=16)
    journal = t_audit.Journal()
    srv = t_server.RandServer(2, config=cfg, journal=journal, device=CPU)
    reqs = t_burst.make_requests(burst=120, tenants=9, seed=2, max_side=16)
    out = t_burst.run_burst(srv, reqs, submit_threads=4, timeout=120)
    assert srv.shutdown(timeout=60)
    assert len(out) == 120 and srv.stats()["requests_served"] == 120
    assert sorted(e["rid"] for e in journal.requests()) == \
        sorted(r.rid for r in reqs)
    replayed = t_audit.replay(journal, seed=2, device=CPU)
    assert t_audit.response_digest(replayed) == t_audit.response_digest(out)
    t_audit.verify_ledger_disjoint(journal)
    t_audit.verify_ledger_disjoint(srv.block_service)


def test_rid_checks_refuse_reuse_and_bad_specs():
    journal = t_audit.Journal()
    srv = t_server.RandServer(1, config=t_server.ServerConfig(max_batch=2),
                              journal=journal, start=False, device=CPU)
    srv.submit(t_frontend.RandRequest("a", (4,), rid="x"))
    with pytest.raises(ValueError, match="already used"):
        srv.submit(t_frontend.RandRequest("b", (4,), rid="x"))
    with pytest.raises(ValueError, match="already used"):
        srv.submit_batch([t_frontend.RandRequest("b", (4,), rid="y"),
                          t_frontend.RandRequest("b", (4,), rid="x")])
    srv.submit(t_frontend.RandRequest("b", (4,), rid="y"))  # nothing leaked
    with pytest.raises(ValueError):
        srv.submit(t_frontend.RandRequest("a", (4,), sampler="nope(1)"))
    assert srv.shutdown(timeout=60)
    assert [e["rid"] for e in journal.requests()] == ["x", "y"]


# ---------------------------------------------------------------------------
# the card is the default
# ---------------------------------------------------------------------------

def test_entry_points_need_a_card_unless_told_otherwise(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_server.RandServer(seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_transport.ShardHost(0)
    fleet = t_fleet.Fleet.__new__(t_fleet.Fleet)     # spawns nothing
    fleet.fault_plan = t_fleet.FaultPlan()
    fleet.config = t_fleet.FleetConfig(journal_dir=str(tmp_path))
    cmd = fleet.shard_command(1)
    assert cmd[1:3] == ["-m", "repro_torch.service.fleet"]
    assert "--device" not in cmd
    fleet.config = t_fleet.FleetConfig(journal_dir=str(tmp_path),
                                       device="cpu")
    assert fleet.shard_command(1)[-2:] == ["--device", "cpu"]


def _cli(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(kw.pop("env", {}))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.service",
                             *args], env=env, cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            **kw)


def test_cli_without_a_card_exits_non_zero():
    proc = _cli(["--burst", "4", "--tenants", "2"],
                env={"CUDA_VISIBLE_DEVICES": ""})
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in err and "digest" not in out


@pytest.mark.parametrize("sig", [signal.SIGINT, signal.SIGTERM])
def test_cli_lingers_then_drains_on_signal(tmp_path, sig):
    """``--device cpu --linger``: the burst's digest equals an in-process
    server's, replay is bit-identical, and SIGINT / SIGTERM drains and
    exits 0."""
    digest_file = tmp_path / "d.txt"
    proc = _cli(["--device", "cpu", "--burst", "64", "--tenants", "32",
                 "--journal", str(tmp_path / "j.jsonl"), "--verify-replay",
                 "--digest-out", str(digest_file), "--linger", "120"])
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("ready"):
                ready.set()
    ready = threading.Event()
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        assert ready.wait(timeout=120), (lines, proc.stderr.read())
        proc.send_signal(sig)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    reader.join(timeout=10)
    text = "".join(lines)
    assert "replay: OK" in text and text.rstrip().endswith("drained")
    reqs = t_burst.make_requests(burst=64, tenants=32, seed=0)
    out, _, _ = _serve(t_server, reqs, journal=None,
                       config=t_server.ServerConfig(max_batch=256,
                                                    max_delay_s=0.25),
                       device=CPU)
    assert digest_file.read_text().strip() == t_audit.response_digest(out)


def test_first_cpu_math_of_a_process_equals_every_later_call():
    """In a fresh process that has imported ``repro_torch``, the first CPU
    ``exp`` split over 32 intra-op threads equals the second bit for bit.
    Without the package's import-time VML settle, 12.5 % of such processes
    differ (``tools/cpu_math_race.py``, prelude ``none``: 20 of 160), so
    48 processes all pass with probability 0.875^48 < 0.2 % when the settle
    is gone."""
    code = ("import torch\n"
            "torch.set_num_threads(32)\n"
            "import repro_torch\n"
            "u = torch.linspace(-3.0, 3.0, 1 << 18)\n"
            "a, b = torch.exp(u), torch.exp(u)\n"
            "print(int((a.view(torch.int32) != b.view(torch.int32)).sum()))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = []
    for _ in range(6):
        procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                                  stdout=subprocess.PIPE, text=True)
                 for _ in range(8)]
        outs += [p.communicate(timeout=120)[0].strip() for p in procs]
    assert outs == ["0"] * 48


@pytest.mark.parametrize("module", [t_burst, t_server, t_fleet],
                         ids=lambda m: m.__name__)
def test_service_doctests_run_clean(module):
    results = doctest.testmod(module, verbose=False)
    assert results.failed == 0 and results.attempted > 0
