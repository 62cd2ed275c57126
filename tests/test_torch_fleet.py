"""The port's shard fleet (``repro_torch.service.fleet``) end to end on the
CPU: real shard subprocesses over TCP, scripted faults, journal failover.

A kill mid-burst and a hung shard (fenced by SIGKILL, then adopted) give
the no-fault run's digest; the union of the shard journals replays the
whole burst, through the port's ``audit.replay`` bit for bit and through
the reference's on the integer and threshold classes.  Each shard logs
the device it serves on, and a fleet without a card refuses to start
rather than serve on the CPU.  Every subprocess wait has its own timeout.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.service import audit as j_audit
from repro_torch.runtime.fault import FaultPlan
from repro_torch.service import audit as t_audit
from repro_torch.service import transport as t_transport
from repro_torch.service.burst import make_requests
from repro_torch.service.fleet import (Fleet, FleetConfig, FleetError,
                                       run_fleet_burst)

ROOT = Path(__file__).resolve().parent.parent
BURST, TENANTS, SEED = 64, 16, 0
CPU = "cpu"
#: the integer and threshold classes of a burst (equal to the reference's)
EXACT_PREFIXES = ("bits", "uniform", "bernoulli", "poisson", "categorical")


def _fleet_run(journal_dir, fault_plan, **client_kw):
    cfg = FleetConfig(num_shards=2, seed=SEED, journal_dir=str(journal_dir),
                      device=CPU)
    reqs = make_requests(burst=BURST, tenants=TENANTS, seed=SEED)
    with Fleet(cfg, fault_plan) as fleet:
        client = fleet.client(**client_kw)
        responses = run_fleet_burst(client, reqs)
        stats = client.stats()
        client.close()
        journals = fleet.journals()
    assert len(responses) == BURST
    return responses, stats, journals


def _union_replay(journals, replay):
    out = {}
    for path in journals.values():
        out.update(replay(path))
        t_audit.verify_ledger_disjoint(t_audit.Journal(path, readonly=True))
    return out


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The no-fault run every fault run is held to."""
    d = tmp_path_factory.mktemp("nofault")
    responses, stats, journals = _fleet_run(d, FaultPlan())
    return {"dir": d, "responses": responses, "stats": stats,
            "journals": journals,
            "digest": t_audit.response_digest(responses)}


def test_no_fault_fleet_serves_on_the_given_device(baseline):
    assert baseline["stats"]["failovers"] == 0
    assert baseline["stats"]["errors"] == 0
    for i in range(2):
        first = (baseline["dir"] / f"shard{i}.log").read_text().splitlines()
        assert first[0] == f"shard {i} serves on cpu"
    replayed = _union_replay(
        baseline["journals"],
        lambda p: t_audit.replay(p, seed=SEED, device=CPU))
    assert len(replayed) == BURST
    assert t_audit.response_digest(replayed) == baseline["digest"]


def test_fleet_journals_replay_through_the_reference(baseline):
    replayed = _union_replay(baseline["journals"],
                             lambda p: j_audit.replay(p, seed=SEED))
    assert sorted(replayed) == sorted(baseline["responses"])
    reqs = make_requests(burst=BURST, tenants=TENANTS, seed=SEED)
    exact = [r for r in reqs if r.sampler.startswith(EXACT_PREFIXES)]
    assert len(exact) > BURST // 2
    for r in exact:
        got, want = baseline["responses"][r.rid], np.asarray(replayed[r.rid])
        if isinstance(got, torch.Tensor):
            got = got.view(torch.int16).numpy()
            want = want.view(np.int16)
        assert got.dtype == want.dtype and np.array_equal(got, want), r.rid


def test_fleet_kill_midburst_digest_equals_no_fault(tmp_path, baseline):
    responses, stats, journals = _fleet_run(
        tmp_path, FaultPlan.parse(f"kill@{BURST // 2}"))
    assert t_audit.response_digest(responses) == baseline["digest"]
    assert stats["failovers"] == 1 and stats["recovery_ms"] is not None
    replayed = _union_replay(
        journals, lambda p: t_audit.replay(p, seed=SEED, device=CPU))
    assert len(replayed) == BURST
    assert t_audit.response_digest(replayed) == baseline["digest"]


def test_fleet_hang_is_fenced_then_adopted(tmp_path, baseline):
    responses, stats, _ = _fleet_run(
        tmp_path, FaultPlan.parse(f"hang@{BURST // 2}"), deadline_s=8.0)
    assert t_audit.response_digest(responses) == baseline["digest"]
    assert stats["failovers"] == 1


def test_fleet_without_a_card_refuses_to_start(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    cfg = FleetConfig(num_shards=2, seed=SEED, journal_dir=str(tmp_path),
                      spawn_timeout_s=60.0)
    with pytest.raises(FleetError, match="exited"):
        Fleet(cfg)
    log = (tmp_path / "shard0.log").read_text()
    assert "no CUDA device" in log and "serves on" not in log


def test_cli_fleet_kill_replays_to_the_no_fault_digest(tmp_path, baseline):
    """``python -m repro_torch.service --fleet 2 --fault-plan kill@32``
    prints the no-fault fleet's digest and a bit-identical union replay."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.service", "--device", "cpu",
         "--fleet", "2", "--burst", str(BURST), "--tenants", str(TENANTS),
         "--journal-dir", str(tmp_path), "--fault-plan", f"kill@{BURST // 2}",
         "--verify-replay", "--digest-out", str(tmp_path / "d.txt")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "failovers=1" in out.stdout and "replay: OK" in out.stdout
    assert (tmp_path / "d.txt").read_text().strip() == baseline["digest"]


def test_adopt_is_refused_while_the_owner_lives(tmp_path):
    """Fencing: adoption reports ``locked`` while another process holds
    the journal's flock, and succeeds once that owner is killed."""
    path = str(tmp_path / "j.jsonl")
    code = ("import time\n"
            "from repro_torch.service.audit import Journal\n"
            f"j = Journal({path!r})\n"
            "j.append_window('c', 0, 8)\n"
            "j.flush()\n"
            "print('locked', flush=True)\n"
            "time.sleep(300)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    owner = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.PIPE, text=True)
    try:
        assert owner.stdout.readline().strip() == "locked"
        with t_transport.ShardHost(3, device=CPU) as host:
            reply = host._handle_adopt({"shard": 1, "journal": path})
            assert not reply["ok"] and reply["kind"] == "locked"
            owner.kill()
            owner.wait(timeout=30)
            reply = host._handle_adopt({"shard": 1, "journal": path})
            assert reply["ok"] and 1 in host.shards()
            ledger = host._servers[1].ledger_state()["channels"]["c"]
            assert ledger["committed"] == [[0, 8]] and ledger["floor"] == 8
    finally:
        if owner.poll() is None:
            owner.kill()
            owner.wait(timeout=30)
        owner.stdout.close()


def test_fleet_journal_dir_holds_only_its_own_files(baseline):
    names = sorted(p.name for p in baseline["dir"].iterdir())
    assert names == ["shard0.jsonl", "shard0.log", "shard0.port",
                     "shard1.jsonl", "shard1.log", "shard1.port"]
