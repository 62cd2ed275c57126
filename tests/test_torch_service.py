"""The port's service layer (``repro_torch.service.{tenants,frontend,audit}``)
and fault plans (``repro_torch.runtime.fault``) against the reference.

Tenants, fault plans, channel names and response slicing are pure host
code and must equal the reference exactly.  The journal must be the
reference's byte for byte on disk, so a journal written by either package
loads, restores and replays in the other; replayed integer and threshold
classes are bit-equal to the reference's replay, the log-based classes
within ``sampler.ulp_error`` <= 8 (torch-CPU ``log`` against XLA:CPU's,
ROADMAP section C).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.runtime import blocks as j_blocks
from repro.runtime import fault as j_fault
from repro.service import audit as j_audit
from repro.service import frontend as j_frontend
from repro.service import tenants as j_tenants
from repro_torch.core import sampler as t_sampler
from repro_torch.runtime import blocks as t_blocks
from repro_torch.runtime import fault as t_fault
from repro_torch.service import audit as t_audit
from repro_torch.service import frontend as t_frontend
from repro_torch.service import tenants as t_tenants

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


# ---------------------------------------------------------------------------
# tenants
# ---------------------------------------------------------------------------

def test_tenant_regions_equal_reference_over_10k_ids():
    ids = [f"tenant/{i}" for i in range(10_000)] + ["", " ", "é" * 9,
                                                     "x" * 300]
    got = [t_tenants.tenant_region(i) for i in ids]
    assert got == [j_tenants.tenant_region(i) for i in ids]
    assert len(set(got)) == len(ids)
    size = 1 << t_tenants.REGION_BITS
    assert all(b % size == 0 for b in got)
    assert t_tenants.tenant_region("a", 3) == j_tenants.tenant_region("a", 3)


def test_registry_lifecycle_matches_reference():
    regs = [mod.TenantRegistry(default_quota=100)
            for mod in (t_tenants, j_tenants)]
    for reg in regs:
        t = reg.register("alice")
        assert t.tag(5) == t.region_lo + 5 and t.region_slots == 1 << 16
        with pytest.raises(ValueError, match="outside tenant"):
            t.tag(1 << 16)
        reg.charge("alice", 60)
        reg.charge("bob", 7)
        reg.refund("alice", 10)
        with pytest.raises(Exception, match="quota"):
            reg.charge("alice", 51)
        assert reg.register("alice") is t
    assert regs[0].usage() == regs[1].usage()
    for reg in regs:
        snap = reg.retire("alice")
        assert snap.served == 50 and "alice" not in reg and len(reg) == 1
        assert reg.retire("alice") is None
        again = reg.register("alice")
        assert (again.region_lo, again.served) == (snap.region_lo, 0)
    assert regs[0].usage() == regs[1].usage()


def test_registry_rejects_region_collision():
    reg = t_tenants.TenantRegistry(region_bits=0)
    reg.register("a")
    reg._by_region[t_tenants.tenant_region("b", 0)] = "other"
    with pytest.raises(t_tenants.TenantCollisionError):
        reg.register("b")


def test_quota_rejection_consumes_nothing():
    reg = t_tenants.TenantRegistry(default_quota=10)
    reg.charge("t", 8)
    with pytest.raises(t_tenants.QuotaExceeded):
        reg.charge("t", 3)
    assert reg.get("t").served == 8 and reg.get("t").requests == 1


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

PLANS = ["", "kill@512", "kill@512,slow@600~0.05", "hang@40#1~30",
         " drop@3 , kill@9#2 ", '[{"index": 4, "kind": "slow", '
         '"seconds": 0.5, "shard": null}]']


@pytest.mark.parametrize("text", PLANS)
def test_fault_plan_parse_matches_reference(text):
    got = t_fault.FaultPlan.parse(text)
    want = j_fault.FaultPlan.parse(text)
    assert got.to_json() == want.to_json()
    assert bool(got) == bool(want)
    assert t_fault.FaultPlan.from_json(want.to_json()) == got
    assert j_fault.FaultPlan.from_json(got.to_json()) == want


@pytest.mark.parametrize("bad", ["explode@3", "kill", "kill@-1"])
def test_fault_plan_rejects_bad_specs(bad):
    with pytest.raises(ValueError):
        t_fault.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        j_fault.FaultPlan.parse(bad)


def test_seeded_plans_and_rid_index_match_reference():
    for seed in range(5):
        kw = dict(burst=1000, kinds=("kill", "slow", "drop"), count=3)
        assert t_fault.FaultPlan.seeded(seed, **kw).to_json() == \
            j_fault.FaultPlan.seeded(seed, **kw).to_json()
    for rid in ("burst/000512", "r", "", None, "a7b/0042 "):
        assert t_fault.rid_index(rid) == j_fault.rid_index(rid)


def test_fault_injector_fires_each_spec_once():
    inj = t_fault.FaultInjector(t_fault.FaultPlan.parse("kill@3#1,slow@3"))
    assert inj.fire(0, 3).kind == "slow"        # kill is for shard 1 only
    assert inj.fire(0, 3) is None               # fired once
    assert inj.fire(1, 3).kind == "kill"
    assert inj.fire(1, None) is None and inj.fire(1, 3) is None
    with pytest.raises(t_fault.SimulatedFailure):
        raise t_fault.SimulatedFailure("step 3")


# ---------------------------------------------------------------------------
# frontend: channels, assignments, response slices
# ---------------------------------------------------------------------------

def test_class_channel_and_assignment_match_reference():
    for sampler, dtype in (("bits", "float32"), ("gamma(2.5)", "bfloat16")):
        assert t_frontend.class_channel(sampler, dtype) == \
            j_frontend.class_channel(sampler, dtype)
    kw = dict(rid="r", tenant_id="t", sampler="uniform", out_dtype="float32",
              shape=(3, 5), channel="c", lo=8, rows=16, tags=(1, 2))
    a, b = t_frontend.Assignment(**kw), j_frontend.Assignment(**kw)
    assert a.num_samples == b.num_samples == 15
    import dataclasses
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("col0,ncols,n,shape", [(0, 2, 15, (3, 5)),
                                                (1, 3, 20, (20,)),
                                                (4, 1, 7, (7,))])
def test_slice_response_matches_reference(col0, ncols, n, shape):
    block = np.arange(8 * 5, dtype=np.uint32).reshape(8, 5)
    want = j_frontend.slice_response(block, col0, ncols, n, shape)
    got = t_frontend.slice_response(block, col0, ncols, n, shape)
    assert np.array_equal(got, want)
    got_t = t_frontend.slice_response(torch.from_numpy(block), col0, ncols,
                                      n, shape)
    assert np.array_equal(got_t.numpy(), want)


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

REQUESTS = [("bits", "float32", (9,)), ("uniform", "float32", (4, 3)),
            ("uniform", "bfloat16", (6,)), ("bernoulli(0.3)", "float32", (5,)),
            ("poisson(3.5)", "float32", (7,)), ("normal", "float32", (8,)),
            ("exponential(1.5)", "float32", (5,)), ("gumbel", "float32",
                                                     (6,))]
EXACT = ("bits", "uniform", "bernoulli", "poisson")


def _write_journal(mod_audit, mod_frontend, path):
    j = mod_audit.Journal(path)
    j.append_window("service/class/bits/float32", 0, 8)
    assigns = []
    for i, (sampler, dtype, shape) in enumerate(REQUESTS):
        ch = mod_frontend.class_channel(sampler, dtype)
        a = mod_frontend.Assignment(
            rid=f"rid/{i:03d}", tenant_id=f"tenant/{i % 3}", sampler=sampler,
            out_dtype=dtype, shape=shape, channel=ch,
            lo=16 * i + (2 ** 32 if i % 2 else 0), rows=8,
            tags=tuple(range(1000 * i, 1000 * i + 3)))
        if i < 3:
            j.append_request(a)
        else:
            assigns.append(a)
    j.append_batch(assigns, [(a.channel, a.lo, a.lo + a.rows)
                             for a in assigns])
    j.flush()
    j.close()
    return path


def test_journal_file_is_the_references_byte_for_byte(tmp_path):
    a = _write_journal(t_audit, t_frontend, str(tmp_path / "t.jsonl"))
    b = _write_journal(j_audit, j_frontend, str(tmp_path / "j.jsonl"))
    assert Path(a).read_bytes() == Path(b).read_bytes()
    tj = t_audit.Journal(b, readonly=True)
    jj = j_audit.Journal(a, readonly=True)
    assert tj.entries == jj.entries
    assert tj.windows() == jj.windows()
    assert tj.requests() == jj.requests()
    assert tj.ledger_state() == jj.ledger_state()
    assert tj.find_request("rid/004") == jj.find_request("rid/004")
    assert tj.find_request("nope") is None


def test_replay_matches_the_references_replay(tmp_path):
    path = _write_journal(j_audit, j_frontend, str(tmp_path / "j.jsonl"))
    want = j_audit.replay(path, seed=11)
    got = t_audit.replay(path, seed=11, device=CPU)
    assert sorted(got) == sorted(want)
    exact = {}
    for i, (sampler, dtype, shape) in enumerate(REQUESTS):
        rid = f"rid/{i:03d}"
        g, w = got[rid], want[rid]
        assert tuple(g.shape) == tuple(w.shape) == shape
        if dtype == "bfloat16":
            assert g.dtype == torch.bfloat16
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16))
        elif sampler.split("(")[0] in EXACT:
            assert g.dtype == np.asarray(w).dtype
            assert np.array_equal(g, w)
        else:
            ulp = t_sampler.ulp_error(torch.from_numpy(g),
                                      torch.from_numpy(np.asarray(w)))
            assert float(ulp.max()) <= 8.0
            continue
        exact[rid] = w
    # the digest of the exactly replayed classes is the reference's
    assert t_audit.response_digest({r: got[r] for r in exact}) == \
        j_audit.response_digest(exact)


def test_torn_tail_is_repaired_like_the_reference(tmp_path):
    for mod in (t_audit, j_audit):
        path = str(tmp_path / f"{mod.__name__}.jsonl")
        j = mod.Journal(path)
        for lo in range(0, 40, 8):
            j.append_window("c", lo, lo + 8)
        j.close()
        raw = Path(path).read_bytes()
        Path(path).write_bytes(raw[: len(raw) - 10])   # torn final line
        j2 = mod.Journal(path)
        assert [w["lo"] for w in j2.windows()] == [0, 8, 16, 24]
        j2.append_window("c", 32, 40)
        j2.close()
    a = (tmp_path / f"{t_audit.__name__}.jsonl").read_bytes()
    b = (tmp_path / f"{j_audit.__name__}.jsonl").read_bytes()
    assert a == b


def test_newline_less_tail_survives_reopen(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = t_audit.Journal(path)
    j.append_window("c", 0, 8)
    j.close()
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 1)
    j2 = t_audit.Journal(path)
    assert len(j2.windows()) == 1
    j2.append_window("c", 8, 16)
    j2.close()
    assert [w["lo"] for w in t_audit.Journal(path).windows()] == [0, 8]


def test_journal_lock_is_shared_with_the_reference(tmp_path):
    """One writer per journal across both packages: while the port holds
    the lock a reference process is refused, and the reverse."""
    path = str(tmp_path / "j.jsonl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")

    def other(pkg):
        code = ("import sys\n"
                f"from {pkg}.service.audit import Journal, "
                "JournalLockedError\n"
                "try:\n"
                f"    Journal({path!r})\n"
                "except JournalLockedError:\n"
                "    sys.exit(42)\n"
                "sys.exit(0)\n")
        return subprocess.run([sys.executable, "-c", code], env=env,
                              timeout=120).returncode

    j1 = t_audit.Journal(path)
    j1.append_window("c", 0, 8)
    j1.flush()
    assert other("repro") == 42
    assert other("repro_torch") == 42
    assert len(t_audit.Journal(path, readonly=True).windows()) == 1
    j1.close()
    assert other("repro_torch") == 0
    j2 = j_audit.Journal(path)
    assert other("repro_torch") == 42
    j2.close()


def test_restore_into_fences_like_the_reference(tmp_path):
    path = _write_journal(j_audit, j_frontend, str(tmp_path / "j.jsonl"))
    t_svc = t_blocks.BlockService(seed=3, device=CPU)
    j_svc = j_blocks.BlockService(seed=3)
    t_audit.Journal(path, readonly=True).restore_into(t_svc, fence=True)
    j_audit.Journal(path, readonly=True).restore_into(j_svc, fence=True)
    assert t_svc.ledger_state() == j_svc.ledger_state()
    ch = t_frontend.class_channel("normal", "float32")
    t_svc.open(ch)
    hi = max(w["hi"] for w in t_audit.Journal(path, readonly=True).windows()
             if w["channel"] == ch)
    with pytest.raises(t_blocks.LeaseError, match="floor"):
        t_svc.lease(ch, 4, at=0)
    assert t_svc.lease(ch, 4).lo == hi
    unfenced = t_blocks.BlockService(seed=3, device=CPU)
    t_audit.Journal(path, readonly=True).restore_into(unfenced)
    unfenced.open(ch)
    assert unfenced.lease(ch, 4, at=0).lo == 0


def test_verify_ledger_disjoint():
    svc = t_blocks.BlockService(seed=1, device=CPU)
    svc.open("a")
    svc.take("a", 8)
    svc.take("a", 8)
    assert t_audit.verify_ledger_disjoint(svc) == {"a": 1}
    j = t_audit.Journal()
    j.append_window("a", 0, 8)
    j.append_window("a", 8, 16)
    assert t_audit.verify_ledger_disjoint(j) == {"a": 2}
    j.append_window("a", 4, 12)
    with pytest.raises(t_blocks.LeaseError, match="overlaps"):
        t_audit.verify_ledger_disjoint(j)
    with pytest.raises(t_blocks.LeaseError, match="malformed"):
        t_audit.verify_ledger_disjoint(
            {"channels": {"b": {"committed": [[5, 5]]}}})


def test_response_digest_takes_numpy_and_torch_alike():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert t_audit.response_digest({"r": a}) == \
        t_audit.response_digest({"r": torch.from_numpy(a)}) == \
        j_audit.response_digest({"r": a})
    assert t_audit.response_digest({"r": a}) != \
        t_audit.response_digest({"r": a.reshape(3, 2)})
    json.dumps(t_audit.Journal().ledger_state())


# ---------------------------------------------------------------------------
# Coalescer: the reference's assignments, bytes, journal and stats
# ---------------------------------------------------------------------------

def test_request_quantization_matches_reference():
    for n in (1, 7, 8, 9, 100, 2048, 2049, 10 ** 6):
        for max_rows in (64, t_frontend.DEFAULT_MAX_ROWS):
            assert t_frontend.request_rows(n, max_rows) == \
                j_frontend.request_rows(n, max_rows)
        assert t_frontend._next_pow2(n) == j_frontend._next_pow2(n)
    assert (t_frontend.DEFAULT_MAX_ROWS, t_frontend._MIN_ROWS,
            t_frontend.WINDOW_FN_CACHE_SIZE) == (
        j_frontend.DEFAULT_MAX_ROWS, j_frontend._MIN_ROWS,
        j_frontend.WINDOW_FN_CACHE_SIZE)
    r = t_frontend.RandRequest("t", (4, 3), "poisson(3.5)", "bfloat16", "r")
    j = j_frontend.RandRequest("t", (4, 3), "poisson(3.5)", "bfloat16", "r")
    assert (r.num_samples, r.klass) == (j.num_samples, j.klass)
    with pytest.raises(ValueError, match="unknown sampler"):
        t_frontend.RandRequest("t", (2,), "bad(1)", rid="x").validate()
    with pytest.raises(ValueError, match="empty"):
        t_frontend.RandRequest("t", (0,), rid="x").validate()
    with pytest.raises(ValueError):
        t_frontend.request_rows(0)


#: (tenant, shape, sampler, dtype) of each batch's requests: several
#: classes, a tenant with two requests in one class, an invalid spec and
#: a request past its tenant's quota
BATCH = [("alice", (5,), "bits", "float32"),
         ("bob", (40, 3), "uniform", "float32"),
         ("alice", (17,), "uniform", "bfloat16"),
         ("carol", (9,), "bernoulli(0.3)", "float32"),
         ("bob", (3,), "poisson(3.5)", "float32"),
         ("dave", (2,), "bad(1)", "float32"),
         ("alice", (300,), "bits", "float32"),
         ("erin", (1000,), "uniform", "float32"),
         ("carol", (11,), "categorical[0.5,0.5]", "float32")]


def _coalescers(tmp_path, cache=2):
    jj = j_audit.Journal(str(tmp_path / "j.jsonl"))
    tj = t_audit.Journal(str(tmp_path / "t.jsonl"))
    jr = j_tenants.TenantRegistry()
    tr = t_tenants.TenantRegistry()
    for reg in (jr, tr):
        reg.register("erin", quota=1500)   # the second batch overruns it
    jc = j_frontend.Coalescer(j_blocks.BlockService(7), jr, journal=jj,
                              window_fn_cache_size=cache, max_rows=256)
    tc = t_frontend.Coalescer(t_blocks.BlockService(7, device=CPU), tr,
                              journal=tj, window_fn_cache_size=cache,
                              max_rows=256)
    return (jc, jj), (tc, tj)


def _requests(mod, batch):
    return [mod.RandRequest(t, s, sp, d, rid=f"b{batch}/r{i}")
            for i, (t, s, sp, d) in enumerate(BATCH)]


def test_coalescer_matches_reference(tmp_path):
    (jc, jj), (tc, tj) = _coalescers(tmp_path)
    for batch in range(3):
        jresp, jasg, jerr = jc.flush(_requests(j_frontend, batch))
        tresp, tasg, terr = tc.flush(_requests(t_frontend, batch))
        assert [dataclasses.asdict(a) for a in tasg] == \
            [dataclasses.asdict(a) for a in jasg]
        assert sorted(terr) == sorted(jerr)
        assert {r: type(e).__name__ for r, e in terr.items()} == \
            {r: type(e).__name__ for r, e in jerr.items()}
        assert f"b{batch}/r5" in terr                       # invalid spec
        assert (f"b{batch}/r7" in terr) == (batch > 0)      # quota
        assert sorted(tresp) == sorted(jresp)
        for rid, want in jresp.items():
            got = tresp[rid]
            if isinstance(got, torch.Tensor):
                got = got.view(torch.int16).numpy()
                want = np.asarray(want).view(np.int16)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want), rid
    assert tc.stats() == jc.stats()
    assert tc.stats()["window_fn_cache"] == 2      # LRU-evicted to its bound
    tj.close()
    jj.close()
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()


def test_coalescer_journals_replay_across_packages(tmp_path):
    (jc, jj), (tc, tj) = _coalescers(tmp_path, cache=8)
    tresp, _, _ = tc.flush(_requests(t_frontend, 0))
    jresp, _, _ = jc.flush(_requests(j_frontend, 0))
    tj.close()
    jj.close()
    from_port = j_audit.replay(str(tmp_path / "t.jsonl"), seed=7)
    from_ref = t_audit.replay(str(tmp_path / "j.jsonl"), seed=7, device=CPU)
    assert sorted(from_port) == sorted(from_ref) == sorted(tresp)
    assert t_audit.response_digest(from_ref) == \
        j_audit.response_digest(from_port) == \
        t_audit.response_digest(tresp) == j_audit.response_digest(jresp)


def test_coalescer_engine_failure_refunds_and_releases(monkeypatch):
    reg = t_tenants.TenantRegistry()
    svc = t_blocks.BlockService(7, device=CPU)
    co = t_frontend.Coalescer(svc, reg)

    def fail(*a, **kw):
        raise RuntimeError("engine down")
    monkeypatch.setattr(t_frontend.engine, "generate", fail)
    resp, asg, err = co.flush([t_frontend.RandRequest("a", (9,), rid="x")])
    assert (resp, asg) == ({}, []) and "engine down" in str(err["x"])
    assert reg.get("a").served == 0 and reg.get("a").requests == 0
    ch = t_frontend.class_channel("bits", "float32")
    assert svc.ledger_state()["channels"][ch]["committed"] == []
    monkeypatch.undo()
    resp, asg, err = co.flush([t_frontend.RandRequest("a", (9,), rid="y")])
    assert asg[0].lo == 0 and not err
    assert co.stats()["engine_calls"] == 1
    with pytest.raises(ValueError, match="rid"):
        co.flush([t_frontend.RandRequest("a", (9,))])
    with pytest.raises(ValueError, match="unique"):
        co.flush([t_frontend.RandRequest("a", (9,), rid="z")] * 2)
