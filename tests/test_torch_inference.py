"""The port's inference tier (``repro_torch.inference``) against the
reference (``repro.inference``), on the CPU.

Kernel level: the plain version of kernel F and the port's two-pass
oracle against the reference's Pallas kernel (interpret mode, as its own
tests run it) and its two-pass oracle over ``engine.generate(backend=
"ref")`` noise, over the reference's (V, B) x (inv_temp, top_k) matrix.
Tokens must be equal.  Scores are held to ``sampler.ulp_error`` <= 8: the
scaled logits are bit-equal, but torch-CPU ``log`` differs from XLA:CPU's
by up to 2 ULP (ROADMAP section C), so the gumbel noise is not.  Token
parity then holds where no two scores lie within that slack of a column's
maximum, which these fixed seeds show, as the reference's own contract
says (``repro/inference/kernels/gumbel_argmax.py``).

Tier level: the slot pool, the sampler's journal records (byte for byte),
the synthetic logit model (bit for bit), the batcher's transcript digest
at the reference's ``SMALL`` schedule on the fused and torch paths, and
crash replay across the two packages in both directions.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import inference as j_inf
from repro.core import engine as j_engine
from repro.core import u64 as j_u64
from repro.inference import kernels as j_kern
from repro.inference.kernels import gumbel_argmax as j_ga
from repro.runtime import blocks as j_blocks
from repro.service import audit as j_audit
from repro.service import tenants as j_tenants
from repro_torch import inference as t_inf
from repro_torch.core import engine as t_engine
from repro_torch.core import sampler as t_sampler
from repro_torch.inference import sampling as t_sampling
from repro_torch.inference import slots as t_slots
from repro_torch.inference.kernels import gumbel_argmax as t_kern
from repro_torch.runtime import blocks as t_blocks
from repro_torch.service import audit as t_audit
from repro_torch.service import tenants as t_tenants

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
ULP_BOUND = 8.0
SMALL = dict(capacity=4, vocab=64, sequences=8, rate=1.0, seed=5)
CLI_SMALL = ["--batch", "4", "--vocab", "64", "--sequences", "8", "--rate",
             "1", "--seed", "5"]


def _setup(seed, V, B, ctr=977, deco="splitmix64"):
    """Logits (V, B), leaf offsets and the reference's (V, B) gumbel noise
    for one decode step, as the reference's tests build them."""
    rng = np.random.default_rng(seed)
    logits_t = rng.normal(size=(V, B)).astype(np.float32)
    x0, h_fam = j_engine.family_from_seed(seed, 0xD0)
    tags = jnp.arange(B, dtype=jnp.uint32)
    h = j_engine.derive_leaf(
        (jnp.broadcast_to(h_fam[0], tags.shape),
         jnp.broadcast_to(h_fam[1], tags.shape)),
        (jnp.zeros_like(tags), tags))
    c = tuple(map(jnp.asarray, j_u64.const64(ctr)))
    roots, ctr_rows = j_engine.root_and_ctr_rows(x0, c, V)
    plan = j_engine.GenPlan(x0=x0, h=h, num_steps=V, ctr=c, offset=None,
                            mode="ctr", deco=deco, sampler="gumbel",
                            out_dtype="float32")
    noise = j_engine.generate(plan, backend="ref")
    x0_int = (int(np.asarray(x0[0])) << 32) | int(np.asarray(x0[1]))
    assert x0_int == t_engine.family_from_seed(seed, 0xD0)[0]
    words = t_kern.leaf_words(
        (int(a) << 32) | int(b) for a, b in zip(np.asarray(h[0]).tolist(),
                                                np.asarray(h[1]).tolist()))
    return dict(logits_t=logits_t, h=h, roots=roots, ctr_rows=ctr_rows,
                noise=noise, x0=x0_int, words=words, ctr=ctr)


def _thresh(logits_t, B, top_k):
    if top_k:
        j = jax.lax.top_k(jnp.asarray(logits_t).T, top_k)[0][:, -1]
        t = torch.topk(torch.from_numpy(logits_t).T, top_k,
                       dim=-1).values[:, -1]
        assert np.array_equal(np.asarray(j), t.numpy())
        return j, t
    return (jnp.full((B,), -jnp.inf, jnp.float32),
            torch.full((B,), float("-inf")))


def _port_scores(s, inv_temp, thresh_t, deco="splitmix64"):
    """The port's full (V, B) masked score block for a setup."""
    V, B = s["logits_t"].shape
    root, crow = t_engine.root_and_ctr_rows(s["x0"], s["ctr"], V)
    hh, hl = t_kern.words_to_limbs(s["words"])
    bits = t_sampler.ctr_bits((root[0][:, None], root[1][:, None]),
                              (crow[0][:, None], crow[1][:, None]),
                              (hh[None, :], hl[None, :]), deco=deco)
    lt = torch.from_numpy(s["logits_t"])
    return t_kern._masked(t_kern.gumbel_scores(bits, lt, inv_temp), lt,
                          thresh_t[None, :])


# ---------------------------------------------------------------------------
# kernel F: plain version and two-pass oracle against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V,B", [(512, 256), (512, 128), (64, 8),
                                 (300, 20), (1000, 130)])
@pytest.mark.parametrize("inv_temp,top_k", [(1.0, 0), (1.25, 0),
                                            (1.0, 16), (2.0, 4)])
def test_fused_plain_matches_reference(V, B, inv_temp, top_k):
    s = _setup(9, V, B)
    j_th, t_th = _thresh(s["logits_t"], B, top_k)
    it = np.float32(inv_temp)
    lt = jnp.asarray(s["logits_t"])
    j_fused = np.asarray(j_kern.fused_argmax(
        lt, s["h"], s["roots"], s["ctr_rows"], j_th, inv_temp=it,
        interpret=True))
    j_two = np.asarray(j_kern.twopass_argmax(lt, s["noise"], j_th,
                                             inv_temp=it))
    logits = torch.from_numpy(s["logits_t"].T.copy())       # (B, V)
    got, best = t_kern.fused_argmax_plain(
        logits, s["words"], s["x0"], s["ctr"], t_th, inv_temp=float(it),
        with_scores=True)
    assert got.dtype == torch.int32 and got.shape == (B,)
    assert np.array_equal(got.numpy(), j_fused)
    assert np.array_equal(j_two, j_fused)
    # the port's two-pass oracle over its own engine's gumbel block
    plan = t_engine.GenPlan(x0=s["x0"], h=t_kern.words_to_limbs(s["words"]),
                            num_steps=V, ctr=s["ctr"], sampler="gumbel")
    noise = t_engine.generate(plan, backend="torch")
    two = t_kern.twopass_argmax(logits.T, noise, t_th, inv_temp=float(it))
    assert np.array_equal(two.numpy(), j_fused)
    # scores: the port's block within the ULP slack of the reference's
    want = np.where(s["logits_t"] >= np.asarray(j_th)[None, :],
                    s["logits_t"] * it + np.asarray(s["noise"]),
                    -np.inf).astype(np.float32)
    score = _port_scores(s, float(it), t_th)
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(score.numpy()), finite)
    ulp = t_sampler.ulp_error(score[torch.from_numpy(finite)],
                              torch.from_numpy(want[finite]))
    assert float(ulp.max()) <= ULP_BOUND
    assert torch.equal(best, score.gather(0, got[None, :].long())[0] + 0.0)
    if top_k:
        assert (logits[torch.arange(B), got.long()] >= t_th).all()


def test_twopass_on_reference_noise_is_bit_exact():
    """Given the reference's own noise block, the port's scoring, mask and
    first-argmax give the reference's tokens and scores bit for bit."""
    V, B = 300, 20
    s = _setup(4, V, B)
    j_th, t_th = _thresh(s["logits_t"], B, 4)
    it = np.float32(1.25)
    want = np.asarray(j_kern.twopass_argmax(
        jnp.asarray(s["logits_t"]), s["noise"], j_th, inv_temp=it))
    noise = torch.from_numpy(np.array(s["noise"]))
    lt = torch.from_numpy(s["logits_t"])
    got = t_kern.twopass_argmax(lt, noise, t_th, inv_temp=float(it))
    assert np.array_equal(got.numpy(), want)
    from repro.core import sampler as j_sampler
    lj = jnp.asarray(s["logits_t"])
    j_score = np.asarray(j_ga._masked(
        j_sampler.fma_guard(lj * it) + s["noise"], lj, j_th.reshape(1, -1)))
    t_score = t_kern._masked(lt * float(it) + noise, lt, t_th[None, :])
    assert np.array_equal(t_score.numpy().view(np.int32),
                          j_score.view(np.int32))


def test_fused_argmax_reads_a_vocab_major_view_without_copy():
    """The reference's (V, B) layout is passed as a transposed view."""
    s = _setup(2, 200, 12)
    lt = torch.from_numpy(s["logits_t"])
    th = torch.full((12,), float("-inf"))
    a = t_kern.fused_argmax(lt.T, s["words"], s["x0"], s["ctr"], th,
                            inv_temp=1.0)
    b = t_kern.fused_argmax(lt.T.contiguous(), s["words"], s["x0"],
                            s["ctr"], th, inv_temp=1.0)
    assert lt.T.stride() == (1, 12) and torch.equal(a, b)


@pytest.mark.parametrize("deco", ["splitmix64", "fmix32"])
def test_fused_plain_both_decorrelators_high_counter(deco):
    """Counters past 2^32 and the fmix32 decorrelator: the plain version
    equals the two-pass oracle over the port engine's gumbel block, and
    the reference's kernel."""
    V, B = 300, 20
    ctr = 2 ** 32 + 12345
    s = _setup(6, V, B, ctr=ctr, deco=deco)
    j_th, t_th = _thresh(s["logits_t"], B, 0)
    want = np.asarray(j_kern.fused_argmax(
        jnp.asarray(s["logits_t"]), s["h"], s["roots"], s["ctr_rows"], j_th,
        inv_temp=np.float32(1.0), deco=deco, interpret=True))
    lt = torch.from_numpy(s["logits_t"])
    got = t_kern.fused_argmax(lt.T, s["words"], s["x0"], ctr, t_th,
                              inv_temp=1.0, deco=deco)
    plan = t_engine.GenPlan(x0=s["x0"], h=t_kern.words_to_limbs(s["words"]),
                            num_steps=V, ctr=ctr, deco=deco, sampler="gumbel")
    two = t_kern.twopass_argmax(lt, t_engine.generate(plan), t_th,
                                inv_temp=1.0)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, two)


def test_all_masked_columns_give_token_zero():
    V, B = 64, 8
    s = _setup(1, V, B)
    lt = torch.from_numpy(s["logits_t"]).clone()
    th = torch.full((B,), float("-inf"))
    th[[1, 5]] = float("inf")                     # everything masked
    lt[:, 3] = float("-inf")                      # every logit -inf
    got = t_kern.fused_argmax(lt.T, s["words"], s["x0"], s["ctr"], th,
                              inv_temp=1.0)
    assert got[[1, 3, 5]].tolist() == [0, 0, 0]
    want = np.asarray(j_kern.fused_argmax(
        jnp.asarray(lt.numpy()), s["h"], s["roots"], s["ctr_rows"],
        jnp.asarray(th.numpy()), inv_temp=np.float32(1.0), interpret=True))
    assert np.array_equal(got.numpy(), want)


# counter at which leaf tag 13 of family (seed 7, purpose 0xD0) draws the
# bits whose uniform u = 6171993 / 2^24 has log(u) == -1 exactly on the
# CPU, so its gumbel noise is -0.0 (found by a search over counters)
NEG_ZERO = dict(seed=7, purpose=0xD0, tag=13, counter=24235)


def negative_zero_case(device="cpu"):
    """One sequence whose scores tie at -0.0 (index 5: logit -0.0 plus
    noise -0.0) and +0.0 (index 9: logit = -noise); every other logit is
    -100.  Returns (logits (1, V), h words, x0, ctr)."""
    V, v0, v1 = 40, 5, 9
    x0, h_fam = t_engine.family_from_seed(NEG_ZERO["seed"],
                                          NEG_ZERO["purpose"])
    h = t_engine.derive_leaf_host(h_fam, NEG_ZERO["tag"])
    ctr = NEG_ZERO["counter"] - v0
    plan = t_engine.GenPlan(x0=x0, h=t_engine.leaf_limbs([h], device),
                            num_steps=V, ctr=ctr, sampler="gumbel")
    g = t_engine.generate(plan)[:, 0]
    logits = torch.full((1, V), -100.0, device=device)
    logits[0, v0] = -0.0
    logits[0, v1] = -g[v1]
    return logits, t_kern.leaf_words([h], device), x0, ctr, g


def test_negative_zero_ties_with_positive_zero():
    """-0.0 and +0.0 scores compare equal: the first index wins, as in
    the reference's argmax_first, and the winning score reads +0.0."""
    logits, h, x0, ctr, g = negative_zero_case()
    assert g[5].item() == 0.0 and torch.signbit(g[5]).item()
    th = torch.full((1,), float("-inf"))
    tok, best = t_kern.fused_argmax_plain(logits, h, x0, ctr, th,
                                          inv_temp=1.0, with_scores=True)
    scores = logits[0] * 1.0 + g
    assert torch.signbit(scores[5]) and not torch.signbit(scores[9])
    assert tok.tolist() == [5]
    assert np.asarray(j_kern.argmax_first(jnp.asarray(
        scores.numpy()[:, None]))).tolist() == [5]
    assert best.item() == 0.0 and not torch.signbit(best).item()


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_inf.ContinuousBatcher(t_inf.ScheduleConfig(**SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_inf.run_offline(t_inf.ScheduleConfig(**SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_inf.GumbelMaxSampler.standalone(seed=0, vocab=8, capacity=2)


def test_synthetic_logit_model_defaults_to_the_card(monkeypatch):
    """A SyntheticLogitModel built with no device is on the card, and
    raises without one (it took the CPU silently before)."""
    if torch.cuda.is_available():
        assert t_inf.SyntheticLogitModel(2, 8).device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_inf.SyntheticLogitModel(2, 8)
    assert t_inf.SyntheticLogitModel(2, 8, device=CPU).device.type == "cpu"


def test_top_k_one_is_the_argmax():
    s = _setup(3, 500, 16)
    lt = torch.from_numpy(s["logits_t"])
    th = torch.topk(lt.T, 1, dim=-1).values[:, -1]
    got = t_kern.fused_argmax(lt.T, s["words"], s["x0"], s["ctr"], th,
                              inv_temp=1.0)
    assert torch.equal(got.long(), torch.argmax(lt, dim=0))


def test_argmax_first_breaks_ties_low():
    rng = np.random.default_rng(5)
    s = rng.normal(size=(64, 32)).astype(np.float32)
    got = t_kern.argmax_first(torch.from_numpy(s))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.argmax(s, axis=0))
    assert np.array_equal(got.numpy(),
                          np.asarray(j_kern.argmax_first(jnp.asarray(s))))
    t = np.zeros((8, 4), np.float32) - 1.0
    t[2, :] = 7.0
    t[5, :] = 7.0
    t[1, 3], t[6, 3] = -0.0, 0.0                  # -0 == +0: index 1 wins
    t[:, 3] = np.where(t[:, 3] == 7.0, -1.0, t[:, 3])
    got = t_kern.argmax_first(torch.from_numpy(t)).tolist()
    assert got == [2, 2, 2, 1]
    assert got == np.asarray(j_kern.argmax_first(jnp.asarray(t))).tolist()


def test_gumbel_scores_is_the_shared_transform():
    """Port's scoring transform: the f32-rounded scaled logit plus the
    sampler grammar's gumbel stage; the scaled logit is bit-equal to the
    reference's ``fma_guard`` product, the whole within the ULP slack."""
    from repro.core import sampler as j_sampler
    bits = j_sampler.remix_bits(
        jnp.arange(256, dtype=jnp.uint32) * np.uint32(0x9E3779B9), 7)
    logits = jnp.linspace(-2.0, 2.0, 256).astype(jnp.float32)
    tb = torch.from_numpy(np.asarray(bits).astype(np.int64))
    tl = torch.from_numpy(np.array(logits))
    got = t_kern.gumbel_scores(tb, tl, 0.5)
    assert torch.equal(got, tl * 0.5 + t_sampler.gumbel_from_bits(tb))
    assert np.array_equal((tl * 0.5).numpy(),
                          np.asarray(j_sampler.fma_guard(
                              logits * np.float32(0.5))))
    want = np.array(j_kern.gumbel_scores(bits, logits, np.float32(0.5)))
    assert float(t_sampler.ulp_error(got, torch.from_numpy(want)).max()) \
        <= ULP_BOUND


def test_leaf_words_round_trip():
    hs = [0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 2]
    w = t_kern.leaf_words(hs)
    hi, lo = t_kern.words_to_limbs(w)
    assert [(int(a) << 32) | int(b) for a, b in zip(hi, lo)] == hs


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def _active(mod, registry, n, position=0):
    out = []
    for slot in range(n):
        sid = f"seq/{slot}"
        t = registry.register(sid)
        out.append(mod.ActiveSeq(slot=slot, seq_id=sid, tenant_id=sid,
                                 tag=t.tag(0), position=position))
    return out


def test_sampler_greedy_consumes_nothing():
    s = t_inf.GumbelMaxSampler.standalone(
        seed=1, vocab=32, capacity=4,
        spec=t_inf.SamplingSpec(temperature=0.0), device=CPU)
    logits = np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32)
    toks = s.sample_step(0, logits, _active(t_inf, s.registry, 4))
    assert np.array_equal(toks, np.argmax(logits, -1))
    st = s.stats()
    assert st["engine_calls"] == 0 and st["greedy"]
    assert s.service.ledger_state()["channels"][s.channel]["committed"] == []


@pytest.mark.parametrize("path", ["fused", "torch"])
def test_sampler_journal_is_the_references_byte_for_byte(tmp_path, path):
    """One stochastic step journals ONE atomic batch record; the port's
    journal file equals the reference's, tokens included."""
    V, cap = 64, 4
    logits = np.random.default_rng(7).normal(size=(cap, V)).astype(
        np.float32)
    files, toks = [], []
    for mod, audit_mod, extra in ((j_inf, j_audit, {}),
                                  (t_inf, t_audit, {"device": CPU})):
        p = tmp_path / f"{mod.__name__}.jsonl"
        j = audit_mod.Journal(str(p))
        kw = dict(path=path) if mod is t_inf else {}
        s = mod.GumbelMaxSampler.standalone(seed=5, vocab=V, capacity=cap,
                                            journal=j, **kw, **extra)
        act = _active(mod, s.registry, cap)
        toks.append([np.asarray(s.sample_step(t, logits, [
            mod.ActiveSeq(slot=a.slot, seq_id=a.seq_id,
                          tenant_id=a.tenant_id, tag=a.tag, position=t)
            for a in act])) for t in range(3)])
        j.close()
        files.append(p.read_bytes())
        assert s.stats()["calls_per_step"] == 1.0
    assert files[0] == files[1]
    assert all(np.array_equal(a, b) for a, b in zip(*toks))


def test_sampler_replays_through_lease_or_regenerate(tmp_path):
    path = str(tmp_path / "j.jsonl")
    V, cap = 64, 4
    logits = np.random.default_rng(7).normal(size=(cap, V)).astype(
        np.float32)

    def batch(active, t):
        return [t_inf.ActiveSeq(slot=a.slot, seq_id=a.seq_id,
                                tenant_id=a.tenant_id, tag=a.tag,
                                position=t) for a in active]

    j = t_audit.Journal(path)
    s = t_inf.GumbelMaxSampler.standalone(seed=5, vocab=V, capacity=cap,
                                          journal=j, device=CPU)
    act = _active(t_inf, s.registry, cap)
    first = [s.sample_step(t, logits, batch(act, t)) for t in range(3)]
    j.close()
    j2 = t_audit.Journal(path)
    batches = [e for e in j2.entries if e["kind"] == "batch"]
    assert len(batches) == 3 and len(batches[0]["requests"]) == cap
    assert batches[0]["windows"] == [
        {"channel": t_sampling.class_channel(), "lo": 0, "hi": V}]
    svc = t_blocks.BlockService(seed=5, device=CPU)
    j2.restore_into(svc, fence=True)
    s2 = t_inf.GumbelMaxSampler(svc, t_tenants.TenantRegistry(), vocab=V,
                                capacity=cap, journal=j2)
    act2 = _active(t_inf, s2.registry, cap)
    again = [s2.sample_step(t, logits, batch(act2, t)) for t in range(3)]
    j2.close()
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    assert s2.stats()["replayed_steps"] == 3
    # each journaled sequence's noise regenerates from its record alone
    rep = t_audit.replay(t_audit.Journal(path, readonly=True), seed=5,
                         device=CPU)
    assert len(rep) == 3 * cap and all(v.shape == (V,) for v in rep.values())


def test_sampler_rejects_bad_config():
    with pytest.raises(ValueError, match="unknown sampling path"):
        t_inf.GumbelMaxSampler.standalone(seed=0, vocab=8, capacity=2,
                                          path="xla", device=CPU)
    with pytest.raises(ValueError, match="top_k"):
        t_inf.GumbelMaxSampler.standalone(
            seed=0, vocab=8, capacity=2, spec=t_inf.SamplingSpec(top_k=9),
            device=CPU)
    with pytest.raises(ValueError, match="top_k must be >= 0"):
        t_inf.SamplingSpec(top_k=-1)
    with pytest.raises(ValueError, match="vocab >= 1"):
        t_inf.GumbelMaxSampler.standalone(seed=0, vocab=0, capacity=2,
                                          device=CPU)


# ---------------------------------------------------------------------------
# the slot pool
# ---------------------------------------------------------------------------

def test_slot_pool_admit_retire_reuse_ledger_disjoint():
    svc = t_blocks.BlockService(seed=3, device=CPU)
    reg = t_tenants.TenantRegistry()
    pool = t_inf.SlotPool(svc, reg, capacity=2, min_len=2, len_spread=5)
    a = pool.admit("seq/a", 0)
    b = pool.admit("seq/b", 0)
    assert (a.slot, b.slot) == (0, 1) and not pool.has_free()
    assert 2 <= a.target_len <= 7
    with pytest.raises(RuntimeError, match="no free slot"):
        pool.admit("seq/c", 1)
    gone = pool.retire(0)
    assert gone.seq_id == "seq/a" and "seq/a" not in reg
    c = pool.admit("seq/c", 3)
    assert c.slot == 0 and c.occupant == 1
    led = svc.ledger_state()["channels"][t_slots.slot_channel(0)]
    assert led["committed"] == [[0, 16]] and led["floor"] == 8
    t_audit.verify_ledger_disjoint(svc)
    with pytest.raises(t_blocks.LeaseError, match="floor"):
        svc.lease(t_slots.slot_channel(0), 4, at=0)
    pool.retire(0)
    with pytest.raises(ValueError, match="not occupied"):
        pool.retire(0)
    assert pool.num_active() == 1


def test_slot_pool_admission_draws_replay_and_match_reference(tmp_path):
    """Same (slot, occupant) => same target_len: across a journal-restored
    service, and across the two packages."""
    def run(mod_blocks, mod_tenants, pool_cls, audit_mod, path, **kw):
        j = audit_mod.Journal(path)
        svc = mod_blocks.BlockService(seed=9, **kw)
        if j.entries:
            j.restore_into(svc, fence=True)
        pool = pool_cls(svc, mod_tenants.TenantRegistry(), capacity=2,
                        journal=j)
        lens = []
        for i in range(5):
            if not pool.has_free():
                pool.retire(i % 2)
            lens.append(pool.admit(f"seq/{i}", i).target_len)
        j.close()
        return lens

    p = str(tmp_path / "t.jsonl")
    first = run(t_blocks, t_tenants, t_inf.SlotPool, t_audit, p, device=CPU)
    again = run(t_blocks, t_tenants, t_inf.SlotPool, t_audit, p, device=CPU)
    ref = run(j_blocks, j_tenants, j_inf.SlotPool, j_audit,
              str(tmp_path / "j.jsonl"))
    assert first == again == ref


# ---------------------------------------------------------------------------
# the batcher and the harness
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_small_digest():
    return j_inf.ContinuousBatcher(j_inf.ScheduleConfig(**SMALL)).run().digest


@pytest.mark.parametrize("path", ["fused", "torch"])
def test_batcher_digest_equals_reference(ref_small_digest, path):
    r = t_inf.ContinuousBatcher(t_inf.ScheduleConfig(**SMALL, path=path),
                                device=CPU).run()
    assert r.digest == ref_small_digest
    assert r.digest == t_inf.transcript_digest(r.transcripts)
    assert r.admitted == r.retired == SMALL["sequences"]
    assert r.sampler_stats["calls_per_step"] == 1.0
    assert 0.0 < r.occupancy <= 1.0
    for toks in r.transcripts.values():
        assert len(toks) >= 4 and all(0 <= t < SMALL["vocab"] for t in toks)


def test_batcher_seed_changes_tokens(ref_small_digest):
    r = t_inf.ContinuousBatcher(
        t_inf.ScheduleConfig(**{**SMALL, "seed": 6}), device=CPU).run()
    assert r.digest != ref_small_digest


def test_schedule_config_fields_match_reference():
    import dataclasses
    a = dataclasses.asdict(t_inf.ScheduleConfig())
    b = dataclasses.asdict(j_inf.ScheduleConfig())
    assert a == b


@pytest.mark.parametrize("cap,vocab,pos0", [(4, 32, 0), (5, 300, 2 ** 32 - 3),
                                            (3, 1000, 12345)])
def test_synthetic_logits_equal_reference_bit_for_bit(cap, vocab, pos0):
    tm = t_inf.SyntheticLogitModel(cap, vocab, scale=6.0, device=CPU)
    jm = j_inf.SyntheticLogitModel(cap, vocab, scale=6.0)
    h = np.asarray([tm.seq_hash(f"s{i}") for i in range(cap)], np.uint32)
    p = (np.arange(cap, dtype=np.uint64) + pos0).astype(np.uint32)
    got = tm(h, p)
    want = np.asarray(jm(h, p))
    assert got.dtype == torch.float32 and got.shape == (cap, vocab)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert float(got.min()) >= 0.0 and float(got.max()) < 6.0
    assert not torch.equal(got, tm(h, p + np.uint32(1)))


def test_run_offline_parity_flag_in_process(tmp_path, ref_small_digest):
    report = t_inf.run_offline(t_inf.ScheduleConfig(**SMALL),
                               journal_path=str(tmp_path / "j.jsonl"),
                               parity=True, device=CPU)
    j = report.to_json()
    assert j["parity_digest"] == j["digest"] == ref_small_digest
    assert j["calls_per_step"] == 1.0 and j["retired"] == SMALL["sequences"]
    assert j["device"] == "cpu"


def test_reference_journal_replays_through_the_port(tmp_path,
                                                    ref_small_digest):
    """A journal the reference wrote for a whole run restores into the
    port's batcher, which replays every step to the same digest; and the
    reverse."""
    jp = str(tmp_path / "ref.jsonl")
    j_inf.run_offline(j_inf.ScheduleConfig(**SMALL), journal_path=jp)
    r = t_inf.run_offline(t_inf.ScheduleConfig(**SMALL), journal_path=jp,
                          device=CPU)
    assert r.result.digest == ref_small_digest
    assert r.result.sampler_stats["replayed_steps"] == r.result.decode_steps
    tp = str(tmp_path / "port.jsonl")
    t_inf.run_offline(t_inf.ScheduleConfig(**SMALL), journal_path=tp,
                      device=CPU)
    back = j_inf.run_offline(j_inf.ScheduleConfig(**SMALL), journal_path=tp)
    assert back.result.digest == ref_small_digest
    assert back.result.sampler_stats["replayed_steps"] == \
        back.result.decode_steps
    j_audit.verify_ledger_disjoint(j_audit.Journal(tp, readonly=True))


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


def test_killed_reference_run_replays_through_the_port(tmp_path,
                                                       ref_small_digest):
    """The reference process killed at decode step 6 (SIGKILL semantics)
    leaves a journal; the port's batcher restarted on it gives the
    reference's fault-free digest."""
    journal = str(tmp_path / "run.jsonl")
    killed = subprocess.run(
        [sys.executable, "-m", "repro.inference", *CLI_SMALL, "--journal",
         journal, "--fault-plan", "kill@6"], cwd=ROOT, env=_env(),
        timeout=300)
    assert killed.returncode == 1
    r = t_inf.run_offline(t_inf.ScheduleConfig(**SMALL),
                          journal_path=journal, device=CPU)
    assert r.result.digest == ref_small_digest
    assert 0 < r.result.sampler_stats["replayed_steps"] < \
        r.result.decode_steps
    t_audit.verify_ledger_disjoint(t_audit.Journal(journal, readonly=True))


def test_port_kill_and_replay_subprocess(tmp_path, ref_small_digest):
    args = [sys.executable, "-m", "repro_torch.inference", "--device", "cpu",
            *CLI_SMALL]
    journal = str(tmp_path / "run.jsonl")
    killed = subprocess.run(args + ["--journal", journal, "--fault-plan",
                                    "kill@6"], cwd=ROOT, env=_env(),
                            timeout=300)
    assert killed.returncode == 1, "kill fault must take the process down"
    out = tmp_path / "replay.digest"
    again = subprocess.run(args + ["--journal", journal, "--digest-out",
                                   str(out)], cwd=ROOT, env=_env(),
                           timeout=300)
    assert again.returncode == 0
    assert out.read_text().strip() == ref_small_digest
    t_audit.verify_ledger_disjoint(t_audit.Journal(journal, readonly=True))


def test_harness_cli_json_report(capsys):
    from repro_torch.inference import harness
    assert harness.main(["--device", "cpu", *CLI_SMALL, "--json",
                         "--top-k", "5"]) == 0
    import json
    rep = json.loads(capsys.readouterr().out)
    assert rep["config"]["top_k"] == 5 and rep["calls_per_step"] == 1.0
    assert rep["device"] == "cpu"


@pytest.mark.parametrize("inv_temp,top_k", [(1.0, 0), (0.5, 3), (2.0, 40)])
def test_subnormal_logits_give_reference_tokens(inv_temp, top_k):
    """Logits of +-0, subnormals and the smallest normals: the reference
    reads subnormals as zeros of their sign (XLA:CPU), so at a top-k
    threshold of a subnormal or zero every subnormal ties with zero.  The
    port's plain version, two-pass oracle and mask must pick its tokens."""
    V, B = 256, 32
    s = _setup(5, V, B)
    pats = np.array([0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF,
                     0x00400000, 0x80400000, 0x0, 0x80000000, 0x00800000,
                     0x80800000], np.uint32)
    rng = np.random.default_rng(11)
    lt_np = pats[rng.integers(0, len(pats), size=(V, B))].view(np.float32)
    j_th, t_th = _thresh(lt_np, B, top_k)
    it = np.float32(inv_temp)
    want = np.asarray(j_kern.twopass_argmax(jnp.asarray(lt_np), s["noise"],
                                            j_th, inv_temp=it))
    noise = torch.from_numpy(np.array(s["noise"]))
    lt = torch.from_numpy(lt_np.copy())
    got = t_kern.twopass_argmax(lt, noise, t_th, inv_temp=float(it))
    assert np.array_equal(got.numpy(), want)
    fused = t_kern.fused_argmax_plain(lt.T.contiguous(), s["words"], s["x0"],
                                      s["ctr"], t_th, inv_temp=float(it))
    assert np.array_equal(fused.numpy(), want)
