"""Kernel tests that need a CUDA card (marker ``gpu``).

Run on a machine with a card:  PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py.  Without a card every test here skips; whether a
card is present is decided inside the ``cuda`` fixture, so every worker
collects the same tests.
"""
import numpy as np
import pytest
import torch

from repro_torch import inference
from repro_torch.core import engine, golden, sampler, stream, u64, \
    xorshift
from repro_torch.inference.kernels import gumbel_argmax as ga
from repro_torch.kernels import digests
from repro_torch.kernels import fused_dropout as fd
from repro_torch.kernels import mc, ops
from repro_torch.kernels import thundering_block as tb
from repro_torch.runtime import blocks
from repro_torch.runtime.blocks import BlockService

pytestmark = pytest.mark.gpu

STAGES = ["bits", "uniform", "normal", "bernoulli(0.3)", "exponential(1.5)",
          "poisson(3.5)", "gamma(2.5)", "gamma(3.0,0.5)", "gumbel",
          "categorical[0.5,0.25,0.125,0.125]"]
EXACT = ("bits", "uniform", "bernoulli", "poisson", "categorical")
OPTION = dict(s0=100.0, strike=100.0, r=0.05, sigma=0.2, t=1.0)
# Option partials, relative to the largest partial: the kernel sums each
# tile in row order and the plain version in torch's order, and CUDA's
# logf / cosf / expf may differ from torch's by a few ULP per draw.
OPTION_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b, kind):
    if a.dtype in (torch.uint32, torch.bool):
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    if kind in EXACT:
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    return float(sampler.ulp_error(a, b).max()) <= 8.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", STAGES)
@pytest.mark.parametrize("mode,deco", [("ctr", "splitmix64"),
                                       ("ctr", "fmix32"),
                                       ("faithful", "splitmix64")])
def test_kernel_matches_plain_version(cuda, mode, deco, spec, dtype):
    for T, S, off in [(40, 130, 12345), (2, 1, 2 ** 32 + 7),
                      (256, 1000, 2 ** 32 + 7)]:
        plan = engine.make_plan(seed=3, num_streams=S, num_steps=T,
                                offset=off, mode=mode, deco=deco,
                                sampler=spec, out_dtype=dtype, device=cuda)
        got = engine.generate(plan, backend="cuda")
        want = engine.generate(plan, backend="torch")
        assert got.shape == want.shape and got.dtype == want.dtype
        assert _same(got, want, sampler.parse(spec)[0]), (T, S, off)


@pytest.mark.parametrize("mode", ["ctr", "faithful"])
def test_kernel_matches_numpy_golden(cuda, mode):
    plan = engine.make_plan(seed=4, num_streams=9, num_steps=37,
                            offset=2 ** 33 + 1, mode=mode, device=cuda)
    got = engine.generate(plan).cpu().numpy()
    h = np.array([u64.join64(a, b) for a, b in
                  zip(plan.h[0].tolist(), plan.h[1].tolist())], np.uint64)
    want = golden.thundering_block(plan.x0, h, 37, mode=mode,
                                   offset=2 ** 33 + 1).T
    assert np.array_equal(got, want)


def test_windows_and_stream_on_card(cuda):
    tb.reset_counts()
    plan = engine.make_plan(seed=5, num_streams=300, num_steps=64,
                            device=cuda)
    stack = engine.generate_windows(plan, 3)
    for w in range(3):
        one = engine.generate(engine.shift_plan(plan, 64 * w))
        assert torch.equal(stack[w].view(torch.int32), one.view(torch.int32))
    fam = stream.new_stream(5, 0, device=cuda)
    col = stream.random_bits(stream.derive(fam, 7), (64,))
    assert torch.equal(col.view(torch.int32),
                       stack[0][:, 7].contiguous().view(torch.int32))
    assert tb.thundering_ctr.launches > 0
    assert tb.thundering_ctr_plain.cuda_runs == 0


@pytest.mark.parametrize("donate", [False, True])
def test_producer_on_card(cuda, donate):
    svc = BlockService(seed=6, device=cuda)
    svc.open("g", num_streams=257, sampler="uniform")
    with svc.producer("g", 32, depth=2, fuse=4, count=9, donate=donate,
                      check_ring=True) as prod:
        got = [(lease.lo, blk.clone()) for lease, blk in prod]
    ref = BlockService(seed=6, device="cpu")
    ref.open("g", num_streams=257, sampler="uniform")
    for lo, blk in got:
        want = ref.regenerate("g", lo, 32)
        assert torch.equal(blk.cpu(), want)


def test_out_of_place_checks_raise(cuda):
    plan = engine.make_plan(seed=1, num_streams=8, num_steps=8, device=cuda)
    with pytest.raises(ValueError, match="out must be"):
        engine.generate(plan, out=torch.empty((8, 8), dtype=torch.float32,
                                              device=cuda))


def test_block_kernels_reproduce_recorded_digests(cuda):
    """Kernels A and B write, byte for byte, what the recorded build wrote
    (every stage and dtype, both decorrelators, faithful mode)."""
    got = digests.compute(cuda)
    assert set(got) == set(digests.RECORDED)
    assert digests.mismatches(got) == []


def test_fused_dropout_kernel_reproduces_recorded_digests(cuda):
    """Kernel C writes, byte for byte, what the recorded build wrote (every
    dtype x rate x counter x input, special values and NaNs included)."""
    got = digests.compute_dropout(cuda)
    assert set(got) == set(digests.DROPOUT_RECORDED)
    assert digests.mismatches(got) == []


# (T, S, offset): one column (the stream API's S = 1), S that no 16-byte
# run divides, odd row counts, and a row wider than one block of runs.
EDGE_SHAPES = [(33, 1, 7), (8, 1, 2 ** 32 + 12345), (7, 3, 12345),
               (9, 5, 2 ** 32 + 12345), (41, 130, 12345),
               (5, 2 ** 14 + 1, 2 ** 32)]
EDGE_CASES = [(spec, dtype) for spec, dtypes in digests.STAGES
              for dtype in dtypes]


def _block(mode, deco, plan, T, spec, dtype, plain, out=None):
    kw = dict(sampler=sampler.parse(spec), out_dtype=dtype)
    if mode == "ctr":
        fn = tb.thundering_ctr_plain if plain else tb.thundering_ctr
        kw["deco"] = deco
        args = (plan.x0, plan.ctr, T, plan.h)
    else:
        fn = tb.thundering_faithful_plain if plain else tb.thundering_faithful
        kw["block_t"] = tb.tile_rows(16, T)
        args = (plan.x0, plan.ctr, T, plan.h,
                tb.lane_states(plan.num_streams, plan.device))
    if out is not None:
        kw["out"] = out
    return fn(*args, **kw)


@pytest.mark.parametrize("spec,dtype", EDGE_CASES)
@pytest.mark.parametrize("mode,deco", [("ctr", "splitmix64"),
                                       ("ctr", "fmix32"),
                                       ("faithful", "splitmix64")])
def test_block_kernels_match_plain_at_edges(cuda, mode, deco, spec, dtype):
    kind = sampler.parse(spec)[0]
    for T, S, off in EDGE_SHAPES:
        if kind == "normal" and T % 2:
            T += 1
        plan = engine.make_plan(seed=11, num_streams=S, num_steps=T,
                                offset=off, device=cuda)
        want = _block(mode, deco, plan, T, spec, dtype, plain=True)
        got = _block(mode, deco, plan, T, spec, dtype, plain=False)
        assert got.dtype == want.dtype, (T, S, off)
        assert _same(got, want, kind), (T, S, off)
        # an out= view one element past a 16-byte line
        buf = torch.empty(T * S + 1, dtype=want.dtype, device=cuda)
        view = buf[1:].view(T, S)
        res = _block(mode, deco, plan, T, spec, dtype, plain=False, out=view)
        assert res.data_ptr() == view.data_ptr()
        assert torch.equal(view.view(torch.uint8), got.view(torch.uint8)), \
            (T, S, off)


@pytest.mark.parametrize("ctr", [0, 12345, 2 ** 32 + 12345, 2 ** 63 + 1])
def test_device_tile_states_match_host_jump(cuda, ctr):
    S, T, bt = 1000, 1000, 64
    plan = engine.make_plan(seed=1, num_streams=S, num_steps=T, offset=ctr,
                            mode="faithful", device=cuda)
    n_tiles = -(-T // bt)
    got = tb.faithful_tile_states(tb.lane_states(S, cuda), ctr, bt, n_tiles)
    want = engine._faithful_tile_states(plan, bt, n_tiles)
    assert np.array_equal(u64.limbs(got.cpu()).numpy().astype(np.uint32),
                          want)


def test_faithful_card_path_makes_no_host_jump(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("host GF(2) jump on the card path")
    plan = engine.make_plan(seed=2, num_streams=300, num_steps=100,
                            offset=2 ** 32 + 12345, mode="faithful",
                            device=cuda)
    tb.lane_states(300, cuda)                  # the one-time upload
    want = engine.generate(plan, backend="torch")
    monkeypatch.setattr(engine, "_faithful_tile_states", refuse)
    monkeypatch.setattr(engine, "_faithful_states_at", refuse)
    monkeypatch.setattr(xorshift, "jump_batch", refuse)
    tb.reset_counts()
    got = engine.generate(plan)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert tb.thundering_faithful.launches == 1
    assert tb.thundering_faithful_plain.cuda_runs == 0


@pytest.mark.parametrize("mode", ["ctr", "faithful"])
def test_producer_ring_on_card(cuda, mode):
    svc = BlockService(seed=7, device=cuda)
    svc.open("r", num_streams=2 ** 10, mode=mode)
    with svc.producer("r", 64, depth=2, fuse=4, count=9, donate=True,
                      check_ring=True) as prod:
        got = [(lease.lo, blk.clone()) for lease, blk in prod]
    ref = BlockService(seed=7, device="cpu")
    ref.open("r", num_streams=2 ** 10, mode=mode)
    for lo, blk in got:
        assert torch.equal(blk.cpu(), ref.regenerate("r", lo, 64))


@pytest.mark.parametrize("T,S,bt,off", [(37, 130, 8, 0),
                                        (256, 130, 256, 2 ** 32 + 12345),
                                        (1000, 1000, 64, 2 ** 32 - 300)])
def test_mc_kernels_match_plain_versions(cuda, T, S, bt, off):
    px, py = (engine.make_plan(seed=3, num_streams=S, num_steps=T, purpose=p,
                               offset=off, device=cuda) for p in (1, 2))
    args = (px.x0, px.ctr, T, px.h, py.h)
    got = mc.pi_partials(*args, block_t=bt)
    assert torch.equal(got, mc.pi_partials_plain(*args, block_t=bt))
    got = mc.option_partials(*args, block_t=bt, **OPTION)
    want = mc.option_partials_plain(*args, block_t=bt, **OPTION)
    assert float((got - want).abs().max()) <= \
        OPTION_RTOL * float(want.abs().max())


@pytest.mark.parametrize("offset", [0, 2 ** 32 - 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(3, 1001), (8, 128), (257, 3072)])
def test_fused_dropout_kernel_matches_plain_version(cuda, shape, dtype,
                                                    offset):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    s = stream.advance(stream.new_stream(7, 0, device=cuda), offset)
    view = torch.int32 if dtype == torch.float32 else torch.int16
    for rate in (0.1, 0.5, 1e-9):
        got = fd.fused_dropout_2d(x, s.h, s.x0, s.ctr, rate)
        want = fd.fused_dropout_2d_plain(x, s.h, s.x0, s.ctr, rate)
        assert torch.equal(got.view(view), want.view(view)), rate


def test_fused_dropout_kernel_takes_misaligned_input(cuda):
    base = torch.randn(64 * 65 + 1, device=cuda)
    x = base[1:].view(64, 65)  # contiguous, 4 bytes past a 16-byte line
    s = stream.new_stream(8, 0, device=cuda)
    got = fd.fused_dropout_2d(x, s.h, s.x0, s.ctr, 0.3)
    want = fd.fused_dropout_2d_plain(x, s.h, s.x0, s.ctr, 0.3)
    assert torch.equal(got, want)


def test_apps_run_on_the_kernels(cuda):
    mc.reset_counts()
    fd.reset_counts()
    kw = dict(seed=1, num_lanes=300, draws_per_lane=200, block_t=64)
    pi = ops.estimate_pi(**kw)
    assert pi.device.type == "cuda" and pi.dtype == torch.float32
    assert pi.item() == ops.estimate_pi(**kw, device="cpu").item()
    price = ops.price_option(**kw)
    want = ops.price_option(**kw, device="cpu").item()
    assert abs(price.item() - want) <= OPTION_RTOL * want
    svc = BlockService(seed=2, device=cuda)
    e1 = blocks.estimate_pi(svc, num_lanes=128, draws_per_lane=64)
    e2 = blocks.estimate_pi(svc, num_lanes=128, draws_per_lane=64)
    assert e1.item() != e2.item()
    assert svc.ledger_state()["channels"]["mc/pi"]["committed"] == [[0, 128]]
    x = torch.randn((4, 8, 128), device=cuda, dtype=torch.bfloat16)
    s = stream.new_stream(3, 0, device=cuda)
    y = ops.fused_dropout(x, s, 0.1)
    want = ops.fused_dropout(x.cpu(), stream.new_stream(3, 0, device="cpu"),
                             0.1)
    assert torch.equal(y.cpu().view(torch.int16), want.view(torch.int16))
    assert torch.equal(ops.fused_dropout(x, s, 0.1, use_kernel=False), y)
    assert mc.pi_partials.launches > 0 and mc.option_partials.launches > 0
    assert fd.fused_dropout_2d.launches > 0
    assert mc.pi_partials_plain.cuda_runs == 0
    assert mc.option_partials_plain.cuda_runs == 0
    assert fd.fused_dropout_2d_plain.cuda_runs == 0


# ---------------------------------------------------------------------------
# kernel F: fused gumbel-max sampling
# ---------------------------------------------------------------------------

GA_SHAPES = [(256000, 64), (256000, 256), (1000, 130), (300, 20), (64, 8)]
GA_OPTIONS = [(1.0, 0), (1.25, 0), (1.0, 16), (2.0, 4)]


def _ga_case(V, B, device, seed=9):
    """(B, V) logits and (B,) leaf words of family (seed, 0xD0)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    logits = torch.randn((B, V), generator=gen, device=device)
    x0, h_fam = engine.family_from_seed(seed, 0xD0)
    h = ga.leaf_words([engine.derive_leaf_host(h_fam, t) for t in range(B)],
                      device)
    return logits, h, x0


def _ga_check(logits, h, x0, ctr, th, inv_temp, deco="splitmix64"):
    """Kernel F against its plain version: tokens equal, winning scores
    equal bit for bit; returns the tokens."""
    B = logits.shape[0]
    scores = torch.empty(B, device=logits.device)
    got = ga.fused_argmax(logits, h, x0, ctr, th, inv_temp=inv_temp,
                          deco=deco, scores_out=scores)
    want, best = ga.fused_argmax_plain(logits, h, x0, ctr, th,
                                       inv_temp=inv_temp, deco=deco,
                                       with_scores=True)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(scores.view(torch.int32), best.view(torch.int32))
    return got


@pytest.mark.parametrize("deco", ["splitmix64", "fmix32"])
@pytest.mark.parametrize("inv_temp,top_k", GA_OPTIONS)
@pytest.mark.parametrize("V,B", GA_SHAPES)
def test_gumbel_argmax_kernel_matches_plain_version(cuda, V, B, inv_temp,
                                                    top_k, deco):
    logits, h, x0 = _ga_case(V, B, cuda)
    th = (torch.topk(logits, top_k, dim=-1).values[:, -1] if top_k
          else torch.full((B,), float("-inf"), device=cuda))
    for ctr in (977, 2 ** 32 + 12345):
        got = _ga_check(logits, h, x0, ctr, th, inv_temp, deco)
        if top_k:
            assert (logits[torch.arange(B, device=cuda), got.long()]
                    >= th).all()


def test_gumbel_argmax_kernel_reads_a_vocab_major_view(cuda):
    logits, h, x0 = _ga_case(1000, 130, cuda)
    lt = logits.T.contiguous()                  # the reference's (V, B)
    th = torch.full((130,), float("-inf"), device=cuda)
    got = _ga_check(lt.T, h, x0, 5, th, 1.0)
    assert torch.equal(got, ga.fused_argmax(logits, h, x0, 5, th,
                                            inv_temp=1.0))


def test_gumbel_argmax_kernel_masked_columns_and_top_1(cuda):
    logits, h, x0 = _ga_case(300, 20, cuda)
    th = torch.full((20,), float("-inf"), device=cuda)
    th[[1, 7]] = float("inf")                   # everything masked
    logits[3] = float("-inf")                   # every logit -inf
    got = _ga_check(logits, h, x0, 2 ** 33, th, 1.0)
    assert got[[1, 3, 7]].tolist() == [0, 0, 0]
    top1 = torch.topk(logits, 1, dim=-1).values[:, -1]
    top1[[1, 7]] = float("inf")
    got = _ga_check(logits, h, x0, 2 ** 33, top1, 2.0)
    keep = [b for b in range(20) if b not in (1, 3, 7)]
    assert torch.equal(got[keep].long(), torch.argmax(logits[keep], -1))


def test_gumbel_argmax_kernel_negative_zero_ties(cuda):
    """Scores -0.0 (index 5) and +0.0 (index 9) tie; the first wins.
    Leaf tag 13 of family (7, 0xD0) draws u = 6171993 / 2^24 at counter
    24235, whose log is -1 exactly where logf rounds it so."""
    V, v0, v1 = 40, 5, 9
    x0, h_fam = engine.family_from_seed(7, 0xD0)
    h = engine.derive_leaf_host(h_fam, 13)
    ctr = 24235 - v0
    plan = engine.GenPlan(x0=x0, h=engine.leaf_limbs([h], cuda),
                          num_steps=V, ctr=ctr, sampler="gumbel")
    g = engine.generate(plan)[:, 0]
    logits = torch.full((1, V), -100.0, device=cuda)
    logits[0, v0] = -0.0
    logits[0, v1] = -g[v1]
    th = torch.full((1,), float("-inf"), device=cuda)
    got = _ga_check(logits, ga.leaf_words([h], cuda), x0, ctr, th, 1.0)
    if g[v0].item() == 0.0:
        assert got.tolist() == [v0]


def test_batcher_on_card_fused_equals_twopass(cuda):
    ga.reset_counts()
    tb.reset_counts()
    cfg = inference.ScheduleConfig(capacity=16, vocab=1000, sequences=24,
                                   rate=4.0, seed=5, top_k=50)
    rep = inference.run_offline(cfg, parity=True, device=cuda)
    j = rep.to_json()
    assert j["parity_digest"] == j["digest"] and j["calls_per_step"] == 1.0
    assert ga.fused_argmax.launches == j["decode_steps"]
    assert tb.thundering_ctr.launches > 0
    assert ga.fused_argmax_plain.cuda_runs == 0
    cpu = inference.run_offline(cfg, device="cpu")
    assert cpu.result.digest == j["digest"]


# ---------------------------------------------------------------------------
# the repaired faults, the sharded fan-out and the battery on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_dropout_subnormal_inputs_give_the_rerecorded_bytes(cuda,
                                                                  dtype):
    """The 24 re-recorded cases: bfloat16 / float32 subnormal inputs read
    as zeros of their sign; the non-NaN ones equal the plain version."""
    n = 0
    for key, (dt, name, rate, ctr) in digests.dropout_cases(
            ("special", "special+nan")):
        if dt != dtype:
            continue
        x = digests.dropout_input(dt, name, cuda)
        s = stream.advance(stream.new_stream(digests.SEED, 0, device=cuda),
                           ctr)
        y = fd.fused_dropout_2d(x, s.h, s.x0, s.ctr, rate)
        assert digests.digest(y) == digests.DROPOUT_RECORDED[key]
        if name == "special":
            want = fd.fused_dropout_2d(x.cpu(), s.h, s.x0, s.ctr, rate)
            assert torch.equal(y.cpu().view(torch.uint8),
                               want.view(torch.uint8))
        n += 1
    assert n == 12


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_fused_dropout_per_element_epilogue_on_special_inputs(cuda, dtype):
    """The special values, subnormals included, through the per-element
    epilogue (a misaligned view, a ragged last run) equal the plain
    version bit for bit."""
    view = torch.int32 if dtype == "float32" else torch.int16
    s = stream.advance(stream.new_stream(digests.SEED, 0, device=cuda), 3)
    for layout, x in digests.special_layouts(dtype, cuda):
        for rate in (0.1, 0.5):
            got = fd.fused_dropout_2d(x, s.h, s.x0, s.ctr, rate)
            want = fd.fused_dropout_2d_plain(x, s.h, s.x0, s.ctr, rate)
            assert torch.equal(got.view(view), want.view(view)), (layout,
                                                                  rate)


def test_stream_normal_card_within_slack_of_cpu(cuda):
    card = stream.normal(stream.new_stream(42, 0, device=cuda), (2 ** 20,))
    host = stream.normal(stream.new_stream(42, 0, device="cpu"), (2 ** 20,))
    assert float(sampler.ulp_error(card.cpu(), host).max()) <= 8.0


@pytest.mark.parametrize("mode,deco", [("ctr", "splitmix64"),
                                       ("ctr", "fmix32"),
                                       ("faithful", "splitmix64")])
@pytest.mark.parametrize("S", [130, 2 ** 14 + 1])
def test_generate_sharded_on_card_equals_generate(cuda, mode, deco, S):
    plan = engine.make_plan(seed=42, num_streams=S, num_steps=64,
                            offset=2 ** 32 + 12345, mode=mode, deco=deco,
                            device=cuda)
    want = engine.generate(plan)
    for shape, names in (((3,), ("streams",)), ((2, 2), ("hosts",
                                                         "streams"))):
        mesh = engine.Mesh.of([cuda] * int(np.prod(shape)), shape, names)
        got = engine.generate_sharded(plan, mesh=mesh, axis_names=names)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    split = engine.Mesh.of(["cpu", cuda], (2,), ("streams",))
    got = engine.generate_sharded(plan, mesh=split)
    assert got.device == torch.device("cpu")
    assert torch.equal(got.view(torch.int32), want.cpu().view(torch.int32))


def test_battery_cuda_rows_equal_their_torch_twins(cuda):
    from repro_torch.quality import battery
    rep = battery.run_battery("tiny", device=cuda)
    assert rep["ok"]
    rows = {g["name"]: g for g in rep["generators"]}
    for name, g in rows.items():
        if name.endswith("/cuda"):
            twin = rows[name[:-len("cuda")] + "torch"]
            assert (g["intra"], g["cross"]) == (twin["intra"], twin["cross"])


@pytest.mark.parametrize("top_k,inv_temp", [(0, 1.0), (3, 0.5), (40, 2.0)])
def test_gumbel_argmax_subnormal_logits_equal_plain(cuda, top_k, inv_temp):
    pats = np.array([0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF, 0x0,
                     0x80000000, 0x00800000, 0x80800000], np.uint32)
    bits = pats[np.random.default_rng(3).integers(0, len(pats), (16, 700))]
    logits = torch.from_numpy(bits.view(np.float32).copy()).to(cuda)
    x0, h_fam = engine.family_from_seed(9, 0xD0)
    h = ga.leaf_words([engine.derive_leaf_host(h_fam, t) for t in range(16)],
                      cuda)
    th = (torch.topk(logits, top_k, dim=-1).values[:, -1].contiguous()
          if top_k else torch.full((16,), float("-inf"), device=cuda))
    got = ga.fused_argmax(logits, h, x0, 977, th, inv_temp=inv_temp)
    want = ga.fused_argmax_plain(logits.cpu(), h.cpu(), x0, 977, th.cpu(),
                                 inv_temp=inv_temp)
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# the serving tier on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("donate", [False, True])
def test_pool_columns_equal_regenerate_on_card(cuda, donate):
    from repro_torch.service import (Journal, RandRequest, RandServer,
                                     ServerConfig)
    from repro_torch.service.server import pool_channel
    klass = ("uniform", "bfloat16")
    cfg = ServerConfig(max_batch=4, max_delay_s=0.0, hot_classes=(klass,),
                       pool_rows=64, pool_cols=8, pool_donate=donate)
    journal = Journal()
    srv = RandServer(5, config=cfg, journal=journal, start=False,
                     device=cuda)
    reqs = [RandRequest(tenant_id=f"t{i % 3}", shape=(30 + i,),
                        sampler=klass[0], out_dtype=klass[1], rid=f"p{i}")
            for i in range(40)]
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    out = {r.rid: f.result(timeout=120) for r, f in zip(reqs, futs)}
    assert srv.stats()["pool_requests"] == 40
    assert srv.shutdown(timeout=60)
    svc = BlockService(seed=5, device=cuda)
    ch = pool_channel(*klass)
    svc.open(ch, num_streams=8, sampler=klass[0], out_dtype=klass[1])
    for e in journal.requests():
        block = svc.regenerate(ch, e["lo"], e["rows"]).cpu()
        cols = block[:, e["tags"]].T.reshape(-1)[:out[e["rid"]].numel()]
        assert torch.equal(cols.view(torch.int16),
                           out[e["rid"]].view(torch.int16))


def test_server_burst_replays_bit_identically_on_card(cuda):
    from repro_torch.service import (Journal, RandServer, ServerConfig,
                                     replay, response_digest,
                                     verify_ledger_disjoint)
    from repro_torch.service.burst import make_requests
    tb.reset_counts()
    journal = Journal()
    srv = RandServer(0, config=ServerConfig(
        max_batch=64, max_delay_s=0.25,
        hot_classes=(("bits", "float32"), ("uniform", "float32"))),
        journal=journal, start=False, device=cuda)
    reqs = make_requests(burst=256, tenants=64, seed=0)
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    out = {r.rid: f.result(timeout=120) for r, f in zip(reqs, futs)}
    assert srv.shutdown(timeout=60)
    assert srv.stats()["pool_requests"] > 0
    assert response_digest(replay(journal, seed=0, device=cuda)) == \
        response_digest(out)
    verify_ledger_disjoint(journal)
    assert tb.thundering_ctr.launches > 0
    assert tb.thundering_ctr_plain.cuda_runs == 0


@pytest.mark.parametrize("version", [1, 2])
def test_bfloat16_responses_survive_the_wire_on_card(cuda, version):
    import socket
    from repro_torch.service import RandServer, ServerConfig, transport
    srv = RandServer(1, config=ServerConfig(max_batch=1), device=cuda)
    got = srv.request("t", (7, 9), sampler="normal", out_dtype="bfloat16")
    assert srv.shutdown(timeout=60)
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    a, b = socket.socketpair()
    try:
        transport.send_wire(a, {"ok": True, "array": got}, version=version)
        back = transport.reply_array(transport.recv_wire(b)[0])
    finally:
        a.close()
        b.close()
    assert back.dtype == torch.bfloat16 and tuple(back.shape) == (7, 9)
    assert torch.equal(back.view(torch.int16), got.view(torch.int16))


def _ordered_f32(t):
    i = t.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(2 ** 31) - i, i)


@pytest.mark.parametrize("arch", ["gemma_7b", "qwen15_32b"])
def test_serve_smoke_width_card_matches_cpu(cuda, arch):
    """The model at ``smoke_config`` width on the card against the same
    code on the CPU: init within 8 ULP, logits on equal weights within
    the CPU tests' port-against-reference tolerance (0.02)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import pipeline_for, smoke_config
    from repro_torch.models import registry
    from repro_torch.models.common import flatten, unflatten
    cfg = smoke_config(get_config(arch))
    m_cpu, m_card = registry.build(cfg, "cpu"), registry.build(cfg, cuda)
    p_cpu = flatten(m_cpu.init(0)[0])
    p_card = flatten(m_card.init(0)[0])
    for path, want in p_cpu.items():
        got = p_card[path].cpu()
        assert int((_ordered_f32(got) - _ordered_f32(want)).abs().max()) \
            <= 8, path
    toks = pipeline_for(cfg, 4, 16, 0, device="cpu").batch_at(0)["tokens"]
    want, _ = m_cpu.forward(unflatten(p_cpu), {"tokens": toks})
    same = unflatten({k: v.to(cuda) for k, v in p_cpu.items()})
    got, _ = m_card.forward(same, {"tokens": toks.to(cuda)})
    assert float((got.cpu() - want).abs().max()) <= 0.02
    cache = m_card.init_cache(4, 16)
    for pos in range(16):
        lg, cache = m_card.decode(same, cache, toks[:, pos:pos + 1].to(cuda),
                                  pos)
        assert float((lg.cpu() - want[:, pos]).abs().max()) <= 0.15 + \
            0.05 * float(want[:, pos].abs().max())


def test_chunked_init_on_card_equals_whole_draw(cuda):
    from repro_torch.models import common
    tb.reset_counts()
    s = common.param_stream(5, "layers/wi", cuda)
    whole = common.trunc_normal(s, (3, 1000, 7), 0.02)
    for chunk in (4097, 1 << 14):
        part = common.trunc_normal(s, (3, 1000, 7), 0.02, chunk=chunk)
        assert torch.equal(part.view(torch.int32), whole.view(torch.int32))
    assert tb.thundering_ctr.launches > 0
    assert tb.thundering_ctr_plain.cuda_runs == 0
    cpu = common.trunc_normal(common.param_stream(5, "layers/wi", "cpu"),
                              (3, 1000, 7), 0.02)
    assert int((_ordered_f32(whole.cpu()) - _ordered_f32(cpu)).abs().max()) \
        <= 8


def test_serve_on_card_fused_equals_twopass(cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.train import smoke_config
    cfg = smoke_config(get_config("glm4_9b"))
    ga.reset_counts()
    kw = dict(batch=4, prompt_len=8, gen=6, temperature=0.8, device=cuda)
    fused, stats = serve.serve(cfg, sampler_path="fused", **kw)
    assert ga.fused_argmax.launches == 6
    twopass, _ = serve.serve(cfg, sampler_path="cuda", **kw)
    assert np.array_equal(fused, twopass)
    assert stats["sampler_calls_per_step"] == 1.0
    assert ga.fused_argmax_plain.cuda_runs == 0


def test_train_on_card_is_deterministic_and_resumes(cuda, tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import smoke_config, train
    from repro_torch.models.common import flatten
    cfg = smoke_config(get_config("gemma_7b"))
    kw = dict(steps=4, global_batch=4, seq_len=64, save_every=2,
              log_every=1, device=cuda)
    tb.reset_counts()
    runs = [train(cfg, ckpt_dir=str(tmp_path / name), fail_at=fail, **kw)
            for name, fail in (("a", None), ("b", None), ("c", 3))]
    assert tb.thundering_ctr.launches > 0
    assert tb.thundering_ctr_plain.cuda_runs == 0
    (pa, oa, la), (pb, ob, lb), (pc, _, lc) = runs
    assert la == lb and dict(lc) == dict(la)
    for k, v in flatten(pa).items():
        for other in (pb, pc):
            assert torch.equal(v.view(torch.int32),
                               flatten(other)[k].view(torch.int32)), k
    assert int(oa.step) == int(ob.step) == 4


@pytest.mark.parametrize("clip_norm", [1e9, 1.0])
def test_adamw_on_card_equals_cpu(cuda, clip_norm):
    from repro_torch.optim import AdamWState, adamw_update, cosine_schedule
    rng = np.random.default_rng(2)
    shape = (1024, 768)
    host = {k: torch.from_numpy(rng.normal(0, s, shape).astype(np.float32))
            for k, s in (("p", 0.02), ("g", 1e-3), ("m", 1e-4), ("v", 1e-8))}
    out = []
    for dev in ("cpu", cuda):
        # copies: the update is in place, and .to("cpu") of a CPU tensor
        # is the tensor itself
        st = AdamWState(torch.tensor(2, dtype=torch.int32),
                        {"w": host["m"].to(dev, copy=True)},
                        {"w": host["v"].abs().to(dev)})
        p, st = adamw_update({"w": host["g"].to(dev)}, st,
                             {"w": host["p"].to(dev, copy=True)},
                             lr=cosine_schedule(3e-4, 100, 1000),
                             clip_norm=clip_norm)
        out.append([t["w"].cpu() for t in (p, st.m, st.v)])
    for a, b in zip(*out):
        d = (_ordered_f32(a) - _ordered_f32(b)).abs()
        if clip_norm > 1e8:          # no clipping: bit-equal
            assert int(d.max()) == 0
        else:                        # the norm's float32 sum order differs
            assert int(d.max()) <= 4
