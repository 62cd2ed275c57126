"""Kernel tests that need a CUDA card (marker ``gpu``).

Run on a machine with a card:  PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py.  Without a card every test here skips; whether a
card is present is decided inside the ``cuda`` fixture, so every worker
collects the same tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine, golden, sampler, stream, u64
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
