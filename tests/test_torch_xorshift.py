"""The xorshift128 GF(2) jump in plain torch, and kernel B's tile states.

``repro_torch.core.xorshift.jump_tensor`` is the plain torch form of the
reference's ``jump_traced``; on the CPU it is what
``thundering_block.faithful_tile_states`` runs in place of the card's
jump kernels.  It must equal the reference's ``jump_traced`` and
``jump_batch`` on the same numpy states, with no tolerance.  The kernel
wrappers' CPU paths (the plain versions) must give the reference's
numpy golden blocks in faithful mode, and the integer stages of the
recorded card digests.
"""
import numpy as np
import pytest
import torch

from repro.core import golden as j_golden
from repro.core import xorshift as j_xorshift
from repro_torch.core import engine, u64, xorshift
from repro_torch.kernels import digests
from repro_torch.kernels import thundering_block as tb

CPU = torch.device("cpu")
COUNTS = [0, 1, 255, 256, 2 ** 32 + 12345, 2 ** 63 + 1]
CTRS = [0, 12345, 2 ** 32 + 12345, 2 ** 63 + 1]


def _states(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=(n, 4), dtype=np.uint64
                        ).astype(np.uint32)


def _np(t: torch.Tensor) -> np.ndarray:
    return u64.limbs(t).numpy().astype(np.uint32)


@pytest.mark.parametrize("n", COUNTS)
def test_jump_tensor_matches_reference_jumps(n):
    states = _states(7, seed=n % 97)
    hi, lo = u64.split64(n)
    got = _np(xorshift.jump_tensor(u64.limbs(torch.from_numpy(
        states.view(np.int32))), hi, lo))
    traced = np.asarray(j_xorshift.jump_traced(
        states, np.uint32(hi), np.uint32(lo)))
    assert np.array_equal(got, traced)
    assert np.array_equal(got, j_xorshift.jump_batch(states, n))


def test_jump_tensor_takes_one_count_per_state():
    states = _states(len(COUNTS), seed=5)
    his, los = zip(*(u64.split64(n) for n in COUNTS))
    got = _np(xorshift.jump_tensor(
        u64.limbs(torch.from_numpy(states.view(np.int32))),
        torch.tensor(his), torch.tensor(los)))
    traced = np.asarray(j_xorshift.jump_traced(
        states, np.array(his, np.uint32), np.array(los, np.uint32)))
    assert np.array_equal(got, traced)
    for i, n in enumerate(COUNTS):
        assert np.array_equal(got[i], j_xorshift.jump_batch(states[i:i + 1],
                                                            n)[0])


def _matvec_nibbles(table, states):
    """One matvec of (S, 4) states by a (32, 16, 4) nibble table, as the
    card's tb_gf2_matvec does it: 32 lookups and their XOR."""
    out = np.zeros_like(states)
    for p in range(32):
        out ^= table[p][(states[:, p // 8] >> np.uint32(4 * (p % 8))) & 15]
    return out


def test_nibble_tables_match_packed_rows():
    """The card's jump reads M**(2**k) as nibble tables; the same matvec
    as the packed rows the reference's jumps use."""
    tables = xorshift._pow2_nibble_tables(64)
    rows = j_xorshift._packed_pow2_matrices(64)
    states = _states(33, seed=3)
    for k in (0, 1, 8, 31, 32, 63):
        assert np.array_equal(_matvec_nibbles(tables[k], states),
                              j_xorshift._matvec_batch(rows[k], states))


def test_states_at_matches_jump_batch():
    tbl = xorshift.lane_table(9)
    offsets = [0, 0, 3, 256, 2 ** 33]
    got = xorshift.states_at(tbl, offsets)
    for i, off in enumerate(offsets):
        assert np.array_equal(got[i], xorshift.jump_batch(tbl, off).T)


def test_lane_states_is_the_lane_table():
    lanes = tb.lane_states(37, CPU)
    assert tuple(lanes.shape) == (4, 37) and lanes.dtype == torch.int64
    assert np.array_equal(_np(lanes).T, j_xorshift.lane_table(37))


@pytest.mark.parametrize("ctr", CTRS)
def test_tile_states_plain_jump_matches_host_jump(ctr):
    S, T, bt = 37, 200, 16
    plan = engine.make_plan(seed=1, num_streams=S, num_steps=T, offset=ctr,
                            mode="faithful", device=CPU)
    n_tiles = -(-T // bt)
    got = tb.faithful_tile_states(tb.lane_states(S, CPU), plan.ctr, bt,
                                  n_tiles)
    assert tuple(got.shape) == (n_tiles, 4, S)
    assert np.array_equal(_np(got), engine._faithful_tile_states(
        plan, bt, n_tiles))


@pytest.mark.parametrize("ctr", CTRS)
def test_faithful_wrapper_plain_path_matches_golden(ctr):
    S, T = 5, 37
    plan = engine.make_plan(seed=4, num_streams=S, num_steps=T, offset=ctr,
                            mode="faithful", device=CPU)
    got = engine.generate(plan, backend="cuda", block_t=8)
    h = np.array([u64.join64(a, b) for a, b in zip(plan.h[0].tolist(),
                                                   plan.h[1].tolist())],
                 np.uint64)
    want = j_golden.thundering_block(plan.x0, h, T, mode="faithful",
                                     offset=ctr).T
    assert np.array_equal(got.numpy(), want)


def test_faithful_wrapper_checks_lanes():
    plan = engine.make_plan(seed=4, num_streams=5, num_steps=8, device=CPU)
    with pytest.raises(ValueError, match="lanes must be"):
        tb.thundering_faithful(plan.x0, 0, 8, plan.h, tb.lane_states(4, CPU),
                               block_t=8)


def test_recorded_digests_of_exact_stages_match_plain_versions():
    """The integer and threshold stages of the plain versions give the
    card's recorded bytes (the log / trig stages differ by ULPs)."""
    got = digests.compute(CPU, shapes=digests.SHAPES[:1], exact_only=True)
    assert len(got) == 33
    assert digests.mismatches(got) == []
