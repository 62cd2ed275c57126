"""Kernel F's launch plan on the CPU: the grid the wrapper gives the card.

Kernel F (``csrc/gumbel_argmax.cu``) runs one cluster of ``cluster``
blocks of ``threads`` threads per row.  Thread t of block k owns v = k *
threads + t + s * G for s = 0, 1, ... (G = cluster * threads); thread 0 of
block k jumps from x0 to the root x_{ctr + k*threads + 1}, thread t applies
row t of ``affine_table(threads)``, and every grid-stride step applies the
plan's (jump_a, jump_c).  The numpy mirror here walks that arithmetic
(uint64, wrapping as the card's does) and holds it against
``lcg.advance`` and ``engine.root_and_ctr_rows``, which the plain version
reads.
"""
import numpy as np
import pytest

from repro_torch.core import engine, lcg
from repro_torch.core.u64 import M64
from repro_torch.inference.kernels import gumbel_argmax as ga


def _occupancy(regs: int, sms: int = 132):
    """Resident clusters per (threads, cluster) of a card with ``sms`` SMs
    and a kernel of ``regs`` registers a thread."""
    out = {}
    for threads in ga.BLOCK_THREADS:
        per_sm = min(2048 // threads, 65536 // (regs * threads))
        for c in range(1, ga.CLUSTER_MOST + 1):
            out[threads, c] = sms * per_sm // c
    return out


OCCUPANCIES = {"32 registers": _occupancy(32), "48 registers":
               _occupancy(48), "72 registers": _occupancy(72)}
SHAPES = [(256000, 64), (256000, 256), (256000, 8), (256000, 1),
          (50304, 64), (50304, 65), (49155, 64), (32000, 64), (1000, 130),
          (300, 20), (64, 8), (1000, 65535)]


def _owners(V: int, cluster: int, threads: int) -> np.ndarray:
    """(V,) count of the (chunk, thread, step) triples owning each v."""
    G = cluster * threads
    count = np.zeros(V, np.int64)
    for k in range(cluster):
        first = k * threads + np.arange(threads)
        for t0 in first[first < V]:
            count[np.arange(t0, V, G)] += 1
    return count


def _kernel_roots(x0: int, ctr: int, V: int, plan) -> np.ndarray:
    """(V,) uint64 roots as kernel F forms them under ``plan``."""
    c, threads = plan.cluster, plan.threads
    G = c * threads
    table = ga.affine_table(threads)
    roots = np.zeros(V, np.uint64)
    with np.errstate(over="ignore"):
        for k in range(c):
            base = np.uint64(lcg.advance(x0, (ctr + k * threads + 1) & M64))
            t = np.arange(threads)
            v = k * threads + t
            cur = table[:, 0] * base + table[:, 1]
            while True:
                live = v < V
                if not live.any():
                    break
                roots[v[live]] = cur[live]
                v = v + G
                cur = np.uint64(plan.jump_a) * cur + np.uint64(plan.jump_c)
    return roots


@pytest.mark.parametrize("occ", sorted(OCCUPANCIES))
@pytest.mark.parametrize("V,B", SHAPES)
def test_every_entry_is_owned_once(V, B, occ):
    plan = ga.launch_plan(B, V, OCCUPANCIES[occ])
    assert 1 <= plan.cluster <= ga.CLUSTER_MOST
    assert plan.threads in ga.BLOCK_THREADS
    assert (plan.cluster - 1) * plan.threads < V     # no block without a v
    assert (_owners(V, plan.cluster, plan.threads) == 1).all()
    assert (plan.jump_a, plan.jump_c) == lcg.lcg_skip(plan.cluster
                                                      * plan.threads)


@pytest.mark.parametrize("occ", sorted(OCCUPANCIES))
@pytest.mark.parametrize("V,B", SHAPES)
def test_plan_fills_one_wave_as_far_as_it_can(V, B, occ):
    table = OCCUPANCIES[occ]
    plan = ga.launch_plan(B, V, table)
    fits = {(t, c) for (t, c), n in table.items()
            if n >= B and (c - 1) * t < V}
    if fits:
        assert table[plan.threads, plan.cluster] >= B
        useful = min(plan.cluster * plan.threads, V)
        assert useful == max(min(t * c, V) for t, c in fits)
    else:
        assert plan.cluster * plan.threads == min(ga.BLOCK_THREADS)


@pytest.mark.parametrize("most", [1, 8, 16])
def test_plan_takes_no_cluster_the_card_cannot_hold(most):
    """Sizes the card holds no cluster of (a count of 0, or no count:
    non-portable sizes on a card that refuses them) are never chosen."""
    table = {k: n for k, n in _occupancy(32).items() if k[1] <= most}
    plan = ga.launch_plan(8, 256000, table)
    assert plan.cluster == most and plan.threads == 1024
    table[1024, most] = 0
    assert ga.launch_plan(8, 256000, table)[:2] != (most, 1024)


def test_plan_raises_when_no_cluster_fits():
    empty = {(t, c): 0 for t in ga.BLOCK_THREADS
             for c in range(1, ga.CLUSTER_MOST + 1)}
    with pytest.raises(RuntimeError, match="no cluster"):
        ga.launch_plan(64, 50304, empty)


@pytest.mark.parametrize("threads", ga.BLOCK_THREADS)
def test_affine_table_is_the_in_block_jump(threads):
    table = ga.affine_table(threads)
    assert table.shape == (threads, 2) and table.dtype == np.uint64
    for t in (0, 1, 2, 31, 255, threads - 1):
        assert tuple(int(x) for x in table[t]) == lcg.lcg_skip(t)


@pytest.mark.parametrize("ctr", [977, 2 ** 32 + 12345, None])
@pytest.mark.parametrize("V,B,occ", [(50304, 64, "48 registers"),
                                     (4999, 8, "32 registers"),
                                     (1000, 130, "72 registers"),
                                     (64, 8, "48 registers")])
def test_block_jump_and_affine_table_give_every_root(V, B, occ, ctr):
    """The block jump composed with ``block_affine_constants(threads)`` and
    the grid stride gives x_{ctr + v + 1} for every v, also for a window
    that ends where the counter wraps (ctr = 2**64 - V)."""
    ctr = 2 ** 64 - V if ctr is None else ctr
    x0, _ = engine.family_from_seed(9, 0xD0)
    plan = ga.launch_plan(B, V, OCCUPANCIES[occ])
    got = _kernel_roots(x0, ctr, V, plan)
    (hi, lo), _ = engine.root_and_ctr_rows(x0, ctr, V)
    want = (hi.numpy().astype(np.uint64) << np.uint64(32)) | \
        lo.numpy().astype(np.uint64)
    assert np.array_equal(got, want)
    for v in (0, 1, plan.threads - 1, plan.threads, V // 2, V - 1):
        if v < V:
            assert int(got[v]) == lcg.advance(x0, (ctr + v + 1) & M64)


def test_launch_arguments_pack_as_the_kernel_reads_them():
    """ga_launch reads one 160-byte block of 8-byte fields (``GaArgs``);
    full-range u64 states and counters pack without loss."""
    assert ga._LAUNCH_ARGS.size == 160
    fields = ga._LAUNCH_ARGS.unpack(ga._LAUNCH_ARGS.pack(
        1 << 40, 50304, 1, 64, 50304, 2, 3, M64, 2 ** 64 - 50304, 1.25, 1,
        1024, 2, 4, M64 - 1, 5, 6, 0, 0, 7))
    assert fields[7] == M64 and fields[8] == 2 ** 64 - 50304
    assert fields[9] == 1.25 and fields[17] == 0
