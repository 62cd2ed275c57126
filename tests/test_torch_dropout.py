"""The port's fused dropout (``kernels/fused_dropout.py``,
``ops.fused_dropout``) against the reference, bit for bit.

Inputs come from a numpy seed; the reference's Pallas kernel runs in
interpret mode on JAX's CPU backend and the port's wrapper runs its plain
version on the CPU.  Masks and outputs must be equal in every bit, in
float32 and bfloat16 (a bfloat16 product of x and the bfloat16 scale is
exact in float32, so both round it once).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stream as j_stream
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.runtime import blocks as j_blocks
from repro_torch.core import stream as t_stream
from repro_torch.kernels import digests
from repro_torch.kernels import fused_dropout as t_fd
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.runtime.blocks import BlockService

CPU = "cpu"
# Each rate runs at its own counter offset: from 0, across 2^32, past 2^32.
OFFSETS = {0.1: 0, 0.5: 2 ** 32 - 1000, 1e-9: 2 ** 32 + 12345}
DTYPES = {"float32": (torch.float32, jnp.float32, np.int32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, np.int16),
          "float16": (torch.float16, jnp.float16, np.int16)}


def _x(shape, dtype, seed=0):
    """(torch, jax) copies of one seeded normal array, rounded once."""
    t_dt, j_dt, _ = DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(t_dt), jnp.asarray(x, j_dt)


def _bits(a, dtype):
    """The bit pattern of a torch or jax array as a numpy int array."""
    view = DTYPES[dtype][2]
    if isinstance(a, torch.Tensor):
        return a.view({np.int32: torch.int32, np.int16: torch.int16}[view]) \
            .numpy()
    return np.asarray(a).view(view)


def _streams(seed, offset):
    js = j_stream.advance(j_stream.new_stream(seed, 0), offset)
    ts = t_stream.advance(t_stream.new_stream(seed, 0, device=CPU), offset)
    return js, ts


@pytest.mark.parametrize("rate", sorted(OFFSETS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 128), (16, 256), (4, 8, 128),
                                   (3, 1001)])
def test_fused_dropout_matches_reference(shape, dtype, rate):
    js, ts = _streams(31, OFFSETS[rate])
    tx, jx = _x(shape, dtype)
    want = j_ops.fused_dropout(jx, js, rate)
    got = t_ops.fused_dropout(tx, ts, rate)
    assert got.shape == tx.shape and got.dtype == tx.dtype
    assert np.array_equal(_bits(got, dtype), _bits(want, dtype))
    assert torch.equal(t_ops.fused_dropout(tx, ts, rate, use_kernel=False),
                       got)


def test_fused_dropout_float16_matches_reference():
    js, ts = _streams(32, 2 ** 32 - 7)
    tx, jx = _x((8, 128), "float16")
    want = j_ops.fused_dropout(jx, js, 0.3, use_kernel=False)
    got = t_ops.fused_dropout(tx, ts, 0.3)
    assert np.array_equal(_bits(got, "float16"), _bits(want, "float16"))


def test_mask_bits_match_reference():
    js, ts = _streams(33, 2 ** 32 - 50)
    want = j_ref.dropout_mask_bits((js.h_hi, js.h_lo), (js.x0_hi, js.x0_lo),
                                   (js.ctr_hi, js.ctr_lo), 100)
    got = t_ref.dropout_mask_bits(ts.h, ts.x0, ts.ctr, 100)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_rate_is_identity(dtype):
    _, ts = _streams(39, 0)
    tx, _ = _x((8, 128), dtype)
    assert t_ops.fused_dropout(tx, ts, 0.0) is tx
    assert t_fd.fused_dropout_2d(tx, ts.h, ts.x0, ts.ctr, -0.5) is tx


def test_mask_is_stream_bits_below_threshold():
    _, ts = _streams(35, 2 ** 32 - 300)
    x = torch.ones((5, 123))
    rate = 0.3
    y = t_ops.fused_dropout(x, ts, rate)
    bits = t_stream.random_bits(ts, (5 * 123,)).to(torch.int64)
    keep = (bits < t_fd.keep_threshold(rate)).reshape(x.shape)
    assert torch.equal(y != 0, keep)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    assert torch.equal(y[keep], (x * scale)[keep])


def test_counter_advance_shifts_mask_by_rows():
    _, ts = _streams(37, 0)
    tx, _ = _x((16, 128), "float32")
    a = t_ops.fused_dropout(tx, ts, 0.4)
    b = t_ops.fused_dropout(tx[8:], t_stream.advance(ts, 8 * 128), 0.4)
    assert torch.equal(a[8:], b)


def test_block_m_does_not_change_result():
    _, ts = _streams(41, 5)
    tx, _ = _x((32, 128), "bfloat16")
    outs = [t_ops.fused_dropout(tx, ts, 0.3, block_m=m) for m in (1, 8, 16)]
    for o in outs[1:]:
        assert torch.equal(o.view(torch.int16), outs[0].view(torch.int16))


def test_lease_form_matches_reference():
    shape = (4, 8, 128)
    tx, jx = _x(shape, "float32", seed=3)
    js = j_blocks.BlockService(seed=5)
    js.open("train/dropout")
    ts = BlockService(seed=5, device=CPU)
    ts.open("train/dropout")
    n = t_fd.mask_elems(shape)
    assert n == 4 * 8 * 128
    js.lease("train/dropout", 7).commit()
    ts.lease("train/dropout", 7).commit()
    want = j_ops.fused_dropout(jx, js.lease("train/dropout", n), 0.25)
    got = t_ops.fused_dropout(tx, ts.lease("train/dropout", n), 0.25)
    assert np.array_equal(_bits(got, "float32"), _bits(want, "float32"))
    with pytest.raises(ValueError, match="smaller than"):
        t_ops.fused_dropout(tx, ts.lease("train/dropout", n - 1), 0.25)


def test_bad_inputs_raise():
    _, ts = _streams(43, 0)
    with pytest.raises(ValueError, match="fused dropout takes"):
        t_fd.fused_dropout_2d(torch.ones((2, 4), dtype=torch.float64), ts.h,
                              ts.x0, ts.ctr, 0.5)
    with pytest.raises(ValueError, match="2-D"):
        t_fd.fused_dropout_2d(torch.ones(8), ts.h, ts.x0, ts.ctr, 0.5)
    with pytest.raises(ValueError, match="out must be"):
        t_fd.fused_dropout_2d(torch.ones((2, 4)), ts.h, ts.x0, ts.ctr, 0.5,
                              out=torch.empty((4, 2)))


def test_out_is_written_in_place():
    _, ts = _streams(45, 0)
    x = torch.ones((4, 64))
    out = torch.empty_like(x)
    y = t_fd.fused_dropout_2d(x, ts.h, ts.x0, ts.ctr, 0.5, out=out)
    assert y is out
    assert torch.equal(out, t_fd.fused_dropout_2d(x, ts.h, ts.x0, ts.ctr,
                                                  0.5))


def test_keep_threshold_and_mask_elems():
    assert t_fd.keep_threshold(0.5) == 2 ** 31
    assert t_fd.keep_threshold(1e-12) == 2 ** 32 - 1
    assert t_fd.mask_elems(()) == 1
    assert t_fd.mask_elems((3, 1001)) == 3003


# Kernel C's recorded bytes (digests.DROPOUT_RECORDED): the plain version's
# arithmetic is integer work plus one rounding, so on the CPU it writes
# the card's bytes for every input without NaN (torch-CPU's NaN pattern is
# not the card's).  The cases run grouped by (input, counter), so that the
# mask bits of one (counter, size) - a pure function, and most of the
# plain version's time at (4096, 3072) - are computed once for the three
# dtypes and rates that use them.
NO_NAN_CASES = sorted(
    digests.dropout_cases([name for name in digests.DROPOUT_INPUTS
                           if not name.endswith("nan")]),
    key=lambda kc: (kc[1][1], kc[1][3], kc[1][0], kc[1][2]))


@functools.lru_cache(maxsize=1)
def _dropout_input(dtype, name):
    return digests.dropout_input(dtype, name, CPU)


_mask_bits = functools.lru_cache(maxsize=1)(t_ref.dropout_mask_bits)


@pytest.mark.parametrize("key,case", NO_NAN_CASES,
                         ids=[k.replace(" ", "-") for k, _ in NO_NAN_CASES])
def test_plain_version_reproduces_recorded_digests(key, case, monkeypatch):
    monkeypatch.setattr(t_ref, "dropout_mask_bits", _mask_bits)
    dtype, name, rate, ctr = case
    x = _dropout_input(dtype, name)
    s = t_stream.advance(t_stream.new_stream(digests.SEED, 0, device=CPU),
                         ctr)
    got = t_fd.fused_dropout_2d(x, s.h, s.x0, s.ctr, rate)
    assert digests.digest(got) == digests.DROPOUT_RECORDED[key]


def test_recorded_dropout_cases_are_complete():
    keys = {k for k, _ in digests.dropout_cases()}
    assert keys == set(digests.DROPOUT_RECORDED)
    assert len(keys) == 3 * 3 * 2 * len(digests.DROPOUT_INPUTS)


# Bit patterns of the special values per dtype: +-0, +-inf, the smallest
# and the largest subnormal, the largest finite value; then NaNs (quiet,
# negative, with a payload).
SPECIAL_BITS = {
    "float32": ([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x00000001,
                 0x80000001, 0x007FFFFF, 0x807FFFFF, 0x7F7FFFFF, 0xFF7FFFFF],
                [0x7FC00000, 0xFFC00000, 0x7FC01234, 0x7F800001]),
    "bfloat16": ([0x0000, 0x8000, 0x7F80, 0xFF80, 0x0001, 0x8001, 0x007F,
                  0x807F, 0x7F7F, 0xFF7F], [0x7FC0, 0xFFC0, 0x7FC5, 0x7F81]),
    "float16": ([0x0000, 0x8000, 0x7C00, 0xFC00, 0x0001, 0x8001, 0x03FF,
                 0x83FF, 0x7BFF, 0xFBFF], [0x7E00, 0xFE00, 0x7E05, 0x7C01]),
}


def _special_x(dtype, seed=7):
    """(torch, jax) copies of a seeded normal (16, 256) array holding every
    special value of SPECIAL_BITS 16 times at seeded places."""
    t_dt, j_dt, view = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    normal = rng.standard_normal((16, 256)).astype(np.float32)
    bits = _bits(torch.from_numpy(normal).to(t_dt), dtype).reshape(-1)
    values, nans = SPECIAL_BITS[dtype]
    specials = np.array(values + nans, np.uint32).astype(view)
    where = rng.permutation(bits.size)[:16 * specials.size]
    bits[where] = np.repeat(specials, 16)
    bits = bits.reshape(16, 256)
    tx = torch.from_numpy(bits.copy()).view(t_dt)
    jx = jnp.asarray(bits).view(j_dt)
    return tx, jx


@pytest.mark.parametrize("rate", sorted(OFFSETS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_special_values_match_reference(dtype, rate):
    """The port's plain dropout against the reference's oracle
    (``repro.kernels.ref.fused_dropout``) at +-0, +-inf, subnormals, the
    largest finite value and NaN.

    Equal in every bit except where IEEE 754 leaves the result open: at
    NaN only the positions are compared.  IEEE 754 does not fix the sign
    and payload of a NaN result, and each framework rounds a NaN product
    to bfloat16 / float16 its own way (torch-CPU writes 0x7FC0 for every
    bfloat16 NaN, XLA keeps the sign and payload, the card writes
    0x7FFF); the card's pattern is held by the recorded digests.

    Subnormal inputs are compared in every bit as well: in bfloat16 and
    float32 the reference treats them as zero (a zero of x's sign), in
    float16 they widen to float32 normals.  At rate 0.5 the scale is 2, so
    twice the largest subnormal is normal: a flush of the output alone
    would differ there, and kept subnormals must occur in every case.
    """
    t_dt, j_dt, view = DTYPES[dtype]
    js, ts = _streams(47, OFFSETS[rate])
    tx, jx = _special_x(dtype)
    want = j_ref.fused_dropout(jx, (js.h_hi, js.h_lo), (js.x0_hi, js.x0_lo),
                               (js.ctr_hi, js.ctr_lo), rate)
    got = t_fd.fused_dropout_2d_plain(tx, ts.h, ts.x0, ts.ctr, rate)
    want_bits, got_bits = _bits(want, dtype), _bits(got, dtype)
    nan = np.isnan(np.asarray(want, np.float32))
    assert np.array_equal(torch.isnan(got).numpy(), nan)
    assert np.array_equal(got_bits[~nan], want_bits[~nan])
    x = tx.to(torch.float64)
    subnormal = ((x != 0) & (x.abs() < torch.finfo(t_dt).tiny)).numpy()
    assert subnormal.sum() == 16 * 4
    keep = (t_fd.fused_dropout_2d_plain(torch.ones_like(tx), ts.h, ts.x0,
                                        ts.ctr, rate) != 0).numpy()
    assert (subnormal & keep).any()
