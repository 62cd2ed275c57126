"""The port's fused dropout (``kernels/fused_dropout.py``,
``ops.fused_dropout``) against the reference, bit for bit.

Inputs come from a numpy seed; the reference's Pallas kernel runs in
interpret mode on JAX's CPU backend and the port's wrapper runs its plain
version on the CPU.  Masks and outputs must be equal in every bit, in
float32 and bfloat16 (a bfloat16 product of x and the bfloat16 scale is
exact in float32, so both round it once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stream as j_stream
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.runtime import blocks as j_blocks
from repro_torch.core import stream as t_stream
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
