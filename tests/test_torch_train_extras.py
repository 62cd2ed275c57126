"""``launch.train.train`` with a batch's extra inputs - whisper-small's
``frames`` and the vlm's ``patches``, fed through ``LeasedBatchFeeder``
by the ``BlockService`` delivery layer - against the reference's
``train`` on the CPU: the logged losses within ``LOSS_ATOL`` = 0.02
(``tests/test_torch_train.py``)."""
from __future__ import annotations

import pytest

from repro.launch import train as j_train
from repro_torch.launch import train as t_train

from test_torch_train import (LOSS_ATOL, TRAIN_KW, _cfgs,  # noqa: F401
                              one_torch_thread)

# a vlm's sequence must hold its patch prefix: 8 patch positions at the
# smoke width (smoke_config keeps the published 1024)
OVER = {"qwen2_vl_72b": dict(vision_prefix=8)}


@pytest.mark.parametrize("arch", ["whisper_small", "qwen2_vl_72b"])
def test_train_losses_with_extras_match_reference(arch, tmp_path):
    jc, tc = _cfgs(arch, **OVER.get(arch, {}))
    _, _, jl = j_train.train(jc, ckpt_dir=str(tmp_path / "ref"), **TRAIN_KW)
    _, _, tl = t_train.train(tc, ckpt_dir=str(tmp_path / "port"),
                             device="cpu", **TRAIN_KW)
    assert [s for s, _ in tl] == [s for s, _ in jl] == [0, 1, 2, 3]
    assert max(abs(a - b) for (_, a), (_, b) in zip(tl, jl)) <= LOSS_ATOL
