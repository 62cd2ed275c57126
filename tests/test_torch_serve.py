"""The port's serving path (data pipeline, launch/{train,steps,serve})
against the reference's, on the CPU.

Batches and token picks are bit-exact: the pipeline's uniform stage and
the Zipf lookup are integer-exact, its patches pass the normal stage in
float32 (within 2 ULP of the reference, C1) and round to bf16, and the
sampler is bit-exact given equal logits.  ``serve`` end to end is held
teacher-forced: the port's decode reads the reference's token history,
so each of its picks is compared with the reference's at the same step;
the logits differ only by summation order (``tests/test_torch_models.py``,
at most 0.02).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import pipeline as j_pipeline
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro.runtime import blocks as j_blocks
from repro_torch.configs import get_config as t_get_config
from repro_torch.data import pipeline as t_pipeline
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import registry as t_registry
from repro_torch.runtime import blocks as t_blocks

CPU = "cpu"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.to(torch.float32) if x.dtype == torch.bfloat16
                else x).numpy()
    return np.asarray(x, np.float32) if x.dtype.name == "bfloat16" \
        else np.asarray(x)


def _batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = _np(got[k]), _np(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def test_smoke_config_and_overrides_equal_reference():
    import dataclasses
    assert t_train.SMOKE_OVERRIDES == j_train.SMOKE_OVERRIDES
    for arch in ("gemma_7b", "qwen2_vl_72b", "granite_moe_3b", "zamba2_7b",
                 "whisper_small", "mamba2_2p7b"):
        assert dataclasses.asdict(t_train.smoke_config(
            t_get_config(arch))) == dataclasses.asdict(
            j_train.smoke_config(j_get_config(arch))), arch


@pytest.mark.parametrize("arch,step", [("glm4_9b", 0), ("glm4_9b", 7),
                                       ("qwen2_vl_72b", 3)])
def test_pipeline_batches_equal_reference(arch, step):
    t_cfg = t_train.smoke_config(t_get_config(arch)).scaled(vision_prefix=8)
    j_cfg = j_train.smoke_config(j_get_config(arch)).scaled(vision_prefix=8)
    got = t_train.pipeline_for(t_cfg, 4, 16, 5, device=CPU).batch_at(step)
    want = j_train.pipeline_for(j_cfg, 4, 16, 5).batch_at(step)
    _batches_equal(got, want)
    assert got["tokens"].dtype == torch.int32
    assert ("patches" in got) == (arch == "qwen2_vl_72b")


def test_pipeline_zipf_tail_and_iteration():
    pipe = t_pipeline.SyntheticLMPipeline(1, 50000, 8, 64, device=CPU)
    ref = j_pipeline.SyntheticLMPipeline(1, 50000, 8, 64)
    it, jit_ = iter(pipe), iter(ref)
    for _ in range(2):
        _batches_equal(next(it), next(jit_))
    toks = pipe.batch_at(3)["tokens"]
    assert int(toks.min()) >= 0 and int(toks.max()) < 50000


def test_leased_feeder_batches_equal_reference():
    t_pipe = t_pipeline.SyntheticLMPipeline(3, 512, 2, 8, device=CPU)
    j_pipe = j_pipeline.SyntheticLMPipeline(3, 512, 2, 8)
    t_svc = t_blocks.BlockService(seed=3, device=CPU)
    j_svc = j_blocks.BlockService(seed=3)
    t_feed = t_pipeline.LeasedBatchFeeder(t_pipe, t_svc, depth=2)
    j_feed = j_pipeline.LeasedBatchFeeder(j_pipe, j_svc, depth=2)
    try:
        for step in range(3):
            got, want = t_feed.batch_for(step), j_feed.batch_for(step)
            _batches_equal(got, want)
            _batches_equal(got, t_pipe.batch_at(step))
        snap = t_svc.ledger_state()
        assert snap["channels"]["data/batches"]["committed"] == [[0, 3]]
        # a step out of order repositions the producer onto fresh windows
        _batches_equal(t_feed.batch_for(5), j_feed.batch_for(5))
    finally:
        t_feed.reset()
        j_feed.reset()
    with pytest.raises(ValueError, match="single steps"):
        t_feed._window(0, 2)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("path", ["fused", "torch"])
def test_token_picker_equal_reference_on_equal_logits(temperature, path):
    B, V = 3, 300
    t_pick = t_serve.TokenPicker(seed=4, batch=B, vocab=V,
                                 temperature=temperature, path=path,
                                 device=CPU)
    j_pick = j_serve.TokenPicker(seed=4, batch=B, vocab=V,
                                 temperature=temperature, path="xla")
    rng = np.random.default_rng(9)
    for step in range(4):
        logits = rng.normal(0, 2, (B, V)).astype(np.float32)
        got = t_pick.pick(step, torch.from_numpy(logits))
        want = np.asarray(j_pick.pick(step, logits))
        assert got.dtype == torch.int32 and tuple(got.shape) == (B, 1)
        assert np.array_equal(got.numpy(), want), step
    assert (t_pick.sampler is None) == (temperature == 0.0)
    if t_pick.sampler is not None:
        assert t_pick.sampler.stats()["calls_per_step"] == 1.0


# smoke width keeps the vlm's 1024-position patch prefix, and a prompt
# shorter than the prefix is refused: scale it to the 8-token prompt
SERVE_OVERRIDES = {"qwen2_vl_72b": dict(vision_prefix=8)}


@pytest.mark.parametrize("arch,temperature", [
    ("glm4_9b", 0.8), ("gemma_7b", 0.0), ("olmoe_1b_7b", 0.8),
    ("granite_moe_3b", 0.0), ("mamba2_2p7b", 0.8), ("zamba2_7b", 0.0),
    ("whisper_small", 0.8), ("qwen2_vl_72b", 0.8)])
def test_serve_teacher_forced_on_reference_tokens(arch, temperature,
                                                  monkeypatch):
    """The reference serves B=2 prompts for 6 tokens; the port serves the
    same config, its decode fed the reference's tokens, and each of its
    picks equals the reference's.  The vlm's patches flow through
    prefill, graft and decode."""
    kw = dict(batch=2, prompt_len=8, gen=6, seed=1, temperature=temperature)
    over = SERVE_OVERRIDES.get(arch, {})
    want, _ = j_serve.serve(
        j_train.smoke_config(j_get_config(arch)).scaled(**over),
        sampler_path="xla", **kw)
    picks = []
    real_pick = t_serve.TokenPicker.pick

    def forced(self, step, logits):
        picks.append(real_pick(self, step, logits).numpy()[:, 0])
        return torch.from_numpy(want[:, step:step + 1].astype(np.int32))

    monkeypatch.setattr(t_serve.TokenPicker, "pick", forced)
    got, stats = t_serve.serve(
        t_train.smoke_config(t_get_config(arch)).scaled(**over), device=CPU,
        **kw)
    assert np.array_equal(np.stack(picks, 1), want)
    assert np.array_equal(got, want)
    assert got.shape == (2, 6) and stats["decode_tok_s"] > 0
    assert ("sampler_calls_per_step" in stats) == (temperature > 0)


def test_serve_is_deterministic_and_cli_prints_its_digest(capsys):
    cfg = t_train.smoke_config(t_get_config("glm4_9b"))
    kw = dict(batch=2, prompt_len=4, gen=5, temperature=0.8, device=CPU)
    a, stats = t_serve.serve(cfg, **kw)
    b, _ = t_serve.serve(cfg, **kw)
    assert np.array_equal(a, b) and a.dtype == np.int32
    assert stats["sampler_calls_per_step"] == 1.0
    t_serve.main(["--device", "cpu", "--arch", "glm4_9b", "--smoke",
                  "--batch", "2", "--prompt-len", "4", "--gen", "5",
                  "--temperature", "0.8"])
    out = capsys.readouterr().out
    assert "generated shape: (2, 5)" in out
    assert f"tokens sha256: {t_serve.tokens_digest(a)}" in out


def test_serve_fns_and_graft():
    cfg = t_train.smoke_config(t_get_config("qwen15_32b"))
    m = t_registry.build(cfg, device=CPU)
    prefill, decode = t_steps.make_serve_fns(m)
    params, _ = m.init(0)
    toks = torch.randint(0, cfg.vocab, (2, 4), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    logits, pcache = prefill(params, {"tokens": toks})
    cache = t_serve._graft(cfg, m.init_cache(2, 6), pcache, 4)
    assert cache[0].dtype == torch.float8_e4m3fn
    assert torch.equal(cache[0][:, :, :4].to(torch.float32),
                       pcache[0].to(torch.float8_e4m3fn).to(torch.float32))
    assert not cache[0][:, :, 4:].to(torch.float32).any()
    lg, cache2 = decode(params, cache, toks[:, :1], 4)
    assert cache2[0] is cache[0] and lg.shape == (2, cfg.vocab)


def test_serve_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_train.smoke_config(t_get_config("glm4_9b"))
    for call in (lambda: t_serve.serve(cfg, batch=1, prompt_len=2, gen=2),
                 lambda: t_pipeline.SyntheticLMPipeline(0, 8, 1, 2),
                 lambda: t_serve.TokenPicker(seed=0, batch=1, vocab=8,
                                             temperature=1.0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
