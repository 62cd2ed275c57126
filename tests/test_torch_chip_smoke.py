"""chip_smoke.py's MoE routing check on the CPU, on synthetic recordings.

``_card_against_cpu`` leaves out every row whose MoE group had a token
that the card routed otherwise, and ``_flips_are_near_ties`` holds each
such token to a near-tie: its top-k gap on the CPU within twice the
largest router-probability difference of the call.  A flip across a wide
gap is a routing fault even when it moves one row of eight, which the
half-of-the-rows floor alone lets pass.

Its decode-against-forward check holds a float8 KV cache's decode against
a forward that attends to K and V rounded as the cache stores them
(``_KvStored``), here on qwen1.5-32b at smoke width.

Its dry-run check holds each measured peak against the argument bytes of
the config at its own served or trained shape (``_trained_shape``, on
``meta``): a family's train peak below its own prediction fails even
where it lies above gemma-7b's, and every one of the ten configs the
train paths train needs a depth within its own and a measured peak.  Its
train step watch names a gradient leaf holding a NaN.
"""
from __future__ import annotations

import contextlib
import importlib.util
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread while the module runs: inside the
    suite's 6 workers on 8 cores a thread per core oversubscribes them
    (``tests/test_torch_train.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ROWS, K = 8, 2


def _call(probs, experts=None, gs=1):
    """One ``_MoeRoutes`` record of a call over (tokens, E) probabilities;
    the chosen experts are the top-k of ``probs`` unless given."""
    if experts is None:
        experts = torch.sort(probs, dim=-1, descending=True,
                             stable=True).indices[:, :K]
    return (experts.sort(-1).values,
            torch.zeros(probs.shape[0], K, dtype=torch.bool), gs, probs)


def _recordings(flip_gap):
    """A decode-like call (8 tokens, one per row, 4 experts) on the CPU
    and the card, every probability within 1e-6, where the card chose
    experts {0, 2} for token 3, whose 2nd and 3rd probabilities on the
    CPU are ``flip_gap`` apart; then a later call where token 3's row
    differs by far more (it diverged already)."""
    g = torch.Generator().manual_seed(5)
    base = torch.tensor([0.4, 0.3, 0.2, 0.1]).repeat(ROWS, 1)
    cpu = base + 1e-3 * torch.rand(ROWS, 4, generator=g)
    cpu[3] = torch.tensor([0.45, 0.25 + flip_gap / 2, 0.25 - flip_gap / 2,
                           0.05])
    card = cpu + 1e-6 * (2 * torch.rand(ROWS, 4, generator=g) - 1)
    experts = torch.sort(cpu, dim=-1, descending=True,
                         stable=True).indices[:, :K]
    experts[3] = torch.tensor([0, 2])
    later_card = base.clone()
    later_card[3] = torch.tensor([0.1, 0.2, 0.3, 0.4])
    return ([_call(cpu), _call(base)],
            [_call(card, experts), _call(later_card)])


def test_a_near_tie_flip_passes(cs):
    cpu, card = _recordings(flip_gap=1e-7)
    rows, flipped = cs._rows_routed_alike(cpu, card, ROWS)
    assert flipped == 2 and int(rows.sum()) == ROWS - 1 and not rows[3]
    ties = cs._flips_are_near_ties(cpu, card, ROWS)
    assert ties["flips"] == 2 and ties["held"] == 1
    assert ties["gap"] <= 2 * ties["eps"] <= 2 * cs.MOE_PROB_ATOL


def test_a_wide_gap_flip_of_one_row_fails(cs):
    cpu, card = _recordings(flip_gap=0.1)
    rows, _ = cs._rows_routed_alike(cpu, card, ROWS)
    assert 2 * int(rows.sum()) >= ROWS          # the old check passes
    with pytest.raises(cs.SmokeFailure, match="top-2 gap of 0.1"):
        cs._flips_are_near_ties(cpu, card, ROWS)


def test_router_probabilities_past_the_limit_fail(cs):
    cpu, card = _recordings(flip_gap=1e-7)
    experts, dropped, gs, probs = card[0]
    probs = probs.clone()
    probs[5, 0] += 2 * cs.MOE_PROB_ATOL        # routes alike, far off
    card[0] = (experts, dropped, gs, probs)
    with pytest.raises(cs.SmokeFailure, match="router probabilities"):
        cs._flips_are_near_ties(cpu, card, ROWS)


@pytest.fixture(scope="module")
def f8_cut():
    from repro_torch.configs import get_config
    from repro_torch.launch.train import smoke_config
    from repro_torch.models import registry
    cut = smoke_config(get_config("qwen15_32b"))
    assert cut.kv_dtype == "f8"
    params, _ = registry.build(cut, torch.device("cpu")).init(0)
    return cut, params


def test_float8_decode_is_held_to_the_kv_rounded_forward(cs, f8_cut,
                                                        monkeypatch):
    cut, params = f8_cut
    cpu = torch.device("cpu")
    dec, full, pairs, _ = cs._decode_vs_forward_logits(cut, params, cpu)
    assert pairs == 0 and bool(torch.isfinite(dec).all())
    assert cs._excess(dec, full) <= cs.SERVE_SLACK_ATOL
    # a forward over unrounded K and V lies farther from the float8 decode
    monkeypatch.setattr(cs, "_KvStored", lambda dtype: contextlib.nullcontext())
    _, plain, _, _ = cs._decode_vs_forward_logits(cut, params, cpu)
    assert cs._rms(dec, plain) > 10 * cs._rms(dec, full)


def test_a_wrong_head_mapping_in_the_float8_read_back_fails(cs, f8_cut,
                                                            monkeypatch):
    from repro_torch.models import layers as L
    cut, params = f8_cut
    real = L.decode_attention
    monkeypatch.setattr(L, "decode_attention", lambda q, k, v, pos: real(
        q, k.to(q.dtype).flip(2), v.to(q.dtype).flip(2), pos))
    dec, full, _, _ = cs._decode_vs_forward_logits(
        cut, params, torch.device("cpu"))
    assert cs._excess(dec, full) > cs.SERVE_SLACK_ATOL


# ---------------------------------------------------------------------------
# the dry run's check of every train peak against its own shape
# ---------------------------------------------------------------------------

def test_trained_shape_gives_each_trained_config_its_own_shape(cs):
    want = {"gemma_7b": (cs.TRAIN_LAYERS, 256, {}),
            "olmoe_1b_7b": (cs.TRAIN_FAMILY_LAYERS["olmoe_1b_7b"], 256, {}),
            "whisper_small": (12, 256, {"frames": (8, 1500, 768)}),
            "qwen2_vl_72b": (cs.TRAIN_FAMILY_LAYERS["qwen2_vl_72b"],
                             1024 + cs.TRAIN_VLM_TEXT,
                             {"patches": (8, 1024, 8192)})}
    for arch, (layers, seq, extras) in want.items():
        assert cs._trained_shape(arch) == dict(
            layers=layers, batch=8, seq=seq, extras=extras), arch
    # each config's bytes at its own shape, linear in its layers
    gemma = cs._trained_bytes("gemma_7b")["total"]
    for arch in cs.TRAIN_FAMILY_ARCHS:
        one, two, own = (cs._trained_bytes(arch, n)["total"]
                         for n in (1, 2, 0))
        assert own == one + (cs._trained_shape(arch)["layers"] - 1) * (
            two - one) and own != gemma, arch


def test_every_trained_config_has_a_depth_and_a_held_peak(cs):
    from repro_torch.configs import get_config
    trained = (cs.TRAIN_ARCH,) + cs.TRAIN_FAMILY_ARCHS + cs.TRAIN_LARGE_ARCHS
    assert len(set(trained)) == 10
    for arch in trained:
        assert 1 <= cs._trained_shape(arch)["layers"] <= \
            get_config(arch).n_layers, arch
    # _hold_peaks requires a train peak of each of the ten
    full = _peaks(cs)
    assert {a for a, kind in full if kind == "train"} == set(trained)
    for arch in trained:
        measured = dict(full)
        del measured[(arch, "train")]
        with pytest.raises(cs.SmokeFailure, match="not all measured"):
            cs._hold_peaks(measured)


def _peaks(cs, gib_over=1.0):
    """A ``measured`` dict of every config this run serves or trains, each
    peak ``gib_over`` GiB above the dry run's bytes at its own shape."""
    over = int(gib_over * 2 ** 30)
    out = {}
    for arch in (cs.SERVE_ARCH,) + cs.FAMILY_ARCHS + cs.LARGE_ARCHS:
        out[(arch, "serve")] = [cs._served_bytes(
            arch, cs.SERVE_BATCH, *cs._served_shape(arch))["total"] + over]
    for arch in (cs.TRAIN_ARCH,) + cs.TRAIN_FAMILY_ARCHS + \
            cs.TRAIN_LARGE_ARCHS:
        b = cs._trained_bytes(arch)
        out[(arch, "train")] = [b["total"] + b["grads"] + over]
    return out


def test_every_peak_is_held_against_its_own_shape(cs):
    margin, train_margin = cs._hold_peaks(_peaks(cs))
    assert train_margin == 2 ** 30
    # the serve margin: the configs served whole and gemma-7b's train
    b = cs._trained_bytes(cs.TRAIN_ARCH)
    assert margin == b["grads"] + 2 ** 30


def test_a_family_train_peak_below_its_own_prediction_fails(cs):
    measured = _peaks(cs)
    own = cs._trained_bytes("olmoe_1b_7b")["total"]
    # above gemma-7b's train bytes, which the check held every train peak
    # to before, but below olmoe's own
    assert cs._trained_bytes(cs.TRAIN_ARCH)["total"] < own - 1
    measured[("olmoe_1b_7b", "train")] = [own - 1]
    with pytest.raises(cs.SmokeFailure, match="olmoe_1b_7b train predicts"):
        cs._hold_peaks(measured)


def test_a_missing_train_peak_fails(cs):
    measured = _peaks(cs)
    del measured[("zamba2_7b", "train")]
    with pytest.raises(cs.SmokeFailure, match="not all measured"):
        cs._hold_peaks(measured)


def test_step_watch_names_a_non_finite_gradient(cs, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.train import pipeline_for, smoke_config
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    cfg = smoke_config(get_config("mamba2_2p7b"))
    model = registry.build(cfg, torch.device("cpu"))
    params, _ = model.init(0)
    batch = pipeline_for(cfg, 2, 16, 0, device="cpu").batch_at(0)
    real = steps.value_and_grad

    def poisoned(*a, **kw):
        out, grads = real(*a, **kw)
        grads["layers"]["a_log"][0, 3] = float("nan")
        return out, grads

    monkeypatch.setattr(steps, "value_and_grad", poisoned)
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw:
                        types.SimpleNamespace(record=lambda: None))
    step = steps.make_train_step(model)
    with cs._StepWatch() as watch:
        watch.check = True
        step(params, adamw_init(params), batch, 0)
    assert watch.nonfinite == ["layers/a_log"]
