"""The port's model stack (configs, models/{common,layers,transformer,
moe,mamba2,ssm_lm,hybrid,registry,convert}) against the reference's, on
the CPU, for every family at the reference's smoke widths.

Inputs come from numpy seeds and go through both packages.  Tolerances,
stated per case: integer work (dropout bits, rope frequencies, token
gathers, config data, the float8 cast) is bit-exact; a float32 function
of float32 inputs is held to a few float32 ULP; a function with bf16
output to two bf16 rounding steps (2**-7 of the largest magnitude), as the
two frameworks round bf16 products and transcendentals at different
places.  Whole-model logits on carried-over weights are held to
``LOGIT_ATOL`` (the largest difference measured was 0.0041 on logits
of magnitude ~1), well inside the reference's own decode-against-forward
slack of atol 0.15, rtol 0.05 (``tests/test_models.py``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.core import stream as j_stream
from repro.models import common as j_common
from repro.models import layers as jL
from repro.models import registry as j_registry
from repro_torch.configs import base as t_base
from repro_torch.core import stream as t_stream
from repro_torch.models import common as t_common
from repro_torch.models import convert
from repro_torch.models import layers as tL
from repro_torch.models import registry as t_registry

CPU = "cpu"
# a zeroed decode cache's first tensor: the KV cache (the mamba states
# of an ssm cache)
L_CACHE_DTYPE = {"dense": torch.bfloat16, "moe": torch.bfloat16,
                 "vlm": torch.bfloat16, "encdec": torch.bfloat16,
                 "hybrid": torch.bfloat16, "ssm": torch.float32}
# the reference's smoke widths (tests/test_models.py SMOKE_OVERRIDES)
SMOKE = {
    "gemma_7b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     head_dim=16, d_ff=128, vocab=256, q_chunk=8),
    "glm4_9b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                    d_ff=128, vocab=256, q_chunk=8),
    "qwen15_32b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       d_ff=128, vocab=256, q_chunk=8),
    "granite_34b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
                        d_ff=128, vocab=256, q_chunk=8),
    "qwen2_vl_72b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab=256, vision_prefix=4, q_chunk=8),
    "granite_moe_3b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                           d_ff=32, vocab=256, n_experts=4, top_k=2,
                           q_chunk=8),
    "olmoe_1b_7b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        d_ff=32, vocab=256, n_experts=8, top_k=2, q_chunk=8),
    "mamba2_2p7b": dict(n_layers=2, d_model=64, vocab=256, ssm_state=16,
                        ssm_head_dim=8),
    "zamba2_7b": dict(n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=128, vocab=256, ssm_state=16,
                      ssm_head_dim=8, attn_every=2, q_chunk=8),
    "whisper_small": dict(n_layers=2, enc_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=4, d_ff=128, vocab=256, enc_ctx=24,
                          q_chunk=8),
}
LOGIT_ATOL = 0.02
BF16_REL = 2.0 ** -7          # two bf16 rounding steps
# a prefill cache built through mamba2 blocks (ssm, hybrid): four bf16
# steps.  The blocks' bf16 roundings compound layer by layer; the largest
# difference measured was 0.012 on conv tails of magnitude 0.51, after
# zamba2's fourth mamba layer (a dense cache after 5 layers: 0.0039)
MAMBA_CACHE_REL = 2.0 ** -6


def _cfgs(arch):
    return (j_base.get_config(arch).scaled(**SMOKE[arch]),
            t_base.get_config(arch).scaled(**SMOKE[arch]))


def _both(x: np.ndarray, dtype="float32"):
    """The same values as a jnp array and a torch tensor."""
    x = np.asarray(x)
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(
            x.astype(np.float32)).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x, np.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else np.asarray(x)


def _ordered(bits: np.ndarray) -> np.ndarray:
    """float32 bit patterns -> integers in float order (ULP distance)."""
    i = bits.view(np.int32).astype(np.int64)
    return np.where(i < 0, -(2 ** 31) - i, i)


def _ulp32(a: np.ndarray, b: np.ndarray) -> int:
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    return int(np.abs(_ordered(a) - _ordered(b)).max()) if a.size else 0


def _close_bf16(got, want, rel=BF16_REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= rel * scale, \
        np.abs(got - want).max()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_equal_reference():
    assert t_base.ARCH_IDS == j_base.ARCH_IDS
    assert t_base._ALIASES == j_base._ALIASES
    assert {k: dataclasses.asdict(v) for k, v in t_base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_base.SHAPES.items()}
    assert [f.name for f in dataclasses.fields(t_common.ArchConfig)] == \
        [f.name for f in dataclasses.fields(j_common.ArchConfig)]
    for arch in list(j_base.ARCH_IDS) + ["gemma-7b", "qwen1.5-32b"]:
        tc, jc = t_base.get_config(arch), j_base.get_config(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), arch
        assert tc.resolved_head_dim == jc.resolved_head_dim
        assert tc.ssm_heads == jc.ssm_heads
        for shape in j_base.SHAPES:
            assert t_base.shape_skipped(tc, shape) == \
                j_base.shape_skipped(jc, shape)
    assert list(t_base.runnable_cells()) == list(j_base.runnable_cells())
    with pytest.raises(KeyError):
        t_base.get_config("base")


# ---------------------------------------------------------------------------
# layers, function by function
# ---------------------------------------------------------------------------

def test_norms_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (3, 5, 64)).astype(np.float32)
    w = rng.normal(0, 0.1, (64,)).astype(np.float32)
    b = rng.normal(0, 0.1, (64,)).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        jx, tx = _both(x, dt)
        got = tL.rms_norm(tx, torch.from_numpy(w), 1e-6)
        want = jL.rms_norm(jx, jnp.asarray(w), 1e-6)
        got2 = tL.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b),
                             1e-5)
        want2 = jL.layer_norm(jx, jnp.asarray(w), jnp.asarray(b), 1e-5)
        if dt == "float32":   # a few float32 ULP
            assert np.abs(_np(got) - _np(want)).max() <= 4e-6 * 8
            assert np.abs(_np(got2) - _np(want2)).max() <= 4e-6 * 8
        else:
            _close_bf16(got, want)
            _close_bf16(got2, want2)


def test_rope_and_sinusoids_match_reference():
    for hd, theta in [(16, 10000.0), (32, 1e6), (256, 10000.0)]:
        assert np.array_equal(tL.rope_freqs(hd, theta),
                              jL.rope_freqs(hd, theta))
    assert np.array_equal(tL.sinusoid_positions(24, 64),
                          jL.sinusoid_positions(24, 64))
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    for shape in [(2, 7, 2, 3, 16), (2, 7, 4, 32)]:
        x = rng.normal(0, 1, shape).astype(np.float32)
        for dt in ("float32", "bfloat16"):
            jx, tx = _both(x, dt)
            got = tL.apply_rope(tx, torch.from_numpy(pos), 10000.0)
            want = jL.apply_rope(jx, jnp.asarray(pos), 10000.0)
            # cos / sin of angles up to 5000 rad: a float32 ULP of the
            # angle is ~5e-4 rad, so the two libraries' results may
            # differ by that much before the bf16 rounding
            _close_bf16(got, want, rel=2.0 ** -7 + 1e-3)


@pytest.mark.parametrize("ctr0", [0, 2 ** 32 - 5, 2 ** 64 - 70])
def test_dropout_bits_and_mask_bit_for_bit(ctr0):
    h = 0x1234_5678_9ABC_DEF0
    shape = (3, 5, 7)
    want = jL.dropout_bits(
        (jnp.uint32(h >> 32), jnp.uint32(h & 0xFFFFFFFF)),
        (jnp.uint32(ctr0 >> 32), jnp.uint32(ctr0 & 0xFFFFFFFF)), shape)
    got = tL.dropout_bits(h, ctr0, shape, CPU)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    js = j_stream.advance(j_stream.new_stream(11, 0), ctr0)
    ts = t_stream.advance(t_stream.new_stream(11, 0, device=CPU), ctr0)
    x = np.random.default_rng(3).normal(0, 1, shape).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        for rate in (0.1, 0.5):
            jx, tx = _both(x, dt)
            got = tL.dropout(tx, ts, rate)
            want = jL.dropout(jx, js, rate)
            assert np.array_equal(_np(got).view(np.int32),
                                  _np(want).view(np.int32)), (dt, rate)
    assert tL.dropout(tx, None, 0.5) is tx
    assert tL.dropout(tx, ts, 0.0) is tx


@pytest.mark.parametrize("causal,q_chunk", [(True, 4), (True, 16),
                                            (False, 5)])
def test_attention_matches_reference(causal, q_chunk):
    rng = np.random.default_rng(4)
    B, S, K, R, d = 2, 16, 2, 3, 16
    q = rng.normal(0, 1, (B, S, K, R, d)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, K, d)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, K, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "bfloat16") for a in (q, k, v))
    got = tL.attention(tq, tk, tv, causal=causal, q_chunk=q_chunk)
    want = jL.attention(jq, jk, jv, causal=causal, q_chunk=q_chunk)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want)
    logits = tL._attn_logits(tq, tk, 0.25)
    want_l = jL._attn_logits(jq, jk, np.float32(0.25))
    assert logits.dtype == torch.float32
    # float32 sums of exact bf16 products, in another order
    assert np.abs(_np(logits) - _np(want_l)).max() <= 1e-5


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float8_e4m3fn"])
def test_decode_attention_matches_reference(kv_dtype):
    rng = np.random.default_rng(5)
    B, T, K, R, d = 2, 12, 2, 2, 16
    q = rng.normal(0, 1, (B, 1, K, R, d)).astype(np.float32)
    kc = rng.normal(0, 1, (B, T, K, d)).astype(np.float32)
    vc = rng.normal(0, 1, (B, T, K, d)).astype(np.float32)
    jq, tq = _both(q, "bfloat16")
    jdt = getattr(jnp, kv_dtype)
    tdt = getattr(torch, kv_dtype)
    jk = jnp.asarray(kc, jnp.bfloat16).astype(jdt)
    jv = jnp.asarray(vc, jnp.bfloat16).astype(jdt)
    tk = tL.cast(torch.from_numpy(kc).bfloat16(), tdt)
    tv = tL.cast(torch.from_numpy(vc).bfloat16(), tdt)
    assert np.array_equal(_np(tk.to(torch.float32)),
                          np.asarray(jk.astype(jnp.float32)))
    for pos in (0, 5, T - 1):
        got = tL.decode_attention(tq, tk, tv, pos)
        want = jL.decode_attention(jq, jk, jv, jnp.int32(pos))
        _close_bf16(got, want)


def test_float8_cast_matches_reference_on_every_bf16_value():
    """Every bf16 bit pattern cast to float8_e4m3fn: the reference's NaN
    above 464 (and at +-inf), not torch's saturation."""
    pats = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    x = pats.view(ml_dtypes.bfloat16)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(np.uint8)
    tx = torch.from_numpy(pats.view(np.int16).copy()).view(torch.bfloat16)
    got = tL.cast(tx, torch.float8_e4m3fn).view(torch.uint8).numpy()
    nan = np.isnan(want.view(ml_dtypes.float8_e4m3fn).astype(np.float32))
    assert np.array_equal(np.isnan(got.view(ml_dtypes.float8_e4m3fn)
                                   .astype(np.float32)), nan)
    assert np.array_equal(got[~nan], want[~nan])


@pytest.mark.parametrize("bias", [False, True])
def test_projections_match_reference(bias):
    rng = np.random.default_rng(6)
    B, S, D, K, R, d = 2, 5, 32, 2, 2, 8
    x = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    ws = [rng.normal(0, 0.1, s).astype(np.float32)
          for s in [(D, K, R, d), (D, K, d), (D, K, d)]]
    bs = [rng.normal(0, 0.1, s).astype(np.float32)
          for s in [(K, R, d), (K, d), (K, d)]] if bias else [None] * 3
    jx, tx = _both(x, "bfloat16")
    jw = [jnp.asarray(w) for w in ws + [b for b in bs if b is not None]]
    tw = [torch.from_numpy(w) for w in ws + [b for b in bs if b is not None]]
    got = tL.qkv_split(tx, *tw)
    want = jL.qkv_split(jx, *jw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close_bf16(g, w)
    wo = rng.normal(0, 0.1, (K, R, d, D)).astype(np.float32)
    _close_bf16(tL.attn_out(got[0], torch.from_numpy(wo)),
                jL.attn_out(want[0], jnp.asarray(wo)))


@pytest.mark.parametrize("act,gated", [("silu", True), ("geglu", True),
                                       ("gelu", False)])
def test_mlp_matches_reference(act, gated):
    rng = np.random.default_rng(7)
    B, S, D, Fd = 2, 4, 32, 64
    x = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    wi, wg = (rng.normal(0, 0.2, (D, Fd)).astype(np.float32)
              for _ in range(2))
    wo = rng.normal(0, 0.2, (Fd, D)).astype(np.float32)
    jx, tx = _both(x, "bfloat16")
    got = tL.mlp(tx, torch.from_numpy(wi), torch.from_numpy(wo), act,
                 torch.from_numpy(wg) if gated else None)
    want = jL.mlp(jx, jnp.asarray(wi), jnp.asarray(wo), act,
                  jnp.asarray(wg) if gated else None)
    _close_bf16(got, want)


def test_embed_unembed_and_losses_match_reference():
    rng = np.random.default_rng(8)
    V, D, B, S = 50, 32, 2, 8
    table = rng.normal(0, 0.5, (V, D)).astype(np.float32)
    toks = rng.integers(0, V, (B, S)).astype(np.int32)
    got = tL.embed(torch.from_numpy(toks), torch.from_numpy(table))
    want = jL.embed(jnp.asarray(toks), jnp.asarray(table))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(got), _np(want))
    h = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    jh, th = _both(h, "bfloat16")
    logits = tL.unembed(th, torch.from_numpy(table))
    want_l = jL.unembed(jh, jnp.asarray(table))
    assert logits.dtype == torch.float32
    assert np.abs(_np(logits) - _np(want_l)).max() <= 1e-5
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    jl, tl = _both(_np(want_l))
    for m in (None, mask):
        got = tL.softmax_xent(tl, torch.from_numpy(labels),
                              None if m is None else torch.from_numpy(m))
        want = jL.softmax_xent(jl, jnp.asarray(labels),
                               None if m is None else jnp.asarray(m))
        assert abs(float(got) - float(want)) <= 1e-5
    got = tL.softmax_xent_chunked(th, torch.from_numpy(table),
                                  torch.from_numpy(labels), n_chunks=3)
    want = jL.softmax_xent_chunked(jh, jnp.asarray(table),
                                   jnp.asarray(labels), n_chunks=3)
    assert abs(float(got) - float(want)) <= 1e-5


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class _RefModels(dict):
    """arch -> (reference params and specs at seed 3, jitted reference
    model functions), built on first use.  The reference's init runs
    under ``jax.jit``: one compile per arch instead of one per parameter
    shape, and the same values as its eager init."""

    def __missing__(self, arch):
        m = j_registry.build(_cfgs(arch)[0])
        box = {}

        def init():
            params, box["specs"] = m.init(3)
            return params

        params = jax.jit(init)()
        fns = {"forward": jax.jit(m.forward), "prefill": jax.jit(m.prefill),
               "decode": jax.jit(m.decode), "init_cache": m.init_cache}
        self[arch] = (params, box["specs"], fns)
        return self[arch]


@pytest.fixture(scope="module")
def ref_models():
    return _RefModels()


@pytest.mark.parametrize("arch", list(SMOKE))
def test_init_within_8_ulp_of_reference(arch, ref_models):
    _, tc = _cfgs(arch)
    tp, tspecs = t_registry.build(tc, device=CPU).init(3)
    jp, jspecs, _ = ref_models[arch]
    assert tspecs == jspecs          # logical axes, path for path
    tf_, jf = t_common.flatten(tp), t_common.flatten(jp)
    assert set(tf_) == set(jf)
    for path, want in jf.items():
        want = np.asarray(want)
        got = tf_[path]
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        if not want.any():          # zeros (norm weights, biases): exact
            assert not got.numpy().any(), path
        else:
            assert _ulp32(got.numpy(), want) <= 8, path


def test_chunked_draw_equals_whole_draw():
    s = t_common.param_stream(5, "layers/wq", CPU)
    whole = t_common.trunc_normal(s, (3, 7, 11), 0.02)
    for chunk in (1, 7, 100, 230):
        part = t_common.trunc_normal(s, (3, 7, 11), 0.02, chunk=chunk)
        assert torch.equal(part.view(torch.int32), whole.view(torch.int32))
    assert float(whole.abs().max()) <= 3 * 0.02 * (1 + 1e-6)


def test_meta_init_has_shapes_only():
    _, tc = _cfgs("gemma_7b")
    full = t_base.get_config("gemma_7b")
    params, _ = t_registry.build(full, device="meta").init(0)
    flat = t_common.flatten(params)
    assert all(v.device.type == "meta" for v in flat.values())
    n = sum(v.numel() for v in flat.values())
    assert n == 8_537_680_896      # gemma-7b, tied embeddings
    assert tuple(flat["layers/wg"].shape) == (28, 3072, 24576)


def test_params_from_reference_rejects_a_wrong_tree(ref_models):
    jc, tc = _cfgs("glm4_9b")
    flat = {k: np.asarray(v)
            for k, v in t_common.flatten(ref_models["glm4_9b"][0]).items()}
    ok = convert.params_from_reference(tc, flat, device=CPU)
    assert torch.equal(ok["layers"]["wq"],
                       torch.from_numpy(flat["layers/wq"].copy()))
    bad_path = dict(flat)
    bad_path["layers/wz"] = bad_path.pop("layers/wg")
    with pytest.raises(ValueError, match="paths differ"):
        convert.params_from_reference(tc, bad_path, device=CPU)
    bad_shape = dict(flat, **{"layers/wk": flat["layers/wk"][:, :, :1]})
    with pytest.raises(ValueError, match="layers/wk"):
        convert.params_from_reference(tc, bad_shape, device=CPU)
    bad_dtype = dict(flat, embed=flat["embed"].astype(np.float64))
    with pytest.raises(ValueError, match="embed"):
        convert.params_from_reference(tc, bad_dtype, device=CPU)


# ---------------------------------------------------------------------------
# whole models on carried-over weights
# ---------------------------------------------------------------------------

def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        p = rng.normal(0, 1, (B, cfg.vision_prefix, cfg.d_model))
        jb["patches"], tb["patches"] = _both(p.astype(np.float32),
                                             "bfloat16")
    if cfg.family == "encdec":
        f = rng.normal(0, 1, (B, cfg.enc_ctx, cfg.d_model))
        jb["frames"], tb["frames"] = _both(f.astype(np.float32), "bfloat16")
    return jb, tb


def _cache_shapes(cfg, B, S):
    """The prefill cache's layout, tensor by tensor: (shape, dtype)."""
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    kv = [((cfg.n_layers, B, S, K, hd), torch.bfloat16)] * 2
    mamba = [((cfg.n_layers, B, H, N, P), torch.float32),
             ((cfg.n_layers, B, cfg.ssm_conv - 1, cfg.d_inner),
              torch.bfloat16)] + \
        [((cfg.n_layers, B, cfg.ssm_conv - 1, N), torch.bfloat16)] * 2
    if cfg.family == "encdec":
        return kv + [((cfg.n_layers, B, cfg.enc_ctx, K, hd),
                      torch.bfloat16)] * 2
    if cfg.family == "ssm":
        return mamba
    if cfg.family == "hybrid":
        napps = cfg.n_layers // cfg.attn_every
        return [((napps, B, S, K, hd), torch.bfloat16)] * 2 + mamba
    return kv


def _decode_cache(cfg, tm, jm, tp, jp, tb, jb, B, S):
    """Zeroed full-length decode caches of both packages; an encdec
    cache takes its cross K/V from each package's own prefill."""
    tcache, jcache = tm.init_cache(B, S), jm["init_cache"](B, S)
    if cfg.family == "encdec":
        tcache = tcache[:2] + tm.prefill(tp, tb)[1][2:]
        jcache = tuple(jcache[:2]) + tuple(jm["prefill"](jp, jb)[1][2:])
    return tcache, jcache


@pytest.mark.parametrize("kind", ["forward", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(SMOKE))
def test_logits_match_reference(arch, kind, ref_models):
    jc, tc = _cfgs(arch)
    jp, _, jm = ref_models[arch]
    tm = t_registry.build(tc, device=CPU)
    tp = convert.params_from_reference(tc, jp, device=CPU)
    B, S = 2, 16
    jb, tb = _batch(jc, B, S, seed=5)
    if kind == "forward":
        got, aux = tm.forward(tp, tb)
        want, waux = jm["forward"](jp, jb)
        if jc.family == "moe":
            # the routers read bf16 activations that differ by rounding:
            # two bf16 steps (the largest difference measured was 5e-5
            # of 1.16)
            assert aux.dtype == torch.float32
            assert abs(float(aux) - float(waux)) <= BF16_REL * float(waux)
        else:
            assert float(aux) == 0.0 == float(waux)
    elif kind == "prefill":
        got, gcache = tm.prefill(tp, tb)
        want, wcache = jm["prefill"](jp, jb)
        layout = _cache_shapes(jc, B, S)
        assert len(gcache) == len(wcache) == len(layout)
        rel = MAMBA_CACHE_REL if jc.family in ("ssm", "hybrid") else BF16_REL
        for g, w, (shape, dtype) in zip(gcache, wcache, layout):
            assert tuple(g.shape) == np.shape(w) == shape
            assert g.dtype == dtype
            _close_bf16(g, w, rel)
    else:
        tcache, jcache = _decode_cache(jc, tm, jm, tp, jp, tb, jb, B, S)
        assert tcache[0].dtype == (torch.float8_e4m3fn if jc.kv_dtype == "f8"
                                   else L_CACHE_DTYPE[jc.family])
        got, want = [], []
        for pos in range(S):
            lg, tcache = tm.decode(tp, tcache, tb["tokens"][:, pos:pos + 1],
                                   pos)
            got.append(lg)
            lg, jcache = jm["decode"](jp, jcache,
                                      jb["tokens"][:, pos:pos + 1],
                                      jnp.int32(pos))
            want.append(np.asarray(lg))
        got, want = torch.stack(got, 1), np.stack(want, 1)
    assert got.dtype == torch.float32
    assert got.shape == tuple(np.shape(want))
    assert np.abs(_np(got) - _np(want)).max() <= LOGIT_ATOL


def test_vlm_refuses_a_prompt_shorter_than_its_patch_prefix(ref_models):
    """ROADMAP C11.  With an 8-position patch prefix, a 4-token prompt
    raises ValueError in the reference's forward and prefill (its pad
    refuses a negative width) and in the port's, where a negative
    ``F.pad`` would crop the patches, and in the port's ``launch.serve``;
    8- and 12-token prompts give the reference's logits."""
    from repro_torch.launch import serve, train
    jc, tc = (c.scaled(vision_prefix=8) for c in _cfgs("qwen2_vl_72b"))
    jp, _, jm = ref_models["qwen2_vl_72b"]
    tm = t_registry.build(tc, device=CPU)
    tp = convert.params_from_reference(tc, jp, device=CPU)
    for S in (4, 8, 12):
        jb, tb = _batch(jc, 2, S, seed=7)
        for kind in ("forward", "prefill"):
            if S < tc.vision_prefix:
                with pytest.raises(ValueError):
                    jm[kind](jp, jb)
                with pytest.raises(ValueError, match="of 4 tokens is shorter "
                                   "than its patch prefix of 8"):
                    getattr(tm, kind)(tp, tb)
                continue
            got, want = getattr(tm, kind)(tp, tb)[0], jm[kind](jp, jb)[0]
            assert got.shape == tuple(np.shape(want))
            assert np.abs(_np(got) - _np(want)).max() <= LOGIT_ATOL
    cfg = train.smoke_config(t_base.get_config("qwen2_vl_72b"))
    with pytest.raises(ValueError, match="shorter than its patch prefix"):
        serve.serve(cfg.scaled(vision_prefix=8), batch=2, prompt_len=4,
                    gen=2, device=CPU)


def test_decode_refuses_a_position_past_the_cache():
    _, tc = _cfgs("glm4_9b")
    m = t_registry.build(tc, device=CPU)
    params, _ = m.init(0)
    cache = m.init_cache(1, 4)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    m.decode(params, cache, tok, 3)
    with pytest.raises(ValueError, match="outside the cache"):
        m.decode(params, cache, tok, 4)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in SMOKE:    # every family
        _, tc = _cfgs(arch)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_registry.build(tc)
        assert t_registry.build(tc, CPU).init_cache(1, 2)[0].device.type \
            == "cpu"
    _, tc = _cfgs("gemma_7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_common.ParamFactory(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_reference(tc, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tL.dropout_bits(0x1234, 0, (2, 3))
    assert tL.dropout_bits(0x1234, 0, (2, 3), CPU).device.type == "cpu"
