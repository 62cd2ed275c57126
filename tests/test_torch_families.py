"""The port's MoE, Mamba2, Zamba2-hybrid and encoder-decoder pieces
(models/{moe,mamba2,ssm_lm,hybrid}.py, the encdec part of
models/transformer.py, launch/serve._graft) against the reference's, on
the CPU, on inputs made from numpy seeds.

Tolerances, stated per case:
  * integer work is exact: ``_group_size``, top-k indices (ties included),
    routes and slots, the bf16 causal conv (op by op, as XLA rounds), the
    conv tails;
  * dispatch bit-equal, and the combine weights as the reference uses
    them (cast to bf16), on every group whose routes hold no near-tie
    (the k-th and (k+1)-th router probabilities within 1e-6, where one
    float32 rounding of a logit may flip the choice; the near-ties are
    counted); router probabilities within 1e-6;
  * bf16 outputs within two bf16 rounding steps (2**-7 of the largest
    magnitude); the MoE aux within 8 float32 ULP;
  * float32 SSD work within 1e-5 relative of the reference (the same
    products, summed in another order) and within the reference's own
    1e-3 of the naive recurrence;
  * decode against forward within the reference's slack, atol 0.15,
    rtol 0.05 (``tests/test_models.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stream as j_stream
from repro.models import mamba2 as j_mamba2
from repro.models import moe as j_moe
from repro.models import registry as j_registry
from repro_torch.core import stream as t_stream
from repro_torch.launch import serve as t_serve
from repro_torch.models import mamba2 as t_mamba2
from repro_torch.models import moe as t_moe
from repro_torch.models import registry as t_registry

from test_torch_models import _both, _cfgs, _close_bf16, _np, _ulp32

CPU = "cpu"
NEAR_TIE = 1e-6
NEW_ARCHS = ("granite_moe_3b", "olmoe_1b_7b", "mamba2_2p7b", "zamba2_7b",
             "whisper_small")


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("want,min_groups", [(2048, 32), (512, 32), (7, 3)])
def test_group_size_equals_reference(want, min_groups):
    for n in range(1, 4097):
        assert t_moe._group_size(n, want, min_groups) == \
            j_moe._group_size(n, want, min_groups), n


def test_top_k_puts_the_lower_index_first_among_ties():
    rng = np.random.default_rng(20)
    for E, k in [(8, 2), (40, 8), (64, 8), (5, 5)]:
        # few distinct values: most rows hold ties across the k-th place
        probs = rng.integers(0, 4, (64, E)).astype(np.float32) / 4.0
        probs[0] = 0.25                      # all equal
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = t_moe.top_k(torch.from_numpy(probs), k)
        assert np.array_equal(gi.numpy(), np.asarray(wi)), (E, k)
        assert np.array_equal(gv.numpy(), np.asarray(wv)), (E, k)
        assert gi[0].tolist() == list(range(k))


def _ref_dispatch(top_w, top_idx, E, C):
    """The reference's dispatch / combine loop (``moe.moe_mlp``)."""
    G, gs, k = top_idx.shape
    dispatch = jnp.zeros((G, gs, E, C), jnp.bfloat16)
    combine = jnp.zeros((G, gs, E, C), jnp.float32)
    counts = jnp.zeros((G, E), jnp.int32)
    for j in range(k):
        onehot = jax.nn.one_hot(top_idx[..., j], E, dtype=jnp.int32)
        pos_in_e = jnp.cumsum(onehot, axis=1) - onehot + counts[:, None, :]
        pos_j = jnp.sum(pos_in_e * onehot, axis=-1)
        slot = jax.nn.one_hot(jnp.where(pos_j < C, pos_j, C), C + 1,
                              dtype=jnp.float32)[..., :C]
        d_j = onehot.astype(jnp.float32)[..., None] * slot[..., None, :]
        dispatch = dispatch + d_j.astype(jnp.bfloat16)
        combine = combine + d_j * top_w[..., j][..., None, None]
        counts = counts + jnp.sum(onehot, axis=1)
    return np.asarray(dispatch, np.float32), np.asarray(combine)


def _dense(slot, top_w, E, C):
    """(G, gs, E, C) dispatch and combine of the port's slots."""
    G, gs, k = slot.shape
    onehot = torch.nn.functional.one_hot(slot, E * C + 1)[..., :E * C]
    onehot = onehot.to(torch.float32)
    dispatch = onehot.sum(2).reshape(G, gs, E, C)
    combine = (onehot * top_w[..., None]).sum(2).reshape(G, gs, E, C)
    return dispatch.numpy(), combine.numpy()


def _moe_case(arch, B, S, seed):
    _, cfg = _cfgs(arch)
    rng = np.random.default_rng(seed)
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.d_ff
    h = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    ws = [rng.normal(0, s, shape).astype(np.float32)
          for s, shape in [(0.5, (D, E)), (0.2, (E, D, Fd)),
                           (0.2, (E, D, Fd)), (0.2, (E, Fd, D))]]
    return cfg, h, ws


@pytest.mark.parametrize("arch,B,S,jitter", [
    ("olmoe_1b_7b", 4, 64, False), ("olmoe_1b_7b", 4, 64, True),
    ("granite_moe_3b", 2, 48, True), ("olmoe_1b_7b", 64, 1, False)])
def test_moe_mlp_matches_reference(arch, B, S, jitter):
    cfg, h, ws = _moe_case(arch, B, S, seed=21)
    E, k = cfg.n_experts, cfg.top_k
    jh, th = _both(h, "bfloat16")
    jw, tw = [jnp.asarray(w) for w in ws], [torch.from_numpy(w) for w in ws]
    jrng = j_stream.new_stream(9, 0) if jitter else None
    trng = t_stream.new_stream(9, 0, device=CPU) if jitter else None
    N = B * S
    gs = t_moe._group_size(N, want=cfg.moe_group)
    G = N // gs
    C = max(1, int(np.ceil(cfg.capacity_factor * k * gs / E)))

    # routing
    jprobs, _ = j_moe.router_probs(jh.reshape(G, gs, -1), jw[0], jrng)
    tprobs, _ = t_moe.router_probs(th.reshape(G, gs, -1), tw[0], trng)
    assert np.abs(tprobs.numpy() - np.asarray(jprobs)).max() <= 1e-6
    jtop_w, jtop_idx = jax.lax.top_k(jprobs, k)
    jtop_w = jtop_w / jnp.maximum(jnp.sum(jtop_w, -1, keepdims=True), 1e-9)
    ttop_w, ttop_idx, slot = t_moe.route(tprobs, k, C)
    srt = np.sort(np.asarray(jprobs), -1)[..., ::-1]
    clear = (srt[..., k - 1] - srt[..., k]) > NEAR_TIE           # (G, gs)
    near_ties = int((~clear).sum())
    assert near_ties <= N // 100, near_ties        # counted, not hidden
    assert np.array_equal(ttop_idx.numpy()[clear], np.asarray(jtop_idx)[clear])
    whole = clear.all(1)                           # groups free of near-ties
    assert whole.sum() >= G - near_ties
    jd, jc = _ref_dispatch(jtop_w, jtop_idx, E, C)
    td, tc = _dense(slot, ttop_w, E, C)
    assert np.array_equal(td[whole], jd[whole])
    # the float32 combine: the weights' own difference (router logits
    # summed in another order; measured at most 2.1e-7); as the reference
    # uses it, cast to bf16, bit-equal
    assert np.abs(tc[whole] - jc[whole]).max() <= 1e-6
    bf16 = lambda a: torch.from_numpy(a).bfloat16().float().numpy()
    assert np.array_equal(bf16(tc[whole]), bf16(jc[whole]))
    dropped = int((slot == E * C).sum())

    # the whole MLP
    jy, jaux = j_moe.moe_mlp(cfg, jh, *jw, jrng)
    ty, taux = t_moe.moe_mlp(cfg, th, *tw, trng)
    assert ty.dtype == torch.bfloat16 and ty.shape == th.shape
    rows = np.repeat(whole, gs).reshape(B, S)
    _close_bf16(ty.float().numpy()[rows], np.asarray(jy, np.float32)[rows])
    assert _ulp32(np.float32(float(taux)), np.float32(float(jaux))) <= 8
    if B * S > 64:
        assert dropped > 0      # the case exercises the capacity


@pytest.mark.parametrize("jitter", [False, True])
def test_moe_mlp_gradients_match_reference(jitter):
    """The gradients of sum(y * r) + aux for a fixed numpy r, on equal
    inputs, at the train tests' gradient tolerance: per leaf, max |port -
    ref| <= 2^-5 of the leaf's largest and the RMS difference <= 2^-6 of
    its RMS (tests/test_torch_train.py)."""
    cfg, h, ws = _moe_case("olmoe_1b_7b", 4, 64, seed=24)
    r = np.random.default_rng(25).normal(0, 1, h.shape).astype(np.float32)
    jrng = j_stream.new_stream(9, 0) if jitter else None
    trng = t_stream.new_stream(9, 0, device=CPU) if jitter else None

    def j_loss(h, *w):
        y, aux = j_moe.moe_mlp(cfg, h, *w, jrng)
        return jnp.sum(y.astype(jnp.float32) * r) + aux

    jargs = [jnp.asarray(h, jnp.bfloat16)] + [jnp.asarray(w) for w in ws]
    want = jax.jit(jax.grad(j_loss, argnums=tuple(range(5))))(*jargs)
    targs = [torch.from_numpy(h).bfloat16().requires_grad_()] + \
        [torch.from_numpy(w).requires_grad_() for w in ws]
    y, aux = t_moe.moe_mlp(cfg, *targs, trng)
    (torch.sum(y.float() * torch.from_numpy(r)) + aux).backward()
    for t, w in zip(targs, want):
        g, w = t.grad.float().numpy().astype(np.float64), np.asarray(
            w, np.float32).astype(np.float64)
        assert g.shape == w.shape
        d = g - w
        assert np.abs(d).max() <= 2.0 ** -5 * np.abs(w).max()
        assert np.sqrt(np.mean(d ** 2)) <= 2.0 ** -6 * np.sqrt(
            np.mean(w ** 2))


def test_moe_backward_gathers_are_deterministic():
    cfg, h, ws = _moe_case("olmoe_1b_7b", 4, 64, seed=22)
    grads = []
    for _ in range(2):
        th = torch.from_numpy(h).bfloat16().requires_grad_()
        tw = [torch.from_numpy(w).requires_grad_() for w in ws]
        y, aux = t_moe.moe_mlp(cfg, th, *tw,
                               t_stream.new_stream(3, 0, device=CPU))
        (y.float().square().sum() + aux).backward()
        grads.append([th.grad] + [w.grad for w in tw])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    # every token's gradient is the sum over its kept choices
    assert grads[0][0].abs().sum() > 0


def test_moe_jitter_stream_reaches_the_router():
    cfg, h, ws = _moe_case("olmoe_1b_7b", 4, 64, seed=23)
    th = torch.from_numpy(h).bfloat16()
    tw = [torch.from_numpy(w) for w in ws]
    plain = t_moe.router_probs(th, tw[0], None)[0]
    s = t_stream.new_stream(4, 0, device=CPU)
    a = t_moe.router_probs(th, tw[0], s)[0]
    b = t_moe.router_probs(th, tw[0], t_stream.derive(s, 1))[0]
    assert not torch.equal(a, plain) and not torch.equal(a, b)
    assert torch.equal(a, t_moe.router_probs(th, tw[0], s)[0])


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tail_len", [None, 3])
def test_causal_conv_bit_equal(tail_len):
    rng = np.random.default_rng(24)
    B, S, Cn, ck = 2, 9, 40, 4
    x = rng.normal(0, 1, (B, S, Cn)).astype(np.float32)
    w = rng.normal(0, 0.3, (ck, Cn)).astype(np.float32)
    b = rng.normal(0, 0.1, (Cn,)).astype(np.float32)
    jx, tx = _both(x, "bfloat16")
    jt = tt = None
    if tail_len:
        t = rng.normal(0, 1, (B, tail_len, Cn)).astype(np.float32)
        jt, tt = _both(t, "bfloat16")
    want = j_mamba2._causal_conv(jx, jnp.asarray(w), jnp.asarray(b), jt)
    got = t_mamba2._causal_conv(tx, torch.from_numpy(w), torch.from_numpy(b),
                                tt)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(_np(got), _np(want))


def test_softplus_is_logaddexp_without_threshold():
    # (past -87 the result is subnormal, which XLA's CPU flushes to zero)
    x = np.concatenate([np.linspace(-30, 30, 2001, dtype=np.float32),
                        np.float32([0.0, 19.9, 20.0, 20.1, 88.0, -80.0])])
    got = t_mamba2.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    assert _ulp32(got, want) <= 2


def _ssd_inputs(S, seed=11):
    rng = np.random.default_rng(seed)
    B, H, P, N = 2, 3, 4, 5
    x = rng.normal(0, 1, (B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    B_ = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    C_ = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, H, N, P)).astype(np.float32)
    return x, dt, A, B_, C_, h0


def _naive_ssm(x, dt, A, B_, C_, h0):
    """Token-by-token recurrence in float64."""
    h = h0.astype(np.float64)
    ys = np.zeros(x.shape, np.float64)
    for t in range(x.shape[1]):
        dA = np.exp(dt[:, t] * A)
        h = dA[..., None, None] * h + np.einsum(
            "bn,bh,bhp->bhnp", B_[:, t], dt[:, t], x[:, t])
        ys[:, t] = np.einsum("bn,bhnp->bhp", C_[:, t], h)
    return ys, h


@pytest.mark.parametrize("S,chunk,with_h0", [(32, 4, False), (32, 32, True),
                                             (24, 4, True), (40, 32, False)])
def test_ssd_chunked_matches_reference_and_naive(S, chunk, with_h0):
    x, dt, A, B_, C_, start = _ssd_inputs(S)
    h0 = start if with_h0 else None
    want_y, want_f = j_mamba2._ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, B_, C_)), chunk=chunk,
        h0=None if h0 is None else jnp.asarray(h0))
    got_y, got_f = t_mamba2._ssd_chunked(
        *(torch.from_numpy(a) for a in (x, dt, A, B_, C_)), chunk=chunk,
        h0=None if h0 is None else torch.from_numpy(h0))
    for g, w in ((got_y, want_y), (got_f, want_f)):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.float32 and g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * max(1.0, np.abs(w).max())
    ny, nf = _naive_ssm(x, dt, A, B_, C_,
                        start if with_h0 else np.zeros_like(start))
    np.testing.assert_allclose(got_y.numpy(), ny, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(got_f.numpy(), nf, atol=1e-3, rtol=1e-3)


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """One 128-step chunk with dt * A down to -1.6 a step: exp(seg) above
    the diagonal overflows.  The reference's gradient is NaN there (ROADMAP
    C9); the port's, masked before the exp, is finite and equals the
    reference's at chunk 4 (no overflow: the same function)."""
    x, dt, A, B_, C_, _ = _ssd_inputs(128, seed=32)
    dt = np.full_like(dt, 0.1)
    A = np.float32([-16.0, -8.0, -1.0])
    jargs = [jnp.asarray(a) for a in (x, dt, A, B_, C_)]

    def j_loss(chunk):
        return jax.grad(lambda x, dt: jnp.sum(j_mamba2._ssd_chunked(
            x, dt, *jargs[2:], chunk=chunk)[0]), argnums=(0, 1))

    nan_grads = jax.jit(j_loss(128))(*jargs[:2])
    assert any(np.isnan(np.asarray(g)).any() for g in nan_grads)
    want = jax.jit(j_loss(4))(*jargs[:2])
    targs = [torch.from_numpy(a).requires_grad_() for a in (x, dt)]
    y, _ = t_mamba2._ssd_chunked(*targs, *(torch.from_numpy(a)
                                           for a in (A, B_, C_)), chunk=128)
    y.sum().backward()
    wy = j_mamba2._ssd_chunked(*jargs, chunk=128)[0]
    assert np.abs(y.detach().numpy() - np.asarray(wy)).max() <= \
        1e-5 * np.abs(np.asarray(wy)).max()
    for t, w in zip(targs, want):
        g, w = t.grad.numpy(), np.asarray(w)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(),
                                   rtol=1e-3)


@pytest.mark.parametrize("seq_len,prev", [(1, True), (2, True), (3, True),
                                          (5, True), (1, False), (2, False)])
def test_tail_of_equals_reference(seq_len, prev):
    rng = np.random.default_rng(25)
    seq = rng.normal(0, 1, (2, seq_len, 6)).astype(np.float32)
    tail = rng.normal(0, 1, (2, 3, 6)).astype(np.float32)
    js, ts = _both(seq, "bfloat16")
    jt, tt = _both(tail, "bfloat16") if prev else (None, None)
    got = t_mamba2._tail_of(tt, ts, 4)
    want = j_mamba2._tail_of(jt, js, 4)
    assert tuple(got.shape) == want.shape == (2, 3, 6)
    assert np.array_equal(_np(got), _np(want))


def _mamba_layer(cfg, seed):
    """One layer's parameters from the reference's init, with non-zero
    norms and biases."""
    from repro.models.common import ParamFactory
    rng = np.random.default_rng(seed)
    flat = jax.jit(lambda: j_mamba2.mamba_layer_params(
        ParamFactory(seed), cfg, "layers", 1))()
    lp = {k.split("/")[1]: np.asarray(v[0]) for k, v in flat.items()}
    for name in ("norm", "gnorm", "conv_x_b", "conv_B_b", "conv_C_b"):
        lp[name] = rng.normal(0, 0.1, lp[name].shape).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in lp.items()},
            {k: torch.from_numpy(v.copy()) for k, v in lp.items()})


def test_mamba_decode_step_matches_reference():
    jc, tc = _cfgs("mamba2_2p7b")
    jlp, tlp = _mamba_layer(jc, 26)
    rng = np.random.default_rng(27)
    B, D, H, N, P = 3, jc.d_model, jc.ssm_heads, jc.ssm_state, jc.ssm_head_dim
    h = rng.normal(0, 1, (B, 1, D)).astype(np.float32)
    st = rng.normal(0, 0.1, (B, H, N, P)).astype(np.float32)
    tails = [rng.normal(0, 1, (B, 3, c)).astype(np.float32)
             for c in (jc.d_inner, N, N)]
    jh, th = _both(h, "bfloat16")
    jt, tt = zip(*(_both(t, "bfloat16") for t in tails))
    tst = torch.from_numpy(st.copy())
    want_h, want_st, want_t = jax.jit(
        lambda *a: j_mamba2.mamba_decode_step(jc, *a))(
        jlp, jh, jnp.asarray(st), tuple(jt))
    got_h, got_st, got_t = t_mamba2.mamba_decode_step(tc, tlp, th, tst,
                                                      tuple(tt))
    assert got_st is tst and all(g is t for g, t in zip(got_t, tt))
    _close_bf16(got_h, want_h)
    ws = np.asarray(want_st)
    assert np.abs(got_st.numpy() - ws).max() <= 1e-5 * np.abs(ws).max()
    for g, w in zip(got_t, want_t):
        assert np.array_equal(_np(g), _np(w))


def test_mamba_block_matches_reference_with_carry():
    jc, tc = _cfgs("mamba2_2p7b")
    jlp, tlp = _mamba_layer(jc, 28)
    rng = np.random.default_rng(29)
    B, S = 2, 12
    h = rng.normal(0, 1, (B, S, jc.d_model)).astype(np.float32)
    jh, th = _both(h, "bfloat16")
    h0 = rng.normal(0, 0.1, (B, jc.ssm_heads, jc.ssm_state,
                             jc.ssm_head_dim)).astype(np.float32)
    tails = [rng.normal(0, 1, (B, 3, c)).astype(np.float32)
             for c in (jc.d_inner, jc.ssm_state, jc.ssm_state)]
    jt, tt = zip(*(_both(t, "bfloat16") for t in tails))
    want, (wf, wt) = jax.jit(
        lambda lp, h, t, h0: j_mamba2.mamba_block(jc, lp, h, conv_tails=t,
                                                  h0=h0))(
        jlp, jh, jt, jnp.asarray(h0))
    got, (gf, gt) = t_mamba2.mamba_block(tc, tlp, th, conv_tails=tt,
                                         h0=torch.from_numpy(h0))
    _close_bf16(got, want)
    assert np.abs(gf.numpy() - np.asarray(wf)).max() <= \
        2.0 ** -7 * np.abs(np.asarray(wf)).max()
    for g, w in zip(gt, wt):
        assert np.array_equal(_np(g), _np(w))


def test_mamba_layer_constants_equal_reference():
    from repro.models.common import ParamFactory as JPF
    from repro_torch.models.common import ParamFactory as TPF
    jc, tc = _cfgs("zamba2_7b")
    want = jax.jit(lambda: j_mamba2.mamba_layer_params(JPF(0), jc, "layers",
                                                       3))()
    got = t_mamba2.mamba_layer_params(TPF(0, device="meta"), tc, "layers", 3)
    for name in ("dt_bias", "a_log"):
        g = t_mamba2.mamba_layer_params(TPF(0, device=CPU), tc, "layers",
                                        3)[f"layers/{name}"]
        assert np.array_equal(g.numpy(), np.asarray(want[f"layers/{name}"]))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


# ---------------------------------------------------------------------------
# cache layouts, grafting, decode against forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_cache_layout_equals_reference(arch):
    jc, tc = _cfgs(arch)
    want = j_registry.build(jc).init_cache(3, 10)
    got = t_registry.build(tc, CPU).init_cache(3, 10)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape, arch
        assert str(g.dtype).split(".")[-1] == str(w.dtype), arch
        assert not g.to(torch.float32).any()


@pytest.mark.parametrize("arch", ["zamba2_7b", "whisper_small",
                                  "mamba2_2p7b", "olmoe_1b_7b"])
def test_graft_in_place_and_decode_continues_prefill(arch):
    """``_graft`` copies the prompt's self-attention K/V into the full
    cache and takes the rest of the prefill cache; decoding the next
    token from it equals the forward's logits at that position."""
    _, cfg = _cfgs(arch)
    m = t_registry.build(cfg, CPU)
    params, _ = m.init(1)
    rng = np.random.default_rng(30)
    B, P, G = 2, 6, 3
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P + G))
                            .astype(np.int32))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            0, 1, (B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
        ).bfloat16()
    full, _ = m.forward(params, batch)
    logits, pcache = m.prefill(params, dict(batch, tokens=toks[:, :P]))
    empty = m.init_cache(B, P + G)
    cache = t_serve._graft(cfg, empty, pcache, P)
    if cfg.family == "ssm":
        assert cache is pcache
    else:
        for full_kv, pre in zip(cache[:2], pcache[:2]):
            assert torch.equal(full_kv[:, :, :P], pre)
            assert not full_kv[:, :, P:].float().any()
        assert cache[0] is empty[0] and cache[1] is empty[1]
        assert all(c is p for c, p in zip(cache[2:], pcache[2:]))
    steps = [logits]
    for i in range(G - 1):
        lg, cache2 = m.decode(params, cache, toks[:, P + i:P + i + 1], P + i)
        assert all(a is b for a, b in zip(cache2, cache))   # in place
        steps.append(lg)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               full[:, P - 1:P + G - 1].numpy(),
                               atol=0.15, rtol=0.05)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_matches_forward(arch):
    """Decode logits token by token against the full forward's, within
    the reference's slack (tests/test_models.py)."""
    _, cfg = _cfgs(arch)
    m = t_registry.build(cfg, CPU)
    params, _ = m.init(3)
    rng = np.random.default_rng(5)
    B, S = 2, 8
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                            .astype(np.int32))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            0, 1, (B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
        ).bfloat16()
    full, _ = m.forward(params, batch)
    cache = m.init_cache(B, S)
    if cfg.family == "encdec":   # cross K/V from a 1-token prefill
        pc = m.prefill(params, dict(batch, tokens=toks[:, :1]))[1]
        cache = cache[:2] + pc[2:]
    dec = []
    for pos in range(S):
        lg, cache = m.decode(params, cache, toks[:, pos:pos + 1], pos)
        dec.append(lg)
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), full.numpy(),
                               atol=0.15, rtol=0.05)


def test_cross_attention_decode_sees_every_encoder_position():
    """encdec decode attends to all enc_ctx positions (pos = enc_ctx
    masks nothing), and a self-attention position past the cache is
    refused."""
    _, cfg = _cfgs("whisper_small")
    m = t_registry.build(cfg, CPU)
    params, _ = m.init(0)
    rng = np.random.default_rng(31)
    frames = torch.from_numpy(rng.normal(0, 1, (1, cfg.enc_ctx, cfg.d_model))
                              .astype(np.float32)).bfloat16()
    tok = torch.zeros((1, 1), dtype=torch.int32)
    _, pc = m.prefill(params, {"frames": frames, "tokens": tok})
    cache = m.init_cache(1, 2)[:2] + pc[2:]
    base, _ = m.decode(params, tuple(c.clone() for c in cache), tok, 0)
    last = [c.clone() for c in cache]
    last[2][:, :, -1] += 1.0            # the last encoder position's keys
    moved, _ = m.decode(params, tuple(last), tok, 0)
    assert not torch.equal(base, moved)
    with pytest.raises(ValueError, match="outside the cache"):
        m.decode(params, cache, tok, 2)
