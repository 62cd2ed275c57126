"""The port's dropless MoE and GraniteMoe's scalars, on the CPU, against
the benchmark's plain reference ``bench/reference/moe_lm.py`` (float32,
written from GraniteMoe's equations, imports nothing of the port).

  * ``moe_mlp`` on the dropless path: values and gradients at a small
    size with uneven expert loads and one empty expert;
  * reruns of the block are bit-identical;
  * a tiny granite's loss and gradients over 2 train steps, router jitter
    included (the reference makes the jitter words again from the step's
    seed with the plain generator);
  * prefill then decode against forward, with the scalars on; forward
    against the reference's logits.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import stream as tstream
from repro_torch.launch import steps
from repro_torch.models import moe, registry
from repro_torch.models.common import GraniteConfig, flatten

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

ARCH = dict(name="granite-tiny", family="moe", n_layers=2, d_model=128,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=384, act="silu",
            rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=True,
            n_experts=8, top_k=4, capacity_factor=0.0, moe_group=32,
            embedding_multiplier=12.0, attention_multiplier=0.03125,
            residual_multiplier=0.22, logits_scaling=6.0)
CFG = GraniteConfig(**ARCH)


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
def ref():
    """``bench/reference/moe_lm.py``, loaded by path (it imports the
    benchmark's other references as ``bench.reference``)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(
        "bench_moe_lm", ROOT / "bench" / "reference" / "moe_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def _weights(ref, arch, seed):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for path, shape in ref.moe_lm_leaves(arch):
        if path.endswith("norm"):
            out[path] = torch.zeros(shape)
        else:
            out[path] = torch.randn(shape, generator=g) * 0.02
    return out


def _block_case(seed=3, N=96):
    """(h (1, N, D) bf16, router, wg, wi, wo): every row's feature 0 is 4,
    which the router weighs -10 for expert 0 (it gets no row) and +0.5 for
    experts 1 and 2 (the loads are uneven)."""
    g = torch.Generator().manual_seed(seed)
    D, E, F = CFG.d_model, CFG.n_experts, CFG.d_ff
    h = torch.randn(1, N, D, generator=g)
    h[..., 0] = 4.0
    h = h.bfloat16()
    router = torch.randn(D, E, generator=g) * 0.3
    router[0] = 0.0
    router[0, 0], router[0, 1:3] = -10.0, 0.5
    ws = [torch.randn(E, D, F, generator=g) * 0.1,
          torch.randn(E, D, F, generator=g) * 0.1,
          torch.randn(E, F, D, generator=g) * 0.1]
    return h, router, ws


def _run_block(h, router, ws, rng):
    leaves = [x.clone().requires_grad_() for x in [h, router] + ws]
    y, aux = moe.moe_mlp(CFG, leaves[0], *leaves[1:], rng)
    r = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
    total = (y.float() * r).sum() + aux
    return y, aux, torch.autograd.grad(total, leaves), r


def test_dropless_block_matches_reference_with_an_empty_expert(ref):
    h, router, ws = _block_case()
    N = h.shape[1]
    rng = tstream.new_stream(11, 0, device=CPU)
    y, aux, grads, r = _run_block(h, router, ws, rng)

    # the loads: expert 0 empty, the others uneven
    probs, _ = moe.router_probs(h.reshape(1, N, -1), router, rng)
    _, top = moe.top_k(probs, CFG.top_k)
    loads = torch.bincount(top.reshape(-1), minlength=CFG.n_experts)
    assert loads[0] == 0 and len(set(loads[1:].tolist())) >= 4
    assert any(int(n) % moe.GROUP_ALIGN for n in loads)   # rows padded
    row, choice, ends = moe.dropless_plan(top.reshape(N, -1),
                                          CFG.n_experts)
    assert torch.equal(choice[row.reshape(-1)], torch.arange(row.numel()))
    assert int(ends[-1]) == choice.numel()
    # the jitter: the router's logits follow the reference's words for
    # this stream, and not those of another
    x = h.float().reshape(N, -1)
    got = moe.router_probs(h.reshape(1, N, -1), router, rng)[1][0]
    near = _rel(got, (x * ref.jitter_factor(rng.h, x.shape, CPU)) @ router)
    other = tstream.derive(rng, 1).h
    far = _rel(got, (x * ref.jitter_factor(other, x.shape, CPU)) @ router)
    assert near < 0.2 * far, (near, far)

    leaves = [x.detach().float().clone().requires_grad_()
              for x in [h, router] + ws]
    p = dict(zip(["router", "moe_wg", "moe_wi", "moe_wo"], leaves[1:]))
    factor = ref.jitter_factor(rng.h, (N, CFG.d_model), CPU)
    want, want_aux = ref.moe(ARCH, p, leaves[0].reshape(N, -1), factor,
                             "float32")
    want_total = (want.reshape(y.shape) * r).sum() + want_aux
    want_grads = torch.autograd.grad(want_total, leaves)
    assert _rel(y, want.reshape(y.shape)) < 1e-2
    assert abs(float(aux) - float(want_aux)) < 1e-3 * float(want_aux)
    for name, g, w in zip(["h", "router", "wg", "wi", "wo"], grads,
                          want_grads):
        assert _rel(g, w) < 3e-2, name
    # the empty expert's weights get no gradient
    assert all(float(g[0].abs().max()) == 0.0 for g in grads[2:])


def test_dropless_block_reruns_bit_identically():
    h, router, ws = _block_case(seed=4, N=128)
    rng = tstream.new_stream(12, 0, device=CPU)
    a = _run_block(h, router, ws, rng)
    b = _run_block(h, router, ws, rng)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


def test_dropless_drops_nothing_where_the_capacity_path_drops():
    h, router, ws = _block_case(seed=5, N=128)
    with moe.watch_drops() as drops:
        moe.moe_mlp(CFG, h, router, *ws, None)
        moe.moe_mlp(dataclasses.replace(CFG, capacity_factor=1.25), h,
                    router, *ws, None)
    assert int(drops[0]) == 0 and int(drops[1]) > 0


def _tree(flat_leaves):
    tree = {"layers": {}}
    for k, v in flat_leaves.items():
        if k.startswith("layers/"):
            tree["layers"][k.split("/", 1)[1]] = v
        else:
            tree[k] = v
    return tree


def test_tiny_granite_two_train_steps_match_reference(ref):
    """Losses within 1e-3; each leaf's gradient norm within 2 % and the
    gradient within 15 % (a token whose k-th and (k+1)-th router logits
    lie within bf16's rounding may pick another expert than the float32
    reference's: at this size a few tokens move a few % of an expert
    leaf's gradient)."""
    model = registry.build(CFG, device=CPU)
    params = _tree({k: v.clone() for k, v in _weights(ref, ARCH, 5).items()})
    from repro_torch.optim import adamw_init
    state = adamw_init(params)
    step_fn = steps.make_train_step(model, seed=0)
    root = tstream.new_stream(0, 0xD07, device=CPU)
    g = torch.Generator().manual_seed(6)
    for step in range(2):
        toks = torch.randint(0, ARCH["vocab"], (2, 33), generator=g)
        batch = {"tokens": toks[:, :-1].to(torch.int32),
                 "labels": toks[:, 1:].to(torch.int32)}
        rng = tstream.derive(root, step)
        (loss, _), grads = steps.value_and_grad(model, params, batch, rng)
        flat = {k: v.detach().clone().requires_grad_()
                for k, v in flatten(params).items()}
        want = ref.loss(ARCH, _tree(flat), batch["tokens"], batch["labels"],
                        step=step)
        want_g = torch.autograd.grad(want, list(flat.values()))
        want = float(want.detach())
        assert abs(float(loss) - want) < 1e-3 * want, step
        got_g = flatten(grads)
        for k, w in zip(flat, want_g):
            gap = abs(float(got_g[k].norm()) - float(w.norm()))
            assert gap < 2e-2 * float(w.norm()), (step, k)
            assert _rel(got_g[k], w) < 0.15, (step, k)
        params, state, m = step_fn(params, state, batch, step)
        assert float(m["loss"]) == float(loss)


def test_granite_prefill_then_decode_follows_forward(ref):
    model = registry.build(CFG, device=CPU)
    params = _tree(_weights(ref, ARCH, 7))
    toks = torch.randint(0, ARCH["vocab"], (2, 12),
                         generator=torch.Generator().manual_seed(8)
                         ).to(torch.int32)
    logits, _ = model.forward(params, {"tokens": toks})
    want = ref.logits_at(ARCH, params, toks, 0)
    assert _rel(logits, want) < 2e-2
    # without the scalars the logits differ far more than that
    plain = registry.build(dataclasses.replace(
        CFG, embedding_multiplier=None, attention_multiplier=None,
        residual_multiplier=None, logits_scaling=None), device=CPU)
    assert _rel(plain.forward(params, {"tokens": toks})[0], want) > 0.2
    P = 5
    last, (k, v) = model.prefill(params, {"tokens": toks[:, :P]})
    assert _rel(last, logits[:, P - 1]) < 1e-2
    cache = model.init_cache(2, toks.shape[1])
    cache[0][:, :, :P] = k
    cache[1][:, :, :P] = v
    for pos in range(P, toks.shape[1]):
        out, cache = model.decode(params, cache, toks[:, pos:pos + 1], pos)
        assert _rel(out, logits[:, pos]) < 1e-2, pos
