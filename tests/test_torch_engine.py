"""The port's engine and stream API against the reference.

The port's ``"torch"`` backend is held against ``repro``'s ``xla``
backend (bit-exact with its ``ref`` oracle and numpy golden by the
reference's own contract) at awkward shapes and counter offsets, in both
modes and with both decorrelators.  On the CPU the ``"cuda"`` backend
runs the kernel wrappers' plain versions, which take the kernels'
arguments (in-kernel root jumps, faithful row-tile start states), so the
tests hold that argument plumbing too.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as j_engine
from repro.core import stream as j_stream
from repro_torch import trace
from repro_torch.core import engine, sampler, stream
from repro_torch.kernels import thundering_block as tb

CPU = "cpu"
SHAPES = [(1, 1), (9, 3), (40, 130), (256, 512)]
OFFSETS = [0, 12345, 2 ** 32 + 7]
MODE_DECOS = [("ctr", "splitmix64"), ("ctr", "fmix32"),
              ("faithful", "splitmix64")]


def _np(x):
    """Port output -> numpy, bfloat16 as its uint16 bit pattern."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _jnp(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _plans(T, S, off, mode, deco, spec="bits", dtype="float32"):
    kw = dict(seed=29, num_streams=S, num_steps=T, offset=off, mode=mode,
              deco=deco, sampler=spec, out_dtype=dtype)
    return j_engine.make_plan(**kw), engine.make_plan(device=CPU, **kw)


def _golden(T, S, off, mode, deco):
    """The reference's numpy uint64 golden block, (T, S).  The golden model
    has no fmix32 decorrelator, so that one is composed from the same
    golden root sequence and ``repro.core.splitmix.ctr_decorrelator32_host``."""
    from repro.core import golden, lcg, splitmix
    tp = engine.make_plan(seed=29, num_streams=S, num_steps=T, offset=off,
                          device=CPU)
    h = (tp.h[0].numpy().astype(np.uint64) << np.uint64(32)) \
        | tp.h[1].numpy().astype(np.uint64)
    if deco == "splitmix64" or mode == "faithful":
        return golden.thundering_block(tp.x0, h, T, mode=mode, offset=off).T
    A, C = lcg.lcg_skip(off)
    roots = golden.lcg_seq((A * tp.x0 + C) % 2 ** 64, T)
    out = np.empty((T, S), np.uint32)
    for s in range(S):
        deco_s = [splitmix.ctr_decorrelator32_host(int(h[s]), off + t)
                  for t in range(T)]
        out[:, s] = golden.xsh_rr(roots + h[s]) ^ np.array(deco_s, np.uint32)
    return out


@pytest.mark.parametrize("mode,deco", MODE_DECOS)
@pytest.mark.parametrize("T,S", SHAPES)
def test_bits_match_reference(mode, deco, T, S):
    """Every offset against the reference's numpy golden model (held
    bit-exact to its xla / ref backends by the reference's own tests);
    ``test_bits_match_reference_xla`` adds the xla backend itself."""
    for off in OFFSETS:
        _, tp = _plans(T, S, off, mode, deco)
        want = _golden(T, S, off, mode, deco)
        got = engine.generate(tp)
        assert got.dtype == torch.uint32
        assert np.array_equal(_np(got), want), (mode, deco, T, S, off)
        assert np.array_equal(_np(engine.generate(tp, backend="cuda")),
                              want), ("wrapper plain", mode, deco, T, S, off)


@pytest.mark.parametrize("mode,deco", MODE_DECOS)
def test_bits_match_reference_xla(mode, deco, reference_stages):
    T, S, off = STAGE_SHAPE
    _, tp = _plans(T, S, off, mode, deco)
    assert np.array_equal(_np(engine.generate(tp)),
                          reference_stages["bits", mode, deco])


SPECS = ["uniform", "normal", "bernoulli(0.3)", "exponential(1.5)",
         "poisson(3.5)", "gamma(2.5)", "gamma(3.0,0.5)", "gumbel",
         "categorical[0.5,0.25,0.125,0.125]"]
LOG_STAGES = ("normal", "exponential", "gamma", "gumbel")
SPEC_DTYPES = [(s, d) for s in SPECS for d in ("float32", "bfloat16")
               if not (s.startswith("bernoulli") and d == "bfloat16")]
STAGE_SHAPE = (40, 130, 2 ** 32 + 7)


@pytest.fixture(scope="module")
def reference_stages():
    """Every stage of the reference's xla backend at STAGE_SHAPE, computed
    in one pass: the bit block of each (mode, deco) through
    ``sampler.apply(..., barrier=True)``, which is that backend's stage."""
    from repro.core import sampler as j_sampler
    T, S, off = STAGE_SHAPE
    out = {}
    for mode, deco in MODE_DECOS:
        jp, _ = _plans(T, S, off, mode, deco)
        bits = j_engine.generate(jp, backend="xla")
        out["bits", mode, deco] = np.asarray(bits)
        for spec, dtype in SPEC_DTYPES:
            out[spec, dtype, mode, deco] = np.asarray(j_sampler.apply(
                bits, j_sampler.parse(spec), dtype, barrier=True))
    jp, _ = _plans(T, S, off, "faithful", "splitmix64", "normal")
    out["direct"] = np.asarray(j_engine.generate(jp, backend="xla"))
    return out


def test_reference_stage_pass_is_the_xla_backend(reference_stages):
    assert np.array_equal(
        reference_stages["direct"],
        reference_stages["normal", "float32", "faithful", "splitmix64"])


@pytest.mark.parametrize("mode,deco", MODE_DECOS)
@pytest.mark.parametrize("spec,dtype", SPEC_DTYPES)
def test_sampler_stages_match_reference(spec, dtype, mode, deco,
                                        reference_stages):
    T, S, off = STAGE_SHAPE
    _, tp = _plans(T, S, off, mode, deco, spec, dtype)
    ref = reference_stages[spec, dtype, mode, deco]
    for backend in ("torch", "cuda"):
        got = engine.generate(tp, backend=backend)
        assert got.shape == ref.shape
        if spec.startswith(LOG_STAGES):
            want = torch.from_numpy(ref.astype(np.float32)).to(got.dtype)
            err = sampler.ulp_error(got, want)
            assert float(err.max()) <= 8.0, (spec, backend)
        else:
            assert np.array_equal(_np(got), _jnp(ref)), (spec, backend)


@pytest.mark.parametrize("mode", ["ctr", "faithful"])
def test_generate_windows_matches_stacked_and_reference(mode):
    jp, tp = _plans(10, 33, 12345, mode, "splitmix64")
    stacked = torch.stack([engine.generate(engine.shift_plan(tp, w * 10))
                           for w in range(3)])
    for backend in ("torch", "cuda"):
        got = engine.generate_windows(tp, 3, backend=backend)
        assert tuple(got.shape) == (3, 10, 33)
        assert torch.equal(got.view(torch.int32), stacked.view(torch.int32))
    want = _jnp(j_engine.generate_windows(jp, 3, backend="xla"))
    assert np.array_equal(_np(stacked), want)


def test_generate_windows_normal_pairs_per_window():
    _, tp = _plans(6, 20, 3, "ctr", "splitmix64", "normal")
    wide = engine.generate_windows(tp, 4, backend="cuda")
    for w in range(4):
        one = engine.generate(engine.shift_plan(tp, w * 6))
        assert torch.equal(wide[w], one)


@pytest.mark.parametrize("mode", ["ctr", "faithful"])
def test_plan_from_arrays_resumes_reference_plan(mode):
    jp = j_engine.make_plan(seed=77, num_streams=21, num_steps=16,
                            offset=2 ** 32 + 99, mode=mode, sampler="uniform")
    want = _jnp(j_engine.generate(jp, backend="xla"))
    tp = engine.plan_from_arrays(
        *(np.asarray(a) for a in (*jp.x0, *jp.h, *jp.ctr)),
        num_steps=jp.num_steps, mode=jp.mode, deco=jp.deco,
        sampler=jp.sampler, out_dtype=jp.out_dtype, device=CPU)
    assert np.array_equal(_np(engine.generate(tp)), want)


def test_pallas_interpret_ctr_case():
    """One small case against the reference's Pallas kernel in interpret
    mode (ctr mode; the reference's faithful Pallas path is not used)."""
    jp, tp = _plans(40, 130, 12345, "ctr", "splitmix64", "uniform")
    want = _jnp(j_engine.generate(jp, backend="pallas"))
    assert np.array_equal(_np(engine.generate(tp, backend="cuda")), want)


def test_engine_validation_and_dispatch():
    _, tp = _plans(5, 4, 0, "ctr", "splitmix64")
    assert engine.select_backend(tp) == "torch"
    assert set(engine.available_backends()) == {"torch", "cuda"}
    with pytest.raises(ValueError, match="even T"):
        engine.sample(tp, sampler="normal")
    with pytest.raises(ValueError, match="unknown backend"):
        engine.generate(tp, backend="pallas")
    with pytest.raises(ValueError, match="unknown mode"):
        engine.generate(dataclasses.replace(tp, mode="other"))
    with pytest.raises(ValueError, match="unknown deco"):
        engine.generate(dataclasses.replace(tp, deco="other"))
    with pytest.raises(ValueError, match="num_windows"):
        engine.generate_windows(tp, 0)
    with pytest.raises(ValueError, match="S=1"):
        engine.generate_flat(tp)


def test_generate_into_out_buffer():
    _, tp = _plans(8, 6, 40, "faithful", "splitmix64", "uniform")
    out = torch.empty((8, 6), dtype=torch.float32)
    res = engine.generate(tp, backend="cuda", out=out)
    assert res is out and torch.equal(out, engine.generate(tp))
    with pytest.raises(ValueError, match="out must be"):
        engine.generate(tp, backend="cuda",
                        out=torch.empty((8, 6), dtype=torch.bfloat16))


def test_wrappers_count_no_launch_on_cpu():
    trace.reset_counters("thundering_")
    _, tp = _plans(4, 3, 0, "ctr", "splitmix64")
    engine.generate(tp, backend="cuda")
    assert trace.counter("thundering_ctr.launches") == 0
    assert trace.counter("thundering_ctr_plain.cuda_runs") == 0


# Families from seeds {0, 7, 2**63 + 5} x purposes {0, 3}: leaf offsets
# with the top bit set among them.
LEAF_FAMILIES = [engine.family_from_seed(seed, purpose)[1]
                 for seed in (0, 7, 2 ** 63 + 5) for purpose in (0, 3)]


@pytest.mark.parametrize("S", [1, 7, 257])
@pytest.mark.parametrize("h_family", LEAF_FAMILIES[:2] + LEAF_FAMILIES[-1:])
def test_leaf_table_equals_derive_leaf_host(h_family, S):
    hi, lo = engine.leaf_table(h_family, S, CPU)
    assert hi.dtype == lo.dtype == torch.int64 and hi.shape == (S,)
    got = [(int(a) << 32) | int(b) for a, b in zip(hi, lo)]
    assert got == [engine.derive_leaf_host(h_family, s) for s in range(S)]


def test_leaf_table_takes_the_plain_version_on_cpu():
    trace.reset_counters("leaf_table")
    tables = trace.counter("engine.leaf_tables")
    h_fam = LEAF_FAMILIES[-1]
    got = engine.leaf_table(h_fam, 33, torch.device(CPU))
    want = tb.leaf_table_plain(h_fam, 33)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert trace.counter("engine.leaf_tables") == tables + 1
    assert trace.counter("leaf_table.launches") == 0
    assert trace.counter("leaf_table_plain.cuda_runs") == 0


def test_leaf_table_of_no_streams_is_empty():
    for table in (engine.leaf_table(LEAF_FAMILIES[0], 0, CPU),
                  tb.leaf_table(LEAF_FAMILIES[0], 0)):
        assert [(t.dtype, tuple(t.shape)) for t in table] == \
            [(torch.int64, (0,))] * 2


def test_faithful_tile_rows_are_even():
    assert tb.tile_rows(256, 4096) == 256
    assert tb.tile_rows(256, 9) == 10
    assert tb.tile_rows(7, 100) == 6
    assert tb.tile_rows(256, 1) == 2


# ---------------------------------------------------------------------------
# stream API
# ---------------------------------------------------------------------------

def _jstream(seed, sid=0):
    return j_stream.new_stream(seed, sid)


def _tstream(seed, sid=0):
    return stream.new_stream(seed, sid, device=CPU)


def test_stream_draws_match_reference():
    """Every draw is 40 elements (normals: 39, drawn as 40), so the
    reference compiles one single-stream plan shape."""
    js, ts = _jstream(7), _tstream(7)
    js2, ts2 = j_stream.advance(js, 2 ** 32 + 5), stream.advance(ts, 2 ** 32 + 5)
    assert np.array_equal(_np(stream.random_bits(ts2, (5, 8))),
                          _jnp(j_stream.random_bits(js2, (5, 8))))
    assert np.array_equal(_np(stream.uniforms(ts, (40,))),
                          _jnp(j_stream.uniforms(js, (40,))))
    assert np.array_equal(
        _np(stream.uniforms(ts, (40,), dtype=torch.bfloat16)),
        _jnp(j_stream.uniforms(js, (40,), dtype=jnp.bfloat16)))
    z = stream.normals(ts, (39,))
    assert z.shape == (39,)
    ref = torch.from_numpy(np.array(j_stream.normals(js, (39,))))
    assert float(sampler.ulp_error(z, ref).max()) <= 8.0
    assert np.array_equal(_np(stream.uniform(ts, (40,), minval=2.0,
                                             maxval=3.0)),
                          _jnp(j_stream.uniform(js, (40,), minval=2.0,
                                                maxval=3.0)))
    assert np.array_equal(_np(stream.bernoulli(ts, 0.3, (40,))),
                          _jnp(j_stream.bernoulli(js, 0.3, (40,))))
    p = np.float32(0.7)
    assert np.array_equal(
        _np(stream.bernoulli(ts, torch.tensor(p), (40,))),
        _jnp(j_stream.bernoulli(js, jnp.asarray(p), (40,))))
    g = stream.gumbel(ts, (40,))
    gref = torch.from_numpy(np.array(j_stream.gumbel(js, (40,))))
    assert float(sampler.ulp_error(g, gref).max()) <= 8.0
    n = stream.normal(ts, (40,))
    nref = torch.from_numpy(np.array(j_stream.normal(js, (40,))))
    assert float(sampler.ulp_error(n, nref).max()) <= 8.0
    logits = np.random.default_rng(3).normal(size=(4, 10)).astype(np.float32)
    assert np.array_equal(
        stream.categorical(ts, torch.from_numpy(logits)).numpy(),
        np.asarray(j_stream.categorical(js, jnp.asarray(logits))))


def test_stream_derive_split_advance_match_reference():
    js, ts = _jstream(42, 3), _tstream(42, 3)
    for tag in (0, 5, 2 ** 40 + 1):
        jd, td = j_stream.derive(js, tag), stream.derive(ts, tag)
        assert td.h == (int(jd.h_hi) << 32 | int(jd.h_lo))
        assert td.x0 == (int(jd.x0_hi) << 32 | int(jd.x0_lo))
    jk, tk = j_stream.split(js, 3), stream.split(ts, 3)
    assert [k.h for k in tk] == [int(k.h_hi) << 32 | int(k.h_lo) for k in jk]
    a = stream.random_bits(ts, (6,))
    b = stream.random_bits(stream.advance(ts, 2), (4,))
    assert torch.equal(a[2:], b)


def test_bulk_column_equals_derived_stream():
    """docs/architecture.md invariant 2: column s of a bulk block is
    random_bits of the stream derived from the family with tag s."""
    plan = engine.make_plan(seed=42, num_streams=6, num_steps=17,
                            offset=0, device=CPU)
    block = engine.generate(plan)
    fam = _tstream(42, 0)
    for s in (0, 3, 5):
        col = stream.random_bits(stream.derive(fam, s), (17,))
        assert torch.equal(col, block[:, s])


def test_root_and_ctr_rows_match_reference():
    off = 2 ** 32 - 3                      # the counter rows carry into hi
    roots, rows = engine.root_and_ctr_rows(0xABCDEF0123456789, off, 9)
    j_roots, j_rows = j_engine.root_and_ctr_rows(
        tuple(jnp.uint32(v) for v in (0xABCDEF01, 0x23456789)),
        tuple(jnp.uint32(v) for v in ((off >> 32), off & 0xFFFFFFFF)), 9)
    for got, want in zip((*roots, *rows), (*j_roots, *j_rows)):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


# ---------------------------------------------------------------------------
# stream.normal: XLA's ErfInv32 in float32 tensor ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 123])
def test_stream_normal_large_draw_within_slack_of_reference(seed):
    """2**16 normals: enough draws with |u| > 0.999, where torch's own
    ``erfinv`` was up to 91 ULP from the reference's ``lax.erf_inv``."""
    js, ts = _jstream(seed), _tstream(seed)
    n = 2 ** 16
    got = stream.normal(ts, (n,))
    want = torch.from_numpy(np.array(j_stream.normal(js, (n,))))
    err = sampler.ulp_error(got, want)
    print(f"stream.normal seed {seed}: max ulp_error {float(err.max())}, "
          f"bit-equal {float((err == 0).float().mean()):.4f}")
    assert float(err.max()) <= 8.0
    assert got.dtype == torch.float32 and got.shape == (n,)


def test_erf_inv32_sweep_near_one_within_slack_of_reference():
    import jax
    edge = np.float32(1.0) - np.float32(1e-7)
    near = edge - np.arange(1 << 14, dtype=np.float32) * np.float32(6e-8)
    u = np.concatenate([near, -near, np.linspace(
        -edge, edge, 1 << 16, dtype=np.float32)]).astype(np.float32)
    got = stream.erf_inv32(torch.from_numpy(u))
    want = torch.from_numpy(np.array(jax.lax.erf_inv(jnp.asarray(u))))
    err = sampler.ulp_error(got, want)
    print(f"erf_inv32 sweep: max ulp_error {float(err.max())}")
    assert float(err.max()) <= 8.0
    assert bool((torch.sign(got) == torch.sign(torch.from_numpy(u))).all())


# ---------------------------------------------------------------------------
# generate_sharded: columns split over a mesh of devices
# ---------------------------------------------------------------------------

MESHES = [((1,), ("streams",)), ((2,), ("streams",)), ((3,), ("streams",)),
          ((2, 2), ("hosts", "streams"))]


def _cpu_mesh(shape, names):
    return engine.Mesh.of([CPU] * int(np.prod(shape)), shape, names)


@pytest.mark.parametrize("S", [7, 24, 130])
@pytest.mark.parametrize("mode,deco", MODE_DECOS)
@pytest.mark.parametrize("mesh_shape,names", MESHES,
                         ids=["1", "2", "3", "2x2"])
def test_generate_sharded_equals_reference(mesh_shape, names, mode, deco, S):
    """Faithful at S not divisible by the shard count is the case where a
    shard built from its own S_loc lanes would draw the wrong bits."""
    jp, tp = _plans(9 if mode == "ctr" else 10, S, 2 ** 32 + 7, mode, deco)
    mesh = _cpu_mesh(mesh_shape, names)
    got = engine.generate_sharded(tp, mesh=mesh, axis_names=names)
    assert np.array_equal(_np(got), _jnp(j_engine.generate(jp, backend="xla")))


@pytest.mark.parametrize("spec,dtype", [("uniform", "bfloat16"),
                                        ("normal", "float32"),
                                        ("poisson(3.5)", "float32")])
def test_generate_sharded_float_stages_equal_generate(spec, dtype):
    _, tp = _plans(8, 11, 5, "faithful", "splitmix64", spec, dtype)
    mesh = _cpu_mesh((3,), ("streams",))
    assert np.array_equal(_np(engine.generate_sharded(tp, mesh=mesh)),
                          _np(engine.generate(tp)))


def test_generate_sharded_replicated_axis_and_default_mesh():
    _, tp = _plans(6, 13, 0, "ctr", "splitmix64")
    want = _np(engine.generate(tp))
    # the "hosts" axis is not named: its shards are replicas
    mesh = _cpu_mesh((2, 3), ("hosts", "streams"))
    assert np.array_equal(_np(engine.generate_sharded(tp, mesh=mesh)), want)
    assert mesh.shard_devices(("streams",)) == [torch.device(CPU)] * 3
    assert np.array_equal(_np(engine.generate_sharded(tp)), want)
    assert engine.default_mesh(device=CPU).shape == {"streams": 1}


def test_generate_sharded_axis_validation_matches_reference():
    import jax
    from jax.sharding import Mesh as JMesh
    jp, tp = _plans(4, 6, 0, "ctr", "splitmix64")
    jmesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                  ("hosts", "streams"))
    tmesh = _cpu_mesh((1, 1), ("hosts", "streams"))
    for kw in (dict(axis_names=("hosts", "model")), dict(axis_name="data")):
        with pytest.raises(ValueError) as j_err:
            j_engine.generate_sharded(jp, mesh=jmesh, **kw)
        with pytest.raises(ValueError) as t_err:
            engine.generate_sharded(tp, mesh=tmesh, **kw)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError) as j_err:
        j_engine.generate_sharded(jp, axis_names=("hosts", "streams"))
    with pytest.raises(ValueError) as t_err:
        engine.generate_sharded(tp, axis_names=("hosts", "streams"))
    assert str(t_err.value) == str(j_err.value) == \
        "axis_names requires an explicit mesh"
    with pytest.raises(ValueError, match="axis names"):
        engine.Mesh.of([CPU, CPU], (2,), ("a", "b"))


def test_generate_lane_override_is_a_column_slice_of_the_global_table():
    _, wide = _plans(8, 12, 2 ** 32 + 7, "faithful", "splitmix64")
    want = engine.generate(wide)
    lanes = tb.lane_states(12, torch.device(CPU))[:, 4:9].contiguous()
    part = dataclasses.replace(wide, h=(wide.h[0][4:9], wide.h[1][4:9]))
    for backend in ("torch", "cuda"):
        got = engine.generate(part, backend=backend, lanes=lanes)
        assert torch.equal(got.view(torch.int32), want[:, 4:9].view(torch.int32))
    assert not torch.equal(engine.generate(part).view(torch.int32),
                           want[:, 4:9].view(torch.int32))
