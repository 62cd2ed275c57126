"""Crush-lite battery: generators x tests -> a quality report.

``run_battery(profile=...)`` draws blocks through the port's delivery
surfaces - ``engine.generate`` on both backends and both decorrelator
modes, ``engine.generate_sharded`` (the mesh fan-out), leased
``runtime.blocks.BlockService`` windows and coalesced multi-tenant
``service.frontend`` requests - runs the Crush-lite tests
(``quality.crush``) per stream column with TestU01-style two-level
aggregation and the inter-stream cross-battery (``quality.cross``), and
returns one deterministic, machine-readable report of the reference's
schema (``report_json`` writes the reference's canonical bytes, and
either package's ``render`` renders either report).

The generator matrix is the reference's with the port's backends in
place of the reference's: ``torch`` (the plain tensor backend) stands
where the reference has ``ref`` / ``xla``, ``cuda`` (kernels A and B)
where it has ``pallas``.  Each ``cuda`` row has a ``torch`` twin that
draws the same bits, so on a card their statistics must agree exactly.
The leased, sharded and service rows draw through the battery's device
with the backend that device selects.  Every block is drawn on the
battery's device and comes to the host with one copy; the statistics
are float64 numpy on the host.

Verdicts, as in the paper's Table 3/4 ordering:

  * every ``thundering/*`` generator must PASS (intra and cross),
  * every ``dist/*`` generator - the fused distribution stages reduced to
    uniform words by the probability integral transform
    (``quality.pit``) - must PASS,
  * ``ablation/raw_lcg`` and ``ablation/no_deco`` must FAIL the
    cross-battery, and ``ablation/raw_lcg_pit`` (the raw LCG pushed
    through the exponential stage) must still fail through the PIT;
    the report's ``ok`` is true only when every generator behaves as
    expected.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import statistics as st
from repro_torch.quality import cross as cross_mod
from repro_torch.quality import crush

#: battery-wide thresholds (TestU01's "suspect" band, scaled to our block
#: counts): a test fails when its second-level aggregate rejects at
#: ``alpha`` or any single first-level p-value falls below ``hard``.
ALPHA_KS = 1e-3
ALPHA_POISSON = 1e-3
ALPHA_CROSS = 1e-4
HARD_P = 1e-9

DEFAULT_SEED = 20260726

#: where the CLI writes its report and rendered pages by default (an
#: ignored directory: the reference's committed report stays its own)
DEFAULT_OUT_DIR = "build/quality_torch"

#: shards of the sharded rows' mesh (cycled over the device's mesh)
SHARDS = 4


@dataclasses.dataclass(frozen=True)
class Profile:
    """One battery size: every test dimension is a pure function of it."""
    name: str
    intra_t: int        # words per stream column (first-level block)
    intra_s: int        # stream columns per generator (second-level N)
    cross_s: int        # streams in the cross-battery sweep
    cross_t: int        # words per stream in the cross-battery
    max_pairs: int      # interleaved pairs in the cross-battery


PROFILES: Dict[str, Profile] = {
    # the reference's committed-report profile
    "fast": Profile("fast", intra_t=4096, intra_s=32,
                    cross_s=1024, cross_t=2048, max_pairs=32),
    # seconds, still separates the ablations
    "tiny": Profile("tiny", intra_t=1024, intra_s=8,
                    cross_s=128, cross_t=1024, max_pairs=16),
    # SmallCrush-scale sample sizes; the cross-battery at the main
    # path's width, (4096, 2**14), rides the blocked Gram sweep
    "full": Profile("full", intra_t=16384, intra_s=64,
                    cross_s=16384, cross_t=4096, max_pairs=64),
}


# ---------------------------------------------------------------------------
# block sources
# ---------------------------------------------------------------------------

def _host(block: torch.Tensor) -> np.ndarray:
    """One copy of a drawn block to the host."""
    return block.cpu().numpy()


def _engine_block(seed: int, t: int, s: int, mode: str, deco: str,
                  backend: str, device) -> np.ndarray:
    """(T, S) uint32 through ``engine.generate`` on one backend."""
    from repro_torch.core import engine
    plan = engine.make_plan(seed=seed, num_streams=s, num_steps=t,
                            mode=mode, deco=deco, device=device)
    return _host(engine.generate(plan, backend=backend))


def _leased_block(seed: int, t: int, s: int, mode: str, deco: str,
                  device, n_windows: int = 4) -> np.ndarray:
    """(T, S) uint32 drawn as ``n_windows`` consecutive BlockService
    leases: disjoint counter-window accounting must hand back the same
    bits as one bulk ``engine.generate`` call (asserted here)."""
    from repro_torch.core import engine
    from repro_torch.runtime import blocks
    service = blocks.BlockService(seed, device=device)
    service.open("quality/intra", num_streams=s, mode=mode, deco=deco)
    step = t // n_windows
    lengths = [step] * (n_windows - 1) + [t - step * (n_windows - 1)]
    block = torch.cat([service.generate(service.lease("quality/intra", n))
                       for n in lengths], dim=0)
    plan = engine.make_plan(seed=seed, num_streams=s, num_steps=t,
                            mode=mode, deco=deco, device=device,
                            purpose=blocks.channel_purpose("quality/intra"))
    if not torch.equal(block.view(torch.int32),
                       engine.generate(plan).view(torch.int32)):
        raise AssertionError(
            "BlockService leased windows disagree with bulk generation")
    return _host(block)


def sharded_mesh(device):
    """The sharded rows' mesh: ``SHARDS`` shards over the device's default
    mesh, several of them on one card when it has fewer cards."""
    from repro_torch.core import engine
    devs = list(engine.default_mesh(device=device.type).devices.flat)
    return engine.Mesh.of([devs[k % len(devs)] for k in range(SHARDS)],
                          (SHARDS,), ("streams",))


def _sharded_block(seed: int, t: int, s: int, mode: str, deco: str,
                   device) -> np.ndarray:
    """(T, S) uint32 through the ``generate_sharded`` mesh fan-out."""
    from repro_torch.core import engine
    plan = engine.make_plan(seed=seed, num_streams=s, num_steps=t,
                            mode=mode, deco=deco, device=device)
    return _host(engine.generate_sharded(plan, mesh=sharded_mesh(device)))


def _service_block(seed: int, t: int, s: int, deco: str,
                   device) -> np.ndarray:
    """(T, S) uint32 drawn through the coalescing frontend.

    One single-column request per stream from ``s`` DISTINCT tenants,
    packed into one gathered-tag call.  Each response is checked against
    its journal replay (a stand-alone per-request ``engine.generate``),
    so the battery asserts that coalesced slices equal bulk generation."""
    from repro_torch.runtime import blocks
    from repro_torch.service import audit as audit_mod
    from repro_torch.service.frontend import Coalescer, RandRequest
    from repro_torch.service.tenants import TenantRegistry
    journal = audit_mod.Journal()
    service = blocks.BlockService(seed, device=device)
    co = Coalescer(service, TenantRegistry(), journal=journal, deco=deco,
                   max_rows=t)
    reqs = [RandRequest(tenant_id=f"quality/{j:04d}", shape=(t,),
                        rid=f"q{j:04d}") for j in range(s)]
    responses, _, errors = co.flush(reqs)
    if errors:
        raise AssertionError(f"service flush errors: {errors}")
    replayed = audit_mod.replay(journal, seed=seed, device=device)
    block = np.stack([responses[f"q{j:04d}"] for j in range(s)], axis=1)
    direct = np.stack([replayed[f"q{j:04d}"] for j in range(s)], axis=1)
    if not np.array_equal(block, direct):
        raise AssertionError(
            "coalesced service responses disagree with journal replay")
    return block


def _ablation_block(seed: int, t: int, s: int, kind: str,
                    device) -> np.ndarray:
    """(T, S) uint32 for the paper's Table 3/4 ablation baselines."""
    from repro_torch.core import baselines
    if kind == "raw_lcg":
        streams = baselines.raw_lcg_bits(seed, s, t, device=device)
    elif kind == "no_deco":
        streams = baselines.raw_lcg_bits(seed, s, t, permute=True,
                                         h_mode="adjacent", device=device)
    else:
        raise ValueError(f"unknown ablation {kind!r}")
    return _host(streams.T.contiguous())


def _dist_block(seed: int, t: int, s: int, spec: str, mode: str,
                backend: str, device) -> np.ndarray:
    """(T, S) uint32 PIT words for a distribution stage.

    Shaped samples come through ``engine.generate`` with the sampler
    stage fused in the plan, on the requested backend; the PIT's
    randomization bits come from an independent draw of the same family
    (engine purpose 1), as ``quality.pit`` requires.
    """
    from repro_torch.core import engine
    from repro_torch.quality import pit
    plan = engine.make_plan(seed=seed, num_streams=s, num_steps=t,
                            mode=mode, sampler=spec, device=device)
    x = _host(engine.generate(plan, backend=backend))
    vplan = engine.make_plan(seed=seed, num_streams=s, num_steps=t,
                             mode=mode, purpose=1, device=device)
    v = _host(engine.generate(vplan, backend=backend))
    return pit.pit_words(x, spec, v)


def _ablation_pit_block(seed: int, t: int, s: int, device) -> np.ndarray:
    """(T, S) uint32: raw-LCG bits pushed through the exponential stage
    and reduced by the PIT - the transform-laundering ablation, which
    must still FAIL the cross-battery."""
    from repro_torch.core import baselines, u64
    from repro_torch.core import sampler as sampler_mod
    from repro_torch.quality import pit
    bits = baselines.raw_lcg_bits(seed, s, t, device=device).T
    spec = sampler_mod.parse("exponential(1.0)")
    x = _host(sampler_mod.apply(u64.limbs(bits.contiguous()), spec,
                                "float32"))
    v = _host(baselines.raw_lcg_bits(seed ^ 0x9E3779B9, s, t,
                                     device=device).T.contiguous())
    return pit.pit_words(x, spec, v)


# ---------------------------------------------------------------------------
# two-level intra battery
# ---------------------------------------------------------------------------

def run_intra(block: np.ndarray) -> Dict:
    """Per-column Crush-lite tests over a (T, S) block, aggregated.

    Chi-square-family tests yield one p-value per stream column and a
    KS-uniformity second level; counting-family tests sum their Poisson
    counts over columns into a single two-sided Poisson tail.
    """
    t, s = block.shape
    tests: Dict[str, Dict] = {}
    for name in sorted(crush.CHI2_TESTS):
        fn = crush.CHI2_TESTS[name]
        ps = np.array([fn(np.ascontiguousarray(block[:, j]))
                       for j in range(s)])
        p_ks = st.ks_uniform_pvalue(ps)
        p_min = float(ps.min())
        tests[name] = {"agg": "ks", "n_blocks": s, "p_ks": p_ks,
                       "p_min": p_min,
                       "ok": p_ks >= ALPHA_KS and p_min >= HARD_P}
    for name in sorted(crush.POISSON_TESTS):
        fn = crush.POISSON_TESTS[name]
        counts, lam = 0, 0.0
        for j in range(s):
            c, l = fn(np.ascontiguousarray(block[:, j]))
            counts += c
            lam += l
        p = st.poisson_two_sided(counts, lam)
        tests[name] = {"agg": "poisson_sum", "n_blocks": s,
                       "count": counts, "mean": lam, "p": p,
                       "ok": p >= ALPHA_POISSON}
    return {"block_words": t, "num_blocks": s, "tests": tests,
            "ok": all(rep["ok"] for rep in tests.values())}


# ---------------------------------------------------------------------------
# generator configs
# ---------------------------------------------------------------------------

#: rows whose backend is the one the battery's device selects
DEVICE_BACKEND = "device"


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    name: str
    expect: str                   # "pass" | "fail"
    delivery: str                 # provenance string for the report
    kind: str = "engine"          # "engine" | "leased" | "sharded" |
                                  # "service" | "dist" | ablation
    mode: str = "ctr"
    deco: str = "splitmix64"
    backend: str = "torch"        # "torch" | "cuda" | DEVICE_BACKEND | "-"
    sampler: str = "bits"         # distribution spec for kind="dist"
    run_intra: bool = True
    run_cross: bool = False


#: the distribution stages the battery PIT-verifies (one spec per kind)
DIST_SPECS: tuple = ("exponential(1.5)", "poisson(3.5)", "gamma(2.5)",
                     "categorical[0.5,0.25,0.125,0.125]")


def battery_configs() -> List[GeneratorConfig]:
    """The acceptance matrix: thundering in both decorrelator modes on
    both backends (+ the fmix32 hash and the delivery layers), the
    distribution stages, and the ablations that must fail."""
    cfgs: List[GeneratorConfig] = []
    for mode in ("ctr", "faithful"):
        for backend in ("torch", "cuda"):
            cfgs.append(GeneratorConfig(
                name=f"thundering/{mode}/{backend}", expect="pass",
                kind="engine", mode=mode, backend=backend,
                delivery=f"engine.generate(backend={backend!r})"))
            if mode == "ctr" and backend == "torch":
                # the reference's xla/ctr row: BlockService leases, so
                # the battery also checks the delivery layer's accounting
                cfgs.append(GeneratorConfig(
                    name="thundering/ctr/leased", expect="pass",
                    kind="leased", mode=mode, backend=DEVICE_BACKEND,
                    delivery="runtime.blocks.BlockService (4 leased "
                             "windows, parity-checked vs bulk)"))
    for backend in ("torch", "cuda"):
        cfgs.append(GeneratorConfig(
            name=f"thundering/ctr-fmix32/{backend}", expect="pass",
            kind="engine", mode="ctr", deco="fmix32", backend=backend,
            delivery=f"engine.generate(backend={backend!r})"))
    for mode in ("ctr", "faithful"):
        cfgs.append(GeneratorConfig(
            name=f"thundering/{mode}/sharded", expect="pass", kind="sharded",
            mode=mode, backend=DEVICE_BACKEND, run_intra=False,
            run_cross=True,
            delivery=f"engine.generate_sharded (stream-axis mesh fan-out, "
                     f"{SHARDS} shards)"))
    cfgs.append(GeneratorConfig(
        name="thundering/ctr/service", expect="pass", kind="service",
        mode="ctr", backend=DEVICE_BACKEND, run_cross=True,
        delivery="service.frontend.Coalescer (one request per tenant, "
                 "replay parity-checked vs engine.generate)"))
    for spec in DIST_SPECS:
        dist = spec.split("(")[0].split("[")[0]
        for backend in ("torch", "cuda"):
            # the two analytically-invertible stages also run the
            # cross-battery (the PIT words must stay independent ACROSS
            # streams); the cuda twin runs what its torch row runs
            cfgs.append(GeneratorConfig(
                name=f"dist/{dist}/{backend}", expect="pass", kind="dist",
                mode="ctr", backend=backend, sampler=spec,
                run_cross=dist in ("exponential", "poisson"),
                delivery=f"engine.generate(sampler={spec!r}, "
                         f"backend={backend!r}) -> quality.pit"))
    for kind in ("raw_lcg", "no_deco"):
        cfgs.append(GeneratorConfig(
            name=f"ablation/{kind}", expect="fail", kind=kind,
            mode="-", deco="-", backend="-", run_cross=True,
            delivery="core.baselines.raw_lcg_bits"))
    cfgs.append(GeneratorConfig(
        name="ablation/raw_lcg_pit", expect="fail", kind="raw_lcg_pit",
        mode="-", deco="-", backend="-", sampler="exponential(1.0)",
        run_intra=False, run_cross=True,
        delivery="core.baselines.raw_lcg_bits -> sampler.apply"
                 "('exponential(1.0)') -> quality.pit"))
    return cfgs


def runs_on(cfg: GeneratorConfig, device: torch.device) -> bool:
    """Whether ``cfg`` can run on ``device``: a ``cuda`` row needs a card."""
    return cfg.backend != "cuda" or device.type == "cuda"


def _backend(cfg: GeneratorConfig, device: torch.device) -> str:
    if cfg.backend == DEVICE_BACKEND:
        return "cuda" if device.type == "cuda" else "torch"
    return cfg.backend


def _draw(cfg: GeneratorConfig, seed: int, t: int, s: int,
          device: torch.device) -> np.ndarray:
    if not runs_on(cfg, device):
        raise ValueError(f"generator {cfg.name!r} runs the cuda kernels "
                         f"and needs a CUDA device, not {device}")
    if cfg.kind == "engine":
        return _engine_block(seed, t, s, cfg.mode, cfg.deco, cfg.backend,
                             device)
    if cfg.kind == "leased":
        return _leased_block(seed, t, s, cfg.mode, cfg.deco, device)
    if cfg.kind == "sharded":
        return _sharded_block(seed, t, s, cfg.mode, cfg.deco, device)
    if cfg.kind == "service":
        return _service_block(seed, t, s, cfg.deco, device)
    if cfg.kind == "dist":
        return _dist_block(seed, t, s, cfg.sampler, cfg.mode, cfg.backend,
                           device)
    if cfg.kind == "raw_lcg_pit":
        return _ablation_pit_block(seed, t, s, device)
    return _ablation_block(seed, t, s, cfg.kind, device)


# ---------------------------------------------------------------------------
# running the battery
# ---------------------------------------------------------------------------

def _round_floats(obj, sig: int = 10):
    """Round every float to ``sig`` significant digits so the JSON stays
    byte-identical across BLAS/FFT builds (all test statistics reduce to
    integer counts; only derived tails carry float noise)."""
    if isinstance(obj, float):
        return float(f"{obj:.{sig}g}")
    if isinstance(obj, dict):
        return {k: _round_floats(v, sig) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_round_floats(v, sig) for v in obj]
    return obj


def run_battery(profile: str = "fast", *, seed: int = DEFAULT_SEED,
                generators: Optional[List[str]] = None,
                progress=None, device=None, timings=None) -> Dict:
    """Run the Crush-lite battery on ``device`` and return the report.

    ``device`` is the card unless the caller asks for the CPU; there only
    the rows that need no kernel run by default, and a ``cuda`` row named
    in ``generators`` raises (it never falls back to the plain backend).
    ``progress`` is an optional ``fn(str)`` callback; ``timings``, an
    optional dict, receives ``{name: {"draw_s": ..., "stats_s": ...}}``
    (host clock, the draw ending in its copy to the host).

    Example:
        >>> from repro_torch.quality import battery
        >>> rep = battery.run_battery(
        ...     "tiny", device="cpu",
        ...     generators=["thundering/ctr/torch", "ablation/raw_lcg"])
        >>> [g["as_expected"] for g in rep["generators"]]
        [True, True]
    """
    import time
    from repro_torch.core import engine
    device = engine.resolve_device(device)
    prof = PROFILES[profile]
    cfgs = battery_configs()
    if generators is not None:
        wanted = set(generators)
        unknown = wanted - {c.name for c in cfgs}
        if unknown:
            raise ValueError(f"unknown generators {sorted(unknown)}; "
                             f"have {[c.name for c in cfgs]}")
        cfgs = [c for c in cfgs if c.name in wanted]
    else:
        cfgs = [c for c in cfgs if runs_on(c, device)]
    gen_reports: List[Dict] = []
    for cfg in cfgs:
        if progress:
            progress(f"battery[{prof.name}] {cfg.name} ...")
        entry: Dict = {"name": cfg.name, "expect": cfg.expect,
                       "delivery": cfg.delivery, "mode": cfg.mode,
                       "deco": cfg.deco, "backend": _backend(cfg, device),
                       "sampler": cfg.sampler,
                       "intra": None, "cross": None}
        draw_s = stats_s = 0.0
        if cfg.run_intra:
            t0 = time.perf_counter()
            block = _draw(cfg, seed, prof.intra_t, prof.intra_s, device)
            t1 = time.perf_counter()
            entry["intra"] = run_intra(block)
            draw_s += t1 - t0
            stats_s += time.perf_counter() - t1
        if cfg.run_cross:
            t0 = time.perf_counter()
            block = _draw(cfg, seed, prof.cross_t, prof.cross_s, device)
            t1 = time.perf_counter()
            entry["cross"] = cross_mod.run_cross(
                np.ascontiguousarray(block.T), alpha=ALPHA_CROSS,
                hard=HARD_P, max_pairs=prof.max_pairs)
            draw_s += t1 - t0
            stats_s += time.perf_counter() - t1
        if timings is not None:
            timings[cfg.name] = {"draw_s": draw_s, "stats_s": stats_s}
        oks = [part["ok"] for part in (entry["intra"], entry["cross"])
               if part is not None]
        entry["ok"] = all(oks)
        entry["as_expected"] = entry["ok"] == (cfg.expect == "pass")
        gen_reports.append(entry)
    report = {
        "schema": 1,
        "suite": "crush-lite",
        "profile": prof.name,
        "seed": seed,
        "alpha": {"ks": ALPHA_KS, "poisson": ALPHA_POISSON,
                  "cross": ALPHA_CROSS, "hard": HARD_P},
        "sizes": dataclasses.asdict(prof),
        "tests": list(crush.ALL_TESTS)
                 + ["pairwise_sweep"]
                 + [f"interleaved/{n}" for n in sorted(cross_mod.PAIR_TESTS)],
        "generators": gen_reports,
        "ok": all(g["as_expected"] for g in gen_reports),
    }
    return _round_floats(report)


def report_json(report: Dict) -> str:
    """Canonical byte-stable serialization of a battery report."""
    return json.dumps(report, indent=2, sort_keys=True) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="fast", choices=sorted(PROFILES))
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--generators", default=None,
                    help="comma-separated generator names (default: every "
                         "row the device runs)")
    ap.add_argument("--out", default=f"{DEFAULT_OUT_DIR}/QUALITY_report.json")
    args = ap.parse_args(argv)
    gens = args.generators.split(",") if args.generators else None
    report = run_battery(args.profile, seed=args.seed, generators=gens,
                         progress=print, device=args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(report_json(report))
    status = "OK" if report["ok"] else "NOT AS EXPECTED"
    print(f"{args.out}: {status} "
          f"({sum(g['as_expected'] for g in report['generators'])}/"
          f"{len(report['generators'])} generators as expected)")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
