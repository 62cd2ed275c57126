"""Dry run: what each (arch x shape) cell holds per device on the
production meshes, without allocating it.

The reference lowers and compiles every cell with XLA on 512 forced host
devices and reads XLA's memory and cost analyses.  The port compiles
nothing.  ``lower_cell`` builds the model on ``meta``
(``registry.build(cfg, "meta")``: shapes and dtypes, no storage, no
draw), resolves the reference's partition specs (``models/sharding.py``)
on ``make_production_mesh(device="meta")`` and counts each device's
argument bytes: parameters (+ AdamW's ``m`` and ``v`` for a train cell),
inputs and decode cache, each leaf's bytes divided by the product of its
assigned axes' sizes.  Those bytes are a lower bound of a device's
memory: the temporaries and outputs that only a compile can size are not
in them, and the report's keys that only a compile fills (XLA's other
memory sizes, its cost and collectives) hold ``None``.  The reference's
``_fit_layers`` / ``_fit_cfg`` exist only to correct XLA's count of a
loop body once per loop; with no compile there is nothing to correct,
so the port has neither.

``rng_fanout_cell`` runs the RNG block fan-out over a production-shaped
mesh of one device (the card by default): every shard is one
``generate`` of its columns, so the fan-out has no collective by
construction, and the gathered block must equal one ``generate`` bit
for bit.  ``service_cell`` fires the reference's in-process RandService
burst, on the card by default.

    python -m repro_torch.launch.dryrun --all --both-meshes
    python -m repro_torch.launch.dryrun --rng-fanout --both-meshes
    python -m repro_torch.launch.dryrun --service
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, input_specs,
                                 shape_skipped)
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.analysis import _COLLECTIVES, HBM_BW, PEAK_FLOPS
from repro_torch.launch.mesh import make_production_mesh, rng_axes
from repro_torch.models import registry
from repro_torch.models import sharding
from repro_torch.models.common import flatten

NOTE = ("memory.argument_size_in_bytes counts each device's parameters "
        "(+ optimizer state), inputs and cache under the partition specs: "
        "a lower bound of a device's memory (no compile sizes the "
        "temporaries and outputs; every key only a compile fills is null)")

# the keys of the reference's memory report that only a compile fills
_COMPILED_MEMORY = ("output_size_in_bytes", "temp_size_in_bytes",
                    "alias_size_in_bytes", "generated_code_size_in_bytes",
                    "total_bytes_per_device")


def _leaves(tree):
    """Leaves of nested dicts / tuples (an ``AdamWState`` too)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def count_params(shapes_tree) -> int:
    total = 0
    for x in _leaves(shapes_tree):
        n = 1
        for d in x.shape:
            n *= int(d)
        total += n
    return total


def active_params(cfg, params_shapes) -> int:
    """MoE-aware active parameter count for MODEL_FLOPS = 6*N_active*D."""
    total = 0
    for path, leaf in flatten(params_shapes).items():
        n = 1
        for d in leaf.shape:
            n *= d
        if "moe_" in path and cfg.n_experts:
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return total


def np_prod(t) -> int:
    out = 1
    for v in t:
        out *= int(v)
    return out


def model_flops_from_counts(cfg, n_active: int, shape_name: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N MoE-active."""
    spec = SHAPES[shape_name]
    if spec.kind == "train":
        return 6.0 * n_active * spec.global_batch * spec.seq_len
    if spec.kind == "prefill":
        return 2.0 * n_active * spec.global_batch * spec.seq_len
    return 2.0 * n_active * spec.global_batch  # decode: 1 token/sequence


def _device_bytes(t: torch.Tensor, spec, mesh) -> int:
    """Bytes of one device's shard of ``t`` under ``spec``."""
    split = math.prod(sharding._axsize(mesh, ax) for ax in spec
                      if ax is not None)
    return t.numel() * t.element_size() // split


def argument_bytes(model: registry.Model, batch_specs: Dict[str, Any],
                   mesh, kind: str,
                   param_dtype: Optional[torch.dtype] = None
                   ) -> Dict[str, int]:
    """Each device's argument bytes of one ``kind`` step ("train",
    "prefill" or "decode") of ``model`` (built on ``meta``) on ``mesh``:
    {"params", "opt_state", "inputs", "cache", "total"}.

    ``param_dtype``: the dtype float32 parameters are held in (None keeps
    float32).  A train step also holds AdamW's ``m`` and ``v`` like the
    parameters, its replicated int32 step, and the step's own int32
    argument (counted in "inputs"); its parameters are sharded in train
    mode (FSDP), the others in serve mode.
    """
    params, specs = model.init(0)
    flat = flatten(params)
    if param_dtype is not None:
        flat = {k: v.to(param_dtype) if v.dtype == torch.float32 else v
                for k, v in flat.items()}
    train = kind == "train"
    pspecs = sharding.param_pspecs(specs, flat, mesh,
                                   "train" if train else "serve")
    out = {"params": sum(_device_bytes(v, pspecs[k], mesh)
                         for k, v in flat.items())}
    out["opt_state"] = 2 * out["params"] + 4 if train else 0
    bshard = steps_mod.batch_sharding(model.cfg, batch_specs, mesh)
    out["inputs"] = 4 if train else 0
    out["cache"] = 0
    for name, spec in batch_specs.items():
        if name == "cache":
            out["cache"] = sum(_device_bytes(t, s, mesh) for t, s in
                               zip(spec, bshard["cache"]))
        else:
            out["inputs"] += _device_bytes(spec, bshard[name], mesh)
    out["total"] = sum(out.values())
    return out


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               fit_costs: bool = True,
               overrides: Optional[Dict[str, Any]] = None,
               param_dtype: Optional[str] = None) -> Dict[str, Any]:
    """The report of one (arch x shape x mesh) cell, on shapes alone.

    Serve cells hold bf16 parameters, train cells float32 masters and
    AdamW's ``m`` and ``v`` (the reference's ``_compile_cell``).  The
    roofline: ``compute_s`` = model flops per chip / ``PEAK_FLOPS``,
    ``memory_s`` = argument bytes per device / ``HBM_BW`` (one read of
    every argument, a lower bound).  ``fit_costs`` and ``param_dtype``
    take the reference's values and change nothing here: there is no
    cost fit, and a bf16 train step keeps float32 masters as its
    arguments.
    """
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    skip = shape_skipped(cfg, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "skipped": skip}

    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    n_chips = int(np_prod(mesh.devices.shape))
    spec = SHAPES[shape_name]
    report: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "kind": spec.kind,
        "mesh": "x".join(str(s) for s in mesh.devices.shape),
        "chips": n_chips, "lower_s": None, "compile_s": None,
    }
    model = registry.build(cfg, "meta")
    params, _ = model.init(0)
    report["n_params"] = count_params(params)
    report["n_params_active"] = active_params(cfg, params)
    args = argument_bytes(
        model, input_specs(cfg, shape_name, model), mesh, spec.kind,
        None if spec.kind == "train" else torch.bfloat16)
    report["memory"] = {"argument_size_in_bytes": args["total"],
                        **{k: None for k in _COMPILED_MEMORY}}
    report["arguments"] = args
    report["cost_raw"] = None
    report["collectives_raw"] = None
    report["hlo_lines"] = None
    report["cost_fit"] = None
    mf = model_flops_from_counts(cfg, report["n_params_active"], shape_name)
    report["roofline"] = {
        "compute_s": mf / n_chips / PEAK_FLOPS,
        "memory_s": args["total"] / HBM_BW,
        "collective_s": None,
        "model_flops_total": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flops_ratio": None,
    }
    terms = {k: report["roofline"][k] for k in ("compute_s", "memory_s")}
    report["roofline"]["bottleneck"] = max(terms, key=terms.get)
    report["note"] = NOTE
    return report


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
    t = as_int[a.element_size()]
    return torch.equal(a.view(t), b.view(t))


def rng_fanout_cell(*, multi_pod: bool = False, num_streams: int = 2 ** 14,
                    num_steps: int = 256, device=None) -> Dict[str, Any]:
    """The RNG block fan-out over a production-shaped mesh whose every
    entry is ``device`` (the card by default).

    The (host, stream) layout of ``engine.generate_sharded`` over ALL
    mesh axes: each of the 256 / 512 shards is one ``generate`` of its
    column slice from the replicated root (counter addressing - the
    paper's "no extra root hardware per instance"), so there is no
    collective by construction.  Reports per sampler the shard count, the
    bytes of one shard, the wall ms of the fan-out and whether the
    gathered block equals one ``generate`` bit for bit.
    """
    from repro_torch.core import engine

    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    dev = mesh.devices.flat[0]
    axes = rng_axes(mesh)
    n_chips = int(np_prod(mesh.devices.shape))
    report: Dict[str, Any] = {
        "kind": "rng_fanout",
        "mesh": "x".join(str(s) for s in mesh.devices.shape),
        "axes": list(axes), "chips": n_chips, "device": str(dev),
        "num_streams": num_streams, "num_steps": num_steps,
    }
    n_shards = len(mesh.shard_devices(axes))
    for sampler, out_dtype in (("bits", "float32"), ("uniform", "bfloat16")):
        plan = engine.make_plan(seed=7, num_streams=num_streams,
                                num_steps=num_steps, sampler=sampler,
                                out_dtype=out_dtype, device=dev)
        want = engine.generate(plan)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        got = engine.generate_sharded(plan, mesh=mesh, axis_names=axes)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        coll = {k: 0 for k in _COLLECTIVES}
        coll["total"] = 0
        report[sampler] = {
            "out_dtype": str(got.dtype).replace("torch.", ""),
            "shards": n_shards,
            "bytes_per_shard": (num_steps * -(-num_streams // n_shards)
                                * got.element_size()),
            "collective_bytes": coll,
            "wall_ms": wall_ms,
            "equal_to_generate": _same_bits(got, want),
        }
    return report


def service_cell(*, burst: int = 192, tenants: int = 96,
                 seed: int = 11, device=None) -> Dict[str, Any]:
    """In-process RandService burst, on the card by default.

    The serving analogue of ``rng_fanout_cell``: fires a deterministic
    mixed (shape, sampler, dtype) burst through the coalescing frontend
    + standing pool, then asserts the acceptance properties — zero
    counter-window overlap (ledger-verified on both the live service
    and the journal) and bit-identical journal replay — and reports
    requests/s, p50/p99 latency and the coalescing factor.
    """
    from repro_torch.service import (Journal, RandServer, ServerConfig,
                                     replay, verify_ledger_disjoint)
    from repro_torch.service.audit import response_digest
    from repro_torch.service.burst import make_requests, run_burst

    journal = Journal()
    server = RandServer(seed, config=ServerConfig(
        max_batch=64, max_delay_s=0.25,
        hot_classes=(("uniform", "float32"),)), journal=journal,
        device=device)
    t0 = time.time()
    responses = run_burst(server, make_requests(
        burst=burst, tenants=tenants, seed=seed))
    wall_s = time.time() - t0
    stats = server.stats()
    windows = verify_ledger_disjoint(server.block_service)
    verify_ledger_disjoint(journal)
    digest = response_digest(responses)
    replay_ok = response_digest(replay(journal, seed=seed,
                                       device=server.device)) == digest
    server.shutdown()
    return {
        "kind": "service", "burst": burst, "tenants": tenants,
        "seed": seed, "device": str(server.device),
        "wall_s": round(wall_s, 3), "digest": digest,
        "replay_ok": replay_ok, "ledger_windows": windows,
        "stats": {k: (round(v, 4) if isinstance(v, float) else v)
                  for k, v in stats.items()},
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (hillclimb variants)")
    ap.add_argument("--param-dtype", default=None, choices=[None, "bf16"])
    ap.add_argument("--tag", default="",
                    help="suffix for output json names")
    ap.add_argument("--rng-fanout", action="store_true",
                    help="run the RNG (host, stream) block fan-out on the "
                         "production mesh(es) of the card and report bytes "
                         "per shard, wall ms, collective bytes (0 by "
                         "construction) and equality with one generate")
    ap.add_argument("--service", action="store_true",
                    help="run an in-process RandService mixed burst on the "
                         "card and report requests/s, latency, coalescing "
                         "factor, ledger disjointness and replay "
                         "bit-identity")
    args = ap.parse_args()

    if args.service:
        os.makedirs(args.out, exist_ok=True)
        rep = service_cell()
        with open(os.path.join(args.out, "service.json"), "w") as f:
            json.dump(rep, f, indent=2)
        s = rep["stats"]
        status = "OK" if rep["replay_ok"] else "FAIL"
        print(f"[{status}] service burst={rep['burst']} "
              f"tenants={s['tenants']} req/s={s['requests_per_s']:.0f} "
              f"p50={s['latency_p50_ms']:.1f}ms "
              f"p99={s['latency_p99_ms']:.1f}ms "
              f"calls/req={s['calls_per_request']:.3f} "
              f"replay={'bit-identical' if rep['replay_ok'] else 'MISMATCH'}"
              f" digest={rep['digest']}", flush=True)
        if not rep["replay_ok"]:
            raise SystemExit("service replay mismatch")
        return

    if args.rng_fanout:
        os.makedirs(args.out, exist_ok=True)
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        failures = 0
        for mp in meshes:
            rep = rng_fanout_cell(multi_pod=mp)
            tag = f"rng_fanout__{'multipod' if mp else 'pod'}"
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rep, f, indent=2)
            per = {s: rep[s] for s in ("bits", "uniform")}
            equal = {s: r["equal_to_generate"] for s, r in per.items()}
            shard_bytes = {s: r["bytes_per_shard"] for s, r in per.items()}
            wall = {s: round(r["wall_ms"], 2) for s, r in per.items()}
            coll = {s: r["collective_bytes"]["total"]
                    for s, r in per.items()}
            status = "OK" if all(equal.values()) else "FAIL"
            failures += status == "FAIL"
            print(f"[{status}] {tag} mesh={rep['mesh']} chips={rep['chips']}"
                  f" shards={per['bits']['shards']} bytes/shard="
                  f"{shard_bytes} ms={wall} collective_bytes={coll}"
                  f" equal_to_generate={equal}", flush=True)
        if failures:
            raise SystemExit(f"{failures} fan-outs differ from generate")
        return

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
        overrides[k] = v

    cells = []
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                cells.append((arch, shape, mp))

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'multipod' if mp else 'pod'}"
        if args.tag:
            tag += "__" + args.tag
        try:
            rep = lower_cell(arch, shape, multi_pod=mp, fit_costs=not mp,
                             overrides=overrides or None,
                             param_dtype=args.param_dtype)
        except Exception as e:
            rep = {"arch": arch, "shape": shape, "multi_pod": mp,
                   "error": f"{type(e).__name__}: {e}"}
            failures += 1
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rep, f, indent=2)
        status = ("SKIP" if rep.get("skipped") else
                  "FAIL" if rep.get("error") else "OK")
        extra = ""
        if status == "OK":
            r = rep["roofline"]
            extra = (f" args/dev={rep['memory']['argument_size_in_bytes']/2**30:.2f}GiB"
                     f" compute={r['compute_s']*1e3:.2f}ms"
                     f" memory={r['memory_s']*1e3:.2f}ms"
                     f" bottleneck={r['bottleneck']}")
        elif status == "FAIL":
            extra = " " + rep["error"][:200]
        print(f"[{status}] {tag}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
