#!/usr/bin/env python3
"""Time design variants of kernel C (fused dropout) against the kept kernel.

    python3 tools/dropout_variants.py [--out FILE]

Each variant is the kept source, ``src/repro_torch/csrc/fused_dropout.cu``,
with the edits of ``VARIANTS`` (text replaced; each must occur once).  The
kept source and every variant are built with the library's own nvcc flags
into ``build/dropout_variants/``, all at once.  Each variant must write the
kept kernel's bytes at (32768, 3072), rate 0.1, in bfloat16, float16 and
float32; then each is timed with CUDA events in turns with the kept
kernel (kept, the variants, the reverse, twice; 20 launches a turn).

Prints one JSON line: the card's name and power limit, and for each build
and dtype its registers and spill bytes (``ptxas -v``), the SASS counts of
its loop over whole 16-byte runs (the loop with one global load and one
global store, by ``tools/sass_loop_counts.py`` over ``cuobjdump -sass``:
INT32, IMAD and all instructions per element) and its ms per call in each
turn.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import sass_loop_counts as slc  # noqa: E402
from chip_smoke import time_cuda  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT_DIR = ROOT / "build" / "dropout_variants"
SHAPE = (8 * 4096, 3072)
RATE = 0.1
SEED = 42

# splitmix64's mix with every shift by a constant k as a multiply: a right
# shift of a word as its high product by 2^(32 - k) (IMAD.HI on the FMA
# pipe), a left shift as its low product.  The multipliers are read from
# constant memory, so that ptxas cannot turn them back into shifts.
MULHI = r'''
__constant__ u32 fd_pow2[3] = {4u, 32u, 2u};  // 2^(32 - k), k = 30, 27, 31
__device__ __forceinline__ u32 fd_mix_mulhi(u64 z, u32 perm) {
  const u32 m30 = fd_pow2[0], m27 = fd_pow2[1], m31 = fd_pow2[2];
  u32 lo = (u32)z, hi = (u32)(z >> 32);
  lo ^= __umulhi(lo, m30) ^ (hi * m30);
  hi ^= __umulhi(hi, m30);
  z = (((u64)hi << 32) | lo) * TB_MIX1;
  lo = (u32)z;
  hi = (u32)(z >> 32);
  lo ^= __umulhi(lo, m27) ^ (hi * m27);
  hi ^= __umulhi(hi, m27);
  z = (((u64)hi << 32) | lo) * TB_MIX2;
  lo = (u32)z;
  hi = (u32)(z >> 32);
  return perm ^ hi ^ __umulhi(hi, m31) ^ lo ^ __umulhi(lo, m31) ^ (hi * m31);
}
'''

PREFETCH = "constexpr bool prefetch = sizeof(T) == 4;"
BOUNDS = "__launch_bounds__(FD_THREADS, 1)"
INCLUDE = '#include "sampler_stage.cuh"\n'

#: name -> [(text of the kept source, its replacement)]
VARIANTS = {
    # every dtype issues the next run's load before the current run's mask
    "prefetch_all": [(PREFETCH, "constexpr bool prefetch = true;")],
    # no dtype does
    "prefetch_none": [(PREFETCH, "constexpr bool prefetch = false;")],
    # the mix's shifts on the FMA pipe
    "mulhi": [(INCLUDE, INCLUDE + MULHI),
              ("b[j] = tb_mix64_fold_xor(", "b[j] = fd_mix_mulhi(")],
    # ptxas's own register count for 256 threads (no minimum of blocks)
    "regs_free": [(BOUNDS, "__launch_bounds__(FD_THREADS)")],
    # 8 resident blocks of 256 per SM: at most 32 registers
    "regs32": [(BOUNDS, "__launch_bounds__(FD_THREADS, 8)")],
}

#: dtype label -> (torch dtype name, FdType, elements per 16-byte run,
#: the mangled name's template argument)
DTYPES = {"bf16": ("bfloat16", 1, 8, "I13__nv_bfloat16E"),
          "f16": ("float16", 2, 8, "I6__halfE"),
          "f32": ("float32", 0, 4, "IfE")}


def variant_source(edits) -> str:
    text = (CSRC / "fused_dropout.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"dropout_variants: {old!r} does not occur "
                             f"once in fused_dropout.cu")
        text = text.replace(old, new)
    return text


def build(name: str, edits) -> dict:
    """Compile one build; return its library, registers, spills and SASS
    counts per dtype."""
    from repro_torch.kernels import build as kbuild
    d = OUT_DIR / name
    d.mkdir(parents=True, exist_ok=True)
    src = d / "fused_dropout.cu"
    src.write_text(variant_source(edits))
    lib = d / "libfused_dropout.so"
    proc = subprocess.run(
        [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-I", str(CSRC), "-Xptxas",
         "-v", "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"dropout_variants: nvcc failed for {name}:\n"
                         f"{proc.stderr}")
    sass = subprocess.run(
        [str(Path(kbuild.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(lib)], capture_output=True, text=True, check=True).stdout
    (d / "fused_dropout.sass").write_text(sass)
    info = {"lib": lib, "dtypes": {}}
    # ptxas -v names each kernel before its register line
    regs = {}
    for m in re.finditer(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                         r"registers.*?(?=Compiling|\Z)", proc.stderr, re.S):
        spill = re.search(r"(\d+) bytes spill stores", m.group(0))
        regs[m.group(1)] = (int(m.group(2)), int(spill.group(1)) if spill
                            else 0)
    funcs = slc.parse(sass)
    for label, (_, _, k, tag) in DTYPES.items():
        fname = next(f for f in funcs
                     if "fused_dropout_kernel" in f and tag in f)
        runs = [body for _, _, body in slc.loops(funcs[fname])
                if [op[:3] for _, op, _ in body
                    if op.startswith(("LDG", "STG"))] in (["LDG", "STG"],
                                                           ["STG", "LDG"])]
        body = max(runs, key=len)
        c = collections.Counter(slc.pipe(op) for _, op, _ in body)
        r, s = regs.get(fname, (None, None))
        info["dtypes"][label] = {
            "registers": r, "spill_bytes": s,
            "int32_per_elem": c["int"] / k, "imad_per_elem": c["imad"] / k,
            "all_per_elem": len(body) / k}
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="append the line here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("dropout_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.core import lcg, stream
    from repro_torch.kernels import fused_dropout as fd
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    builds = {"kept": []} | VARIANTS
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        infos = dict(zip(builds, pool.map(build, builds, builds.values())))
    ptr, u64_t, cint = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
    libs = {}
    for name, info in infos.items():
        lib = ctypes.CDLL(str(info.pop("lib")))
        lib.fd_launch.argtypes = [ptr, ptr, ctypes.c_longlong, cint, u64_t,
                                  u64_t, u64_t, ctypes.c_uint32,
                                  ctypes.c_float, ptr]
        lib.fd_launch.restype = cint
        libs[name] = lib
    dev = torch.device("cuda")
    s = stream.new_stream(SEED, 0, device=dev)
    base = lcg.advance(s.x0, s.ctr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    sp = torch.cuda.current_stream(dev).cuda_stream
    for label, (dt_name, dt_id, _, _) in DTYPES.items():
        dt = getattr(torch, dt_name)
        x = torch.randn(SHAPE, generator=gen, device=dev, dtype=dt)
        scale = torch.tensor(1.0 / (1.0 - RATE), dtype=dt).item()
        ys = {name: torch.empty_like(x) for name in libs}

        def run(name):
            code = libs[name].fd_launch(
                x.data_ptr(), ys[name].data_ptr(), x.numel(), dt_id, base,
                s.ctr, s.h, fd.keep_threshold(RATE), scale, sp)
            if code:
                raise SystemExit(f"dropout_variants: {name} failed to launch:"
                                 f" {code}")
        for name in libs:
            run(name)
        torch.cuda.synchronize()
        word = torch.int16 if x.element_size() == 2 else torch.int32
        for name in libs:
            if not torch.equal(ys[name].view(word), ys["kept"].view(word)):
                raise SystemExit(f"dropout_variants: {name} writes other "
                                 f"bytes than the kept kernel in {dt_name}")
        order = list(libs) + list(libs)[::-1]
        for name in order + order:
            ms = time_cuda(lambda: run(name), reps=20)
            infos[name]["dtypes"][label].setdefault("ms", []).append(ms)
        del x, ys
    line = json.dumps({"card": card, "shape": list(SHAPE), "rate": RATE,
                       "builds": infos})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
