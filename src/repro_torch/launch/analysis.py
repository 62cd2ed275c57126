"""Roofline analysis helpers: HLO collective parsing, hardware model.

The text parsers read the result types of optimized, post-SPMD HLO as
XLA prints it (``compiled.as_text()``); they are the reference's, so a
dump from either package's world reads the same.  The hardware model is
one NVIDIA H100 SXM: the port runs on that card.
"""
from __future__ import annotations

import re
from typing import Dict

# NVIDIA H100 SXM hardware model for the roofline (per card; NVIDIA's
# data sheet, dense rates at the 700 W power limit)
PEAK_FLOPS = 989e12          # bf16 FLOP/s (tensor cores)
HBM_BW = 3.35e12             # B/s
# NVLink 4, one direction.  The port runs in one process with no
# collective, so no term of its dry run divides by this.
ICI_BW = 450e9               # B/s

_DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1,
                "f8e5m2": 1, "s64": 8, "u64": 8, "s32": 4, "u32": 4,
                "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
                "c64": 8, "c128": 16}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(text: str) -> int:
    """Sum byte sizes of every TYPE[dims] group in an HLO result type."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-op-kind bytes moved (result-shape convention), from optimized
    post-SPMD HLO.  'start' variants counted; 'done' variants skipped so
    async pairs are not double counted."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        line = line.strip()
        m = re.match(r"%?[\w.\-]+ = (.*?) (\w[\w\-]*)\(", line)
        if not m:
            continue
        result_type, opname = m.groups()
        base = opname.replace("-start", "")
        if opname.endswith("-done"):
            continue
        if base in _COLLECTIVES:
            out[base] += _shape_bytes(result_type)
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out
