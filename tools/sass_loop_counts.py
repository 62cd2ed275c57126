#!/usr/bin/env python3
"""Count the instructions of each loop in a ``cuobjdump -sass`` listing.

For every function of the listing, every backward branch closes a loop:
the instructions from the branch's target to the branch itself.  Each
loop is printed with its instruction count by issue pipe, so the
per-element operation counts that ``chip_smoke.py`` divides by the
card's peak rates can be read from what the compiler emitted:

  int   INT32 pipe: IADD3, LOP3, SHF, ISETP, SEL, LEA, PRMT, IABS, FLO, ...
  imad  IMAD* (the integer multiplies; Hopper issues them on the FMA pipe)
  fp32  FADD, FMUL, FFMA, FSETP, FMNMX, FSEL, ...
  mufu  MUFU.* (the special-function unit: lg2, ex2, rsq, rcp, sin, cos)
  conv  I2F / F2I / F2F / F2FP conversions
  mem   loads and stores
  other branches, moves and the rest

With ``--ranges a-b,c-d`` (hex addresses) it counts instead the
instructions of one path through a function: the union of the ranges,
e.g. a loop without its never-taken slow path.

Usage:  cuobjdump -sass build/repro_torch/libmc-*.so > mc.sass
        python3 tools/sass_loop_counts.py mc.sass [function-substring]
        python3 tools/sass_loop_counts.py mc.sass ILi1 --ranges 0710-0e50
"""
from __future__ import annotations

import collections
import re
import sys

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                    r"([^;]*);")
_FUNC = re.compile(r"Function : (\S+)")
_BRA = re.compile(r"(0x[0-9a-f]+)")

_INT = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "IABS",
        "FLO", "POPC", "IMNMX", "BMSK", "SGXT", "VIADD", "IADD", "LOP",
        "SHL", "SHR", "BREV", "PLOP3", "P2R", "R2P", "VIMNMX")
_FP32 = ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FCHK", "FSWZADD",
         "FRND")
_CONV = ("I2F", "F2I", "F2F", "F2FP", "I2FP", "F2IP")
_MEM = ("LDG", "STG", "LD", "ST", "LDL", "STL", "LDS", "STS", "LDC", "ULDC")


def pipe(op: str) -> str:
    base = op.split(".")[0]
    if base.startswith("IMAD"):
        return "imad"
    if base == "MUFU":
        return "mufu"
    for name, group in (("int", _INT), ("fp32", _FP32), ("conv", _CONV),
                        ("mem", _MEM)):
        if base in group:
            return name
    return "other"


def parse(text: str):
    """{function: [(address, opcode, operands)]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return funcs


def loops(instrs):
    """(start, end, instructions) of every backward branch's loop."""
    out = []
    for addr, op, rest in instrs:
        if op != "BRA":
            continue
        m = _BRA.search(rest)
        if m and int(m.group(1), 16) <= addr:
            start = int(m.group(1), 16)
            body = [i for i in instrs if start <= i[0] <= addr]
            out.append((start, addr, body))
    return out


def describe(body) -> str:
    counts = collections.Counter(pipe(op) for _, op, _ in body)
    mufu = collections.Counter(op for _, op, _ in body
                               if op.startswith("MUFU"))
    return (f"{len(body)} instructions "
            + " ".join(f"{k}={counts[k]}" for k in
                       ("int", "imad", "fp32", "mufu", "conv", "mem",
                        "other"))
            + (f"  {dict(mufu)}" if mufu else ""))


def main(argv) -> int:
    args = list(argv[1:])
    ranges = None
    if "--ranges" in args:
        i = args.index("--ranges")
        ranges = [tuple(int(v, 16) for v in r.split("-"))
                  for r in args[i + 1].split(",")]
        del args[i:i + 2]
    if not args:
        print(__doc__)
        return 2
    want = args[1] if len(args) > 1 else ""
    with open(args[0]) as f:
        funcs = parse(f.read())
    for name, instrs in funcs.items():
        if want not in name:
            continue
        print(f"{name}: {len(instrs)} instructions")
        if ranges is not None:
            body = [i for i in instrs
                    if any(lo <= i[0] <= hi for lo, hi in ranges)]
            print(f"  path {args_text(ranges)}: {describe(body)}")
            continue
        for start, end, body in loops(instrs):
            print(f"  loop {start:#06x}-{end:#06x}: {describe(body)}")
    return 0


def args_text(ranges) -> str:
    return ",".join(f"{lo:04x}-{hi:04x}" for lo, hi in ranges)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
