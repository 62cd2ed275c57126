"""Recorded sha256 digests of the kernels' output bytes.

Journal replay (``service.audit``, ``inference.scheduler``) regenerates
blocks long after they were first drawn, so kernels A and B must keep
writing the same bytes when they are rebuilt or redesigned.  The float
stages are held against their plain versions only within a few ULP, so
that check cannot show it; these digests can.  ``RECORDED`` holds the
digests of every sampler stage and dtype, both decorrelators and faithful
mode, at two shapes, as the card's kernels wrote them (NVIDIA H100 80GB
HBM3); ``compute`` recomputes them through ``engine.generate``.

``DROPOUT_RECORDED`` does the same for kernel C (fused dropout, through
``fused_dropout_2d``): every dtype x rate x counter x input, the inputs
being seeded normals at four shapes (one of them a view that starts one
element past a 16-byte line) and one input per dtype of special values
(every bit pattern of a 16-bit dtype; for float32, random bit patterns
with signed zeros, infinities, the extreme subnormals and the largest
finite value), once without and once with NaNs.  The 24 bfloat16 and
float32 cases of the special inputs were recorded again when kernel C
began to read subnormal inputs as zeros, as the reference does; the other
84 kept their first values.

On a CPU the plain versions run instead: their integer and threshold
stages give the recorded bytes, their log / trig stages differ by ULPs;
the plain dropout gives the recorded bytes of every input without NaN
(torch-CPU writes another NaN pattern than the card).

    python -m repro_torch.kernels.digests [--out FILE]   # on a card
"""
from __future__ import annotations

import argparse
import hashlib
import json
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.core import engine, stream
from repro_torch.kernels import fused_dropout as fd

SEED = 42
HIGH_OFFSET = 2 ** 32 + 12345
SHAPES = ((40, 130, 12345), (256, 2 ** 14, HIGH_OFFSET))
MODES = (("ctr", "splitmix64"), ("ctr", "fmix32"), ("faithful", "splitmix64"))
#: chip_smoke.py's STAGES: every stage, each in the dtypes it takes.
STAGES = (
    ("bits", ("float32",)),
    ("uniform", ("float32", "bfloat16")),
    ("normal", ("float32", "bfloat16")),
    ("bernoulli(0.3)", ("float32",)),
    ("bernoulli(0.0)", ("float32",)),
    ("bernoulli(1.0)", ("float32",)),
    ("exponential(1.5)", ("float32", "bfloat16")),
    ("poisson(3.5)", ("float32", "bfloat16")),
    ("gamma(2.5)", ("float32", "bfloat16")),
    ("gamma(1.0)", ("float32",)),
    ("gamma(3.0,0.5)", ("float32", "bfloat16")),
    ("gumbel", ("float32", "bfloat16")),
    ("categorical[0.5,0.25,0.125,0.125]", ("float32", "bfloat16")),
    ("categorical[1.0]", ("float32",)),
)
EXACT_STAGES = ("bits", "uniform", "bernoulli", "poisson", "categorical")


def case_key(mode: str, deco: str, spec: str, dtype: str, T: int, S: int,
             off: int) -> str:
    name = "faithful" if mode == "faithful" else f"ctr/{deco}"
    return f"{name} {spec} {dtype} T={T} S={S} off={off}"


def cases(shapes=SHAPES) -> Iterator[Tuple[str, dict]]:
    """(key, ``engine.make_plan`` keywords) of every recorded case."""
    for T, S, off in shapes:
        for mode, deco in MODES:
            for spec, dtypes in STAGES:
                for dtype in dtypes:
                    yield (case_key(mode, deco, spec, dtype, T, S, off),
                           dict(seed=SEED, num_streams=S, num_steps=T,
                                offset=off, mode=mode, deco=deco,
                                sampler=spec, out_dtype=dtype))


def digest(block: torch.Tensor) -> str:
    """sha256 of a block's bytes, row-major."""
    raw = block.contiguous().cpu().view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()


def compute(device=None, shapes=SHAPES, exact_only: bool = False
            ) -> Dict[str, str]:
    """{case key: digest} of ``engine.generate`` on ``device``."""
    out = {}
    plans: Dict[Tuple, engine.GenPlan] = {}
    for key, kw in cases(shapes):
        stage = kw["sampler"].split("(")[0].split("[")[0]
        if exact_only and stage not in EXACT_STAGES:
            continue
        base = (kw["num_streams"], kw["num_steps"], kw["offset"], kw["mode"],
                kw["deco"])
        if base not in plans:
            plans[base] = engine.make_plan(
                **{k: v for k, v in kw.items()
                   if k not in ("sampler", "out_dtype")}, device=device)
        out[key] = digest(engine.sample(plans[base], sampler=kw["sampler"],
                                        out_dtype=kw["out_dtype"]))
    return out


#: kernel C's cases: dtype x rate x counter x input
DROPOUT_DTYPES = ("float32", "bfloat16", "float16")
DROPOUT_RATES = (0.1, 0.5, 1e-9)
DROPOUT_COUNTERS = (0, HIGH_OFFSET)
#: input name -> shape; "64x1001+1" starts one element past a 16-byte line
DROPOUT_INPUTS = {"3x1001": (3, 1001), "64x1001+1": (64, 1001),
                  "8x128": (8, 128), "4096x3072": (4096, 3072),
                  "special": (256, 256), "special+nan": (256, 256)}
# (sign-free exponent mask, mantissa mask, bit pattern of 1.0) per dtype
_FLOAT_BITS = {"float32": (0x7F800000, 0x007FFFFF, 0x3F800000),
               "bfloat16": (0x7F80, 0x007F, 0x3F80),
               "float16": (0x7C00, 0x03FF, 0x3C00)}


def dropout_key(dtype: str, name: str, rate: float, ctr: int) -> str:
    return f"fused_dropout {dtype} {name} rate={rate!r} ctr={ctr}"


def _special_bits(dtype: str, with_nan: bool) -> np.ndarray:
    """65536 bit patterns: each pattern of a 16-bit dtype once in seeded
    order; for float32 random patterns with +-0, +-inf, the smallest and
    largest subnormals and the largest finite value 16 times each.  NaN
    patterns become 1.0 unless ``with_nan``."""
    rng = np.random.default_rng(SEED + 1)
    exp_mask, man_mask, one = _FLOAT_BITS[dtype]
    if dtype == "float32":
        bits = rng.integers(0, 2 ** 32, 2 ** 16, dtype=np.uint64)
        specials = np.array([0x0, 0x7F800000, 0x1, 0x007FFFFF, 0x7F7FFFFF],
                            np.uint64)
        specials = np.concatenate([specials, specials | 0x80000000])
        where = rng.permutation(2 ** 16)[:16 * specials.size]
        bits[where] = np.repeat(specials, 16)
    else:
        bits = rng.permutation(2 ** 16).astype(np.uint64)
    nan = ((bits & exp_mask) == exp_mask) & ((bits & man_mask) != 0)
    if not with_nan:
        bits[nan] = one
    return bits


def special_values(dtype: str, with_nan: bool = False) -> torch.Tensor:
    """The 65536 special-value patterns of ``_special_bits`` as a 1-d CPU
    tensor of ``dtype``."""
    bits = _special_bits(dtype, with_nan)
    if dtype == "float32":
        host = torch.from_numpy(bits.astype(np.uint32).view(np.int32))
    else:
        host = torch.from_numpy(bits.astype(np.uint16).view(np.int16))
    return host.view(getattr(torch, dtype))


def dropout_input(dtype: str, name: str, device=None) -> torch.Tensor:
    """Input ``name`` of kernel C's cases in ``dtype`` on ``device``,
    made from a numpy seed (the same values on every device)."""
    shape = DROPOUT_INPUTS[name]
    t_dtype = getattr(torch, dtype)
    if name.startswith("special"):
        host = special_values(dtype, name.endswith("nan")).reshape(shape)
    else:
        rng = np.random.default_rng(SEED + sum(shape))
        host = torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(t_dtype)
    device = engine.resolve_device(device)
    if name.endswith("+1"):
        flat = torch.empty(host.numel() + 1, dtype=t_dtype, device=device)
        flat[1:].copy_(host.reshape(-1))
        return flat[1:].view(shape)
    return host.to(device)


def special_layouts(dtype: str, device=None) -> Iterator[Tuple[str, torch.Tensor]]:
    """The NaN-free special values in the two layouts that take kernel C's
    per-element epilogue: a (256, 256) view 2 bytes or 4 bytes past a
    16-byte line, and an aligned (3, 21845) block whose last run is
    ragged."""
    host = special_values(dtype)
    device = engine.resolve_device(device)
    flat = torch.empty(host.numel() + 1, dtype=host.dtype, device=device)
    flat[1:].copy_(host)
    yield "misaligned", flat[1:].view(256, 256)
    yield "ragged", host[:3 * 21845].to(device).view(3, 21845)


def dropout_cases(names=tuple(DROPOUT_INPUTS)) -> Iterator[Tuple[str, tuple]]:
    """(key, (dtype, input name, rate, counter)) of kernel C's cases."""
    for dtype in DROPOUT_DTYPES:
        for name in names:
            for ctr in DROPOUT_COUNTERS:
                for rate in DROPOUT_RATES:
                    yield (dropout_key(dtype, name, rate, ctr),
                           (dtype, name, rate, ctr))


def compute_dropout(device=None) -> Dict[str, str]:
    """{case key: digest} of ``fused_dropout_2d`` on ``device``."""
    out, x, made = {}, None, None
    for key, (dtype, name, rate, ctr) in dropout_cases():
        if made != (dtype, name):
            x, made = dropout_input(dtype, name, device), (dtype, name)
        s = stream.advance(stream.new_stream(SEED, 0, device=x.device), ctr)
        out[key] = digest(fd.fused_dropout_2d(x, s.h, s.x0, s.ctr, rate))
    return out


def mismatches(got: Dict[str, str]) -> list:
    """Keys of ``got`` whose digest differs from the recorded one."""
    recorded = {**RECORDED, **DROPOUT_RECORDED}
    return [k for k, v in got.items() if recorded.get(k) != v]


RECORDED: Dict[str, str] = {
    "ctr/fmix32 bernoulli(0.0) float32 T=256 S=16384 off=4294979641":
        "bb9f8df61474d25e71fa00722318cd387396ca1736605e1248821cc0de3d3af8",
    "ctr/fmix32 bernoulli(0.0) float32 T=40 S=130 off=12345":
        "7e9b40a541c43371a47fd4fe962e935838496a5cea5ffbf72b67c4710d8f75bb",
    "ctr/fmix32 bernoulli(0.3) float32 T=256 S=16384 off=4294979641":
        "e45de825ff2130752a1ec79867b40a71c656b7a07dafb690803572614da19985",
    "ctr/fmix32 bernoulli(0.3) float32 T=40 S=130 off=12345":
        "3239a4923d700ad8dab712054e907b0df6e92fb4ca08efd81ca23ffa01dc5bb7",
    "ctr/fmix32 bernoulli(1.0) float32 T=256 S=16384 off=4294979641":
        "5d2bafc266e711ed1e303de871e5b281fea2083d96e579dd504798bba5a34b42",
    "ctr/fmix32 bernoulli(1.0) float32 T=40 S=130 off=12345":
        "13e6f6f3b613653c71af3e9cd43ad80260d4535bd2f63142dfe12396229c1550",
    "ctr/fmix32 bits float32 T=256 S=16384 off=4294979641":
        "f993e5763c4b9aed9def66d3a107e29051d8c87a085f39f5fcc74ba16df6fa45",
    "ctr/fmix32 bits float32 T=40 S=130 off=12345":
        "8ed92affc2a52ef777b3ee2456f7a2939017a9ae5fe5a959550022ad09f49580",
    "ctr/fmix32 categorical[0.5,0.25,0.125,0.125] bfloat16 T=256 S=16384 off=4294979641":
        "e0d5a7d4c09ac3d27732c60db3b9e51ad76b2102636e469adf6be3aff2a5dd44",
    "ctr/fmix32 categorical[0.5,0.25,0.125,0.125] bfloat16 T=40 S=130 off=12345":
        "4e6e341f20e53707c9b5f2ed6eb4d0f6a87765e1d695cc2a1aab6671e08147ea",
    "ctr/fmix32 categorical[0.5,0.25,0.125,0.125] float32 T=256 S=16384 off=4294979641":
        "c1719b9d33b067cb0eb24d7fbec9a36e2b83d679668fe3af063045f649212d58",
    "ctr/fmix32 categorical[0.5,0.25,0.125,0.125] float32 T=40 S=130 off=12345":
        "f537beea6f78510652939a73b3af6b523def531f0c5f6f2b1a9123f17909faf2",
    "ctr/fmix32 categorical[1.0] float32 T=256 S=16384 off=4294979641":
        "080acf35a507ac9849cfcba47dc2ad83e01b75663a516279c8b9d243b719643e",
    "ctr/fmix32 categorical[1.0] float32 T=40 S=130 off=12345":
        "a2b87fecc2b5073f875c100496483aecdef3a54306609f71755e274e4a17a487",
    "ctr/fmix32 exponential(1.5) bfloat16 T=256 S=16384 off=4294979641":
        "b19227299a510a6294a32bcb0b10ea69d40bb5dce583d61b0ae6b92f4f821b10",
    "ctr/fmix32 exponential(1.5) bfloat16 T=40 S=130 off=12345":
        "c6cba1e8bee6f521dc8849c0df89c354fcc00fdcbcb2e174df7cf54d897a03f3",
    "ctr/fmix32 exponential(1.5) float32 T=256 S=16384 off=4294979641":
        "e814eaf9cbee6bad6549176e665e393f112ca7263fa106a7bde90f18e7f57fad",
    "ctr/fmix32 exponential(1.5) float32 T=40 S=130 off=12345":
        "6fb572314d74a735748728b8e6b18962fcbaff594b29691434d0d3550fa32817",
    "ctr/fmix32 gamma(1.0) float32 T=256 S=16384 off=4294979641":
        "19f402ba7f085739b4131e5a80e3eb82dabf56f767b46f14c1bec705aff67f85",
    "ctr/fmix32 gamma(1.0) float32 T=40 S=130 off=12345":
        "f16215a7df8fe78868293014754551269c9214656badd1c9f9bbc44d87db8245",
    "ctr/fmix32 gamma(2.5) bfloat16 T=256 S=16384 off=4294979641":
        "6267f927490d0496868a0a8ceaaa3068505d0ec5e17736274f6898662d6c7cf0",
    "ctr/fmix32 gamma(2.5) bfloat16 T=40 S=130 off=12345":
        "d874de1321df650d39264e362c011be5a3a451f4212ee1a0d450392dfbc7c166",
    "ctr/fmix32 gamma(2.5) float32 T=256 S=16384 off=4294979641":
        "02e49533a32f5b24043511d9937315124ed9b86ebf26dbec387057cce59c68b6",
    "ctr/fmix32 gamma(2.5) float32 T=40 S=130 off=12345":
        "1c803e0741c16946ed2be06416ab9468db92235480947ff44b9b0b792ed6d5eb",
    "ctr/fmix32 gamma(3.0,0.5) bfloat16 T=256 S=16384 off=4294979641":
        "4750d22163b3b703956ed63cd3ec2c9b54453963f449b3564ce09d89f8a399a7",
    "ctr/fmix32 gamma(3.0,0.5) bfloat16 T=40 S=130 off=12345":
        "267f5571700df7217e62d0163d38786d251cb4275c1e8cf55109ed680051978c",
    "ctr/fmix32 gamma(3.0,0.5) float32 T=256 S=16384 off=4294979641":
        "64825614b3b48793dcec8d15030c540f4f99e12a8648c3aff4156680d94f4f34",
    "ctr/fmix32 gamma(3.0,0.5) float32 T=40 S=130 off=12345":
        "fe52c9f9e9c2fd4238041e98fbfeb1e409921f1167e602d7d26f86b14e5d2dd6",
    "ctr/fmix32 gumbel bfloat16 T=256 S=16384 off=4294979641":
        "beff0131c60713fc1830a5c5d2217146e506146b74763f4c7ca9e46942288809",
    "ctr/fmix32 gumbel bfloat16 T=40 S=130 off=12345":
        "ae0fcad599251573b1116b7a5f4e4a80a0ceed7dae6361a3d8eb7df6bff02cc8",
    "ctr/fmix32 gumbel float32 T=256 S=16384 off=4294979641":
        "8681ca388626e804e6733231d1489c201aa6afb7d82a24e8a02c821dab810e6c",
    "ctr/fmix32 gumbel float32 T=40 S=130 off=12345":
        "63330919ac3a79b35a696880f2a1dd4a10de93d723716e1fb4fdf3044db3f03a",
    "ctr/fmix32 normal bfloat16 T=256 S=16384 off=4294979641":
        "a9b396765144b7b929b723b6e61dca7c52abddf00d047c5c0ed40b3c5cae85b7",
    "ctr/fmix32 normal bfloat16 T=40 S=130 off=12345":
        "48e8c86e4e9cc3cc7c1fe93a9b2ed0ad56a52de912466474fabd3fbfe5791257",
    "ctr/fmix32 normal float32 T=256 S=16384 off=4294979641":
        "76d40158512c4f49907fda8823af07cc10cd6b405bb0fcc94ea3eb4b531cbb1e",
    "ctr/fmix32 normal float32 T=40 S=130 off=12345":
        "161448569e2ee18f98fda48ef9fdb5531b1c16800c8f7a9e7cc1b2110dd6a7a2",
    "ctr/fmix32 poisson(3.5) bfloat16 T=256 S=16384 off=4294979641":
        "7df8772cd399db84b7b0fdcff9c54c41ba6fe8de463a01fc410d33189eb499c3",
    "ctr/fmix32 poisson(3.5) bfloat16 T=40 S=130 off=12345":
        "8e6f62ab27e57d80034beebf123daa1e0d20f7fe1285b8118b1e9fefb781f3f8",
    "ctr/fmix32 poisson(3.5) float32 T=256 S=16384 off=4294979641":
        "b18895e9bbe077a5293b9ed7b3246a68cdab2259335d00aa36479310f5480c40",
    "ctr/fmix32 poisson(3.5) float32 T=40 S=130 off=12345":
        "2eb257f4c6cd453c3f483e72b7cde6b9aeda4e7bcfcf0d8893f4c1e100a8802b",
    "ctr/fmix32 uniform bfloat16 T=256 S=16384 off=4294979641":
        "edbbf48da45f77600e1b3abe7a731e55ea2732f300ac514247f91fd7220221e0",
    "ctr/fmix32 uniform bfloat16 T=40 S=130 off=12345":
        "342f82ef8177faf04126bb25ca07f16302ac51ffb7cd2500bb181a222a4bb610",
    "ctr/fmix32 uniform float32 T=256 S=16384 off=4294979641":
        "ee95d78736dfe0075ea26959b9792a005725c1381dd6e53bcaf5453b141c82a6",
    "ctr/fmix32 uniform float32 T=40 S=130 off=12345":
        "afb677df970f556bbf5d63531873e7cb953e8db5fb24ca1f08268d90742225c2",
    "ctr/splitmix64 bernoulli(0.0) float32 T=256 S=16384 off=4294979641":
        "bb9f8df61474d25e71fa00722318cd387396ca1736605e1248821cc0de3d3af8",
    "ctr/splitmix64 bernoulli(0.0) float32 T=40 S=130 off=12345":
        "7e9b40a541c43371a47fd4fe962e935838496a5cea5ffbf72b67c4710d8f75bb",
    "ctr/splitmix64 bernoulli(0.3) float32 T=256 S=16384 off=4294979641":
        "412a9e91d5c42f1deb411f7df1f90b85d0184b59f442982b05f1abe7b58c07b6",
    "ctr/splitmix64 bernoulli(0.3) float32 T=40 S=130 off=12345":
        "8cb78e3ba7322dc0108acea13ebe0a59b0e9b7aa26a74e966f3ab17dcba8d417",
    "ctr/splitmix64 bernoulli(1.0) float32 T=256 S=16384 off=4294979641":
        "5d2bafc266e711ed1e303de871e5b281fea2083d96e579dd504798bba5a34b42",
    "ctr/splitmix64 bernoulli(1.0) float32 T=40 S=130 off=12345":
        "13e6f6f3b613653c71af3e9cd43ad80260d4535bd2f63142dfe12396229c1550",
    "ctr/splitmix64 bits float32 T=256 S=16384 off=4294979641":
        "e98b0b8d9e905580926c2f38009fd4b900ce0cd028fb6c7bb3cd2c83e0d5f1f6",
    "ctr/splitmix64 bits float32 T=40 S=130 off=12345":
        "97d5ada46cf8f02fab189c248bfdb06da4d1c2b60c0c55c11a453a21d2bfe880",
    "ctr/splitmix64 categorical[0.5,0.25,0.125,0.125] bfloat16 T=256 S=16384 off=4294979641":
        "2b67ce379ef001320773a420cadaa4fae3d6033d1147ab943f306879af84b5a3",
    "ctr/splitmix64 categorical[0.5,0.25,0.125,0.125] bfloat16 T=40 S=130 off=12345":
        "c5e98b94df16f00abfe577a50855991550e98609f5664380faf0e7bdaa0d0f1d",
    "ctr/splitmix64 categorical[0.5,0.25,0.125,0.125] float32 T=256 S=16384 off=4294979641":
        "d688c5d4f560e140fc18344995262a00c2b435cc0146b5d629cff934e719d7cf",
    "ctr/splitmix64 categorical[0.5,0.25,0.125,0.125] float32 T=40 S=130 off=12345":
        "03a361db167af5bea7ed27ca61c53a317312766a2aa6de67061a2535876c719d",
    "ctr/splitmix64 categorical[1.0] float32 T=256 S=16384 off=4294979641":
        "080acf35a507ac9849cfcba47dc2ad83e01b75663a516279c8b9d243b719643e",
    "ctr/splitmix64 categorical[1.0] float32 T=40 S=130 off=12345":
        "a2b87fecc2b5073f875c100496483aecdef3a54306609f71755e274e4a17a487",
    "ctr/splitmix64 exponential(1.5) bfloat16 T=256 S=16384 off=4294979641":
        "dfe21aa02bc3e621627742b046315cf89ea41e7f6b4a65a2b677ee6117e789ee",
    "ctr/splitmix64 exponential(1.5) bfloat16 T=40 S=130 off=12345":
        "584bad29e5919e3f3e701ef8e7045605efa2404135be65a0d05f7057ca0d024f",
    "ctr/splitmix64 exponential(1.5) float32 T=256 S=16384 off=4294979641":
        "457864cf7320f9d572f4274fe29292c27a0721d2c0f45392ae9c447a93e204db",
    "ctr/splitmix64 exponential(1.5) float32 T=40 S=130 off=12345":
        "20aa547eebab17a000dcf163aed17dfe30a660e9f425d6ea2fdd0829eb7898cc",
    "ctr/splitmix64 gamma(1.0) float32 T=256 S=16384 off=4294979641":
        "c236e92afdf68f5229d4feab517dce5f919fdcc9f4f9527d582a05fb185d51d0",
    "ctr/splitmix64 gamma(1.0) float32 T=40 S=130 off=12345":
        "50ea6977b744277006450d8c2867298f94efe7abe9b275e06ef2df79fba28fc1",
    "ctr/splitmix64 gamma(2.5) bfloat16 T=256 S=16384 off=4294979641":
        "9d78054830bc863bae090333e88e7ac622523fdd09f47f82187b12739627be16",
    "ctr/splitmix64 gamma(2.5) bfloat16 T=40 S=130 off=12345":
        "e83f9c95dbce739fffe4692fd609685c04787c6941623805440ea3117e6ec096",
    "ctr/splitmix64 gamma(2.5) float32 T=256 S=16384 off=4294979641":
        "68b1f41eb2707108df31879932c33cd298689b640db55d02e5e57cac8e3d77d6",
    "ctr/splitmix64 gamma(2.5) float32 T=40 S=130 off=12345":
        "23f36b2f1282ee59ae45076cd079bc58a0937ebbe06dd69ccbac9f9827e4277a",
    "ctr/splitmix64 gamma(3.0,0.5) bfloat16 T=256 S=16384 off=4294979641":
        "4382e9b2c795c675b39758d06659d686e90453802531ce49a54cb7a009265403",
    "ctr/splitmix64 gamma(3.0,0.5) bfloat16 T=40 S=130 off=12345":
        "7782ade38915ec1b90b2234a15a75110719e52372b161b9fbd3f43b0adcdef35",
    "ctr/splitmix64 gamma(3.0,0.5) float32 T=256 S=16384 off=4294979641":
        "d541a4be9de1b6a686e30c317c6bf0b1df13da4f28ba79baf475922222d4dca1",
    "ctr/splitmix64 gamma(3.0,0.5) float32 T=40 S=130 off=12345":
        "30df2ea09f5285498141da6469d00d1471fd64729408b5b4772417096771ebf1",
    "ctr/splitmix64 gumbel bfloat16 T=256 S=16384 off=4294979641":
        "0e30698da2d57cafda6ea3897c4060ff5a7e813e1dc0e44e392535ec3962bfa8",
    "ctr/splitmix64 gumbel bfloat16 T=40 S=130 off=12345":
        "3ce2352b7be8b47bbb3916e854f9214f2197d9a139e66b6b7c7e3100b432203e",
    "ctr/splitmix64 gumbel float32 T=256 S=16384 off=4294979641":
        "2ca12ddf25991eadf3b7b2a7a89da54099ae30e9ff68117c4b5b074906f31487",
    "ctr/splitmix64 gumbel float32 T=40 S=130 off=12345":
        "f02308ecf3df9a3c44e912d065253120e5cbdecd20402f0ba8af8ca64a5cdd15",
    "ctr/splitmix64 normal bfloat16 T=256 S=16384 off=4294979641":
        "178916641ad413574cef07227b9bd5bbddd1a87b43f73c97587ce45c36b4e3b2",
    "ctr/splitmix64 normal bfloat16 T=40 S=130 off=12345":
        "8a53cb636c69eb0c9073adc4e3a3953178cede00f4abd3d10a2203734e91095c",
    "ctr/splitmix64 normal float32 T=256 S=16384 off=4294979641":
        "4d48cf1c6adc658ec26ea3dc3ea1a6dae7c1a898d44b3ccba6cda2fc61b18a49",
    "ctr/splitmix64 normal float32 T=40 S=130 off=12345":
        "937294a5dd26e0828da4654d788bb7d1cacdd213aa70c4a44b1ea9bf8622d1ef",
    "ctr/splitmix64 poisson(3.5) bfloat16 T=256 S=16384 off=4294979641":
        "94ebd8aae3c16bd412d11cb044848029607cddd3f35f7ac72a70b60ebbedea91",
    "ctr/splitmix64 poisson(3.5) bfloat16 T=40 S=130 off=12345":
        "5eed63274211a00dae9d31fad86bb0bbc5ca4d6fc5e38d702cb6cbf1f9b7b4a3",
    "ctr/splitmix64 poisson(3.5) float32 T=256 S=16384 off=4294979641":
        "2b87bc5b63080393b9bdc813e322eb31b52809dd624a0cd65bb9a079987d4f6f",
    "ctr/splitmix64 poisson(3.5) float32 T=40 S=130 off=12345":
        "12a2df76d42db3ce329e8a86101802fcbec6efb0e1617862c6cd995647aae057",
    "ctr/splitmix64 uniform bfloat16 T=256 S=16384 off=4294979641":
        "d7014f4e0c77c90d6e30349a9211fe814f738bd4943c8eb79e98463244e1f4f9",
    "ctr/splitmix64 uniform bfloat16 T=40 S=130 off=12345":
        "0dbde50a6aff1ecda13f195dd9918e73c8bc04a7fbb56076e8c711189a6fd527",
    "ctr/splitmix64 uniform float32 T=256 S=16384 off=4294979641":
        "65e5214e263b7c00f1c6586eb937e52125677cc61e936cb990287ff79ec740c6",
    "ctr/splitmix64 uniform float32 T=40 S=130 off=12345":
        "3d32242cc78ec0c376f81aa1cf4e1ee4b03211ce52db93382fba1f28bcea48ba",
    "faithful bernoulli(0.0) float32 T=256 S=16384 off=4294979641":
        "bb9f8df61474d25e71fa00722318cd387396ca1736605e1248821cc0de3d3af8",
    "faithful bernoulli(0.0) float32 T=40 S=130 off=12345":
        "7e9b40a541c43371a47fd4fe962e935838496a5cea5ffbf72b67c4710d8f75bb",
    "faithful bernoulli(0.3) float32 T=256 S=16384 off=4294979641":
        "1f44a0f80eaa547ceef5076ef2d03dd7475893faa46aec3931ef3f78673352d3",
    "faithful bernoulli(0.3) float32 T=40 S=130 off=12345":
        "ff4cf6430c5125bcd1376547194d205d9184ccff78e001765beac41c5edee20d",
    "faithful bernoulli(1.0) float32 T=256 S=16384 off=4294979641":
        "5d2bafc266e711ed1e303de871e5b281fea2083d96e579dd504798bba5a34b42",
    "faithful bernoulli(1.0) float32 T=40 S=130 off=12345":
        "13e6f6f3b613653c71af3e9cd43ad80260d4535bd2f63142dfe12396229c1550",
    "faithful bits float32 T=256 S=16384 off=4294979641":
        "eb354fd90c52dd1ce534050008338d0119cdbfa0225c98479204868dc0e377be",
    "faithful bits float32 T=40 S=130 off=12345":
        "128591aeb412c9838192751f22920d2ad6b1cdea13b02c98bdf51d9720d06771",
    "faithful categorical[0.5,0.25,0.125,0.125] bfloat16 T=256 S=16384 off=4294979641":
        "6e74292d08760abd53cbbcdda444a38eec8dfd97f3ab8842dce9b164c752bcec",
    "faithful categorical[0.5,0.25,0.125,0.125] bfloat16 T=40 S=130 off=12345":
        "0ce7599fad3443d58387f1743478628dbbb8c647c594370fc270cfc2a57af9ae",
    "faithful categorical[0.5,0.25,0.125,0.125] float32 T=256 S=16384 off=4294979641":
        "a7639c2b02569abf96469dcc1cf1b9e427ccaf993f65005efc1b180f9ec4cd2b",
    "faithful categorical[0.5,0.25,0.125,0.125] float32 T=40 S=130 off=12345":
        "6b583db478ce4cc4e90d168e9ee38cde47d8c35938bd003df7084e4981d991ef",
    "faithful categorical[1.0] float32 T=256 S=16384 off=4294979641":
        "080acf35a507ac9849cfcba47dc2ad83e01b75663a516279c8b9d243b719643e",
    "faithful categorical[1.0] float32 T=40 S=130 off=12345":
        "a2b87fecc2b5073f875c100496483aecdef3a54306609f71755e274e4a17a487",
    "faithful exponential(1.5) bfloat16 T=256 S=16384 off=4294979641":
        "5896d873867c4d2fd28be60d89f941ae27476212807d9e0d11d33eea678704d6",
    "faithful exponential(1.5) bfloat16 T=40 S=130 off=12345":
        "a09007afbe888c19c5b768a7ac4f40ec023e8312c354c3a5b80c9d12a7a19c84",
    "faithful exponential(1.5) float32 T=256 S=16384 off=4294979641":
        "05a3cce896115ad6671407c8efc20a73e826cb3740b9cae3c98f5aa4b176a037",
    "faithful exponential(1.5) float32 T=40 S=130 off=12345":
        "e1aa58a16dafb0a001a03100f357c8c8ae5ee99f48efc8756af2c7b297e4b7f8",
    "faithful gamma(1.0) float32 T=256 S=16384 off=4294979641":
        "5395f4d933737a43b7a273cddd1636171b9856fc4122f9ab5c6f6c3d57c7b87f",
    "faithful gamma(1.0) float32 T=40 S=130 off=12345":
        "bdf1111efaa55f6cfbe54fa05970cb114ce0a1d69905f08914a899ec3e8160ce",
    "faithful gamma(2.5) bfloat16 T=256 S=16384 off=4294979641":
        "546062aa4fe2aac61593adce692a88107e0cb1ba860755305d87a4eafe81759a",
    "faithful gamma(2.5) bfloat16 T=40 S=130 off=12345":
        "67272c62c120a5be8a9f9df9df73014166fcf8726df546f0e6988baeb23dcab6",
    "faithful gamma(2.5) float32 T=256 S=16384 off=4294979641":
        "445468bf3ae08b889088c5b4d38069ba0a2c6b9f0a33acff8faa68d7e86037d6",
    "faithful gamma(2.5) float32 T=40 S=130 off=12345":
        "a750276e1b2d030815a47bd3f9ef7d06cc2ade9bfdf647b9163617cfeecd9a81",
    "faithful gamma(3.0,0.5) bfloat16 T=256 S=16384 off=4294979641":
        "eecceec1eb56f03cec2fcdf51787fb776c84dbf8b0cc6731c8fa14de6cc45e21",
    "faithful gamma(3.0,0.5) bfloat16 T=40 S=130 off=12345":
        "3f50986011caf8c0cb07bf9f0d5d939f5a85b03d8d2d2f660611ded351626b50",
    "faithful gamma(3.0,0.5) float32 T=256 S=16384 off=4294979641":
        "517cc018ff443df7cb585cddb52788184ab6d02cd5f687d99ff3a0d74a0f742f",
    "faithful gamma(3.0,0.5) float32 T=40 S=130 off=12345":
        "177906045c166d9d6751fe0e8dc81775c1ea9407144ab44a5e63e8831f7c3372",
    "faithful gumbel bfloat16 T=256 S=16384 off=4294979641":
        "5c6c0b78ed7cb83b1050e54a13e7ce4e8b25e59afffd78933f1674bd5fdcbbdd",
    "faithful gumbel bfloat16 T=40 S=130 off=12345":
        "126b7ead71ba612fe6c94305aec3660a9811471cfdf6934f03c32338edba3842",
    "faithful gumbel float32 T=256 S=16384 off=4294979641":
        "3575cbaaa5db4ba5fd031962c120f1f52bc257b1fa89e4441cc2d01a42c7cec2",
    "faithful gumbel float32 T=40 S=130 off=12345":
        "ef3d55d438898b02af45376c0c0d555ff8fee34c514546cfe2ada1032277f1ad",
    "faithful normal bfloat16 T=256 S=16384 off=4294979641":
        "46952347d6a479f53ef90fbdc067e1f1451070d7654f5bf1f1bebc373eff2925",
    "faithful normal bfloat16 T=40 S=130 off=12345":
        "ee39ca67fc01d6e31f9a0d8de31a5364060f89030627ca0586b304fa37a63c1a",
    "faithful normal float32 T=256 S=16384 off=4294979641":
        "f3847bde852e687fa01caeb2b296526b75c1ef43383d3f276a535fd52a3ba490",
    "faithful normal float32 T=40 S=130 off=12345":
        "35522ee23baafd81275cc338dcd426d7ad02e5a806c6d1e78939ad932275d441",
    "faithful poisson(3.5) bfloat16 T=256 S=16384 off=4294979641":
        "64e97f8b58127452d5a229bf343c8c4eb08584f7b67e3553a78e3a2a5a55ac6c",
    "faithful poisson(3.5) bfloat16 T=40 S=130 off=12345":
        "70372e06002a3a22a7012f433b2312bce97f33db9d8c315aa165c76ff9aa0573",
    "faithful poisson(3.5) float32 T=256 S=16384 off=4294979641":
        "82412706af4256676b57631f3c18f837dd67f166bfd766ccd2b5b4497ae7da8c",
    "faithful poisson(3.5) float32 T=40 S=130 off=12345":
        "1a70aca5823db8bc43f5dfa0c14169e1daa5b392dc7939a917c2d816f54bef07",
    "faithful uniform bfloat16 T=256 S=16384 off=4294979641":
        "b43414325830e5d5f3ef11382adccc429114965a77df90f97f862ee7a068ad3e",
    "faithful uniform bfloat16 T=40 S=130 off=12345":
        "db8fbfb382aa268925f47fd242bb4442868a482124d36e369d83e90f540b028f",
    "faithful uniform float32 T=256 S=16384 off=4294979641":
        "4d6e834dc06c079228989df6fbad18626027a7e8165ce15d5ae2c9b5005123ea",
    "faithful uniform float32 T=40 S=130 off=12345":
        "0ab36c47dc16cf520448cc68b313da07e8f1aafe350730b27765abc0830d5db4",
}


DROPOUT_RECORDED: Dict[str, str] = {
    "fused_dropout bfloat16 3x1001 rate=0.1 ctr=0":
        "fcf89ae554211b9042372007730027ef0502c06c6b13083ec60e6a265bf8f0cf",
    "fused_dropout bfloat16 3x1001 rate=0.1 ctr=4294979641":
        "f0e9b9bf4f260cd3311e5a2ef124593c839904e2ff7b296cba42d32d93440c69",
    "fused_dropout bfloat16 3x1001 rate=0.5 ctr=0":
        "c59a6ddfc948b49d428e71fad73c91b920fe810d3c5866717cd4d03a9684983d",
    "fused_dropout bfloat16 3x1001 rate=0.5 ctr=4294979641":
        "c8a47840833ba9ff3d5550c4492a959c5ed90405de2ea23f807b2c4d53f43b4b",
    "fused_dropout bfloat16 3x1001 rate=1e-09 ctr=0":
        "66e72db9c976b391ff63ee283be6625994ce031b3cc3ae7875dd65abe21e2385",
    "fused_dropout bfloat16 3x1001 rate=1e-09 ctr=4294979641":
        "66e72db9c976b391ff63ee283be6625994ce031b3cc3ae7875dd65abe21e2385",
    "fused_dropout bfloat16 4096x3072 rate=0.1 ctr=0":
        "818e910deed73804cd3a78a03056986b5d34fd3c42fd83707160ea5fc743da63",
    "fused_dropout bfloat16 4096x3072 rate=0.1 ctr=4294979641":
        "9ae16a96dd62a7da7f66c5c096fc5b28f5ee6c978a86cdb9b255124b5fb4c73d",
    "fused_dropout bfloat16 4096x3072 rate=0.5 ctr=0":
        "ff25cd923ca8c3a815c8ee7fb60c63214e3f650131baea4f728f734da0db3bc2",
    "fused_dropout bfloat16 4096x3072 rate=0.5 ctr=4294979641":
        "69a485f57a03b962c24eda78ef250768b33e9443e2f83472466a4724d623c73f",
    "fused_dropout bfloat16 4096x3072 rate=1e-09 ctr=0":
        "61fbcda3afab7a23beca26827dacb0e232f20f77d1968fd0c2cc251d8067e488",
    "fused_dropout bfloat16 4096x3072 rate=1e-09 ctr=4294979641":
        "61fbcda3afab7a23beca26827dacb0e232f20f77d1968fd0c2cc251d8067e488",
    "fused_dropout bfloat16 64x1001+1 rate=0.1 ctr=0":
        "1334cd5f46badeb5cc60b061491379969567d49539552cdd0bf646f423e6906b",
    "fused_dropout bfloat16 64x1001+1 rate=0.1 ctr=4294979641":
        "2e815b6c4f051e17b177bad8a546c48495617ec1591e4e7291e55f35775137e1",
    "fused_dropout bfloat16 64x1001+1 rate=0.5 ctr=0":
        "0d978e2c77eaa54a137be3a37b5b433b5b09199a425351e60e0399da858a933d",
    "fused_dropout bfloat16 64x1001+1 rate=0.5 ctr=4294979641":
        "d602239bcde34e6704aa96b9f4ada66c203be864a55c12556ad8dad1b26ed260",
    "fused_dropout bfloat16 64x1001+1 rate=1e-09 ctr=0":
        "d647771adbb4ee145e58e3a7072342a6180f4dfeabdef9f4077fc843c4df4039",
    "fused_dropout bfloat16 64x1001+1 rate=1e-09 ctr=4294979641":
        "d647771adbb4ee145e58e3a7072342a6180f4dfeabdef9f4077fc843c4df4039",
    "fused_dropout bfloat16 8x128 rate=0.1 ctr=0":
        "a79bc8b8b143f1119a58e79db46757ede845c1c7e4c19ea00713c60c670717d8",
    "fused_dropout bfloat16 8x128 rate=0.1 ctr=4294979641":
        "b0cd57355f1e5d89f30df82917fea1b3c28e012beb610e4c822c6a1bf3305afe",
    "fused_dropout bfloat16 8x128 rate=0.5 ctr=0":
        "a3cab49e64a4c02e8d48fe7c865db3a9ed5428b43d97ad781c0c03de1b9f07a0",
    "fused_dropout bfloat16 8x128 rate=0.5 ctr=4294979641":
        "84c77f374be916ec741c565f4c90cb2281dbbf6e51929605a2c9f88bc88ff827",
    "fused_dropout bfloat16 8x128 rate=1e-09 ctr=0":
        "0d28ed410bf4961bb8afe210ba0d0f84a4d0a62672aff32a50c7160cc682b045",
    "fused_dropout bfloat16 8x128 rate=1e-09 ctr=4294979641":
        "0d28ed410bf4961bb8afe210ba0d0f84a4d0a62672aff32a50c7160cc682b045",
    "fused_dropout bfloat16 special rate=0.1 ctr=0":
        "0c99160d35011063ae532875e680571cd93d0808f876576836f2dbd242420d1c",
    "fused_dropout bfloat16 special rate=0.1 ctr=4294979641":
        "7845b9ca753f1655e164dd2597ef988e2c2cb7a2124371b40016f62f92a5103c",
    "fused_dropout bfloat16 special rate=0.5 ctr=0":
        "bf93b437bcd000137c17852f14605a6e999e1c215da762cbef2d82b6d07ad1d0",
    "fused_dropout bfloat16 special rate=0.5 ctr=4294979641":
        "4260f1ae4ca3714c2520f2754036bba75b551582711261b878d10083b7e09ba9",
    "fused_dropout bfloat16 special rate=1e-09 ctr=0":
        "99f5f1f7e363aec71880ee34f6522bb0c0a6fced61625f2d62d7fdbd45dfd421",
    "fused_dropout bfloat16 special rate=1e-09 ctr=4294979641":
        "99f5f1f7e363aec71880ee34f6522bb0c0a6fced61625f2d62d7fdbd45dfd421",
    "fused_dropout bfloat16 special+nan rate=0.1 ctr=0":
        "a3ce56b32eac51a0e87f31d4a0788857f2e5bc1245cdecfca787a1d1b5ce5a5f",
    "fused_dropout bfloat16 special+nan rate=0.1 ctr=4294979641":
        "de8058c2ccd996898504e56a54110e095e04ef4930dcf02b1659f9d6ca500410",
    "fused_dropout bfloat16 special+nan rate=0.5 ctr=0":
        "1208bb235801d2909b01055071775f430638d1186f724e525d3cfe8b4984b874",
    "fused_dropout bfloat16 special+nan rate=0.5 ctr=4294979641":
        "d1ce2db0acbf017b392e9224ae2f0983dd6c7635ccfd7486d7ad46c860e7c7e7",
    "fused_dropout bfloat16 special+nan rate=1e-09 ctr=0":
        "255a45f37fa0484602ae604e9f21e7cd7d6ac73bd1e0b159a21fabf7176ce94e",
    "fused_dropout bfloat16 special+nan rate=1e-09 ctr=4294979641":
        "255a45f37fa0484602ae604e9f21e7cd7d6ac73bd1e0b159a21fabf7176ce94e",
    "fused_dropout float16 3x1001 rate=0.1 ctr=0":
        "58e1ab6765944ec46168e682fd175fb6653b9db1cb4be1f038fb63e09d3caf79",
    "fused_dropout float16 3x1001 rate=0.1 ctr=4294979641":
        "260c00c3f648c6890ca70f0afef4feb108107baa0015df49bed03a4b43d5bca1",
    "fused_dropout float16 3x1001 rate=0.5 ctr=0":
        "e0d05b3ea034414530f11099657ec0c6b4d88ccfea791efee1208e846e56b6b4",
    "fused_dropout float16 3x1001 rate=0.5 ctr=4294979641":
        "e8dd6fab9ee927f34238a7f6254e2aa06fb68573a6a35024727f68ea16034465",
    "fused_dropout float16 3x1001 rate=1e-09 ctr=0":
        "945c6b86acb54a0ce0dc2fe2cc887438493db2b12acea86248c83ae528652ae7",
    "fused_dropout float16 3x1001 rate=1e-09 ctr=4294979641":
        "945c6b86acb54a0ce0dc2fe2cc887438493db2b12acea86248c83ae528652ae7",
    "fused_dropout float16 4096x3072 rate=0.1 ctr=0":
        "d02f76342a07dfcde93ddf045716cb3c0786e1a3adb477ee32315cabf07df214",
    "fused_dropout float16 4096x3072 rate=0.1 ctr=4294979641":
        "6e97735e5315b9ffe75bcfb1f4b7c6b8439456691f6273f45e9f4744d300093c",
    "fused_dropout float16 4096x3072 rate=0.5 ctr=0":
        "37e53f7209cfa96edd82a616ae6ac14da370087eaddd9ef7f782661f20679968",
    "fused_dropout float16 4096x3072 rate=0.5 ctr=4294979641":
        "ec461a0d7261367e13cc2b2aa4db93bbe2f41528282101739c8f538b57692e0a",
    "fused_dropout float16 4096x3072 rate=1e-09 ctr=0":
        "5a824f475367867ed4461fc24ad11a5e15acb4cbae90b4904833b8dab7d644b1",
    "fused_dropout float16 4096x3072 rate=1e-09 ctr=4294979641":
        "5a824f475367867ed4461fc24ad11a5e15acb4cbae90b4904833b8dab7d644b1",
    "fused_dropout float16 64x1001+1 rate=0.1 ctr=0":
        "5acedd7610824c7e6f1d2fc5bee1420b7b288b529a5c76bb488e27b4d1f0e580",
    "fused_dropout float16 64x1001+1 rate=0.1 ctr=4294979641":
        "fb59ef88fd8c1ebe6656bf6ddb15e16165714d5583e3f962fc12f1254a50566a",
    "fused_dropout float16 64x1001+1 rate=0.5 ctr=0":
        "1375a73a01c71aefe14d727786408f257d50a8ba04d0bc3ef16551a378c4a9d5",
    "fused_dropout float16 64x1001+1 rate=0.5 ctr=4294979641":
        "31128bab228caf7bdd0aa02da3aaef394867c5a0cd1178ea84f5de5cd954d8b2",
    "fused_dropout float16 64x1001+1 rate=1e-09 ctr=0":
        "146768d538bc2286fb4a33be3cc355cf40c4e1f26bc9d5fa71dd3ebbf5bbcd6d",
    "fused_dropout float16 64x1001+1 rate=1e-09 ctr=4294979641":
        "146768d538bc2286fb4a33be3cc355cf40c4e1f26bc9d5fa71dd3ebbf5bbcd6d",
    "fused_dropout float16 8x128 rate=0.1 ctr=0":
        "8156368a46dc9a24ba34a2ec0a4b758bec38d57bc62fe5412a49facced80499c",
    "fused_dropout float16 8x128 rate=0.1 ctr=4294979641":
        "2b2aa860acd3e56703d9128da021206a2c75bfbf6cb2698b1ea04dc2298f3054",
    "fused_dropout float16 8x128 rate=0.5 ctr=0":
        "801f9bc5aab6fd627877551fb352e2b0dc91e1224b17c73b5837dd8b845f8fcf",
    "fused_dropout float16 8x128 rate=0.5 ctr=4294979641":
        "de56803f2da30a43382505419630c9363fadaf91f4ee68188aea46968608aaf1",
    "fused_dropout float16 8x128 rate=1e-09 ctr=0":
        "795269b2aeaade6d8be24b7aeb5a74920cbec565b723bbdee6a8ba666e3dda42",
    "fused_dropout float16 8x128 rate=1e-09 ctr=4294979641":
        "795269b2aeaade6d8be24b7aeb5a74920cbec565b723bbdee6a8ba666e3dda42",
    "fused_dropout float16 special rate=0.1 ctr=0":
        "3be7cee87e5e1375aea8bcc0662940ff9ac39cd045aecf81baec6a65846175c9",
    "fused_dropout float16 special rate=0.1 ctr=4294979641":
        "8f6ae4d9999bc3dde6618fcacbc20a27c813b45186972b730aa2cf55ab3232f1",
    "fused_dropout float16 special rate=0.5 ctr=0":
        "92b2984b854b64434d135e293e976801d6a0ea9d0a9f41c109b4ed32432eb88f",
    "fused_dropout float16 special rate=0.5 ctr=4294979641":
        "a267ec49bf516c8b486f9371c4e24aedad0434381bdef092695ff80bd0ca919f",
    "fused_dropout float16 special rate=1e-09 ctr=0":
        "f6c318c213637662655e2d81cba01bba013c20a1164b889bb568f65fc75c1d6c",
    "fused_dropout float16 special rate=1e-09 ctr=4294979641":
        "f6c318c213637662655e2d81cba01bba013c20a1164b889bb568f65fc75c1d6c",
    "fused_dropout float16 special+nan rate=0.1 ctr=0":
        "fd6274daf993c985ec61d449a04b31d50790fc0680746f65869b9a02de90aa79",
    "fused_dropout float16 special+nan rate=0.1 ctr=4294979641":
        "18ea8cc8f1a969cd7c96d0a1c808b3276960597ca110b1860736e05d15240b20",
    "fused_dropout float16 special+nan rate=0.5 ctr=0":
        "042d2231d0f651d767b03f9f06196e1dd0b04b346538b9bb3ddb9b7c0b6bb935",
    "fused_dropout float16 special+nan rate=0.5 ctr=4294979641":
        "e6c44124ee49ead7aa7932f03276fd5e95dab640f9785621e895d09d507b2d9f",
    "fused_dropout float16 special+nan rate=1e-09 ctr=0":
        "1fb9359bea91560b789068e38d4ee183418cc1f9d027b1af655546296080a95e",
    "fused_dropout float16 special+nan rate=1e-09 ctr=4294979641":
        "1fb9359bea91560b789068e38d4ee183418cc1f9d027b1af655546296080a95e",
    "fused_dropout float32 3x1001 rate=0.1 ctr=0":
        "5ae31b91513bdb3f644c8d6757943949049b8183f5b904b0eca58c91e7daf5bd",
    "fused_dropout float32 3x1001 rate=0.1 ctr=4294979641":
        "c728c18b3ebb6958ad8b2d0c53624f8c916dfbd37da21cb26bf2cf132209616d",
    "fused_dropout float32 3x1001 rate=0.5 ctr=0":
        "09a82aaff603fca875e98b05ee57b08d4429488eb97d94d156601e528314544f",
    "fused_dropout float32 3x1001 rate=0.5 ctr=4294979641":
        "f2132d299f926ece0da3c56571083558b147d17838962c1239d7e7a2fabfcc94",
    "fused_dropout float32 3x1001 rate=1e-09 ctr=0":
        "17ae1551c1a31be761ec71a3fa4fb282968aabca9237563e18a7bb9448565f2b",
    "fused_dropout float32 3x1001 rate=1e-09 ctr=4294979641":
        "17ae1551c1a31be761ec71a3fa4fb282968aabca9237563e18a7bb9448565f2b",
    "fused_dropout float32 4096x3072 rate=0.1 ctr=0":
        "9b6d8d0c1fad82d605b9136e42bf547a6a2421bdfccaf87ccddd59c363e8ef0c",
    "fused_dropout float32 4096x3072 rate=0.1 ctr=4294979641":
        "c745df1dcb2e6286503af44773fcc6756340929eb317c0f9c207a9d37c546c0f",
    "fused_dropout float32 4096x3072 rate=0.5 ctr=0":
        "3f78f9cd9cae7df75acb668df4948b7eb3b2992a7dd630608e04493a502827bc",
    "fused_dropout float32 4096x3072 rate=0.5 ctr=4294979641":
        "0cca3b9a60e2e4429f98c16d913efd761b4f9af95bd9e47157108b6d84c02d76",
    "fused_dropout float32 4096x3072 rate=1e-09 ctr=0":
        "ce6fbc720905720d9ae17b977535eb98d397057f06dc71b4141f3f08a2ea7c00",
    "fused_dropout float32 4096x3072 rate=1e-09 ctr=4294979641":
        "ce6fbc720905720d9ae17b977535eb98d397057f06dc71b4141f3f08a2ea7c00",
    "fused_dropout float32 64x1001+1 rate=0.1 ctr=0":
        "d6ac101de3b29ce5b14d169b641eb7f7ee5677c858015496d2e38c795416f52b",
    "fused_dropout float32 64x1001+1 rate=0.1 ctr=4294979641":
        "7f9dab312f0d331f4e613c3f519f65cf551b5d189eff2185c3b3dd2b4f881bbd",
    "fused_dropout float32 64x1001+1 rate=0.5 ctr=0":
        "c5fc72d2cf157890a49238b8cfa65e8f5c2ee6feab84442f4121239261781469",
    "fused_dropout float32 64x1001+1 rate=0.5 ctr=4294979641":
        "d5c1101bb96751ae9019f5d1f5f1161d818d9ae454cb301fb61ca4965511d86e",
    "fused_dropout float32 64x1001+1 rate=1e-09 ctr=0":
        "a425bdefaf5550a0655e03ac9aef89d2e1f7b2bbc1b4be838d6628e3cabbe083",
    "fused_dropout float32 64x1001+1 rate=1e-09 ctr=4294979641":
        "a425bdefaf5550a0655e03ac9aef89d2e1f7b2bbc1b4be838d6628e3cabbe083",
    "fused_dropout float32 8x128 rate=0.1 ctr=0":
        "8f3cf39584c96de75b1527c7b3b045f278a86cf1c3c422c445887b00f6db63dc",
    "fused_dropout float32 8x128 rate=0.1 ctr=4294979641":
        "957a86937e16f0a95d61da6d41a6f7dfc92741515c70f8d1e78aa7363765015e",
    "fused_dropout float32 8x128 rate=0.5 ctr=0":
        "f7f82f242be7bfa8e86e49b63d17b15a38200d3cb1829905faf63b37be82312c",
    "fused_dropout float32 8x128 rate=0.5 ctr=4294979641":
        "61615bf22ac4b39b8d9dc7c2d3ad8de4ae097b6d195c68300e4c09abbb70745a",
    "fused_dropout float32 8x128 rate=1e-09 ctr=0":
        "7cf2c9f0d457a7fa459b7d712cce00ffa3c6e9a76895a049fa7b1a561ae14593",
    "fused_dropout float32 8x128 rate=1e-09 ctr=4294979641":
        "7cf2c9f0d457a7fa459b7d712cce00ffa3c6e9a76895a049fa7b1a561ae14593",
    "fused_dropout float32 special rate=0.1 ctr=0":
        "84b1fd06da071faef1386623b71edd9643ad7b4481d41620bd5f3ef1a9a537fe",
    "fused_dropout float32 special rate=0.1 ctr=4294979641":
        "afc9efb5f54ece2a65fd223cd64071aa8d79ff2ae12936f91abae1b407c2c928",
    "fused_dropout float32 special rate=0.5 ctr=0":
        "8507b7b175c46a25c2dca0f51e8e45f59ee7702481c1d7b149e9109dd0a23e63",
    "fused_dropout float32 special rate=0.5 ctr=4294979641":
        "6a7b611ceb15ed2586dc183f0222b92bf4729125622a0d41ce4c859c5a1d971f",
    "fused_dropout float32 special rate=1e-09 ctr=0":
        "9e11b67d85a56ce30329fca5ecdba7da17d11af228883f75e3b935f00bd4bd88",
    "fused_dropout float32 special rate=1e-09 ctr=4294979641":
        "9e11b67d85a56ce30329fca5ecdba7da17d11af228883f75e3b935f00bd4bd88",
    "fused_dropout float32 special+nan rate=0.1 ctr=0":
        "1f1ce0a5db4ddc2f65effd8648a9f9adca13e5bf8ac357da1944a4d1772eaee1",
    "fused_dropout float32 special+nan rate=0.1 ctr=4294979641":
        "0aab21dbec920242eafa25571598fde7a485ca3812cb43698330389c57eb3dde",
    "fused_dropout float32 special+nan rate=0.5 ctr=0":
        "8a08cc51651cb9b869032cb440e392c57e434e765c84a5ffe4a46a0eb8308845",
    "fused_dropout float32 special+nan rate=0.5 ctr=4294979641":
        "fbd8b933d20228a2ace73bc462d8c7bad2178958c5487ad1791839c2f8b23251",
    "fused_dropout float32 special+nan rate=1e-09 ctr=0":
        "eba169b1afb6f05cbe85f53867d44c22175dbb0123d73a591a478047752a0ef0",
    "fused_dropout float32 special+nan rate=1e-09 ctr=4294979641":
        "eba169b1afb6f05cbe85f53867d44c22175dbb0123d73a591a478047752a0ef0",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    got = {**compute(), **compute_dropout()}
    text = json.dumps(got, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    bad = mismatches(got)
    print(f"{len(got)} digests; {len(bad)} differ from RECORDED")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
