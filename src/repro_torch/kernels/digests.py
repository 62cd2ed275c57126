"""Recorded sha256 digests of the block generators' output bytes.

Journal replay (``service.audit``, ``inference.scheduler``) regenerates
blocks long after they were first drawn, so kernels A and B must keep
writing the same bytes when they are rebuilt or redesigned.  The float
stages are held against their plain versions only within a few ULP, so
that check cannot show it; these digests can.  ``RECORDED`` holds the
digests of every sampler stage and dtype, both decorrelators and faithful
mode, at two shapes, as the card's kernels wrote them (NVIDIA H100 80GB
HBM3); ``compute`` recomputes them through ``engine.generate``.

On a CPU the plain versions run instead: their integer and threshold
stages give the recorded bytes, their log / trig stages differ by ULPs.

    python -m repro_torch.kernels.digests [--out FILE]   # on a card
"""
from __future__ import annotations

import argparse
import hashlib
import json
from typing import Dict, Iterator, Tuple

import torch

from repro_torch.core import engine

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


def mismatches(got: Dict[str, str]) -> list:
    """Keys of ``got`` whose digest differs from the recorded one."""
    return [k for k, v in got.items() if RECORDED.get(k) != v]


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    got = compute()
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
