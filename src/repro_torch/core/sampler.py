"""Sampler output stages: distribution shaping fused into generation.

A ``GenPlan`` carries a sampler stage, and every backend applies it where
the bits live: the plain ``"torch"`` backend as tensor code on the bit
block (``apply`` below), the CUDA kernels in registers, so that only the
sampled dtype reaches device memory.  The kernels receive each stage as a
small parameter record built here (``stage_params``): a stage number,
float constants rounded once on the host, and for poisson / categorical a
threshold ladder or alias table.  All constants are bit-equal to the
reference's.

Samplers (``GenPlan.sampler`` spec strings):

  "bits"              raw uint32 (``out_dtype`` ignored)
  "uniform"           U[0, 1) from the top 24 bits, float32 or bfloat16
  "normal"            Box-Muller over adjacent row pairs (2k, 2k+1);
                      needs an even T
  "bernoulli(p)"      bool mask from the exact threshold round(p * 2**32)
  "exponential(r)"    -log(1 - u) / r
  "poisson(r)"        exact-threshold inversion over a float32 CDF ladder
  "gumbel"            -log(-log(u)), u clamped to the smallest normal f32
  "gamma(k[,theta])"  Marsaglia-Tsang with bounded retry rows, scaled
  "categorical[...]"  Walker/Vose alias table

The reference pins products that feed adds with ``fma_guard`` because
XLA may contract ``a*b + c`` into one fused multiply-add depending on the
batch shape.  Eager PyTorch rounds every op on its own, so the plain path
here needs no guard; the CUDA kernels get the same guarantee from
``-fmad=false``.
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import lcg, splitmix, u64
from repro_torch.core.u64 import M32, U64Pair

TINY_F32 = float(np.float32(1.1754944e-38))
TWO_PI_F32 = float(np.float32(2.0 * np.pi))

SamplerSpec = Tuple[str, Optional[object]]

#: The full sampler spec grammar, quoted verbatim by parse() errors.
SPEC_GRAMMAR = (
    "'bits' | 'uniform' | 'normal' | 'gumbel' | 'bernoulli(p)' | "
    "'exponential(rate)' | 'poisson(rate)' | 'gamma(shape[,scale])' "
    "| 'categorical[w0,w1,...]'")

_SCALAR_RE = re.compile(
    r"^(bernoulli|exponential|poisson|gamma)\(([^)]*)\)$")
_CATEGORICAL_RE = re.compile(r"^categorical\[([^\]]*)\]$")
FLOAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

POISSON_MAX_RATE = 32.0
GAMMA_RETRY_ROWS = 6
CATEGORICAL_MAX_OUTCOMES = 64


def _parse_float(kind: str, text: str) -> float:
    try:
        value = float(text)
    except ValueError:
        raise ValueError(
            f"unknown sampler parameter {text!r} for {kind}; "
            f"grammar: {SPEC_GRAMMAR}") from None
    if not np.isfinite(value):
        raise ValueError(f"{kind} parameter must be finite, got {text!r}")
    return value


def parse(spec: str) -> SamplerSpec:
    """Sampler spec string -> hashable (kind, param) tuple.

    >>> parse("poisson(3.5)")
    ('poisson', 3.5)
    >>> parse("gamma(2.5, 0.5)")
    ('gamma', (2.5, 0.5))
    """
    if spec in ("bits", "uniform", "normal", "gumbel"):
        return (spec, None)
    m = _SCALAR_RE.match(spec)
    if m and m.group(1) == "gamma" and "," in m.group(2):
        k_text, _, th_text = m.group(2).partition(",")
        k = _parse_float("gamma", k_text.strip())
        theta = _parse_float("gamma", th_text.strip())
        if k < 1.0:
            raise ValueError(
                f"gamma shape must be >= 1 (Marsaglia-Tsang squeeze "
                f"needs no boost draw), got {k!r}")
        if theta <= 0.0:
            raise ValueError(f"gamma scale must be > 0, got {theta!r}")
        return ("gamma", (k, theta))
    if m:
        kind, p = m.group(1), _parse_float(m.group(1), m.group(2))
        if kind == "exponential" and p <= 0.0:
            raise ValueError(f"exponential rate must be > 0, got {p!r}")
        if kind == "poisson" and not 0.0 <= p <= POISSON_MAX_RATE:
            raise ValueError(f"poisson rate must be in [0, "
                             f"{POISSON_MAX_RATE!r}], got {p!r}")
        if kind == "gamma" and p < 1.0:
            raise ValueError(
                f"gamma shape must be >= 1 (Marsaglia-Tsang squeeze "
                f"needs no boost draw), got {p!r}")
        return (kind, p)
    m = _CATEGORICAL_RE.match(spec)
    if m:
        parts = [s.strip() for s in m.group(1).split(",") if s.strip()]
        weights = tuple(_parse_float("categorical", s) for s in parts)
        if not 1 <= len(weights) <= CATEGORICAL_MAX_OUTCOMES:
            raise ValueError(
                f"categorical needs 1..{CATEGORICAL_MAX_OUTCOMES} "
                f"weights, got {len(weights)}; grammar: {SPEC_GRAMMAR}")
        if min(weights) < 0.0 or sum(weights) <= 0.0:
            raise ValueError(
                f"categorical weights must be >= 0 with positive sum, "
                f"got {weights!r}")
        return ("categorical", weights)
    raise ValueError(f"unknown sampler {spec!r}; grammar: {SPEC_GRAMMAR}")


#: Spec kinds whose outputs are float-coded (see result_dtype).
DISTRIBUTION_KINDS = ("exponential", "poisson", "gamma", "categorical",
                      "gumbel")


def result_dtype(spec: SamplerSpec, out_dtype: str = "float32"
                 ) -> torch.dtype:
    """The torch dtype a sampler stage emits."""
    kind, _ = spec
    if kind == "bits":
        return torch.uint32
    if kind == "bernoulli":
        return torch.bool
    try:
        return FLOAT_DTYPES[out_dtype]
    except KeyError:
        raise ValueError(f"unknown out_dtype {out_dtype!r}; "
                         f"have {sorted(FLOAT_DTYPES)}")


def bernoulli_threshold(p: float) -> int:
    """Exact uint32 threshold for P(bits < thresh) = p (host ints)."""
    return min(int(round(float(p) * (1 << 32))), (1 << 32) - 1)


# ---------------------------------------------------------------------------
# Generation stage
# ---------------------------------------------------------------------------

def ctr_bits(root: U64Pair, ctr: U64Pair, h: U64Pair,
             deco: str = "splitmix64") -> torch.Tensor:
    """ThundeRiNG ctr-mode bits XSH_RR(root + h) ^ deco(h, ctr); operands
    broadcast, so (T, 1) rows against (1, S) offsets give a (T, S) tile."""
    perm = lcg.xsh_rr(u64.add64(root, h))
    deco_fn = splitmix.ctr_decorrelator if deco == "splitmix64" \
        else splitmix.ctr_decorrelator32
    return perm ^ deco_fn(h, ctr)


# ---------------------------------------------------------------------------
# Output-stage transforms on u32 limb tensors
# ---------------------------------------------------------------------------

def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every subnormal value replaced by a zero of its sign:
    the reference's float arithmetic on XLA:CPU reads and writes
    subnormals so (denormals-are-zero, flush-to-zero).  For float32 and
    bfloat16 tensors."""
    sub = (x != 0) & (x.abs() < torch.finfo(x.dtype).tiny)
    return torch.where(sub, x * 0, x)


def uniform_from_bits(bits: torch.Tensor, dtype=torch.float32
                      ) -> torch.Tensor:
    """U[0, 1) from the top 24 bits, at float32; bfloat16 is that value
    rounded once at the end."""
    u = (bits >> 8).to(torch.float32) * 2.0 ** -24
    return u if dtype == torch.float32 else u.to(dtype)


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Standard normal from two U[0,1) arrays (cos branch), log(0)-safe."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, TINY_F32)))
    return r * torch.cos(TWO_PI_F32 * u2)


def normal_pairs(u: torch.Tensor) -> torch.Tensor:
    """(T, S) standard normals from (T, S) uniforms.

    Rows (2k, 2k+1) supply (u1, u2) and receive (r cos th, r sin th).  The
    mate of each row is picked by index; for an odd T the last row pairs
    with row 0, as the reference's roll does.
    """
    T = u.shape[0]
    idx = torch.arange(T, device=u.device)
    even = (idx & 1) == 0
    mate_idx = torch.where(even, (idx + 1) % T, idx - 1)
    mate = u.index_select(0, mate_idx)
    col = even.reshape((T,) + (1,) * (u.dim() - 1))
    u1 = torch.where(col, u, mate)
    u2 = torch.where(col, mate, u)
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, TINY_F32)))
    theta = TWO_PI_F32 * u2
    return r * torch.where(col, torch.cos(theta), torch.sin(theta))


def remix_bits(bits: torch.Tensor, salt: int) -> torch.Tensor:
    """Derived word stream #salt: fmix32 of a golden-ratio-salted copy."""
    return splitmix.fmix32((bits + ((salt * 0x9E3779B9) & M32)) & M32)


def exponential_scale(rate: float) -> float:
    """1 / rate rounded once to float32."""
    return float(np.float32(1.0 / float(rate)))


def exponential_from_bits(bits: torch.Tensor, rate: float) -> torch.Tensor:
    """Exp(rate) float32 by inversion: -log(1 - u) * f32(1 / rate)."""
    u = uniform_from_bits(bits)
    return -torch.log(1.0 - u) * exponential_scale(rate)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel float32 by double-log inversion, -log(-log(u))."""
    u = uniform_from_bits(bits)
    return -torch.log(-torch.log(torch.clamp_min(u, TINY_F32)))


def poisson_thresholds(rate: float) -> Tuple[float, ...]:
    """Float32 CDF threshold ladder for exact-inversion Poisson(rate).

    Entry j is the float64 CDF F(j) rounded once to float32; the ladder
    stops at the first entry above the largest uniform (1 - 2**-24).

    >>> poisson_thresholds(0.0)
    ()
    >>> len(poisson_thresholds(3.5))
    18
    """
    rate = float(rate)
    if not 0.0 <= rate <= POISSON_MAX_RATE:
        raise ValueError(f"poisson rate must be in [0, {POISSON_MAX_RATE!r}]"
                         f", got {rate!r}")
    u_max = 1.0 - 2.0 ** -24
    out, pmf, cdf = [], np.exp(-rate), 0.0
    for j in range(4096):
        cdf += pmf
        t = float(np.float32(cdf))
        if t > u_max:
            break
        out.append(t)
        pmf *= rate / (j + 1)
    return tuple(out)


def gamma_mt_constants(shape: float) -> Tuple[float, float]:
    """Marsaglia-Tsang (d, c) for Gamma(shape >= 1): d = k - 1/3 and
    c = 1/sqrt(9 d), each rounded once to float32 on the host."""
    d = float(shape) - 1.0 / 3.0
    return (float(np.float32(d)),
            float(np.float32(1.0 / np.sqrt(9.0 * d))))


def gamma_from_bits(bits: torch.Tensor, shape: float) -> torch.Tensor:
    """Gamma(shape >= 1, scale 1) float32 via Marsaglia-Tsang with bounded
    retry rows: candidate r draws (u1, u2, u_accept) from
    remix_bits(bits, 3r+1..3r+3); the first accepted candidate wins, and
    an element whose candidates all reject takes the central value d."""
    d, c = gamma_mt_constants(shape)
    out = torch.full(bits.shape, d, dtype=torch.float32, device=bits.device)
    for r in reversed(range(GAMMA_RETRY_ROWS)):
        u1 = uniform_from_bits(remix_bits(bits, 3 * r + 1))
        u2 = uniform_from_bits(remix_bits(bits, 3 * r + 2))
        ua = uniform_from_bits(remix_bits(bits, 3 * r + 3))
        z = box_muller(u1, u2)
        v = 1.0 + c * z
        lv = torch.log(torch.clamp_min(v, TINY_F32))
        lv3 = (lv + lv) + lv
        v3 = v * v * v
        zz = z * z
        squeeze = (1.0 - ua) > float(np.float32(0.0331)) * zz * zz
        log_ok = (torch.log(torch.clamp_min(ua, TINY_F32)) - 0.5 * zz) < (
            d * ((1.0 - v3) + lv3))
        accept = (v > 0.0) & (squeeze | log_ok)
        out = torch.where(accept, d * v3, out)
    return out


def alias_table(weights: Tuple[float, ...]) -> Tuple[Tuple[float, int], ...]:
    """Walker/Vose alias table: K packed (threshold, alias) pairs, the
    thresholds built in float64 and rounded once to float32.

    >>> [(round(t, 4), a) for t, a in alias_table((0.5, 0.25, 0.25))]
    [(1.0, 0), (0.75, 0), (0.75, 0)]
    """
    total = float(sum(weights))
    k = len(weights)
    scaled = [w / total * k for w in weights]
    thresh, alias = [0.0] * k, [0] * k
    small = [j for j in range(k) if scaled[j] < 1.0]
    large = [j for j in range(k) if scaled[j] >= 1.0]
    while small and large:
        s, g = small.pop(), large.pop()
        thresh[s], alias[s] = scaled[s], g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    for j in large + small:
        thresh[j], alias[j] = 1.0, j
    return tuple((float(np.float32(t)), a) for t, a in zip(thresh, alias))


def categorical_from_bits(bits: torch.Tensor,
                          weights: Tuple[float, ...]) -> torch.Tensor:
    """Category index (float32-coded): bin = floor(u K), then the flip
    uniform from remix_bits(bits, 0) keeps the bin or takes its alias."""
    table = alias_table(weights)
    k = len(table)
    if k == 1:
        return torch.zeros(bits.shape, dtype=torch.float32,
                           device=bits.device)
    thresh = torch.tensor([t for t, _ in table], dtype=torch.float32,
                          device=bits.device)
    alias = torch.tensor([float(a) for _, a in table], dtype=torch.float32,
                         device=bits.device)
    bin_f = torch.floor(uniform_from_bits(bits) * float(k))
    flip = uniform_from_bits(remix_bits(bits, 0))
    j = bin_f.to(torch.int64)
    return torch.where(flip < thresh[j], bin_f, alias[j])


def apply(bits: torch.Tensor, spec: SamplerSpec,
          out_dtype: str = "float32") -> torch.Tensor:
    """Apply a parsed sampler stage to a u32 limb bit block (int64 tensor
    of u32 values); ``bits`` comes back as a ``torch.uint32`` tensor."""
    kind, p = spec
    dtype = result_dtype(spec, out_dtype)
    if kind == "bits":
        return u64.to_u32(bits)
    if kind == "uniform":
        return uniform_from_bits(bits, dtype)
    if kind == "bernoulli":
        if p <= 0.0:
            return torch.zeros(bits.shape, dtype=torch.bool,
                               device=bits.device)
        if p >= 1.0:
            return torch.ones(bits.shape, dtype=torch.bool,
                              device=bits.device)
        return bits < bernoulli_threshold(p)
    if kind == "normal":
        x = normal_pairs(uniform_from_bits(bits))
    elif kind == "exponential":
        x = exponential_from_bits(bits, p)
    elif kind == "poisson":
        u = uniform_from_bits(bits)
        x = torch.zeros(bits.shape, dtype=torch.float32, device=bits.device)
        for t in poisson_thresholds(p):
            x = x + (u >= t).to(torch.float32)
    elif kind == "gamma":
        shape, scale = p if isinstance(p, tuple) else (p, None)
        x = exponential_from_bits(bits, 1.0) if shape == 1.0 \
            else gamma_from_bits(bits, shape)
        if scale is not None and scale != 1.0:
            x = x * float(np.float32(scale))
    elif kind == "gumbel":
        x = gumbel_from_bits(bits)
    elif kind == "categorical":
        x = categorical_from_bits(bits, p)
    else:
        raise ValueError(f"unknown sampler kind {kind!r}")
    return x if dtype == torch.float32 else x.to(dtype)


# ---------------------------------------------------------------------------
# Kernel parameter records
# ---------------------------------------------------------------------------

#: Stage numbers shared with ``csrc/sampler_stage.cuh``.
STAGE_IDS = {"bits": 0, "uniform": 1, "normal": 2, "bernoulli": 3,
             "exponential": 4, "poisson": 5, "gamma": 6, "gumbel": 7,
             "categorical": 8}
#: Output type numbers shared with ``csrc/sampler_stage.cuh``.
OUT_TYPE_IDS = {torch.uint32: 0, torch.float32: 1, torch.bfloat16: 2,
                torch.bool: 3}


def stage_params(spec: SamplerSpec, out_dtype: str = "float32"):
    """Host-side constants of a stage for the CUDA kernels.

    Returns ``(stage, out_type, f0, f1, f2, thresh, flag, table_f,
    table_i)``: the float constants are float32-exact python floats, the
    tables python lists (empty when the stage has none).
    """
    kind, p = spec
    out_type = OUT_TYPE_IDS[result_dtype(spec, out_dtype)]
    f0 = f1 = 0.0
    f2 = 1.0
    thresh, flag = 0, 0
    table_f, table_i = [], []
    if kind == "bernoulli":
        if p >= 1.0:
            flag = 1                      # constant True
        elif p > 0.0:
            thresh = bernoulli_threshold(p)
    elif kind == "exponential":
        f0 = exponential_scale(p)
    elif kind == "poisson":
        table_f = list(poisson_thresholds(p))
    elif kind == "gamma":
        shape, scale = p if isinstance(p, tuple) else (p, None)
        if shape == 1.0:
            flag = 1                      # the exact Exp(1) path
        else:
            f0, f1 = gamma_mt_constants(shape)
        if scale is not None:
            f2 = float(np.float32(scale))
    elif kind == "categorical":
        table = alias_table(p)
        table_f = [t for t, _ in table]
        table_i = [a for _, a in table]
    return (STAGE_IDS[kind], out_type, f0, f1, f2, thresh, flag, table_f,
            table_i)


def ulp_error(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise |a - b| in units of the float spacing of ``a``'s dtype
    at max(|a|, |b|, 1).

    The measure for the stages that use log, sin or cos: their rounding
    error is relative to the inputs of the last transcendental, so an
    output near zero (gumbel at u = 1/e, a normal at theta = pi/2) carries
    an absolute error of the order of the spacing at 1, which a raw ULP
    count of the tiny output would inflate without bound.
    """
    mant = {torch.float32: 23, torch.bfloat16: 7}[a.dtype]
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    mag = torch.clamp_min(torch.maximum(a64.abs(), b64.abs()), 1.0)
    return (a64 - b64).abs() / torch.exp2(torch.floor(torch.log2(mag)) - mant)
