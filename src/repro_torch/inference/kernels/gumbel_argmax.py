"""Fused gumbel-max token sampling: one kernel from counter bits to token
ids.

The gumbel-max trick samples ``softmax(logits / temperature)`` by adding
independent standard-Gumbel noise to the scaled logits and taking the
argmax.  A two-pass implementation materialises the (vocab, batch) noise
block in memory and then reduces it against the logits; at decode batch
sizes that noise block is the largest tensor the sampler touches.  Kernel
F (``csrc/gumbel_argmax.cu``) fuses the whole chain instead:

  counter bits (ThundeRiNG ctr mode, one leaf offset per live sequence)
    -> u = top-24-bit uniform
    -> g = -log(-log(u))                (the grammar's "gumbel" stage)
    -> score = f32(logit * inv_temp) + g, top-k mask
    -> first argmax over the vocabulary
    -> (batch,) int32 token ids

in registers, so neither the bit block nor the noise block reaches device
memory.  Logits are read as the sampler holds them, (B, V) row-major; a
(V, B) vocab-major block (the reference's TPU layout) is passed as its
transposed view, and the kernel follows the strides.

Vocabulary entry v of a decode step with counter window ``[ctr, ctr+V)``
draws the bits at counter ``ctr + v``, root ``x_{ctr+v+1}``, leaf ``h_b``:
column b of the (V, B) gumbel block ``engine.generate`` makes for that
window, so the two-pass oracle ``twopass_argmax`` over that block gives
the same tokens.

Ties go to the first index (``argmax_first``), as ``jnp.argmax`` and the
reference kernel do; -0.0 and +0.0 compare equal.  A sequence whose
scores are all -inf (``thresh = +inf``, or every logit -inf) gets token 0.

``fused_argmax`` takes the plain version ``fused_argmax_plain`` for
tensors on the CPU and launches kernel F for CUDA tensors; the counter
``fused_argmax.launches`` (``repro_torch.trace``) counts the launches and
``fused_argmax_plain.cuda_runs`` the plain version's runs on a card.  On
the card a call is one launch of one thread block cluster per
row (``launch_plan``; the card's cluster occupancy and the in-block jump
table ``affine_table`` are set up once per device), with no scratch
tensor and no host jump: the kernel takes ``x0`` and ``ctr`` as they
are.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import engine, lcg, sampler as sampler_mod
from repro_torch.core.u64 import M32, M64, U64Pair
from repro_torch.kernels import build

DECO_IDS = {"splitmix64": 0, "fmix32": 1}

_NEG_INF = float("-inf")
_I32_MAX = 2 ** 31 - 1
# rows of (B, V) the plain version scores at once: bounds its int64 limb
# temporaries at ~2**22 elements each
_PLAIN_ELEMS = 2 ** 22


#: ga_launch's argument block, ``struct GaArgs`` of gumbel_argmax.cu:
#: every field 8 bytes, packed in one call so that ctypes converts one
#: pointer rather than twenty numbers (~0.2 us each)
_LAUNCH_ARGS = struct.Struct("<QqqqqQQQQdqqqQQQQQqQ")
#: block sizes kernel F is built for
BLOCK_THREADS = (256, 512, 1024)
#: the largest cluster kernel F takes, the card's non-portable maximum:
#: 8 is portable, more needs the non-portable cluster attribute, which
#: ``ga_configure`` sets.  Clusters of up to 16 measured faster than of up
#: to 8 where B < 64 and the same above (tools/kernel_times.py)
CLUSTER_MOST = 16


class LaunchPlan(NamedTuple):
    """Kernel F's grid for one (B, V): per row one cluster of ``cluster``
    blocks of ``threads`` threads, G = cluster * threads threads, and the
    root's affine map of G steps, (jump_a, jump_c)."""
    cluster: int
    threads: int
    jump_a: int
    jump_c: int


def launch_plan(B: int, V: int, max_clusters: Mapping[Tuple[int, int], int]
                ) -> LaunchPlan:
    """The (cluster, threads) of a (B, V) call.

    ``max_clusters[threads, cluster]`` is how many such clusters the card
    holds at once (0 or missing: it cannot launch one).  Every block must own a
    vocabulary entry.  Among the sizes whose B clusters fit in one wave,
    the one with the most threads per row that own an entry wins (ties:
    fewer threads per row, then the larger block); when none fits, the
    one with the fewest threads per row.
    """
    best = None
    for threads in BLOCK_THREADS:
        for c in range(1, CLUSTER_MOST + 1):
            resident = max_clusters.get((threads, c), 0)
            if resident < 1 or (c - 1) * threads >= V:
                continue
            row = c * threads
            rank = (True, min(row, V), -row, threads) if B <= resident \
                else (False, 0, -row, threads)
            if best is None or rank > best[0]:
                best = (rank, c, threads)
    if best is None:
        raise RuntimeError("kernel F: no cluster of any block size fits "
                           "this card")
    _, c, threads = best
    jump_a, jump_c = lcg.lcg_skip(c * threads)
    return LaunchPlan(c, threads, jump_a, jump_c)


def affine_table(threads: int) -> np.ndarray:
    """(threads, 2) uint64: (A_t, C_t) of t root steps for t in [0,
    threads), ``lcg.block_affine_constants(threads)`` as kernel F reads
    it: thread t of a block turns the block's root into its own."""
    a_hi, a_lo, c_hi, c_lo = (x.astype(np.uint64)
                              for x in lcg.block_affine_constants(threads))
    sh = np.uint64(32)
    return np.stack([(a_hi << sh) | a_lo, (c_hi << sh) | c_lo], axis=1)


class _Card:
    """Kernel F's state on one device, made once: the library, the
    resident cluster counts per (threads, cluster), the uploaded affine
    tables and the launch plans by (B, V)."""

    def __init__(self, device: torch.device):
        lib = build.library("gumbel_argmax")
        cint = ctypes.c_int
        lib.ga_configure.argtypes = [cint, cint, ctypes.POINTER(cint)]
        lib.ga_configure.restype = cint
        lib.ga_launch.argtypes = [ctypes.c_char_p]
        lib.ga_launch.restype = cint
        lib.ga_gumbel_mismatches.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ga_gumbel_mismatches.restype = cint
        lib.ga_error_string.argtypes = [cint]
        lib.ga_error_string.restype = ctypes.c_char_p
        self.lib, self.index = lib, device.index
        self.max_clusters = {}
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            for threads in BLOCK_THREADS:
                for c in range(1, CLUSTER_MOST + 1):
                    self.check(lib.ga_configure(threads, c, ctypes.byref(n)))
                    self.max_clusters[threads, c] = n.value
        self.affine = {t: torch.from_numpy(affine_table(t).view(np.int64))
                       .to(device) for t in BLOCK_THREADS}
        self.plans: Dict[Tuple[int, int], LaunchPlan] = {}

    def plan(self, B: int, V: int) -> LaunchPlan:
        got = self.plans.get((B, V))
        if got is None:
            got = self.plans[B, V] = launch_plan(B, V, self.max_clusters)
        return got

    def check(self, code: int) -> None:
        if code != 0:
            raise RuntimeError(f"fused_argmax launch failed: "
                               f"{self.lib.ga_error_string(code).decode()}")


_CARDS: Dict[int, _Card] = {}


def _current_stream(index: int) -> int:
    """The raw handle of PyTorch's current stream on card ``index``.  The
    private accessor is the one torch's own generated kernels launch with:
    ~0.2 us a call, where torch.cuda.current_stream(index) builds a Stream
    object in ~9 us (tools/kernel_times.py --sweep)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _card(device: torch.device) -> _Card:
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    card = _CARDS.get(index)
    if card is None:
        card = _CARDS[index] = _Card(torch.device("cuda", index))
    return card


def gumbel_mismatches(device) -> int:
    """How many of the 2^24 uniforms get other noise from kernel F's
    branch-free logf than from CUDA's logf (``tb_gumbel``, the sampler
    stage's), counted on ``device``'s card.  Kernel F is bit-equal to its
    plain version only when this is 0."""
    card = _card(torch.device(device))
    count = torch.zeros(1, dtype=torch.int32, device=f"cuda:{card.index}")
    with torch.cuda.device(card.index):
        card.check(card.lib.ga_gumbel_mismatches(
            count.data_ptr(), _current_stream(card.index)))
    return int(count.item())


# ---------------------------------------------------------------------------
# The shared scoring transform
# ---------------------------------------------------------------------------

def gumbel_scores(bits: torch.Tensor, logits: torch.Tensor,
                  inv_temp: float) -> torch.Tensor:
    """Perturbed scores: ``f32(logits * inv_temp) + gumbel(bits)``.

    The one scoring transform shared by the plain version of kernel F and
    the two-pass oracle.  ``bits`` are u32 values in an int64 tensor;
    ``inv_temp`` is the host's float32 rounding of 1 / temperature.  Eager
    torch rounds the product before the add, as the reference's
    ``fma_guard`` makes XLA do and as kernel F does under ``-fmad=false``.
    """
    return scaled_logits(logits, inv_temp) + sampler_mod.gumbel_from_bits(bits)


def scaled_logits(logits: torch.Tensor, inv_temp: float) -> torch.Tensor:
    """``f32(logits * inv_temp)`` with subnormal inputs and results read
    as zeros of their sign, as the reference computes it on XLA:CPU."""
    flush = sampler_mod.flush_subnormal
    return flush(flush(logits) * float(inv_temp))


def argmax_first(scores: torch.Tensor) -> torch.Tensor:
    """Column-wise argmax over axis 0, FIRST max index wins: (B,) int32.

    Max, then the minimum row index attaining it, as the reference writes
    it; -0.0 and +0.0 are equal.
    """
    m = scores.max(dim=0, keepdim=True).values
    row = torch.arange(scores.shape[0], device=scores.device,
                       dtype=torch.int32).reshape(
                           (-1,) + (1,) * (scores.dim() - 1))
    cand = torch.where(scores == m, row,
                       torch.full_like(row, _I32_MAX))
    return cand.min(dim=0).values


def _masked(scores: torch.Tensor, logits: torch.Tensor,
            thresh: torch.Tensor) -> torch.Tensor:
    """Top-k mask: tokens whose LOGIT is below the per-sequence k-th
    largest logit can never win (-inf score).  Thresholding on raw logits
    keeps the kept set independent of the noise.  A subnormal logit or
    threshold compares as a zero of its sign, as in the reference (so
    every subnormal of a column ties with zero at a threshold of zero)."""
    flush = sampler_mod.flush_subnormal
    return torch.where(flush(logits) >= flush(thresh), scores,
                       torch.full_like(scores, _NEG_INF))


# ---------------------------------------------------------------------------
# Leaf offsets
# ---------------------------------------------------------------------------

def leaf_words(hs: Sequence[int], device="cpu") -> torch.Tensor:
    """(B,) int64 tensor holding the u64 bit patterns of python-int leaf
    offsets: the form kernel F reads, made in one copy."""
    return torch.tensor([h - (1 << 64) if h >= 1 << 63 else h
                         for h in (int(x) & M64 for x in hs)],
                        dtype=torch.int64, device=device)


def words_to_limbs(h: torch.Tensor) -> U64Pair:
    """(hi, lo) limb tensors of a ``leaf_words`` tensor."""
    return (h >> 32) & M32, h & M32


# ---------------------------------------------------------------------------
# Kernel F and its plain version
# ---------------------------------------------------------------------------

def _check(logits: torch.Tensor, h: torch.Tensor, thresh: torch.Tensor
           ) -> Tuple[int, int]:
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"logits must be a (B, V) float32 tensor, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    B, V = logits.shape
    if V < 1:
        raise ValueError("the vocabulary must not be empty")
    if h.shape != (B,) or h.dtype != torch.int64:
        raise ValueError(f"h must be a ({B},) int64 tensor of leaf words, "
                         f"got {tuple(h.shape)} {h.dtype}")
    if thresh.shape != (B,) or thresh.dtype != torch.float32:
        raise ValueError(f"thresh must be a ({B},) float32 tensor, got "
                         f"{tuple(thresh.shape)} {thresh.dtype}")
    if not (logits.device == h.device == thresh.device):
        raise ValueError(f"logits, h and thresh lie on different devices: "
                         f"{logits.device}, {h.device}, {thresh.device}")
    return B, V


def fused_argmax_plain(logits: torch.Tensor, h: torch.Tensor, x0: int,
                       ctr: int, thresh: torch.Tensor, *, inv_temp: float,
                       deco: str = "splitmix64", with_scores: bool = False):
    """Plain torch version of kernel F: (B,) int32 tokens, and with
    ``with_scores`` also the (B,) float32 winning scores (-0.0 as +0.0,
    the form kernel F reports them in).

    Scores rows in chunks of ``_PLAIN_ELEMS`` elements; each element's
    score is the same in any chunking.
    """
    B, V = _check(logits, h, thresh)
    if logits.is_cuda:
        trace.count("fused_argmax_plain.cuda_runs")
    root, crow = engine.root_and_ctr_rows(x0, ctr & M64, V, logits.device)
    hh, hl = words_to_limbs(h)
    step = max(1, _PLAIN_ELEMS // V)
    toks, best = [], []
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        bits = sampler_mod.ctr_bits(
            (root[0][None, :], root[1][None, :]),
            (crow[0][None, :], crow[1][None, :]),
            (hh[b0:b1, None], hl[b0:b1, None]), deco=deco)
        lg = logits[b0:b1]
        s = _masked(gumbel_scores(bits, lg, inv_temp), lg,
                    thresh[b0:b1, None])
        tok = argmax_first(s.T)
        toks.append(tok)
        if with_scores:
            best.append(s.gather(1, tok[:, None].long())[:, 0] + 0.0)
    tokens = torch.cat(toks)
    return (tokens, torch.cat(best)) if with_scores else tokens


def fused_argmax(logits: torch.Tensor, h: torch.Tensor, x0: int, ctr: int,
                 thresh: torch.Tensor, *, inv_temp: float,
                 deco: str = "splitmix64",
                 out: Optional[torch.Tensor] = None,
                 scores_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) int32 sampled tokens from a (B, V) float32 logit view.

    ``h``: (B,) int64 leaf words (``leaf_words``), one per sequence: each
    live sequence's tag selects its independent stream.  ``x0``, ``ctr``:
    the family's root base state and the step's counter window start
    (python ints).  ``thresh``: (B,) float32 top-k logit thresholds (-inf
    disables the mask).  ``inv_temp``: float32 1 / temperature.  ``out``
    ((B,) int32) receives the tokens and ``scores_out`` ((B,) float32)
    the winning scores (-0.0 as +0.0), a debug output.
    """
    B, V = _check(logits, h, thresh)
    if deco not in DECO_IDS:
        raise ValueError(f"unknown deco {deco!r}; have {sorted(DECO_IDS)}")
    for name, t, dt in (("out", out, torch.int32),
                        ("scores_out", scores_out, torch.float32)):
        if t is not None and (t.shape != (B,) or t.dtype != dt
                              or t.device != logits.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) {dt} "
                             f"tensor on {logits.device}")
    if logits.device.type == "cpu":
        if scores_out is None:
            tokens = fused_argmax_plain(logits, h, x0, ctr, thresh,
                                        inv_temp=inv_temp, deco=deco)
        else:
            tokens, best = fused_argmax_plain(logits, h, x0, ctr, thresh,
                                              inv_temp=inv_temp, deco=deco,
                                              with_scores=True)
            scores_out.copy_(best)
        return tokens if out is None else out.copy_(tokens)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_argmax runs on cpu or cuda, not "
                         f"{logits.device}")
    card = _card(logits.device)
    plan = card.plan(B, V)
    h, thresh = h.contiguous(), thresh.contiguous()
    if out is None:
        out = torch.empty(B, dtype=torch.int32, device=logits.device)
    card.check(card.lib.ga_launch(_LAUNCH_ARGS.pack(
        logits.data_ptr(), logits.stride(0), logits.stride(1), B, V,
        h.data_ptr(), thresh.data_ptr(), x0 & M64, ctr & M64,
        float(inv_temp), DECO_IDS[deco], plan.threads, plan.cluster,
        card.affine[plan.threads].data_ptr(), plan.jump_a, plan.jump_c,
        out.data_ptr(), 0 if scores_out is None else scores_out.data_ptr(),
        card.index, _current_stream(card.index))))
    trace.count("fused_argmax.launches")
    return out


# ---------------------------------------------------------------------------
# Two-pass oracle
# ---------------------------------------------------------------------------

def twopass_argmax(logits_t: torch.Tensor, noise: torch.Tensor,
                   thresh: torch.Tensor, *, inv_temp: float) -> torch.Tensor:
    """(B,) int32 tokens from a MATERIALISED (V, B) gumbel noise block.

    The oracle kernel F is checked against: ``noise`` comes from
    ``engine.generate`` with the ``"gumbel"`` sampler stage, and the
    scoring, masking and argmax here are the kernel's plain helpers, so a
    disagreement isolates the kernel's dataflow, not the math.
    ``logits_t`` is (V, B); the sampler passes a transposed view.
    """
    logits_t = logits_t.to(torch.float32)
    score = scaled_logits(logits_t, inv_temp) + noise
    return argmax_first(_masked(score, logits_t, thresh.reshape(1, -1)))
