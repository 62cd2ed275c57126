"""Plain-torch oracles of the block generators.

The semantics the CUDA kernels must reproduce bit for bit.  Blocks are
time-major ``(T, S)``: one root row per time index, shared by S streams
(the paper's one root state per cycle feeding S SOUs).  Both oracles
return the u32 bit block as an int64 limb tensor, before any sampler
stage.  The dropout and Monte-Carlo oracles below them are the plain
semantics of ``fused_dropout`` and ``mc``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import lcg, sampler, u64, xorshift
from repro_torch.core.u64 import U64Pair


def leaf_outputs(root: U64Pair, h: U64Pair) -> torch.Tensor:
    """XSH_RR(root[t] + h[s]): (T,) roots x (S,) offsets -> (T, S)."""
    leaf = u64.add64((root[0][:, None], root[1][:, None]),
                     (h[0][None, :], h[1][None, :]))
    return lcg.xsh_rr(leaf)


def counter_rows(ctr: int, num_steps: int, device) -> U64Pair:
    """(T,) per-row counters ctr + t as limbs."""
    t = torch.arange(num_steps, dtype=torch.int64, device=device)
    c_hi, c_lo = u64.split64(ctr)
    return u64.add64((torch.full_like(t, c_hi), torch.full_like(t, c_lo)),
                     (torch.zeros_like(t), t))


def thundering_block_ctr(x0: int, h: U64Pair, num_steps: int, ctr: int,
                         deco: str = "splitmix64") -> torch.Tensor:
    """(T, S) bits, ctr-mode decorrelator:
    XSH_RR(A_{ctr+t+1} x0 + C_{ctr+t+1} + h_s) ^ deco(h_s, ctr + t)."""
    device = h[0].device
    rh, rl = lcg.root_states_vector(x0, ctr, num_steps, device=device)
    ch, cl = counter_rows(ctr, num_steps, device)
    return sampler.ctr_bits((rh[:, None], rl[:, None]),
                            (ch[:, None], cl[:, None]),
                            (h[0][None, :], h[1][None, :]), deco=deco)


def thundering_block_faithful(x0: int, h: U64Pair, num_steps: int,
                              xs_state: torch.Tensor, ctr: int
                              ) -> torch.Tensor:
    """(T, S) bits with the paper's serial xorshift128 decorrelator.

    ``xs_state``: (S, 4) u32 limbs, substream s already advanced to ctr.
    """
    roots = lcg.root_states_vector(x0, ctr, num_steps, device=h[0].device)
    permuted = leaf_outputs(roots, h)
    x, y, z, w = (xs_state[:, i] for i in range(4))
    rows = []
    for t in range(num_steps):
        x, y, z, w = xorshift.step_xyzw(x, y, z, w)
        rows.append(permuted[t] ^ w)
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# Fused dropout
# ---------------------------------------------------------------------------

def dropout_mask_bits(h: int, x0: int, ctr0: int, n: int,
                      device="cpu") -> torch.Tensor:
    """(n,) u32 limbs consumed by fused dropout: the ctr pipeline for
    elements ctr0 .. ctr0+n-1 of leaf h (flat), i.e. a one-stream block."""
    h_hi, h_lo = u64.split64(h)
    leaf = (torch.tensor([h_hi], dtype=torch.int64, device=device),
            torch.tensor([h_lo], dtype=torch.int64, device=device))
    return thundering_block_ctr(x0, leaf, n, ctr0)[:, 0]


def fused_dropout(x: torch.Tensor, h: int, x0: int, ctr0: int,
                  rate: float) -> torch.Tensor:
    """Reference fused dropout: element p keeps iff its mask bits are below
    round((1 - rate) 2^32); kept values are x * scale, scale being x's
    dtype's rounding of 1 / (1 - rate).

    bfloat16 and float32 subnormal inputs become a zero of their sign
    before the multiply, as the reference's XLA:CPU computation treats
    denormals as zero; float16 widens to float32 normals and keeps them.
    """
    bits = dropout_mask_bits(h, x0, ctr0, x.numel(), x.device)
    if rate > 0:
        keep = bits < sampler.bernoulli_threshold(1.0 - rate)
    else:
        keep = torch.ones_like(bits, dtype=torch.bool)
    if x.dtype in (torch.bfloat16, torch.float32):
        x = sampler.flush_subnormal(x)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep.reshape(x.shape), x * scale, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Monte-Carlo case studies
# ---------------------------------------------------------------------------

def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """U[0,1) float32 from the top 24 bits (the shared sampler stage)."""
    return sampler.uniform_from_bits(bits)


def mc_pi_from_uniforms(ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """(S,) int32 in-circle counts from (T, S) coordinate uniforms."""
    return ((ux * ux + uy * uy) < 1.0).sum(0, dtype=torch.int32)


def mc_pi_partial(x0: int, hx: U64Pair, hy: U64Pair, num_draws: int,
                  ctr: int) -> torch.Tensor:
    """Reference for the fused pi kernel: lane s owns two streams (leaf
    hx[s] for x, hy[s] for y); (S,) int32 in-circle counts."""
    ux = uniform_from_bits(thundering_block_ctr(x0, hx, num_draws, ctr))
    uy = uniform_from_bits(thundering_block_ctr(x0, hy, num_draws, ctr))
    return mc_pi_from_uniforms(ux, uy)


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Standard normal from two U[0,1) tensors (the shared sampler stage)."""
    return sampler.box_muller(u1, u2)


def option_constants(s0: float, k: float, r: float, sigma: float,
                     t: float) -> Tuple[float, float, float, float, float]:
    """(s0, k, drift, vol, disc) of the GBM call integrand as float32
    values: drift = f32((r - sigma^2/2) t), vol = f32(sigma) sqrt(f32(t)),
    disc = exp(f32(-r t)), the last two computed in float32, as the
    reference's kernel rounds them."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32)
    vol = f32(sigma) * torch.sqrt(f32(t))
    disc = torch.exp(f32(-r * t))
    return (float(np.float32(s0)), float(np.float32(k)),
            float(np.float32((r - 0.5 * sigma * sigma) * t)), float(vol),
            float(disc))


def mc_option_from_uniforms(u1: torch.Tensor, u2: torch.Tensor, s0: float,
                            k: float, r: float, sigma: float,
                            t: float) -> torch.Tensor:
    """(S,) f32 per-stream sums of discounted call payoffs
    max(S_T - k, 0) e^{-rt}, S_T = s0 exp(drift + vol z), z the
    Box-Muller normal of (u1, u2), from (T, S) uniforms."""
    s0_, k_, drift, vol, disc = option_constants(s0, k, r, sigma, t)
    st = s0_ * torch.exp(drift + vol * box_muller(u1, u2))
    payoff = torch.clamp_min(st - k_, 0.0) * disc
    return payoff.sum(0, dtype=torch.float32)


def mc_option_partial(x0: int, hx: U64Pair, hy: U64Pair, num_draws: int,
                      ctr: int, s0: float, k: float, r: float, sigma: float,
                      t: float) -> torch.Tensor:
    """Reference for the fused Black-Scholes MC kernel: per-stream sum of
    discounted call payoffs over num_draws GBM terminal prices. (S,) f32."""
    u1 = uniform_from_bits(thundering_block_ctr(x0, hx, num_draws, ctr))
    u2 = uniform_from_bits(thundering_block_ctr(x0, hy, num_draws, ctr))
    return mc_option_from_uniforms(u1, u2, s0, k, r, sigma, t)
