"""Plain-torch oracles of the block generators.

The semantics the CUDA kernels must reproduce bit for bit.  Blocks are
time-major ``(T, S)``: one root row per time index, shared by S streams
(the paper's one root state per cycle feeding S SOUs).  Both oracles
return the u32 bit block as an int64 limb tensor, before any sampler
stage.
"""
from __future__ import annotations

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
