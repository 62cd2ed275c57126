"""Logical-axis -> mesh partition spec resolution (DP/FSDP/TP/EP/SP).

Per-param assignment (not a single global map) so indivisible dims fall
back gracefully per-tensor:

  TP ("model" axis): first divisible axis in priority order
      experts > kv_heads > q_rep > f > ssm_inner > ssm_heads > vocab
      > embed (>=2-D params only — the row-parallel fallback for archs
      like qwen1.5-32b whose 40 heads don't divide a 16-way model axis).
  FSDP (train only; "data" [+ "pod"] axes): first remaining divisible
      axis in order embed > vocab > f > ssm_inner > head — ZeRO-3-style
      parameter + optimizer-state sharding.

Serve mode skips FSDP (weights TP-only, batch over data) and shards KV
caches: kv_heads over model when divisible, else the *context* axis over
model (flash-decoding); batch over data when divisible, else context over
data too (the long_500k single-sequence case).

A spec is a tuple with one entry per dimension: ``None``, a mesh axis
name, or a tuple of axis names - the entries of the reference's
``PartitionSpec``.  A mesh is anything with ``axis_names`` and a
``devices`` array (``engine.Mesh``); the dry run reads specs for their
per-device shapes, and nothing places a tensor by them.

The port runs a model on one card with no ambient mesh, so the hints
the model code calls (``context_parallel_attention``,
``prefer_seq_gather``, ``gather_seq_hint``, ``activation_hint``) return
what the reference returns outside a mesh: the activation unchanged, and
``False`` for the two layout decisions.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from repro_torch.models.common import ArchConfig

TP_PRIORITY = ("experts", "kv_heads", "q_rep", "f", "ssm_inner",
               "ssm_heads", "vocab")
TP_FALLBACK = ("embed",)
FSDP_PRIORITY = ("embed", "vocab", "f", "ssm_inner", "head")

Spec = Tuple


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_axes(mesh) -> Tuple[str, ...]:
    return fsdp_axes(mesh)


def _axsize(mesh, axes) -> int:
    sizes = mesh_axis_sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    return math.prod(sizes[a] for a in axes) if axes else 1


def param_pspec(axes: Tuple[str, ...], shape: Tuple[int, ...], mesh,
                mode: str = "train") -> Spec:
    """Spec for one param given its logical axes + shape."""
    model_sz = _axsize(mesh, "model")
    assign: list = [None] * len(axes)

    def try_assign(names, mesh_axis, mesh_sz, skip_1d=False):
        for name in names:
            if name in axes:
                i = axes.index(name)
                if assign[i] is None and shape[i] % mesh_sz == 0 \
                        and shape[i] > 0:
                    if skip_1d and sum(s > 1 for s in shape) < 2:
                        continue
                    assign[i] = mesh_axis
                    return True
        return False

    ok = try_assign(TP_PRIORITY, "model", model_sz)
    if not ok:
        try_assign(TP_FALLBACK, "model", model_sz, skip_1d=True)
    # Embedding/unembedding tables stay TP-only (the reference measured
    # FSDP on their d_model axis resharding the cotangent to a
    # batch-replicated float32 layout).
    if mode == "train" and "vocab" not in axes:
        fa = fsdp_axes(mesh)
        if fa:
            fsz = _axsize(mesh, fa)
            remaining = [n for n in FSDP_PRIORITY
                         if n in axes and assign[axes.index(n)] is None]
            try_assign(remaining, fa if len(fa) > 1 else fa[0], fsz)
    return tuple(assign)


def param_pspecs(specs: Dict[str, Tuple[str, ...]], params_flat,
                 mesh, mode: str = "train") -> Dict[str, Spec]:
    out = {}
    for path, axes in specs.items():
        out[path] = param_pspec(axes, tuple(params_flat[path].shape), mesh,
                                mode)
    return out


def batch_pspec(mesh, batch_size: int) -> Spec:
    da = data_axes(mesh)
    if da and batch_size % _axsize(mesh, da) == 0:
        return (da if len(da) > 1 else da[0],)
    return (None,)


def _cache_kv_pspec(mesh, shape, kv_idx: int, ctx_idx: int,
                    batch_idx: int = 1) -> Spec:
    """(L/napps, B, T, K, hd) attention-cache spec."""
    sizes = mesh_axis_sizes(mesh)
    assign: list = [None] * len(shape)
    da = data_axes(mesh)
    dsz = _axsize(mesh, da) if da else 1
    if shape[kv_idx] % sizes["model"] == 0:
        assign[kv_idx] = "model"
    elif shape[ctx_idx] % sizes["model"] == 0:
        assign[ctx_idx] = "model"
    if da:
        if shape[batch_idx] % dsz == 0:
            assign[batch_idx] = da if len(da) > 1 else da[0]
        elif assign[ctx_idx] is None and shape[ctx_idx] % dsz == 0:
            assign[ctx_idx] = da if len(da) > 1 else da[0]
        elif assign[ctx_idx] == "model" and \
                shape[ctx_idx] % (dsz * sizes["model"]) == 0:
            assign[ctx_idx] = (*da, "model")
    return tuple(assign)


def cache_pspecs(cfg: ArchConfig, cache, mesh):
    """Specs matching ``Model.init_cache``'s tuple structure."""
    sizes = mesh_axis_sizes(mesh)
    da = data_axes(mesh)
    dsz = _axsize(mesh, da) if da else 1

    def b_axis(b):
        if da and b % dsz == 0:
            return da if len(da) > 1 else da[0]
        return None

    def feat_axis(n):
        return "model" if n % sizes["model"] == 0 else None

    def ssm_specs(st, tx, tb, tc):
        return ((None, b_axis(st.shape[1]), feat_axis(st.shape[2]), None,
                 None),
                (None, b_axis(tx.shape[1]), None, feat_axis(tx.shape[3])),
                (None, b_axis(tb.shape[1]), None, None),
                (None, b_axis(tc.shape[1]), None, None))

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        k, v = cache
        spec = _cache_kv_pspec(mesh, k.shape, kv_idx=3, ctx_idx=2)
        return (spec, spec)
    if fam == "encdec":
        sk, sv, ck, cv = cache
        s_spec = _cache_kv_pspec(mesh, sk.shape, kv_idx=3, ctx_idx=2)
        c_spec = _cache_kv_pspec(mesh, ck.shape, kv_idx=3, ctx_idx=2)
        return (s_spec, s_spec, c_spec, c_spec)
    if fam == "ssm":
        return ssm_specs(*cache)
    if fam == "hybrid":
        kc, vc, *ssm = cache
        kv_spec = _cache_kv_pspec(mesh, kc.shape, kv_idx=3, ctx_idx=2)
        return (kv_spec, kv_spec, *ssm_specs(*ssm))
    raise ValueError(fam)


def tree_shardings(mesh, pspec_tree):
    """The reference places each leaf by its ``NamedSharding``; in one
    process the spec tree is the sharding tree."""
    return pspec_tree


def context_parallel_attention(mesh_or_none, n_kv: int, n_rep: int) -> bool:
    """True when attention must run context-parallel on a model axis that
    divides neither the kv heads nor the query repeats; never on one
    device."""
    return False


def prefer_seq_gather(cfg, batch: int, seq: int) -> bool:
    """Whether a layer gathers its sequence-sharded activations rather
    than its model-sharded weights; there is nothing to gather on one
    device."""
    return False


def gather_seq_hint(x):
    """Layout hint at the input of head- / f-sharded products: identity
    on one device."""
    return x


def activation_hint(x, *, seq_axis: Optional[int] = 1):
    """Sequence-parallel layout hint for a (B, S, ...) activation:
    identity on one device."""
    return x
