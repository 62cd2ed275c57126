"""Batched serving driver: prefill a batch of prompts, then step-decode.

Token sampling is delegated to the inference tier
(``repro_torch.inference.GumbelMaxSampler``): each decode row is a tenant
sequence (``launch/serve/seq/<b>``), and with ``temperature > 0`` every
decode step draws its gumbel noise from ONE leased counter window of a
standalone sampler service — tenant-attributed, ledger-fenced, and
(through the fused path, kernel F on a card) sampled from counter bits
to token ids in one launch.  ``temperature 0`` stays the pure greedy
argmax and consumes no randomness at all.

The model runs on the card unless ``device`` / ``--device`` names
another; ``registry.build`` serves every family (``dense``, ``moe``,
``vlm``, ``encdec``, ``ssm``, ``hybrid``).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch glm4_9b --smoke --batch 4 --prompt-len 32 --gen 16 \\
      --temperature 0.8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch mamba2_2p7b --smoke     # or olmoe_1b_7b, zamba2_7b, ...
"""
from __future__ import annotations

import argparse
import hashlib
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import engine
from repro_torch.inference import ActiveSeq, GumbelMaxSampler, SamplingSpec
from repro_torch.inference.sampling import PATHS
from repro_torch.launch import steps
from repro_torch.launch.train import pipeline_for, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import registry

SAMPLER_TENANT = "launch/serve"


class TokenPicker:
    """Per-step token selection over the inference tier's sampler.

    Greedy (``temperature <= 0``) is the pure argmax — bit-identical to
    sampling-free serving, no service, no leases.  Stochastic picking
    builds one :class:`GumbelMaxSampler` (its own BlockService seeded
    with the serve seed) and registers each batch row as the tenant
    ``launch/serve/seq/<b>``; step ``i`` consumes counter window
    ``[i * vocab, (i+1) * vocab)`` — replayable from (seed, step) alone.
    """

    def __init__(self, *, seed: int, batch: int, vocab: int,
                 temperature: float, path: str = "fused", device=None):
        self.batch = batch
        self.greedy = temperature <= 0.0
        self.sampler = None
        self._active = []
        if not self.greedy:
            self.sampler = GumbelMaxSampler.standalone(
                seed=seed, vocab=vocab, capacity=batch,
                spec=SamplingSpec(temperature=temperature), path=path,
                device=device)
            for b in range(batch):
                sid = f"{SAMPLER_TENANT}/seq/{b}"
                tenant = self.sampler.registry.register(sid)
                self._active.append((sid, tenant.tag(0)))

    def pick(self, step: int, logits: torch.Tensor) -> torch.Tensor:
        """(batch, 1) int32 next tokens for decode step ``step``, on the
        logits' device."""
        if self.greedy:
            return torch.argmax(logits, -1)[:, None].to(torch.int32)
        active = [ActiveSeq(slot=b, seq_id=sid, tenant_id=sid, tag=tag,
                            position=step)
                  for b, (sid, tag) in enumerate(self._active)]
        flat = logits.reshape(self.batch, -1)
        toks = self.sampler.sample_step(step, flat, active)
        return torch.from_numpy(toks).to(logits.device)[:, None]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
          temperature: float = 0.0, sampler_path: str = "fused",
          device=None):
    """Init ``cfg`` from ``seed``, prefill ``batch`` prompts of the data
    pipeline's step 0 and decode ``gen`` tokens.  Returns the (batch, gen)
    int32 tokens and a dict of timings (host clock, each ending in a
    synchronize) and sampler meters."""
    dev = engine.resolve_device(device)
    model = registry.build(cfg, device=dev)
    t_init = time.perf_counter()
    params, _ = model.init(seed)
    _sync(dev)
    t_init = time.perf_counter() - t_init
    pipe = pipeline_for(cfg, batch, max(prompt_len, 2), seed, device=dev)
    b = pipe.batch_at(0)
    prompts = {k: (v[:, :prompt_len] if k in ("tokens", "labels") else v)
               for k, v in b.items()}
    prompts.pop("labels", None)

    total_ctx = prompt_len + gen
    prefill, decode = steps.make_serve_fns(model)

    t0 = time.perf_counter()
    logits, pcache = prefill(params, prompts)
    # copy the prefix kv into a full-length cache (attention families);
    # an ssm cache is position-free: the prefill cache is the decode cache
    cache = pcache if cfg.family == "ssm" else _graft(
        cfg, model.init_cache(batch, total_ctx), pcache, prompt_len)
    del pcache
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    picker = TokenPicker(seed=seed, batch=batch,
                         vocab=int(logits.shape[-1]),
                         temperature=temperature, path=sampler_path,
                         device=dev)
    tok = picker.pick(0, logits)
    out = [tok.cpu().numpy()]
    step_ms = []
    t1 = time.perf_counter()
    for i in range(gen - 1):
        ts = time.perf_counter()
        logits, cache = decode(params, cache, tok, prompt_len + i)
        tok = picker.pick(i + 1, logits)
        out.append(tok.cpu().numpy())   # waits for the step
        step_ms.append((time.perf_counter() - ts) * 1e3)
    t_decode = time.perf_counter() - t1
    toks = np.concatenate(out, axis=1)
    stats = {"init_s": t_init, "prefill_s": t_prefill, "decode_s": t_decode,
             "decode_tok_s": batch * (gen - 1) / max(t_decode, 1e-9)}
    if step_ms:
        stats["step_p50_ms"] = float(np.percentile(step_ms, 50))
        stats["step_p99_ms"] = float(np.percentile(step_ms, 99))
    if picker.sampler is not None:
        stats["sampler_calls_per_step"] = (
            picker.sampler.stats()["calls_per_step"])
    return toks, stats


def _graft(cfg, cache, pcache, prompt_len):
    """Copy prefill results into the zeroed full-length decode cache, in
    place: the self-attention (k, v) at positions [0, prompt_len); the
    rest of an encdec (cross k, v) or hybrid (mamba states, conv tails)
    cache is the prefill's own."""
    fam = cfg.family
    if fam == "ssm":
        return pcache
    for full, pre in zip(cache[:2], pcache[:2]):
        full[:, :, :prompt_len] = L.cast(pre, full.dtype)
    if fam in ("dense", "moe", "vlm"):
        return cache
    if fam in ("encdec", "hybrid"):
        return tuple(cache[:2]) + tuple(pcache[2:])
    raise ValueError(fam)


def tokens_digest(toks: np.ndarray) -> str:
    """sha256 of a token array as little-endian int32 (row-major)."""
    return hashlib.sha256(
        np.ascontiguousarray(toks, dtype="<i4").tobytes()).hexdigest()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4_9b",
                    help="any config of repro_torch.configs (every family)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples via the inference "
                         "tier's fused gumbel-max sampler (tenant-"
                         "attributed, ledger-fenced, replayable)")
    ap.add_argument("--sampler-path", choices=PATHS, default="fused")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain torch path)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    toks, stats = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                        gen=args.gen, temperature=args.temperature,
                        sampler_path=args.sampler_path, device=args.device)
    print("generated shape:", toks.shape)
    print({k: round(v, 4) for k, v in stats.items()})
    print("tokens sha256:", tokens_digest(toks))


if __name__ == "__main__":
    main()
