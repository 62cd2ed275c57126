"""Offline batched generation through ``launch/serve.py``'s path: back to
back rounds of prefill, ``_graft`` into the full decode cache, then one
decode step and one ``TokenPicker`` pick a token.

Traffic keys: ``batch``, ``prompt``, ``gen`` (tokens a sequence),
``temperature``, ``sampler_path``, ``sampler`` (the channel and tenant
names of the serve path's sampler), ``check_sequences`` (finished
sequences compared with the reference, drawn from the seed), ``warm_steps``.
Configuration keys: ``arch`` (the program's ``ArchConfig`` fields, which
the reference reads too), ``limits.decode``.

A round's prompts come from the benchmark's generator; each round's
sampler takes its own seed, so its counters are fresh.  A round's first
token is picked from the prefill's logits; every decode step runs from the
``decode`` call to the token's copy to the host.  The window opens with a
round's prefill and ends at the first step boundary after ``--seconds``.
"""
from __future__ import annotations

import random
from typing import Dict, List

import numpy as np
import torch

from bench import weights
from bench.harness import Check, Run
from bench.reference import dense_lm, misrn


def picker_seed(seed: int, rnd: int) -> int:
    return weights.mix_seed(seed, f"sampler/{rnd}")


class Cell:
    def __init__(self, run: Run):
        from repro_torch.launch import serve, steps
        from repro_torch.models import registry
        from repro_torch.models.common import ArchConfig
        t = run.traffic
        self.arch = dict(run.config["arch"])
        self.cfg = ArchConfig(**self.arch)
        self.B, self.P, self.G = int(t["batch"]), int(t["prompt"]), \
            int(t["gen"])
        self.V = self.cfg.vocab
        self.serve = serve
        self.dev = run.device
        self.params = weights.dense_lm(self.arch, run.seed, self.dev)
        self.model = registry.build(self.cfg, device=self.dev)
        self.prefill, self.decode = steps.make_serve_fns(self.model)
        self.seed = run.seed
        self.rounds = 0
        self.finished: List[tuple] = []     # (round, prompts, tokens) host
        self.tokens = 0
        self.attempted = self.failed = 0
        self._round(run, warm=True)

    def _round(self, run: Run, warm: bool = False) -> None:
        t = run.traffic
        B, P, G = self.B, self.P, self.G
        r = self.rounds
        name = "warm" if warm else f"round/{r}"
        prompts = weights.tokens(self.seed, f"prompts/{name}", (B, P),
                                 self.V, self.dev)
        with run.span("prefill"):
            logits, pcache = self.prefill(self.params, {"tokens": prompts})
            cache = self.serve._graft(
                self.cfg, self.model.init_cache(B, P + G), pcache, P)
            del pcache
            run.sync()
        picker = self.serve.TokenPicker(
            seed=picker_seed(self.seed, -1 if warm else r), batch=B,
            vocab=self.V, temperature=float(t["temperature"]),
            path=t["sampler_path"], device=self.dev)
        with run.span("pick_first"):
            tok = picker.pick(0, logits)
            out = [tok.cpu()]
        steps = int(t["warm_steps"]) if warm else G - 1
        for i in range(steps):
            if not warm and run.elapsed() >= run.seconds:
                break
            with run.span("decode_step"):
                logits, cache = self.decode(self.params, cache, tok, P + i)
                tok = picker.pick(i + 1, logits)
                out.append(tok.cpu())
        if warm:
            return
        self.rounds += 1
        self.attempted += B
        self.tokens += B * len(out)
        run.count("decode_steps", len(out) - 1)
        run.count("prefills", 1)
        run.notes.setdefault("decode_positions", []).extend(
            P + i for i in range(len(out) - 1))
        if len(out) == G:
            self.finished.append((r, prompts.cpu(), torch.cat(out, 1)))

    def window(self, run: Run) -> None:
        while run.elapsed() < run.seconds:
            self._round(run)

    def end_to_end(self, run: Run) -> Dict[str, float]:
        steps = run.span_ms("decode_step")
        out = {"decode_tok_per_s": self.tokens / run.window_s}
        if steps:
            out["decode_step_p95_ms"] = float(np.percentile(steps, 95))
        return out

    def release(self) -> None:
        del self.model, self.prefill, self.decode
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def sample(self, seed: int, k: int) -> List[tuple]:
        """``k`` finished sequences drawn from the seed: (round, row)."""
        rng = random.Random(seed * 0x51ED27 + 0xDEC0)
        pool = [(r, b) for r, _, _ in self.finished for b in range(self.B)]
        return sorted(rng.sample(pool, min(k, len(pool))))

    def check(self, run: Run) -> List[Check]:
        limits = run.config["limits"]["decode"]
        picked = self.sample(run.seed, int(run.traffic["check_sequences"]))
        if not picked:
            return [Check("finished_sequences_missing", 1, 0)]
        gaps = served_gaps(self, run, picked, "float32")
        return [Check("served_gap", max(gaps), limits["served_gap"])]


def noise(traffic: Dict, seed: int, rnd: int, row: int, gen: int,
          vocab: int, device) -> torch.Tensor:
    """(gen, vocab) float64 Gumbel noise the sampler of round ``rnd`` adds
    for sequence ``row``: pick j reads counters j*vocab .. (j+1)*vocab-1
    of the leaf at the sequence tenant's tag, in the channel's family."""
    s = traffic["sampler"]
    x0, h_fam = misrn.family(picker_seed(seed, rnd),
                             misrn.name_tag(s["channel"]))
    h = misrn.derive_leaf_int(h_fam, misrn.tenant_tag(
        s["tenant"].format(row=row)))
    c = torch.arange(gen * vocab, dtype=torch.int64, device=device)
    hh = torch.full_like(c[:1], misrn.s64(h))
    return misrn.gumbel(misrn.words(misrn.roots(x0, c), c, hh)
                        ).reshape(gen, vocab)


def served_gaps(cell: "Cell", run: Run, picked: List[tuple],
                precision: str) -> List[float]:
    """Per checked sequence, the widest gap by which a served token's
    perturbed score lies below the best perturbed score, both scored on
    the reference's logits at ``precision``; for ``"fp8"`` the gap is of
    the token that the fp8 logits put first (the control)."""
    dense_lm.no_tf32()
    t = run.traffic
    inv_temp = float(np.float32(1.0 / float(t["temperature"])))
    rows = {(r, b): (pr[b], tk[b]) for r, pr, tk in cell.finished
            for b in range(cell.B)}
    P, G, V = cell.P, cell.G, cell.V
    gaps = []
    with torch.no_grad():
        for r, b in picked:
            prompt, toks = rows[(r, b)]
            seq = torch.cat([prompt, toks[:-1]]).to(run.device)[None]
            g = noise(t, run.seed, r, b, G, V, run.device)
            ref = dense_lm.logits_at(cell.arch, cell.params, seq, P - 1)[0]
            s_ref = ref.double() * inv_temp + g
            if precision == "float32":
                chosen = toks.to(run.device).long()
            else:
                lo = dense_lm.logits_at(cell.arch, cell.params, seq, P - 1,
                                        precision)[0]
                chosen = torch.argmax(lo.double() * inv_temp + g, -1)
            gap = s_ref.max(-1).values - s_ref.gather(
                -1, chosen[:, None])[:, 0]
            gaps.append(float(gap.max()))
    return gaps
