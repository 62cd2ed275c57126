"""The paper's Monte Carlo apps, leased: ``runtime.blocks.estimate_pi`` and
``price_option`` in turns, each call over a fresh window of the service's
counter space, its answer read on the host as an application reads it.

Traffic keys: ``apps`` (the order of calls), ``lanes``, ``draws`` (a
lane's draws a call), ``samples`` (calls of each app checked, drawn from
the seed, the last call of each among them).  Configuration keys: ``apps``
(each app's family purposes and the option's parameters), ``limits.mc``.
"""
from __future__ import annotations

import random
from typing import Dict, List

import torch

from bench.harness import Check, Run
from bench.reference import misrn

#: the channel each leased app takes its windows from
CHANNELS = {"pi": "mc/pi", "option": "mc/option"}


class Cell:
    def __init__(self, run: Run):
        from repro_torch.runtime import blocks
        t, c = run.traffic, run.config
        self.apps: List[str] = list(t["apps"])
        self.lanes, self.draws = int(t["lanes"]), int(t["draws"])
        opt = c["apps"]["option"]
        self.svc = blocks.BlockService(seed=run.seed, device=run.device)
        self.fns = {
            "pi": lambda: blocks.estimate_pi(
                self.svc, num_lanes=self.lanes, draws_per_lane=self.draws),
            "option": lambda: blocks.price_option(
                self.svc, num_lanes=self.lanes, draws_per_lane=self.draws,
                s0=opt["s0"], strike=opt["strike"], r=opt["r"],
                sigma=opt["sigma"], t=opt["t"])}
        self.calls: Dict[str, int] = {a: 0 for a in CHANNELS}
        self.answers: List[tuple] = []      # (app, call index, value)
        self.attempted = self.failed = 0
        for app in sorted(set(self.apps)):  # warm each app's shapes
            self._call(app, keep=False)

    def _call(self, app: str, keep: bool = True) -> None:
        value = float(self.fns[app]().item())
        if keep:
            self.answers.append((app, self.calls[app], value))
        self.calls[app] += 1

    def window(self, run: Run) -> None:
        i = 0
        while run.elapsed() < run.seconds:
            app = self.apps[i % len(self.apps)]
            self.attempted += 1
            with run.span("app_call"):
                self._call(app)
            i += 1

    def uniforms(self) -> int:
        """Uniforms the window's calls drew: two a point."""
        return 2 * self.lanes * self.draws * len(self.answers)

    def end_to_end(self, run: Run) -> Dict[str, float]:
        return {"mc_gsample_per_s": self.uniforms() / run.window_s / 1e9}

    def release(self) -> None:
        self.ledger = self.svc.ledger_state()["channels"]
        del self.svc, self.fns
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def sampled(self, seed: int, k: int) -> List[tuple]:
        """``k`` answers of each app drawn from the seed, its last one
        always among them."""
        rng = random.Random(seed * 0x2545F491 + 0x3C)
        out = []
        for app in CHANNELS:
            mine = [a for a in self.answers if a[0] == app]
            if mine:
                rest = mine[:-1]
                out += rng.sample(rest, min(k - 1, len(rest))) + [mine[-1]]
        return out

    def check(self, run: Run) -> List[Check]:
        """Sampled answers against the reference's, as relative errors;
        each app's ledger one committed window covering every call."""
        limits = run.config["limits"]["mc"]
        dev = run.device if run.device.type == "cuda" else torch.device("cpu")
        worst = {"pi": 0.0, "option": 0.0}
        for app, k, value in self.sampled(run.seed, int(run.traffic["samples"])):
            ref = reference_answer(run.config, app, run.seed, self.lanes,
                                   self.draws, lo=k * self.draws, device=dev)
            worst[app] = max(worst[app], abs(value - ref) / abs(ref))
        gaps = 0
        for app, ch in CHANNELS.items():
            done = self.ledger.get(ch, {}).get("committed", [])
            want = [[0, self.calls[app] * self.draws]] if self.calls[app] \
                else []
            gaps += int(done != want)
        return [Check("pi_rel_err", worst["pi"], limits["pi_rel_err"]),
                Check("option_rel_err", worst["option"],
                      limits["option_rel_err"]),
                Check("lease_gaps", gaps, 0)]


def reference_answer(config: Dict, app: str, seed: int, lanes: int,
                     draws: int, *, lo: int, device,
                     dtype=torch.float64) -> float:
    """The app's answer over draw window [lo, lo + draws) of every lane,
    from the plain reference; ``dtype`` is the precision of the integrand
    (float64; the control takes bfloat16)."""
    a = config["apps"][app]
    px, py = a["purposes"]
    x0, hx_f = misrn.family(seed, px)
    _, hy_f = misrn.family(seed, py)
    lane = torch.arange(lanes, dtype=torch.int64, device=device)
    hx, hy = misrn.leaves(hx_f, lane), misrn.leaves(hy_f, lane)
    rows = max(1, min(draws, (1 << 24) // lanes))
    total = torch.zeros((), dtype=torch.float64, device=device)
    if app == "option":
        s0, k = a["s0"], a["strike"]
        drift = (a["r"] - 0.5 * a["sigma"] ** 2) * a["t"]
        vol = a["sigma"] * a["t"] ** 0.5
        disc = float(torch.exp(torch.tensor(-a["r"] * a["t"],
                                            dtype=torch.float64)))
    for r0 in range(0, draws, rows):
        n = min(rows, draws - r0)
        c = torch.arange(lo + r0, lo + r0 + n, dtype=torch.int64,
                         device=device)[:, None]
        root = misrn.roots(x0, c)
        ux = misrn.uniform(misrn.words(root, c, hx[None])).to(dtype)
        uy = misrn.uniform(misrn.words(root, c, hy[None])).to(dtype)
        if app == "pi":
            total += ((ux * ux + uy * uy) < 1.0).sum().to(torch.float64)
        else:
            z = misrn.box_muller(ux, uy)
            st = s0 * torch.exp(drift + vol * z)
            total += (torch.clamp_min(st - k, 0.0) * disc).to(
                torch.float64).sum()
    n_points = lanes * draws
    return float(4.0 * total / n_points if app == "pi" else total / n_points)
