"""Bulk delivery: ``BlockService.producer`` blocks read by a consumer.

Traffic keys: ``block_len`` (rows of a block), ``fuse`` (windows generated
by one launch), ``depth`` (queue depth), ``warm_blocks`` (blocks consumed
in set-up), ``samples`` (blocks whose one row and one column are kept for
the check, a reservoir sample drawn from the seed).  Configuration keys:
``num_streams``, ``mode``, ``deco``, ``channel``.

The consumer reduces each block on the card into a per-stream int32
accumulator, a wrapping sum (one read of every word and no temporary, as
an application that uses the numbers), and the window's rate counts every
word delivered and read.
"""
from __future__ import annotations

import random
from typing import Any, Dict, List

import torch

from bench.harness import Check, Run
from bench.reference import misrn


class Cell:
    def __init__(self, run: Run):
        from repro_torch.runtime.blocks import BlockService
        t, c = run.traffic, run.config
        self.S, self.L = int(c["num_streams"]), int(t["block_len"])
        self.channel = c["channel"]
        self.svc = BlockService(seed=run.seed, device=run.device)
        self.svc.open(self.channel, num_streams=self.S, mode=c["mode"],
                      deco=c["deco"])
        self.prod = self.svc.producer(
            self.channel, self.L, depth=int(t["depth"]), fuse=int(t["fuse"]),
            donate=True)
        dev = run.device
        self.acc = torch.zeros(self.S, dtype=torch.int32, device=dev)
        k = int(t["samples"])
        self.rows = torch.zeros((k, self.S), dtype=torch.int32, device=dev)
        self.cols = torch.zeros((k, self.L), dtype=torch.int32, device=dev)
        self.kept: List[Any] = [None] * k
        self.rng = random.Random(run.seed * 0x9E3779B1 + 0xB10C)
        self.los: List[int] = []
        self.blocks = 0
        self.attempted = self.failed = 0
        for _ in range(int(t["warm_blocks"])):
            self._consume(*next(self.prod), sample=False)

    def _consume(self, lease, block: torch.Tensor, sample: bool = True):
        words = block.view(torch.int32)
        self.acc += words.sum(0, dtype=torch.int32)
        if not sample:
            return
        self.los.append(lease.lo)
        self.blocks += 1
        k = len(self.kept)
        slot = (self.blocks - 1 if self.blocks <= k
                else self.rng.randrange(self.blocks))
        if slot < k:
            r, col = self.rng.randrange(self.L), self.rng.randrange(self.S)
            self.rows[slot].copy_(words[r])
            self.cols[slot].copy_(words[:, col])
            self.kept[slot] = (lease.lo, r, col)

    def window(self, run: Run) -> None:
        while run.elapsed() < run.seconds:
            self.attempted += 1
            with run.span("next"):
                lease, block = next(self.prod)
            with run.span("consume"):
                self._consume(lease, block)

    def end_to_end(self, run: Run) -> Dict[str, float]:
        return {"gsample_per_s": self.blocks * self.L * self.S
                / run.window_s / 1e9}

    def release(self) -> None:
        self.prod.close()
        self.ledger = self.svc.ledger_state()["channels"][self.channel]
        self.rows, self.cols = self.rows.cpu(), self.cols.cpu()
        del self.prod, self.acc
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, run: Run) -> List[Check]:
        """Every kept row and column against the reference, word for word;
        the window's leases contiguous and the ledger one committed
        window."""
        x0, h_fam = misrn.family(run.seed, misrn.name_tag(self.channel))
        dev = run.device
        ref_dev = dev if dev.type == "cuda" else torch.device("cpu")
        h = misrn.leaves(h_fam, torch.arange(self.S, device=ref_dev))
        bad = 0
        for slot, kept in enumerate(self.kept):
            if kept is None:
                continue
            lo, r, col = kept
            row = misrn.block(x0, h, lo + r, 1)[0]
            colref = misrn.block(x0, h[col:col + 1], lo, self.L)[:, 0]
            bad += int((row.cpu() != self.rows[slot].to(torch.int64)
                        & misrn.M32).sum())
            bad += int((colref.cpu() != self.cols[slot].to(torch.int64)
                        & misrn.M32).sum())
        gaps = sum(1 for a, b in zip(self.los, self.los[1:])
                   if b != a + self.L)
        committed = self.ledger["committed"]
        ledger_bad = int(len(committed) != 1 or not self.los
                         or committed[0][0] > self.los[0]
                         or committed[0][1] < self.los[-1] + self.L)
        return [Check("word_mismatches", bad, 0),
                Check("lease_gaps", gaps + ledger_bad, 0),
                Check("sampled_blocks_missing",
                      sum(k is None for k in self.kept[:self.blocks]), 0)]
