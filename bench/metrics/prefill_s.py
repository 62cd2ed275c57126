"""Seconds of a round's prefill and graft into the decode cache, ending in
a synchronize, mean over the window's rounds (host clock)."""
import statistics


def read(run):
    spans = run.span_ms("prefill")
    return statistics.fmean(spans) / 1e3 if spans else None
