"""The window's model FLOPs (its prefills and decode steps, from the
shapes, each decode token attending to the positions before it) over the
window's time and the card's published bf16 peak, %."""
from bench import counts, peaks


def read(run):
    arch, t = run.config["arch"], run.traffic
    B, P = int(t["batch"]), int(t["prompt"])
    prefills = run.counters.get("prefills", 0)
    positions = run.notes.get("decode_positions", [])
    if not prefills and not positions:
        return None
    flops = prefills * counts.prefill_flops(arch, B, P)
    flops += sum(counts.decode_flops(arch, B, pos + 1) for pos in positions)
    return 100.0 * flops / run.window_s / peaks.H100_SXM["bf16_flops"]
