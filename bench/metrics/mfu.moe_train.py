"""The window's training FLOPs of the MoE cell (``moe_counts``: forward
and backward of every position, k of the E experts, recomputation not
counted) over the window's time and the card's published bf16 peak, %."""
from bench import moe_counts, peaks


def read(run):
    steps = run.counters.get("train_steps", 0)
    if not steps:
        return None
    t = run.traffic
    flops = steps * moe_counts.train_flops(run.config["arch"],
                                           int(t["batch"]), int(t["seq"]))
    return 100.0 * flops / run.window_s / peaks.H100_SXM["bf16_flops"]
