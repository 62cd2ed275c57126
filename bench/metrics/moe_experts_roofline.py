"""The expert products' share of the card's bf16 peak, %: the gate, up and
down products' FLOPs over the window's rows (the program's counter
``moe.rows``, N * k a call, recomputation included) over the device time
of the program's ``moe.experts`` spans, which hold those products and the
activation between them.  None where the program has no such span."""
from bench import moe_counts, peaks


def read(run):
    ms = (run.notes.get("moe_span_ms") or {}).get("moe.experts")
    rows = (run.notes.get("moe_counters") or {}).get("moe.rows")
    if not ms or not rows:
        return None
    flops = moe_counts.expert_flops(run.config["arch"], rows)
    return 100.0 * flops / (ms * 1e-3) / peaks.H100_SXM["bf16_flops"]
