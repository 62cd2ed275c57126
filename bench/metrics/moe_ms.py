"""Device time of the MoE blocks a train step, ms: the program's spans
``moe.route`` (which holds ``moe.jitter``), ``moe.experts``,
``moe.combine`` and ``moe.experts_bwd`` over the traced window, timed on
the card by the program's tracer, over the window's steps.  None where
the program has no such spans."""

SPANS = ("moe.route", "moe.experts", "moe.combine", "moe.experts_bwd")


def read(run):
    ms, steps = run.notes.get("moe_span_ms"), run.notes.get("moe_steps")
    if not ms or not steps:
        return None
    return sum(ms.get(name, 0.0) for name in SPANS) / steps
