"""Device time of the router's jitter a train step, ms: the program's span
``moe.jitter`` (the ThundeRiNG words of every MoE layer, its forward and
its recomputation) over the traced window, over the window's steps.  None
where the program has no such span."""


def read(run):
    ms, steps = run.notes.get("moe_span_ms"), run.notes.get("moe_steps")
    if not ms or not steps or "moe.jitter" not in ms:
        return None
    return ms["moe.jitter"] / steps
