"""Device-busy time inside a decode step's span, ms a step (the union of
the step's device operations from the profiler's trace)."""


def read(run):
    tr = run.device_trace
    if tr is None:
        return None
    busy, n = tr.busy_in("decode_step")
    return busy / n * 1e3 if n else None
