"""Leaf tables the port builds per leased app call: the program's
counters ``engine.leaf_tables`` over ``blocks.apps`` (``repro_torch.trace``,
always on).  They count over the run's process, set-up included, as no
counter is read at the window's edges; the apps' set-up calls build their
tables as the window's do.  None where the program has no such counters."""


def read(run):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    apps = trace.counter("blocks.apps")
    return trace.counter("engine.leaf_tables") / apps if apps else None
