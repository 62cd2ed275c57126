"""Mean host wait in ``BlockProducer.__next__`` per delivered block, ms
(the benchmark's span around each call)."""
import statistics


def read(run):
    waits = run.span_ms("next")
    return statistics.fmean(waits) if waits else None
