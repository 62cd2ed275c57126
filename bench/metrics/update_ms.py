"""Device time of the AdamW update of a step, ms: CUDA events the
benchmark records around each ``adamw_update`` call, mean over the traced
window's steps."""
import statistics


def read(run):
    events = run.notes.get("update_events")
    if not events:
        return None
    return statistics.fmean(s.elapsed_time(e) for s, e in events)
