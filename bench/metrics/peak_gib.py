"""Peak device memory allocated during the window, GiB
(``max_memory_allocated`` after ``reset_peak_memory_stats`` at its
start)."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.notes["peak_window_bytes"] / 2 ** 30
