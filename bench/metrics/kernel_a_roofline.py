"""Kernel A's share of its roofline, %: the words its launches wrote in the
traced window (4 bytes a sample, from the cell's shapes) over the card's
published bandwidth, divided by their device time."""
from bench import counts, peaks


def read(run):
    tr = run.device_trace
    if tr is None:
        return None
    secs, n = tr.op_seconds(lambda name: "thundering_ctr" in name)
    if n == 0 or secs <= 0:
        return None
    t, c = run.traffic, run.config
    samples = int(t["fuse"]) * int(t["block_len"]) * int(c["num_streams"])
    least = n * counts.kernel_a_bytes(samples) / peaks.H100_SXM[
        "hbm_bytes_per_s"]
    return 100.0 * least / secs
