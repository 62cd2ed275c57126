"""Kernel F's share of its roofline, %: the (batch, vocab) float32 logits
read once and one token a row written (from the cell's shapes), over the
card's published bandwidth, divided by its device time."""
from bench import counts, peaks


def read(run):
    tr = run.device_trace
    if tr is None:
        return None
    secs, n = tr.op_seconds(lambda name: "gumbel_argmax_kernel" in name)
    if n == 0 or secs <= 0:
        return None
    B, V = int(run.traffic["batch"]), int(run.config["arch"]["vocab"])
    least = n * counts.kernel_f_bytes(B, V) / peaks.H100_SXM[
        "hbm_bytes_per_s"]
    return 100.0 * least / secs
