"""Uniforms kernels D and E consumed per second of their own device time,
Gsample/s: two uniforms a point, lanes x draws points a launch."""


def read(run):
    tr = run.device_trace
    if tr is None:
        return None
    secs, n = tr.op_seconds(lambda name: "mc_kernel" in name)
    if n == 0 or secs <= 0:
        return None
    t = run.traffic
    return 2 * int(t["lanes"]) * int(t["draws"]) * n / secs / 1e9
