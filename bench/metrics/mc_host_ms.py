"""Host time of a leased app call, ms: the call's span on the host clock
less the device time of kernels D and E that the call launched (leases,
plans, leaf tables, launch and the answer's read-back), mean over the
traced window's calls."""
import statistics


def _mc(name):
    return "mc_kernel" in name


def read(run):
    tr = run.device_trace
    if tr is None:
        return None
    calls = tr.ops_in(_mc, "app_call")
    if not calls:
        return None
    return statistics.fmean(max(0.0, span - dev) for span, dev in calls) * 1e3
