"""Share of the profiled stretch (some twelve requests in the window's
middle) in which no operation ran on the device, %, from torch.profiler's
device activity."""
from ocbench.devtrace import busy_s


def read(run):
    p = run.profile
    if p is None or not p.device:
        return None
    return 100.0 * (1.0 - busy_s(p.device, p.t0, p.t1) / (p.t1 - p.t0))
