"""``device_idle.serve``: the share of the traced ticks' wall in which the
device ran nothing (1 - busy / wall, from ``torch.profiler``'s CUDA
activity). Layer: the device."""


def read(run):
    t = run.trace
    if t is None or not t.busy_s or not t.window_s:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)
