"""device_idle.<suffix>: percent of the window in which no kernel, copy or
memset ran on the device (profiler trace, intervals merged)."""


def read(rec):
    if rec.device is None or rec.window_s <= 0:
        return None
    t0, t1 = rec.window_ns
    busy = sum(b - a for a, b in rec.device.busy(t0, t1)) / 1e9
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / rec.window_s)
