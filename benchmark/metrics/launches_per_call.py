"""launches_per_call.<suffix>: device kernels a call, from the profiler's
trace of the window."""


def read(rec):
    if rec.device is None or rec.calls == 0:
        return None
    n = rec.device.count("kernel")
    return n / rec.calls if n else None
