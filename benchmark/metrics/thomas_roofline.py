"""thomas_roofline.<suffix>: percent of its roofline that the Thomas
kernel reaches over the window: the least time of every launch at its own
shape (``roofline.thomas_bound_s``), summed, over the kernel's device time
in the trace, summed. Nothing when the window launched none, or when the
trace and the recorded launches disagree in count."""

from roofline import thomas_bound_s


def read(rec):
    if rec.device is None or rec.launches is None or not rec.launches.thomas:
        return None
    seconds, count = rec.device.kernel_seconds("thomas")
    if count != len(rec.launches.thomas) or seconds <= 0:
        return None
    return 100.0 * sum(thomas_bound_s(*s) for s in rec.launches.thomas) / seconds
