"""host_copy_mb.<suffix>: megabytes (1e6 bytes) a call that the port's
``copy`` span counts: the one device-to-host copy of the outputs and the
Jacobian blocks in ``Engine.calculate_radiance`` (traced run)."""

from program_spans import per_call_count


def read(rec):
    value = per_call_count(rec, "copy", "bytes")
    return None if value is None else value / 1e6
