"""constituents_ms.<suffix>: host milliseconds a call in the port's
``constituent`` spans, every constituent's add and derivative phases
inside ``Atmosphere.internal_object`` (traced run; no synchronize)."""

from program_spans import per_call_ms


def read(rec):
    return per_call_ms(rec, ("constituent",))
