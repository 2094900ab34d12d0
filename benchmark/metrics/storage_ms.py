"""storage_ms.<suffix>: host milliseconds a call in the port's ``zero``,
``normalize`` and ``layout`` spans: the atmosphere storage's reset, its
normalisation by the extinctions and the wavelength-leading copies that
``Atmosphere.internal_object`` hands the engine (traced run)."""

from program_spans import per_call_ms


def read(rec):
    return per_call_ms(rec, ("zero", "normalize", "layout"))
