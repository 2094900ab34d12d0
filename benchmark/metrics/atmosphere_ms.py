"""atmosphere_ms.<suffix>: mean host milliseconds a call in
``Atmosphere.internal_object``, the constituent pipeline (traced run)."""


def read(rec):
    span = rec.spans.get("atmosphere")
    if not span or rec.calls == 0:
        return None
    return 1e3 * span[0] / rec.calls
