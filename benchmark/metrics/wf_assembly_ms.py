"""wf_assembly_ms: mean host milliseconds a call in
``Engine._assemble_wfs``, the numpy weighting-function assembly (traced
run)."""


def read(rec):
    span = rec.spans.get("assembly")
    if not span or rec.calls == 0:
        return None
    return 1e3 * span[0] / rec.calls
