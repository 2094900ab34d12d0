"""wf_wavelengths_per_s: wavelengths with radiance and every weighting
function completed over the window, all its calls over all its time
(host clock)."""


def read(rec):
    if not rec.jacobians or rec.window_s <= 0 or rec.calls == 0:
        return None
    return rec.num_wavelengths * rec.calls / rec.window_s
