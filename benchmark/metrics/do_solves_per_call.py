"""do_solves_per_call.<suffix>: azimuth-mode solves a call, the port's
``do_mode`` spans of the forward pass and those that autograd's backward
replays under the Jacobian rows (a generic-route span counts its
``modes``; traced run)."""

from program_spans import per_call_count


def read(rec):
    return per_call_count(rec, "do_mode", "modes", default=1)
