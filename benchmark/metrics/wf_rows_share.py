"""wf_rows_share: percent of the window inside ``Engine._jacobian_row``,
the Jacobian rows, each timed with the device synchronized (traced run)."""


def read(rec):
    span = rec.spans.get("rows")
    if not span or rec.window_s <= 0:
        return None
    return 100.0 * span[0] / rec.window_s
