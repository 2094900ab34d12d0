"""recompute_share.<suffix>: percent of the device time of the kernels
launched inside the port's ``rows`` spans that was launched inside
recomputed ``do_mode`` spans (checkpointed modes replayed by backward).
Each kernel is tied to its launch by its CUPTI correlation id and
credited to the innermost span around the launch (traced run)."""

from program_spans import recompute_share


def read(rec):
    return recompute_share(rec)
