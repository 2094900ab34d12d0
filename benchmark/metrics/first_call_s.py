"""first_call_s: seconds of the cold ``calculate_radiance`` call (kernel
load, lazily built tables, the allocator's first blocks)."""


def read(rec):
    return rec.setup.get("first_call_s")
