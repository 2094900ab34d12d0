"""setup_s: seconds from the process's start to the end of the warm-up:
imports, the kernels' load (their build in a fresh checkout), the engine's
construction, the cold call and the warm-up calls (host clock)."""


def read(rec):
    return rec.setup.get("setup_s")
