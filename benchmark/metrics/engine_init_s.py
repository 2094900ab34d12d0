"""engine_init_s: seconds of ``Engine(config, geometry, viewing)``, its
host tables (tracing, DO mode tables, ray-source tables)."""


def read(rec):
    return rec.setup.get("engine_init_s")
