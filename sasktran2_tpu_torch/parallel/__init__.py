from .sharding import (
    Mesh,
    make_mesh,
    shard_core,
    shard_core_wavelength,
    sharded_radiance_fn,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_core",
    "shard_core_wavelength",
    "sharded_radiance_fn",
]
