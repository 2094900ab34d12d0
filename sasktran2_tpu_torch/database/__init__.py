"""Database access layer of the PyTorch port.

Counterpart of ``sasktran2_tpu/database/__init__.py``: the local cache
directory (``database_root``, under the port's own root, see
``appconfig``) and ``CachedDatabase``. ``MieDatabase`` generates its
tables on the device; ``HITRANLineDatabase`` reads local line files.
``web.py`` fetches and caches files through ``urllib`` (``WebDatabase``,
``ZipWebDatabase``, ``StandardDatabase``, ``download_zenodo_record``), so
a ``file://`` mirror serves it as ``https://`` does; a file already in the
cache is never fetched again.
"""

from __future__ import annotations

from pathlib import Path


def database_root() -> Path:
    """The local database cache directory. Resolution order (see
    ``appconfig``): SASKTRAN2_TPU_TORCH_DB_ROOT env var > user config file
    ``database_root`` key > ``~/.sasktran2_tpu_torch/db``."""
    from ..appconfig import database_root as _cfg_root

    p = _cfg_root()
    p.mkdir(parents=True, exist_ok=True)
    return p


class CachedDatabase:
    """A locally-cached database directory."""

    def __init__(self, rel_path: str):
        self._path = database_root() / rel_path

    def path(self, rel: str = "") -> Path:
        return self._path / rel if rel else self._path

    def exists(self, rel: str = "") -> bool:
        return self.path(rel).exists()

    def clear(self):
        import shutil

        if self._path.exists():
            shutil.rmtree(self._path)


def __getattr__(name):
    # lazy: database.mie and database.hitran_line import the optical
    # layer, which imports this package (web.py imports CachedDatabase
    # from here)
    if name == "MieDatabase":
        from .mie import MieDatabase

        return MieDatabase
    if name == "HITRANLineDatabase":
        from .hitran_line import HITRANLineDatabase

        return HITRANLineDatabase
    if name in ("WebDatabase", "ZipWebDatabase", "StandardDatabase",
                "download_zenodo_record"):
        from . import web

        return getattr(web, name)
    msg = f"module 'sasktran2_tpu_torch.database' has no attribute {name!r}"
    raise AttributeError(msg)
