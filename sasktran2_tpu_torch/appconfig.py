"""User application configuration of the PyTorch port.

Counterpart of ``sasktran2_tpu/appconfig.py``: a small YAML config file
holding user preferences (most importantly ``database_root``) plus
helpers to read and update it. The port keeps its own: its own
environment variables and its own default directory, so that it never
reads a table that the JAX package wrote. ``database_root`` resolution
order: ``SASKTRAN2_TPU_TORCH_DB_ROOT`` env var > config file > default
user dir (``~/.sasktran2_tpu_torch/db``). PyYAML is imported only when a
config file is read or written.
"""

from __future__ import annotations

import os
from pathlib import Path

DB_ROOT_ENV = "SASKTRAN2_TPU_TORCH_DB_ROOT"
CONFIG_DIR_ENV = "SASKTRAN2_TPU_TORCH_CONFIG_DIR"


def config_dir() -> Path:
    """The port's config directory (``SASKTRAN2_TPU_TORCH_CONFIG_DIR`` or
    ``~/.sasktran2_tpu_torch``)."""
    return Path(
        os.environ.get(
            CONFIG_DIR_ENV,
            os.path.join(os.path.expanduser("~"), ".sasktran2_tpu_torch"),
        )
    )


def user_config_file_location() -> Path:
    """Location of the user config file."""
    return config_dir() / "config.yml"


def load_user_config() -> dict:
    """The user config file as a dict ({} when absent)."""
    path = user_config_file_location()
    if not path.exists():
        return {}
    import yaml

    with open(path) as f:
        config = yaml.safe_load(f)
    return config if config is not None else {}


def save_user_config(user_config: dict):
    """Write the user config dict back to disk."""
    import yaml

    p = user_config_file_location()
    p.parent.mkdir(exist_ok=True, parents=True)
    with open(p, "w") as f:
        yaml.dump(user_config, f, default_flow_style=False)


def database_root() -> Path:
    """The configured database root (see the module docstring for the
    resolution order)."""
    env = os.environ.get(DB_ROOT_ENV)
    if env:
        return Path(env)
    cfg = load_user_config().get("database_root")
    if cfg is not None:
        return Path(cfg)
    return config_dir() / "db"
