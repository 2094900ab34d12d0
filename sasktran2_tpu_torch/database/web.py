"""Download-and-cache database layer of the PyTorch port.

Counterpart of ``sasktran2_tpu/database/web.py`` (the upstream web-backed
databases: WebDatabase / ZipWebDatabase / StandardDatabase, and the Zenodo
record download). Cache semantics are the same: a file is fetched once
into the port's database root (``SASKTRAN2_TPU_TORCH_DB_ROOT``, see
``appconfig``), every later ``load()`` is a no-op, ``clear()`` removes the
cached copy. All fetches go through ``urllib``, so a ``file://`` URL
behaves exactly like ``https://``: a local mirror of the upstream tree
serves it with no network, and the tests hold this layer to the JAX
package's on the same ``file://`` trees.

``load_ds`` returns the port's plain ``{"coords", "data_vars"}`` dataset
dict (the structure ``optical.database`` consumes).
"""

from __future__ import annotations

import json
import logging
import urllib.parse
import urllib.request
import zipfile
from pathlib import Path

from . import CachedDatabase, database_root

_LOG = logging.getLogger(__name__)

__all__ = [
    "WebDatabase",
    "ZipWebDatabase",
    "StandardDatabase",
    "download_zenodo_record",
]


class WebDatabase(CachedDatabase):
    """A database consisting of a single file fetched from a URL.

    Parameters
    ----------
    url:
        Location of the file (``https://``, ``file://``, ...).
    rel_path:
        Directory below the database root to place the file in ("" = the
        root itself).
    db_root:
        Override the database root (default: ``appconfig`` resolution).
    """

    def __init__(self, url: str, rel_path: str = "", db_root=None):
        if db_root is None:
            super().__init__(rel_path)
        else:
            self._path = Path(db_root) / rel_path if rel_path else Path(
                db_root
            )
        self.url = url
        self._filename = Path(urllib.parse.urlparse(url).path).name

    def output_file(self) -> Path:
        return self._path / self._filename

    def _post_process(self):
        """Hook run after a successful fetch (zip extraction, etc.)."""

    def load(self) -> Path:
        """Fetch the file into the cache unless it is already present."""
        out = self.output_file()
        if out.exists():
            return out
        self._path.mkdir(parents=True, exist_ok=True)
        try:
            urllib.request.urlretrieve(self.url, filename=str(out))
        except Exception as e:  # noqa: BLE001 - any failed fetch
            _LOG.warning("could not fetch %s: %s", self.url, e)
            if out.exists():  # partial download
                out.unlink()
            msg = (
                f"Database file {out} is not present and fetching "
                f"{self.url} failed ({e}). Place the file there manually "
                "or set SASKTRAN2_TPU_TORCH_DB_ROOT to a directory that "
                "has it."
            )
            raise FileNotFoundError(msg) from e
        self._post_process()
        return out

    def fetch(self, rel: str = "") -> Path:
        """``load()``, or with ``rel`` the path of a file below the cache
        directory, loading the database first if it is absent."""
        if rel:
            p = self.path(rel)
            if p.exists():
                return p
            self.load()
            if p.exists():
                return p
            msg = (
                f"Database file {p} is not present after fetching "
                f"{self.url}. Place the file there manually or set "
                "SASKTRAN2_TPU_TORCH_DB_ROOT."
            )
            raise FileNotFoundError(msg)
        return self.load()

    def clear(self):
        out = self.output_file()
        if out.exists():
            out.unlink()

    def load_ds(self, key: str | None = None):
        """Load the cached file (or ``key`` relative to the cache dir) as
        the port's dataset dict."""
        from ..optical.database import _load_dataset

        path = self.path(key) if key else self.load()
        return _load_dataset(db_filepath=path)


class ZipWebDatabase(WebDatabase):
    """A zip archive fetched from a URL and extracted into the database
    root (upstream ``web.py`` ZipWebDatabase, which extracts into
    ``db_root``)."""

    def __init__(self, url: str, rel_path: str = "", db_root=None):
        super().__init__(url, rel_path, db_root)
        self._extract_root = (
            Path(db_root) if db_root is not None else database_root()
        )

    def _post_process(self):
        out = self.output_file()
        with zipfile.ZipFile(str(out), "r") as zf:
            zf.extractall(str(self._extract_root))


class StandardDatabase:
    """The versioned standard-database surface: every key is fetched
    lazily from ``<base_url>/v_<version>/<key>`` and cached under the
    key's relative path (upstream ``web.py`` StandardDatabase).

    ``base_url`` defaults to the upstream file server and may be pointed
    at any mirror, a ``file://`` tree included.
    """

    DEFAULT_BASE_URL = "https://arg.usask.ca/sasktranfiles/sasktran2_db/"

    def __init__(self, version: str = "latest", base_url: str | None = None,
                 db_root=None):
        base = (base_url or self.DEFAULT_BASE_URL).rstrip("/")
        self._url = f"{base}/v_{version}/"
        self._db_root = db_root

    def path(self, key: str) -> Path:
        rel = str(Path(key).parent)
        rel = "" if rel == "." else rel
        db = WebDatabase(self._url + key, rel_path=rel,
                         db_root=self._db_root)
        db.load()
        return db.output_file()

    def load_ds(self, key: str):
        from ..optical.database import _load_dataset

        return _load_dataset(db_filepath=self.path(key))

    def clear(self):
        msg = "The standard database can only be cleared manually"
        raise NotImplementedError(msg)


def download_zenodo_record(record_id: str, output_dir: Path,
                           api_base: str | None = None) -> list[Path]:
    """Download every file of a Zenodo record into ``output_dir``.

    Speaks the Zenodo records API with ``urllib``: ``GET
    <api_base>/records/<id>`` returns JSON whose ``files`` entries carry
    ``key`` (filename) and a download link. ``api_base`` may point at a
    ``file://`` tree laid out the same way. Files already present are not
    fetched again (cache semantics as above).
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    base = (api_base or "https://zenodo.org/api").rstrip("/")
    with urllib.request.urlopen(f"{base}/records/{record_id}") as resp:
        record = json.loads(resp.read().decode("utf-8"))
    fetched = []
    for entry in record.get("files", []):
        name = entry.get("key") or entry.get("filename")
        if name is None:
            continue
        link = None
        links = entry.get("links", {})
        for cand in ("self", "content", "download"):
            if cand in links:
                link = links[cand]
                break
        if link is None:
            link = f"{base}/records/{record_id}/files/{name}/content"
        target = output_dir / name
        if not target.exists():
            urllib.request.urlretrieve(link, filename=str(target))
        fetched.append(target)
    return fetched
