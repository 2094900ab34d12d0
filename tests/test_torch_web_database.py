"""The port's web database layer (``sasktran2_tpu_torch/database/web.py``)
against the JAX package's, on the five contracts of
``tests/test_web_database.py``: fetch, cache and clear; the missing-source
error; zip extraction; versioned standard-database keys; a Zenodo record.

Each package runs a contract on its own copy of the same ``file://`` tree
under its own root, and the test holds the two records equal: the bytes
each package leaves at each path relative to its cache root (after the
fetch and at the end), the datasets it loads, and the exceptions it
raises (type and message, with the root and the package's database
variable written alike). The served files are written with fixed zip
timestamps, so their bytes do not depend on the hour the JAX side was
recorded. Every URL opened must have the ``file`` scheme
(``file_urls_only``); nothing is downloaded. The JAX side is read from
``sasktran2_tpu_torch/data/golden_test_torch_web_database.npz``
(``tests/torch_support.py``)."""

import io
import json
import tempfile
import urllib.parse
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pytest

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

# a fixed date for every zip member the tests write (npz files included)
ZIP_DATE = (2020, 1, 1, 0, 0, 0)
CONTRACTS = ("fetch_cache_clear", "missing_source", "zip_extracts",
             "standard_versioned_keys", "zenodo_record")


@pytest.fixture(autouse=True)
def file_urls_only(monkeypatch):
    """Every ``urlopen`` (``urlretrieve`` goes through it) must name a
    ``file://`` URL; the URLs opened are listed."""
    opened = []
    real = urllib.request.urlopen

    def urlopen(url, *args, **kwargs):
        name = url if isinstance(url, str) else url.full_url
        scheme = urllib.parse.urlparse(name).scheme
        assert scheme == "file", f"a test opened {name!r}"
        opened.append(name)
        return real(url, *args, **kwargs)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return opened


def _npz_bytes(values):
    """An ``.npz`` of the port's dataset layout (``coord_x``, ``xs``,
    ``dims_xs``) with fixed member timestamps."""
    buf = io.BytesIO()
    arrays = {"coord_x": np.arange(3.0), "xs": np.asarray(values),
              "dims_xs": np.array(["x"])}
    with zipfile.ZipFile(buf, "w") as zf:
        for name, a in arrays.items():
            member = io.BytesIO()
            np.lib.format.write_array(member, a)
            zf.writestr(zipfile.ZipInfo(f"{name}.npy", ZIP_DATE),
                        member.getvalue())
    return buf.getvalue()


def _write(path, data):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)


def _snapshot(cache):
    """{path relative to the cache root: its bytes as uint8}."""
    return {str(p.relative_to(cache)): np.frombuffer(p.read_bytes(), np.uint8)
            for p in sorted(cache.rglob("*")) if p.is_file()}


def _ds_tree(ds):
    return {"coords": dict(ds["coords"]),
            "data_vars": {k: {"dims": np.array(d), "values": np.asarray(v)}
                          for k, (d, v) in ds["data_vars"].items()}}


def _raised(fn, root):
    """The exception ``fn()`` raises as "Type: message", with the root
    and either package's database variable written alike ("none" if it
    raises nothing)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the record compares them
        msg = str(e).replace(str(root), "<root>")
        for var in ("SASKTRAN2_TPU_TORCH_DB_ROOT", "SASKTRAN2_TPU_DB_ROOT"):
            msg = msg.replace(var, "<database root variable>")
        return np.array(f"{type(e).__name__}: {msg}")
    return np.array("none")


def _contract(pkg, name, root):
    """Run one contract of ``tests/test_web_database.py`` with ``pkg``
    (either package) under ``root``: the record the test compares."""
    db_mod = pkg.database
    src, cache = root / "server", root / "cache"
    src.mkdir()
    cache.mkdir()
    rec = {}
    if name == "fetch_cache_clear":
        _write(src / "data.npz", _npz_bytes([1.0, 2.0, 3.0]))
        db = db_mod.WebDatabase((src / "data.npz").as_uri(),
                                rel_path="sub/dir", db_root=cache)
        out = db.load()
        rec["output"] = np.array(str(out.relative_to(cache)))
        rec["after_fetch"] = _snapshot(cache)
        (src / "data.npz").unlink()     # a second load must not fetch
        rec["second_load_same"] = np.array(db.load() == out)
        rec["ds"] = _ds_tree(db.load_ds())
        db.clear()
        rec["exists_after_clear"] = np.array(out.exists())
        rec["load_after_clear"] = _raised(db.load, root)
    elif name == "missing_source":
        db = db_mod.WebDatabase((src / "absent.npz").as_uri(), db_root=cache)
        rec["load"] = _raised(db.load, root)
        rec["partial_left"] = np.array(db.output_file().exists())
    elif name == "zip_extracts":
        members = {"payload/a.npz": _npz_bytes([1.0, 2.0, 3.0]),
                   "payload/nested/b.npz": _npz_bytes([4.0, 5.0, 6.0])}
        with zipfile.ZipFile(src / "bundle.zip", "w") as zf:
            for arc, data in members.items():
                zf.writestr(zipfile.ZipInfo(arc, ZIP_DATE), data)
        db_mod.ZipWebDatabase((src / "bundle.zip").as_uri(),
                              db_root=cache).load()
    elif name == "standard_versioned_keys":
        _write(src / "v_latest" / "cross_sections" / "o3.npz",
               _npz_bytes([7.0, 8.0, 9.0]))
        db = db_mod.StandardDatabase(base_url=src.as_uri(), db_root=cache)
        rec["path"] = np.array(str(db.path("cross_sections/o3.npz")
                                   .relative_to(cache)))
        rec["ds"] = _ds_tree(db.load_ds("cross_sections/o3.npz"))
        rec["clear"] = _raised(db.clear, root)
        rec["missing_key"] = _raised(lambda: db.path("absent/x.npz"), root)
    elif name == "zenodo_record":
        # a file:// tree shaped like the Zenodo records API: <api>/records/
        # <id> is a JSON record whose file entries carry download links
        files = src / "files"
        _write(files / "table.npz", _npz_bytes([1.0, 2.0, 3.0]))
        _write(files / "readme.txt", b"hello")
        record = {"files": [
            {"key": "table.npz",
             "links": {"self": (files / "table.npz").as_uri()}},
            {"filename": "readme.txt",
             "links": {"download": (files / "readme.txt").as_uri()}},
            {"links": {"self": (files / "readme.txt").as_uri()}},  # no name
        ]}
        api = src / "api"
        _write(api / "records" / "999", json.dumps(record).encode())
        out = db_mod.download_zenodo_record("999", cache / "zenodo",
                                            api_base=api.as_uri())
        rec["out"] = np.array([str(p.relative_to(cache)) for p in out])
        rec["after_fetch"] = _snapshot(cache)
        (files / "table.npz").unlink()  # a second download must not fetch
        out = db_mod.download_zenodo_record("999", cache / "zenodo",
                                            api_base=api.as_uri())
        rec["second_out"] = np.array([str(p.relative_to(cache)) for p in out])
        rec["missing_record"] = _raised(
            lambda: db_mod.download_zenodo_record(
                "1000", cache / "zenodo", api_base=api.as_uri()), root)
    rec["files"] = _snapshot(cache)
    return rec


def test_default_base_url_equal(file_urls_only):
    """``StandardDatabase``'s default mirror is the JAX package's, read
    without fetching anything."""
    ref = torch_support.jax_reference(
        lambda: np.array(sk.database.StandardDatabase.DEFAULT_BASE_URL), ())
    assert skt.database.StandardDatabase.DEFAULT_BASE_URL == str(ref)
    db = skt.database.StandardDatabase(version="1.0")
    assert db._url == str(ref).rstrip("/") + "/v_1.0/"
    assert file_urls_only == []


def _assert_records_equal(got, ref, where=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), (where, sorted(got), sorted(ref))
        for k in ref:
            _assert_records_equal(got[k], ref[k], f"{where}/{k}")
    else:
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.dtype.kind == ref.dtype.kind, where
        np.testing.assert_array_equal(got, ref, err_msg=where)


@pytest.mark.parametrize("contract", CONTRACTS)
def test_contract_matches_jax(contract, tmp_path, file_urls_only):
    """One contract of ``tests/test_web_database.py``, run by both
    packages: the same files, bytes, datasets and exceptions."""

    def record():
        with tempfile.TemporaryDirectory() as d:
            return _contract(sk, contract, Path(d))

    ref = torch_support.jax_reference(record, contract)
    got = _contract(skt, contract, tmp_path)
    _assert_records_equal(got, ref)
    # and the contract itself, on the port's record
    files = got["files"]
    if contract == "fetch_cache_clear":
        assert str(got["output"]) == "sub/dir/data.npz"
        assert list(got["after_fetch"]) == ["sub/dir/data.npz"]
        assert bool(got["second_load_same"])
        np.testing.assert_array_equal(got["ds"]["data_vars"]["xs"]["values"],
                                      [1.0, 2.0, 3.0])
        assert not bool(got["exists_after_clear"]) and files == {}
        assert str(got["load_after_clear"]).startswith("FileNotFoundError")
    elif contract == "missing_source":
        assert str(got["load"]).startswith("FileNotFoundError")
        assert "absent.npz" in str(got["load"])
        assert "<database root variable>" in str(got["load"])
        assert not bool(got["partial_left"]) and files == {}
    elif contract == "zip_extracts":
        assert sorted(files) == ["bundle.zip", "payload/a.npz",
                                 "payload/nested/b.npz"]
    elif contract == "standard_versioned_keys":
        assert str(got["path"]) == "cross_sections/o3.npz"
        assert "xs" in got["ds"]["data_vars"]
        assert str(got["clear"]).startswith("NotImplementedError")
        assert str(got["missing_key"]).startswith("FileNotFoundError")
        assert sorted(files) == ["cross_sections/o3.npz"]
    else:
        assert list(got["out"]) == ["zenodo/table.npz", "zenodo/readme.txt"]
        assert list(got["second_out"]) == list(got["out"])
        assert bytes(files["zenodo/readme.txt"]) == b"hello"
        assert str(got["missing_record"]).startswith(("URLError",
                                                      "FileNotFoundError"))
    assert file_urls_only
