"""The port's Mie solution, ensemble integration, Mie tables and the host
copies around them, against the JAX package's, in float64 on the CPU.

* ``mie_coefficients``, ``mie_efficiencies``, ``mie_amplitudes`` and
  ``compute_mie`` on a batch that mixes small and large size parameters
  (0.3 to 80) agree to 1e-10 (each array relative to its largest
  magnitude).
* Members far below the batch's largest size parameter (0.007 and 0.01
  beside 60): the JAX package's batch call gives NaN or wrong values
  there (its psi recurrence runs to the batch's nmax); with
  ``own_nmax=True`` (what the port's ``integrate_mie`` uses) the port
  drops each member's terms above its own nmax, and each member equals
  the JAX package's call on that member alone to 1e-10.
* ``integrate_mie`` (with greek coefficients) and a ``MieDatabase``
  generated into ``tmp_path`` agree to 1e-10, and the table's cache key
  is the JAX package's.
* The distributions, ``_integration_grid``, ``compute_greek_coefficients``,
  the optical databases and Henyey-Greenstein are pinned bit-equal, and
  the port's database root is its own.

The JAX side of the compute is read from
``sasktran2_tpu_torch/data/golden_test_torch_mie.npz``
(``tests/torch_support.py``)."""

import tempfile

import numpy as np
import pytest
import torch

import sasktran2_tpu_torch as skt
from sasktran2_tpu import legendre as legendre_ref
from sasktran2_tpu import mie as mie_pkg_ref
from sasktran2_tpu.database import mie as mie_db_ref
from sasktran2_tpu.mie import distribution as distribution_ref
from sasktran2_tpu.optical import database as database_ref
from sasktran2_tpu.optical import henyey as henyey_ref
from sasktran2_tpu.optical import mie as mie_ref
from sasktran2_tpu_torch import appconfig, legendre
from sasktran2_tpu_torch import mie as mie_pkg
from sasktran2_tpu_torch.database import mie as mie_db
from sasktran2_tpu_torch.mie import distribution
from sasktran2_tpu_torch.optical import database, henyey, mie
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

M = 1.44 - 1e-7j


def _rel(got, ref):
    scale = np.max(np.abs(ref))
    return np.max(np.abs(np.asarray(got) - ref)) / scale


def _mixed_x():
    rng = np.random.default_rng(21)
    return np.concatenate([rng.uniform(0.3, 1.0, 20),
                           rng.uniform(1.0, 10.0, 20),
                           rng.uniform(10.0, 80.0, 20)])


def test_mie_functions_match_jax():
    x = _mixed_x()
    mu = np.cos(np.deg2rad(np.linspace(0.0, 180.0, 37)))

    def jax_side():
        import jax.numpy as jnp

        an, bn = mie_ref.mie_coefficients(jnp.asarray(x), M)
        qext, qsca = mie_ref.mie_efficiencies(jnp.asarray(x), M)
        s1, s2 = mie_ref.mie_amplitudes(jnp.asarray(x), M, jnp.asarray(mu))
        out = mie_ref.compute_mie(x, M, mu)
        return {"an": an, "bn": bn, "qext": qext, "qsca": qsca, "s1": s1,
                "s2": s2, "Qext": out.Qext, "Qsca": out.Qsca,
                "S1": out.S1, "S2": out.S2}

    ref = torch_support.jax_reference(jax_side, (x, mu, M))
    xt = torch.as_tensor(x)
    an, bn = mie.mie_coefficients(xt, M)
    assert an.dtype == torch.complex128
    qext, qsca = mie.mie_efficiencies(xt, M)
    s1, s2 = mie.mie_amplitudes(xt, M, torch.as_tensor(mu))
    out = mie.compute_mie(x, M, mu, device="cpu")
    got = {"an": an, "bn": bn, "qext": qext, "qsca": qsca, "s1": s1,
           "s2": s2, "Qext": out.Qext, "Qsca": out.Qsca, "S1": out.S1,
           "S2": out.S2}
    for k, v in got.items():
        v = v.numpy() if isinstance(v, torch.Tensor) else v
        assert v.shape == ref[k].shape, k
        assert np.all(np.isfinite(v)), k
        assert _rel(v, ref[k]) <= 1e-10, (k, _rel(v, ref[k]))


def test_small_members_of_a_large_batch():
    """The JAX package's batch call is wrong or NaN for members far below
    its largest size parameter; the port's members equal the JAX
    package's call on each member alone."""
    x = np.array([0.007, 0.01, 0.05, 0.1, 0.5, 5.0, 60.0])
    mu = np.cos(np.deg2rad(np.linspace(0.0, 180.0, 19)))

    def jax_side():
        import jax.numpy as jnp

        alone = [mie_ref.compute_mie(x[i:i + 1], M, mu) for i in range(len(x))]
        batch = mie_ref.compute_mie(x, M, mu)
        return {"qext": np.concatenate([a.Qext for a in alone]),
                "qsca": np.concatenate([a.Qsca for a in alone]),
                "s1": np.concatenate([a.S1 for a in alone]),
                "s2": np.concatenate([a.S2 for a in alone]),
                "batch_qext": np.asarray(batch.Qext),
                "nmax": np.array([mie_ref._nmax_for(float(jnp.max(x)))])}

    ref = torch_support.jax_reference(jax_side, (x, mu, M))
    # the reference's own batch: NaN or off by orders of magnitude for the
    # small members
    bad = ~np.isfinite(ref["batch_qext"]) | (
        np.abs(ref["batch_qext"] - ref["qext"]) > 1e-3 * np.abs(ref["qext"]))
    assert np.all(bad[:2]) and not np.any(bad[2:])
    xt = torch.as_tensor(x)
    an, bn = mie.mie_coefficients(xt, M, own_nmax=True)
    qext, qsca = mie.efficiencies_from_coefficients(xt, an, bn)
    s1, s2 = mie.amplitudes_from_coefficients(xt, an, bn,
                                              torch.as_tensor(mu))
    for name, v in (("qext", qext.numpy()), ("qsca", qsca.numpy())):
        assert np.all(np.isfinite(v))
        err = np.abs(v - ref[name]) / np.abs(ref[name])
        assert np.max(err) <= 1e-10, (name, err)
    for name, v in (("s1", s1.numpy()), ("s2", s2.numpy())):
        scale = np.max(np.abs(ref[name]), axis=1, keepdims=True)
        assert np.max(np.abs(v - ref[name]) / scale) <= 1e-10, name


DIST = {"median_radius": 100.0, "mode_width": 1.5}


def _distribution(pkg):
    return pkg.LogNormalDistribution().distribution(**DIST)


def _refr(wl):
    return 1.5 - 0.01j


def test_integrate_mie_matches_jax():
    kw = {"num_angles": 181, "num_quad": 128, "compute_coeffs": True,
          "num_coeffs": 16}
    wl = np.array([450.0, 650.0])

    def jax_side():
        return distribution_ref.integrate_mie(_distribution(mie_pkg_ref),
                                              _refr, wl, **kw)

    ref = torch_support.jax_reference(jax_side, (wl, kw, _refr, DIST))
    got = distribution.integrate_mie(_distribution(mie_pkg), _refr, wl,
                                     device="cpu", **kw)
    assert set(got) == set(ref)
    for k in ref:
        assert np.all(np.isfinite(got[k])), k
        assert _rel(got[k], ref[k]) <= 1e-10, (k, _rel(got[k], ref[k]))


def _mie_database(pkg, db_mod, root, **kw):
    return db_mod.MieDatabase(
        pkg.LogNormalDistribution(),
        pkg.RefractiveIndex(_refr, "const_150_001"),
        np.array([500.0, 700.0]),
        db_root=root,
        max_legendre_moments=16,
        num_size_quadrature=64,
        num_angles=91,
        median_radius=np.array([80.0, 120.0]),
        mode_width=np.array([1.5]),
        **kw,
    )


def test_mie_database_matches_jax(tmp_path):
    def jax_side():
        with tempfile.TemporaryDirectory() as root:
            db = _mie_database(mie_pkg_ref, mie_db_ref, root)
            with np.load(db.data_file) as f:
                arrays = {k: f[k] for k in f.files
                          if not k.startswith("dims_")}
        return {"arrays": arrays, "key": np.array(db._cache_key())}

    ref = torch_support.jax_reference(jax_side, (_refr,))
    db = _mie_database(mie_pkg, mie_db, tmp_path / "port", device="cpu")
    assert str(ref["key"]) == db._cache_key()
    assert db.data_file.name == f"mie_{ref['key']}.npz"
    with np.load(db.data_file) as f:
        got = {k: f[k] for k in f.files}
    for k, v in ref["arrays"].items():
        assert got[k].shape == v.shape, k
        assert _rel(got[k], v) <= 1e-10, (k, _rel(got[k], v))
    # the dims records of the layout
    assert tuple(got["dims_lm_a1"]) == ("legendre", "median_radius",
                                        "mode_width", "wavelength_nm")
    # a second construction reads the cache
    again = _mie_database(mie_pkg, mie_db, tmp_path / "port", device="cpu")
    assert again.data_file == db.data_file


def test_distributions_equal():
    """The named distributions, the frozen one, and the integration grid
    (scipy quad) are the JAX package's."""
    cases = [
        ("LogNormalDistribution", {"median_radius": 120.0,
                                   "mode_width": 1.6}),
        ("UniformDistribution", {"min_radius": 50.0, "max_radius": 200.0}),
        ("GammaDistribution", {"alpha": 4.0, "beta": 0.04}),
        ("TriangularDistribution", {"min_radius": 50.0, "max_radius": 300.0,
                                    "center_radius": 120.0}),
    ]
    r = np.linspace(1.0, 500.0, 50)
    for name, kw in cases:
        a = getattr(mie_pkg, name)()
        b = getattr(mie_pkg_ref, name)()
        assert a.identifier == b.identifier and a.args() == b.args()
        da, db = a.distribution(**kw), b.distribution(**kw)
        np.testing.assert_array_equal(da.pdf(r), db.pdf(r))
        first = next(iter(kw))
        fa = a.freeze(**{first: kw[first]})
        fb = b.freeze(**{first: kw[first]})
        assert fa.identifier == fb.identifier and fa.args() == fb.args()
    dist_a, dist_b = _distribution(mie_pkg), _distribution(mie_pkg_ref)
    for got, ref in zip(distribution._integration_grid(dist_a, 64, 0.99999),
                        distribution_ref._integration_grid(dist_b, 64,
                                                           0.99999)):
        np.testing.assert_array_equal(got, ref)


def test_greek_coefficients_equal():
    rng = np.random.default_rng(22)
    angles = np.linspace(0.0, 180.0, 91)
    p = [np.abs(rng.normal(size=(2, 91))) + 0.1 for _ in range(6)]
    got = legendre.compute_greek_coefficients(*p, angle_grid=angles,
                                              num_coeff=12)
    ref = legendre_ref.compute_greek_coefficients(*p, angle_grid=angles,
                                                  num_coeff=12)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _scatterer_db():
    rng = np.random.default_rng(23)
    wl = np.array([400.0, 500.0, 700.0])
    rad = np.array([0.1, 0.2, 0.4])
    lm = rng.uniform(0.1, 0.5, size=(8, 3, 3))
    lm[0] = 2.0
    return {
        "coords": {"wavelength_nm": wl, "median_radius": rad},
        "data_vars": {
            "xs_total": (("median_radius", "wavelength_nm"),
                         rng.uniform(1e-15, 1e-14, size=(3, 3))),
            "xs_scattering": (("median_radius", "wavelength_nm"),
                              rng.uniform(5e-16, 9e-16, size=(3, 3))),
            "lm_a1": (("legendre", "median_radius", "wavelength_nm"), lm),
            "lm_b1": (("legendre", "median_radius", "wavelength_nm"),
                      0.1 * lm),
        },
    }


def test_optical_databases_equal():
    """The scatterer and absorber databases (interpolation over the
    spectral grid and the per-altitude parameters, the absorber's
    parameter derivatives) and Henyey-Greenstein are the JAX package's."""
    wl = np.array([420.0, 550.0, 690.0, 710.0])
    alts = np.array([0.0, 1000.0, 2000.0])
    kw = {"median_radius": np.array([0.12, 0.3, 0.5])}
    a = database.OpticalDatabaseGenericScatterer(db=_scatterer_db())
    b = database_ref.OpticalDatabaseGenericScatterer(db=_scatterer_db())
    pa = a.scattering_properties(wl, altitudes_m=alts, **kw)
    pb = b.scattering_properties(wl, altitudes_m=alts, **kw)
    assert set(pa) == set(pb)
    for k in pb:
        np.testing.assert_array_equal(pa[k], pb[k])
    rng = np.random.default_rng(24)
    xs = rng.uniform(1e-25, 1e-24, size=(3, 2, 5))
    params = {"temperature_k": [200.0, 250.0, 300.0],
              "pressure_pa": [100.0, 1e5]}
    wl_db = np.linspace(400.0, 800.0, 5)
    abs_a = database.AbsorberDatabase(wl_db, xs, params)
    abs_b = database_ref.AbsorberDatabase(wl_db, xs, params)
    state = {"temperature_k": np.array([210.0, 260.0, 290.0]),
             "pressure_pa": np.array([5e4, 1e3, 200.0])}
    np.testing.assert_array_equal(
        abs_a.cross_sections(wl, altitudes_m=alts, **state),
        abs_b.cross_sections(wl, altitudes_m=alts, **state))
    da = abs_a.cross_section_derivatives(wl, altitudes_m=alts, **state)
    dbr = abs_b.cross_section_derivatives(wl, altitudes_m=alts, **state)
    for k in dbr:
        np.testing.assert_array_equal(da[k], dbr[k])
    np.testing.assert_array_equal(
        henyey.HenyeyGreenstein(0.7).legendre_coefficients(12),
        henyey_ref.HenyeyGreenstein(0.7).legendre_coefficients(12))


def test_database_root_is_the_ports_own(tmp_path, monkeypatch):
    """The port's cache root comes from its own variable and default
    directory, never the JAX package's."""
    monkeypatch.delenv(appconfig.DB_ROOT_ENV, raising=False)
    monkeypatch.setenv("SASKTRAN2_TPU_DB_ROOT", str(tmp_path / "jax"))
    monkeypatch.setenv(appconfig.CONFIG_DIR_ENV, str(tmp_path / "cfg"))
    assert skt.database.database_root() == tmp_path / "cfg" / "db"
    monkeypatch.setenv(appconfig.DB_ROOT_ENV, str(tmp_path / "port"))
    assert skt.database.database_root() == tmp_path / "port"
    assert (tmp_path / "port").is_dir()
    # a WebDatabase with no db_root caches under the port's root
    src = tmp_path / "server" / "table.txt"
    src.parent.mkdir()
    src.write_text("1 2 3")
    db = skt.database.WebDatabase(src.as_uri(), rel_path="web")
    assert db.load() == tmp_path / "port" / "web" / "table.txt"
    assert db.load().read_text() == "1 2 3"
    assert not (tmp_path / "jax").exists()


def test_refractive_indices_equal(tmp_path, monkeypatch):
    """The OSIRIS refractive-index loaders read the same file the same way
    (each package under its own database root), and a missing file
    raises; nothing is fetched."""
    rows = np.column_stack([np.linspace(300.0, 1000.0, 8),
                            np.linspace(1.45, 1.42, 8),
                            np.geomspace(1e-8, 1e-6, 8)])
    for root in ("jax", "port"):
        (tmp_path / root / "refractive_index").mkdir(parents=True)
        np.savetxt(tmp_path / root / "refractive_index"
                   / "refrac_h2so4_osiris.txt", rows, delimiter=",")
    monkeypatch.setenv("SASKTRAN2_TPU_DB_ROOT", str(tmp_path / "jax"))
    monkeypatch.setenv(appconfig.DB_ROOT_ENV, str(tmp_path / "port"))
    wl = np.array([350.0, 765.0, 999.0])
    a, b = mie_pkg.H2SO4(), mie_pkg_ref.H2SO4()
    assert a.identifier == b.identifier
    np.testing.assert_array_equal(a.refractive_index(wl),
                                  b.refractive_index(wl))
    with pytest.raises(FileNotFoundError, match="refrac_dust_osiris"):
        mie_pkg.Dust()


def test_refractive_index_sign():
    """The Mie formulas (xi = psi - i chi) take an absorbing refractive
    index as n + ik: with n - ik the ensemble's scattering cross section
    exceeds its extinction (an ssa above 1, which the engines' input
    validation refuses), with n + ik it falls below, by the same
    amount."""
    dist = mie_pkg.LogNormalDistribution().distribution(median_radius=120.0,
                                                        mode_width=1.6)
    ssa = {}
    for sign in (-1.0, 1.0):
        out = distribution.integrate_mie(
            dist, lambda wl, s=sign: 1.44 + s * 1e-7j, [765.0],
            num_angles=19, num_quad=128, maxintquantile=0.999999,
            device="cpu")
        ssa[sign] = out["xs_scattering"][0] / out["xs_total"][0]
    assert ssa[-1.0] > 1.0 > ssa[1.0]
    assert abs((ssa[-1.0] - 1.0) + (ssa[1.0] - 1.0)) < 1e-3 * abs(
        ssa[1.0] - 1.0)
