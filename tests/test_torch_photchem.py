"""The port's photochemistry (``photchem/``, numpy copies) against the JAX
package's: ``Molecule`` parsing, ``Yankovsky.solve`` (rtol 1e-12),
``calculate_photolysis_rate`` (band, line and TOA-renormalised),
the emission bands and their line weights from HITRAN ``.par`` files,
``o2_singlet_delta_ver`` and the green-line functions, on the cases of
``tests/test_photchem.py``. The JAX side of each case is read from
``sasktran2_tpu_torch/data/golden_test_torch_photchem.npz``
(``tests/torch_support.py``)."""

import numpy as np
import pytest

import sasktran2_tpu as sk
import sasktran2_tpu_torch as skt
from sasktran2_tpu_torch import scenarios
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401

MOLECULES = ["O2", "O(3P)", "O", "O(1D)", "O2(b, v=0)", "O2(X, v=1)", "CO2",
             "O2(a, v=5)", "O(1S)", "N2", "O3"]
O2_MOLAR_MASS = 0.0319988


def _backgrounds(nz):
    """The JAX test's crude 60-90 km profiles, m^-3
    (``tests/test_photchem.py:17-25``)."""
    return {
        "O2": np.full(nz, 4.0e20),
        "O3": np.full(nz, 1.0e14),
        "O": np.full(nz, 1.0e17),
        "N2": np.full(nz, 1.6e21),
        "CO2": np.full(nz, 6.0e17),
    }


def _molecules(pkg):
    out = {}
    for text in MOLECULES:
        m = pkg.photchem.Molecule.parse(text)
        out[text] = {"name": np.array(m.name), "base": np.array(m.base),
                     "is_ground": np.array(m.is_ground)}
    return out


def test_molecule_parsing_matches_jax():
    ref = torch_support.jax_reference(lambda: _molecules(sk), MOLECULES)
    got = _molecules(skt)
    for text in MOLECULES:
        for k, v in ref[text].items():
            assert got[text][k] == v.item(), (text, k)
    assert skt.photchem.Molecule.parse("O(3P)").is_ground
    assert not skt.photchem.Molecule.parse("O2(b, v=0)").is_ground


def _rates(pkg, kind, nz):
    """Photolysis rates of the Yankovsky network: every channel at 1e-9
    (``kind="flat"``), a seeded profile per channel (``"seeded"``), each
    reaction's TOA rate as per-reaction rates with the quantum yield
    (``"array"``), or only the O3 Hartley channel (``"o1d"``)."""
    model = pkg.photchem.Yankovsky()
    names = model.required_photolysis_rates()
    if kind == "flat":
        return {n: np.full(nz, 1.0e-9) for n in names}
    if kind == "seeded":
        rng = np.random.default_rng(11)
        return {n: 10.0 ** rng.uniform(-10.0, -5.0, nz) for n in names}
    if kind == "array":
        return np.array([np.full(nz, r.quantum_yield * r.toa_rate_constant)
                         for r in model.photo_reactions])
    rates = {n: np.zeros(nz) for n in names}
    rates["J_O3_"] = np.full(nz, 1.0e-2)
    return rates


@pytest.mark.parametrize("kind", ["flat", "seeded", "array", "o1d"])
def test_yankovsky_solve_matches_jax(kind):
    nz = 1 if kind == "o1d" else 7
    t = np.linspace(180.0, 240.0, nz)
    bg = _backgrounds(nz)

    def solve(pkg):
        return pkg.photchem.Yankovsky().solve(t, bg, _rates(pkg, kind, nz))

    ref = torch_support.jax_reference(lambda: solve(sk), (kind, t, bg))
    got = solve(skt)
    assert set(got) == set(ref)
    for name, v in ref.items():
        np.testing.assert_allclose(got[name], v, rtol=1e-12, atol=0,
                                   err_msg=name)
    for state in ("O(1D)", "O2(b, v=0)", "O2(a, v=0)"):
        if kind != "o1d":
            assert np.all(got[state] > 0)
    for name in bg:
        assert name not in got


def _photolysis(pkg):
    """``calculate_photolysis_rate`` on the JAX test's TOA case
    (``tests/test_photchem.py:91-106``), a band without TOA
    renormalisation and the Lyman-alpha line (an effective cross
    section)."""
    photo = pkg.photchem.PhotoReaction
    rng = np.random.default_rng(4)
    wl = np.linspace(120.0, 300.0, 181)
    flux = np.ones((181, 4)) * np.linspace(0.2, 1.0, 4)
    xs = np.full((181, 4), 1e-24)
    out = {}
    r = (photo.parse("O2 + hv(SRC) -> O(3P) + O(1D)")
         .with_toa_rate_constant(2.6e-6).with_wavelength_range_nm(130.0,
                                                                  202.0))
    out["toa"] = pkg.photchem.calculate_photolysis_rate(r, wl, flux, xs)
    flux2 = rng.uniform(0.5, 1.5, (181, 6)) * 1e15
    xs2 = 10.0 ** rng.uniform(-26.0, -22.0, (181, 6))
    r2 = (photo.parse("O2 + hv(SRC) -> O(3P) + O(1D)")
          .with_quantum_yield(0.7).with_wavelength_range_nm(140.0, 200.0))
    out["band"] = pkg.photchem.calculate_photolysis_rate(r2, wl, flux2, xs2)
    model = pkg.photchem.Yankovsky()
    lyman = model.photo_reactions[1]
    out["lyman"] = pkg.photchem.calculate_photolysis_rate(
        lyman, wl, flux2, xs2)
    out["widths"] = pkg.photchem.wavelength_bin_widths(wl)
    out["integrated"] = pkg.photchem.integrate_photolysis_rate(
        wl, xs2.T, 0.5, flux2.T)
    out["photon_flux"] = pkg.photchem.irradiance_to_photon_flux(
        wl, np.linspace(0.1, 2.0, 181))
    return out


def test_photolysis_rates_match_jax():
    ref = torch_support.jax_reference(lambda: _photolysis(sk), ())
    got = _photolysis(skt)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=0, err_msg=k)
    np.testing.assert_allclose(got["toa"][-1], 2.6e-6, rtol=1e-12)


def _write_par(tmp_path, rows, name):
    p = tmp_path / name
    p.write_text("\n".join(rows) + "\n")
    return p


def _record(iso, nu0, s, a, elower, gp, gpp, qup="", qlo=""):
    """A 160-column HITRAN record (``tests/test_lineemission.py:93-116``)."""
    line = (
        f"{7:2d}{iso:1d}{nu0:12.6f}{s:10.3E}{a:10.3E}"
        f"{0.05:5.3f}{0.04:5.3f}{elower:10.4f}{0.70:4.2f}{0.0:8.6f}"
    )
    if qup or qlo:
        line += f"{qup:>15}{qlo:>15}"
    line += " " * (146 - len(line))
    line += f"{gp:7.1f}{gpp:7.1f}"
    assert len(line) == 160
    return line


# the JAX tests' two fake O2 files (tests/test_photchem.py:109-137,
# tests/test_lineemission.py:93-116) and the dayglow cell's 1,500 lines
PAR_FILES = {
    "levels": [
        _record(1, 13120.0, 1e-25, 0.06, 2.0, 5.0, 3.0),
        _record(1, 13112.0, 2e-25, 0.02, 10.0, 5.0, 7.0),
        _record(1, 13125.0, 1e-25, 0.08, 10.0, 9.0, 7.0),
    ],
    "quanta": [
        _record(1, 13120.0, 1e-25, 0.060, 2.0, 5.0, 3.0, "b 0", "X 0"),
        _record(1, 13112.0, 2e-25, 0.020, 10.0, 5.0, 7.0, "b 0", "X 0"),
        _record(1, 13125.0, 1e-24, 0.045, 1400.0, 7.0, 5.0, "b 1", "X 1"),
        _record(1, 14520.0, 5e-26, 0.070, 2.0, 5.0, 3.0, "b 1", "X 0"),
    ],
    "dayglow": scenarios.dayglow_par_lines(),
}


def _band_tree(band):
    out = {}
    for k in ("wavelength_nm", "einstein_a_line_s", "upper_energy_cminv",
              "weights", "g_upper", "iso_abundance", "upper_branching",
              "lower_energy_cminv", "line_intensity"):
        v = getattr(band, k)
        if v is not None:
            out[k] = np.asarray(v, dtype=np.float64)
    if band.upper_vib_state is not None:
        out["upper_vib_state"] = np.asarray(band.upper_vib_state).astype(str)
    return out


def _bands(pkg, path):
    """The A band (and the B band where the file has one) of a ``.par``
    file, with the LTE weights at 250 K, both per-altitude weight models
    and the line list of seeded O2(b, v = 0, 1) populations."""
    phem = pkg.photchem.emission
    cat = pkg.optical.load_hitran_par(path, O2_MOLAR_MASS)
    out = {}
    if cat.quanta_upper is not None and any(
            str(q).strip() for q in cat.quanta_upper):
        a_band = phem.oxygen_a_band_from_catalogue(cat)
    else:
        a_band = phem.EmissionBand.from_catalogue(
            "test", "O2(b, v=0)", "O2(X)", 0.0758, cat, 750.0, 775.0)
    out["a"] = _band_tree(a_band)
    out["lte"] = a_band.lte_weights(250.0)
    t = np.linspace(150.0, 300.0, 5)
    for model in ("einstein_a_branching", "hitran_line_strength"):
        out[model] = phem.band_line_weights(a_band, t, model)
    rng = np.random.default_rng(3)
    b0, b1 = rng.uniform(1e9, 1e10, 5), rng.uniform(1e8, 1e9, 5)
    ver, w = phem.oxygen_a_band_line_list_weights_from_populations(
        a_band, t, b0, b1)
    out["ver"], out["line_weights"] = ver, w
    try:
        b_band = phem.oxygen_b_band_from_catalogue(cat)
    except ValueError:
        b_band = None
    if b_band is not None:
        out["b"] = _band_tree(b_band)
        ver, w = phem.oxygen_b_band_line_list_weights_from_populations(
            b_band, t, b1)
        out["b_ver"], out["b_line_weights"] = ver, w
    return out


@pytest.mark.parametrize("name", list(PAR_FILES))
def test_emission_bands_from_par_match_jax(tmp_path, name):
    path = _write_par(tmp_path, PAR_FILES[name], f"{name}.par")
    ref = torch_support.jax_reference(lambda: _bands(sk, path),
                                      PAR_FILES[name])
    got = _bands(skt, path)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v), k
            for kk, vv in v.items():
                if vv.dtype.kind in "US":
                    np.testing.assert_array_equal(got[k][kk], vv)
                else:
                    np.testing.assert_allclose(got[k][kk], vv, rtol=1e-12,
                                               atol=0, err_msg=(k, kk))
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=0,
                                       err_msg=k)
    if name == "quanta":
        assert got["a"]["wavelength_nm"].size == 3
        assert got["b"]["wavelength_nm"].size == 1


def test_lte_weights_require_g_upper():
    cat = skt.optical.LineCatalogue(
        nu0=np.array([13120.0, 13125.0]),
        intensity=np.array([1e-25, 1e-25]),
        gamma_air=np.array([0.05, 0.05]),
        gamma_self=np.array([0.04, 0.04]),
        n_air=np.array([0.7, 0.7]),
        delta_air=np.array([0.0, 0.0]),
        elower=np.array([2.0, 10.0]),
        molar_mass=0.032,
        einstein_a=np.array([0.06, 0.08]),
    )
    band = skt.photchem.EmissionBand.from_catalogue(
        "test", "O2(b, v=0)", "O2(X)", 0.0758, cat, 750.0, 775.0)
    with pytest.raises(ValueError, match="statistical weights"):
        band.lte_weights(250.0)


def _airglow(pkg):
    """``o2_singlet_delta_ver``, the McDade green line (VER and O(1S)),
    the green-line transition and ``photon_ver_from_state_profile`` on
    seeded 60-110 km profiles."""
    rng = np.random.default_rng(9)
    nz = 11
    t = rng.uniform(170.0, 260.0, nz)
    p = np.geomspace(20.0, 0.01, nz)
    o = 10.0 ** rng.uniform(15.0, 18.0, nz)
    o2 = 10.0 ** rng.uniform(18.0, 21.0, nz)
    n2 = 3.7 * o2
    ph = pkg.photchem
    green = ph.oxygen_green_line_transition()
    return {
        "delta": ph.o2_singlet_delta_ver(
            rng.uniform(5e-3, 1e-2, nz), 10.0 ** rng.uniform(13, 15, nz),
            t, p),
        "green_ver": ph.mcdade_oxygen_green_line_photon_ver(t, o, o2, n2),
        "green_o1s": ph.mcdade_oxygen_green_line_o1s_population(
            t, o, o2, n2),
        "transition": np.array([green.wavelength_nm, green.einstein_a_s]),
        "transition_ver": green.photon_ver(o),
        "state_ver": ph.photon_ver_from_state_profile(
            {"O(1S)": o}, "O(1S)", 1.26),
    }


def test_airglow_functions_match_jax():
    ref = torch_support.jax_reference(lambda: _airglow(sk), ())
    got = _airglow(skt)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, atol=0, err_msg=k)
    with pytest.raises(KeyError):
        skt.photchem.photon_ver_from_state_profile({}, "O(1S)", 1.0)
