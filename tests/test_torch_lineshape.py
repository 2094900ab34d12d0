"""The port's line-shape functions and line-by-line absorber against the
JAX package's, in float64 on the CPU.

``wofz`` and both Voigt profiles agree to 1e-12 per element (relative to
|w|) on points inside each of Humlicek's four regions and on their
borders (s = |x| + y at exactly 5.5 and 15; the region 3 / 4 border
y = 0.195 |x| - 0.176 from 1e-9 on either side). ``LineAbsorber``'s cross
sections agree per level to 1e-10 of that level's largest value (they
span many decades, so a relative error per element says nothing in the
far wings): plain, with self-broadening, and AER-coupled (first-order
line mixing) from a synthetic AER file, with the port's level blocks and
line chunks cut small so that both are exercised. The two line-file
parsers are pinned bit-equal. The JAX side of the compute is read from
``sasktran2_tpu_torch/data/golden_test_torch_lineshape.npz``
(``tests/torch_support.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

import sasktran2_tpu_torch as skt
from sasktran2_tpu.optical import line_absorber as line_absorber_ref
from sasktran2_tpu.optical import lineshape as lineshape_ref
from sasktran2_tpu_torch.optical import line_absorber, lineshape
from tests import torch_support
from tests.torch_support import one_torch_thread  # noqa: F401


def _points():
    """Complex arguments in each region and on the borders."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-30.0, 30.0, 4000)
    y = rng.uniform(0.0, 30.0, 4000)
    z = list(x + 1j * y)
    # inside each region, by construction
    z += list(rng.uniform(-2.0, 2.0, 50) + 1j * rng.uniform(0.5, 2.0, 50))
    xb = rng.uniform(3.0, 5.0, 50)
    z += list(xb + 1j * rng.uniform(0.0, 0.1, 50))            # region 4
    z += list(rng.uniform(8.0, 10.0, 50) + 1j * 0.5)          # region 2
    z += list(rng.uniform(20.0, 40.0, 50) + 1j * 1.0)         # region 1
    # borders: s = 5.5 and s = 15 exactly, the region 3 / 4 border +-1e-9
    for s in (5.5, 15.0):
        xs = np.linspace(-s, s, 41)
        z += list(xs + 1j * (s - np.abs(xs)))
    xs = np.linspace(-4.5, 4.5, 41)
    yb = np.maximum(0.195 * np.abs(xs) - 0.176, 0.0)
    z += list(xs + 1j * (yb + 1e-9)) + list(xs + 1j * np.maximum(yb - 1e-9,
                                                                  0.0))
    return np.array(z)


def test_wofz_matches_jax():
    z = _points()

    def jax_side():
        return lineshape_ref.wofz(z)

    ref = torch_support.jax_reference(jax_side, (z, lineshape_ref.wofz))
    got = lineshape.wofz(torch.as_tensor(z))
    assert got.dtype == torch.complex128
    got = got.numpy()
    err = np.abs(got - ref) / np.abs(ref)
    assert np.all(np.isfinite(got))
    assert np.max(err) <= 1e-12, np.max(err)


@pytest.mark.parametrize("complex_form", [False, True])
def test_voigt_profiles_match_jax(complex_form):
    rng = np.random.default_rng(12)
    nu = np.linspace(12990.0, 13010.0, 801)
    nu0 = rng.uniform(12995.0, 13005.0, 7)[:, None]
    alpha = rng.uniform(0.005, 0.02, 7)[:, None]
    gamma = np.concatenate([rng.uniform(1e-5, 0.06, 6), [2.0]])[:, None]
    args = (nu[None, :], nu0, alpha, gamma)
    fn_ref = (lineshape_ref.voigt_profile_complex if complex_form
              else lineshape_ref.voigt_profile)
    fn = (lineshape.voigt_profile_complex if complex_form
          else lineshape.voigt_profile)

    def jax_side():
        out = fn_ref(*args)
        return list(out) if complex_form else out

    ref = torch_support.jax_reference(jax_side, (args, fn_ref))
    got = fn(*(torch.as_tensor(a) for a in args))
    refs = ref if complex_form else [ref]
    gots = list(got) if complex_form else [got]
    # per element relative to |w| / (alpha sqrt(pi)), which the two parts
    # share (the dispersion part crosses zero at the line centre)
    x = (nu[None, :] - nu0) / alpha
    w = lineshape.wofz(torch.as_tensor(x + 1j * (gamma / alpha))).numpy()
    norm = np.abs(w) / (alpha * lineshape.SQRT_PI)
    for a, b in zip(gots, refs):
        a = a.numpy()
        assert a.dtype == np.float64
        assert np.max(np.abs(a - b) / norm) <= 1e-12


def test_doppler_width_equal():
    nu0 = np.linspace(13000.0, 13200.0, 11)
    for t in (180.0, 296.0):
        np.testing.assert_array_equal(
            lineshape.doppler_width(torch.as_tensor(nu0), t, 0.032).numpy(),
            lineshape_ref.doppler_width(nu0, t, 0.032),
        )


def _catalogue(mod, n=700, seed=13):
    rng = np.random.default_rng(seed)
    ga = rng.uniform(0.03, 0.055, n)
    return mod.LineCatalogue(
        nu0=np.sort(rng.uniform(12990.0, 13060.0, n)),
        intensity=10 ** rng.uniform(-27.0, -23.0, n),
        gamma_air=ga, gamma_self=ga + 0.005,
        n_air=rng.uniform(0.6, 0.8, n),
        delta_air=rng.uniform(-0.012, -0.005, n),
        elower=rng.uniform(0.0, 2000.0, n), molar_mass=31.98983e-3,
    )


GRID = 13000.0 + 0.05 * np.arange(900)
PRESSURE = np.array([101325.0, 50000.0, 5000.0, 100.0, 1.0])
TEMPERATURE = np.array([288.0, 255.0, 220.0, 240.0, 190.0])


def _assert_per_level(got, ref, tol=1e-10):
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got))
    err = np.max(np.abs(got - ref), axis=1) / np.max(np.abs(ref), axis=1)
    assert np.max(err) <= tol, err


@pytest.mark.parametrize("self_vmr", [0.0, 0.2095])
def test_line_absorber_matches_jax(self_vmr):
    """700 lines (two chunks of 512, the second padded), 900 grid points,
    5 levels from the surface to 1 Pa; the port in blocks of 2 levels."""
    absorber_ref = line_absorber_ref.LineAbsorber(_catalogue(line_absorber_ref))

    def jax_side():
        return absorber_ref.cross_section_grid(
            GRID, PRESSURE, TEMPERATURE, self_vmr)

    ref = torch_support.jax_reference(
        jax_side, (absorber_ref, GRID, PRESSURE, TEMPERATURE, self_vmr))
    absorber = line_absorber.LineAbsorber(_catalogue(line_absorber),
                                          device="cpu")
    absorber.max_block_elements = 2 * 512 * len(GRID)
    got = absorber.cross_section_grid(GRID, PRESSURE, TEMPERATURE, self_vmr)
    _assert_per_level(got, ref)


def test_line_absorber_cross_sections_wavelength_order():
    """``cross_sections`` takes wavelengths in any order, sorts them to
    wavenumber for the compute and returns the caller's order."""
    wl = 1e7 / GRID[::7]
    wl = wl[np.random.default_rng(14).permutation(len(wl))]
    absorber_ref = line_absorber_ref.LineAbsorber(_catalogue(line_absorber_ref))

    def jax_side():
        return absorber_ref.cross_sections(
            wl, pressure_pa=PRESSURE[:2], temperature_k=TEMPERATURE[:2])

    ref = torch_support.jax_reference(
        jax_side, (absorber_ref, wl, PRESSURE, TEMPERATURE))
    got = line_absorber.LineAbsorber(
        _catalogue(line_absorber), device="cpu").cross_sections(
        wl, pressure_pa=PRESSURE[:2], temperature_k=TEMPERATURE[:2])
    _assert_per_level(got, ref)


def _f100_record(nu, s, gair, gself, elower, nair, dair, couple):
    f = (
        f"{7:2d}{1:1d}{nu:12.6f}{s:10.3E}{1e-3:10.3E}"
        f"{gair:5.3f}{gself:5.3f}{elower:10.4f}{nair:4.2f}{dair:8.5f}"
    )
    f += " " * (3 + 3 + 9 + 9 + 3)
    f += (" 5 -1" if couple else " 5  1").rjust(6)
    assert len(f) == 100
    return f


def _coupling_record(y, g):
    return (
        " " * 3
        + f"{y[0]:12.4E}" + f"{g[0]:11.4E}"
        + f"{y[1]:13.4E}" + f"{g[1]:11.4E}"
        + f"{y[2]:13.4E}" + f"{g[2]:11.4E}"
        + f"{y[3]:13.4E}" + f"{g[3]:11.4E}"
    )


def write_aer_file(path, n=40, seed=15):
    """A synthetic AER line file of ``n`` O2 A-band lines, every other one
    with a line-coupling record (Y and G at 200/250/296/340 K), as
    ``tests/test_aerline.py`` writes its files."""
    rng = np.random.default_rng(seed)
    rows = ["> synthetic O2 A-band AER file"]
    for i, nu in enumerate(np.sort(rng.uniform(13002.0, 13040.0, n))):
        couple = i % 2 == 0
        rows.append(_f100_record(
            nu, 10 ** rng.uniform(-26.0, -23.5), rng.uniform(0.03, 0.05),
            rng.uniform(0.035, 0.055), rng.uniform(0.0, 1500.0),
            rng.uniform(0.6, 0.8), rng.uniform(-0.01, 0.0), couple))
        if couple:
            y = rng.uniform(-0.05, 0.05) * np.array([1.3, 1.1, 1.0, 0.9])
            g = rng.uniform(-1e-3, 1e-3) * np.array([1.3, 1.1, 1.0, 0.9])
            rows.append(_coupling_record(y, g))
    path.write_text("\n".join(rows) + "\n")
    return path


def test_aer_coupled_absorber_matches_jax(tmp_path):
    """First-order Rosenkranz line mixing from an AER file; the levels'
    temperatures span the coupling table and beyond it (clamped)."""
    p = write_aer_file(tmp_path / "o2_aer.txt")
    absorber_ref = line_absorber_ref.AERLineAbsorber("O2", p)
    assert absorber_ref.enable_line_coupling
    temps = np.array([180.0, 230.0, 296.0, 320.0, 360.0])

    def jax_side():
        return absorber_ref.cross_section_grid(GRID, PRESSURE, temps)

    ref = torch_support.jax_reference(
        jax_side, (absorber_ref.cat, GRID, PRESSURE, temps))
    absorber = line_absorber.AERLineAbsorber("O2", p, device="cpu",
                                             line_chunk=16)
    assert absorber.enable_line_coupling
    _assert_per_level(absorber.cross_section_grid(GRID, PRESSURE, temps), ref)


def _write_par(path):
    """A fake 160-character HITRAN .par file with quanta and statistical
    weights, plus one short record and one line too short to parse."""

    def record(nu0, s, a, elower, qup, qlo, gp, gpp):
        line = (
            f"{7:2d}{1:1d}{nu0:12.6f}{s:10.3E}{a:10.3E}"
            f"{0.05:5.3f}{0.04:5.3f}{elower:10.4f}{0.70:4.2f}{-0.0051:8.6f}"
        )
        line += f"{qup:>15}{qlo:>15}"
        line += " " * (146 - len(line))
        line += f"{gp:7.1f}{gpp:7.1f}"
        assert len(line) == 160
        return line

    rows = [
        record(13120.0, 1e-25, 0.060, 2.0, "b 0", "X 0", 5.0, 3.0),
        record(13112.0, 2e-25, 0.020, 10.0, "b 0", "X 0", 5.0, 7.0),
        record(13125.0, 1e-24, 0.045, 1400.0, "b 1", "X 1", 7.0, 5.0)[:120],
        "short line",
    ]
    path.write_text("\n".join(rows) + "\n")
    return path


def _assert_catalogues_equal(got, ref):
    for field in dataclasses.fields(ref):
        a, b = getattr(got, field.name), getattr(ref, field.name)
        if b is None or np.ndim(b) == 0:
            assert a == b, field.name
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)


def test_line_file_parsers_equal(tmp_path):
    par = _write_par(tmp_path / "o2.par")
    _assert_catalogues_equal(
        line_absorber.load_hitran_par(par, 0.032),
        line_absorber_ref.load_hitran_par(par, 0.032))
    aer = write_aer_file(tmp_path / "o2_aer.txt")
    _assert_catalogues_equal(
        line_absorber.load_aer_line_file(aer, 0.032),
        line_absorber_ref.load_aer_line_file(aer, 0.032))
    np.testing.assert_array_equal(line_absorber.AER_COUPLING_TEMPS,
                                  line_absorber_ref.AER_COUPLING_TEMPS)
    assert line_absorber.MOLAR_MASS_KG_MOL == \
        line_absorber_ref.MOLAR_MASS_KG_MOL


def test_line_absorber_needs_a_device(monkeypatch):
    """With no GPU, an absorber that names no device raises instead of
    computing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        skt.optical.LineAbsorber(_catalogue(line_absorber))
