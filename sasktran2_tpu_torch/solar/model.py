"""Solar irradiance model.

Role of the reference ``src/sasktran2/solar/model.py:10-110`` (HSRS 2022
extended spectrum with sample / average / integrate modes and solar
distance scaling). The HSRS file is a runtime download in the reference;
this zero-egress build resolves ``source=`` from the local database cache
(``solar/<source>.nc`` or ``.npz`` with ``wavelength`` [nm] and
``irradiance`` [W/m^2/nm] variables). Without a source or user-supplied
spectrum, an analytic blackbody approximation is used (5772 K photosphere
scaled to the 1361 W/m^2 solar constant, ~10-20% accurate in the visible;
worse through the UV Fraunhofer structure).

(Copy of ``sasktran2_tpu/solar/model.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

import numpy as np

from ..constituent.emission import planck_blackbody_radiance

T_SUN = 5772.0
SOLAR_CONSTANT = 1361.0  # W / m^2

HSRS_2022 = "solar_irradiance_hsrs_2022_11_30_extended"


def _load_solar_source(source: str):
    """(wavelength_nm, irradiance) from the local database cache."""
    from ..database import CachedDatabase
    from ..optical.database import _load_dataset

    db = CachedDatabase("solar")
    p = db.path(f"{source}.nc")
    if not p.exists():
        alt = p.with_suffix(".npz")
        if alt.exists():
            p = alt
        else:
            msg = (
                f"Solar spectrum database {p} is not present. This build "
                "has no network access: place the file under "
                f"{db.path()}, or pass wavelengths_nm/irradiance arrays "
                "directly."
            )
            raise FileNotFoundError(msg)
    ds = _load_dataset(db_filepath=p)
    all_vars = dict(ds["data_vars"])
    coords = ds["coords"]

    def pick(*names):
        for n in names:
            if n in all_vars:
                v = all_vars[n][1]
                return np.asarray(v, dtype=np.float64).ravel()
            if n in coords:
                return np.asarray(coords[n], dtype=np.float64).ravel()
        msg = f"Solar database {p} lacks any of {names}"
        raise ValueError(msg)

    wl = pick("wavelength", "wavelength_nm")
    irr = pick("irradiance", "ssi", "irradiance_w_m2_nm")
    order = np.argsort(wl)
    return wl[order], irr[order]


class SolarModel:
    def __init__(self, wavelengths_nm=None, irradiance=None,
                 mode: str = "sample", resolution_nm: float = 0.0,
                 source: str | None = None,
                 resolution_in_wavelength: bool = True):
        """mode: "sample" (point values), "average" (mean over each
        interval), or "integrate" (integral over each interval, W/m^2).

        ``source`` names a cached spectrum file (e.g. ``HSRS_2022``);
        explicit arrays override it. ``resolution_nm`` sets the interval
        width (in nm, or cm^-1 when ``resolution_in_wavelength`` is False);
        0 derives intervals from the wavelength grid midpoints.
        """
        self.mode = mode.lower()
        if self.mode not in ("sample", "average", "integrate"):
            msg = f"Invalid solar model mode {mode!r}"
            raise ValueError(msg)
        self.resolution_nm = resolution_nm
        self.resolution_in_wavelength = resolution_in_wavelength
        if irradiance is not None:
            self._wl = np.asarray(wavelengths_nm, dtype=np.float64)
            self._irr = np.asarray(irradiance, dtype=np.float64)
        elif source is not None:
            self._wl, self._irr = _load_solar_source(source)
        else:
            # match the reference default (HSRS 2022 extended,
            # src/sasktran2/solar/model.py:13) when the cached file is
            # available; otherwise fall back to the documented blackbody
            # approximation with an explicit warning — never silently
            # substitute the blackbody under the HSRS name.
            try:
                self._wl, self._irr = _load_solar_source(HSRS_2022)
            except FileNotFoundError:
                import logging

                logging.getLogger(__name__).warning(
                    "HSRS 2022 solar spectrum not present in the local "
                    "database cache; falling back to the normalized "
                    "5772 K blackbody approximation (~10-20%% accurate "
                    "in the visible, worse in the UV)."
                )
                self._wl = None
                self._irr = None

    def _point(self, wl_nm):
        if self._irr is not None:
            return np.interp(wl_nm, self._wl, self._irr)
        wl_m = np.asarray(wl_nm, dtype=np.float64) * 1e-9
        b = planck_blackbody_radiance(wl_m, T_SUN)
        # irradiance at 1 AU: pi B (Rsun/AU)^2, normalized to the solar
        # constant for consistency
        geo = np.pi * (6.957e8 / 1.495978707e11) ** 2
        e = b * geo  # W / (m^2 m)
        # normalize total to the solar constant
        norm = SOLAR_CONSTANT / (
            5.670374419e-8 * T_SUN**4 * geo / np.pi
        )
        return e * norm * 1e-9  # W / (m^2 nm)

    def _intervals(self, wl):
        if self.resolution_nm > 0:
            if self.resolution_in_wavelength:
                return (wl - self.resolution_nm / 2,
                        wl + self.resolution_nm / 2)
            # resolution in wavenumber [cm^-1]
            left = 1e7 / (1e7 / wl + self.resolution_nm / 2)
            right = 1e7 / (1e7 / wl - self.resolution_nm / 2)
            return left, right
        # grid-midpoint intervals (reference behavior with resolution=None)
        mid = 0.5 * (wl[:-1] + wl[1:])
        left = np.concatenate([[wl[0] - (mid[0] - wl[0])], mid]) if (
            len(wl) > 1
        ) else wl - 0.5
        right = np.concatenate([mid, [wl[-1] + (wl[-1] - mid[-1])]]) if (
            len(wl) > 1
        ) else wl + 0.5
        return left, right

    def irradiance(self, wavelengths_nm, solardistance: float | None = None):
        """Irradiance at the given wavelengths: W/(m^2 nm) for sample /
        average modes, W/m^2 for integrate. ``solardistance`` [AU] scales
        by 1/d^2 (reference model.py solar_distance_factor)."""
        wl = np.atleast_1d(np.asarray(wavelengths_nm, dtype=np.float64))
        factor = 1.0 / solardistance**2 if solardistance is not None else 1.0
        if self.mode == "sample":
            return self._point(wl) * factor
        left, right = self._intervals(wl)
        out = np.empty_like(wl)
        for i in range(len(wl)):
            grid = np.linspace(left[i], right[i], 33)
            vals = self._point(grid)
            integral = np.trapezoid(vals, grid)
            if self.mode == "integrate":
                out[i] = integral
            else:  # average
                out[i] = integral / (right[i] - left[i])
        return out * factor
