"""Emission constituents.

Roles of the reference's ``ThermalEmission`` (Planck from atmosphere
temperature, ``rust/sasktran2-rs/src/constituent/types/thermal_emission.rs``)
and ``VolumeEmissionRate`` (airglow-style isotropic VER,
``.../monochromatic_emission.rs``).

(Numpy copy of ``sasktran2_tpu/constituent/emission.py`` for the PyTorch
port; a test pins it to the original. The one change: the line-list
emission's Doppler-broadened spectra, a sum over lines of a
[levels, lines, wavelengths] block, are computed with torch on a device
(``device=``, None: the GPU), in float64 as the reference computes them.)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..util.interpolation import linear_interpolating_matrix
from .base import Constituent

H_PLANCK = 6.62607015e-34
C_LIGHT = 299792458.0
K_BOLTZMANN = 1.380649e-23


def planck_blackbody_radiance(wavelength_m, temperature_k):
    """Planck spectral radiance B_lambda [W / (m^2 sr m)]."""
    wl = np.asarray(wavelength_m, dtype=np.float64)
    t = np.asarray(temperature_k, dtype=np.float64)
    c1 = 2.0 * H_PLANCK * C_LIGHT**2
    c2 = H_PLANCK * C_LIGHT / K_BOLTZMANN
    return c1 / wl**5 / np.expm1(c2 / (wl * t))


class ThermalEmission(Constituent):
    """Planck thermal emission source from the atmosphere temperature
    profile. Fills ``storage.emission_source`` in radiance units."""

    def add_to_atmosphere(self, atmo):
        if atmo.temperature_k is None:
            msg = "ThermalEmission requires atmosphere.temperature_k"
            raise ValueError(msg)
        wl_m = atmo.wavelengths_nm * 1e-9
        atmo.storage.emission_source += planck_blackbody_radiance(
            wl_m[None, :], np.asarray(atmo.temperature_k)[:, None]
        )

    def register_derivative(self, atmo, name: str):
        # dB/dT for the temperature weighting function
        wl_m = atmo.wavelengths_nm * 1e-9
        t = np.asarray(atmo.temperature_k)[:, None]
        c2 = H_PLANCK * C_LIGHT / K_BOLTZMANN
        b = planck_blackbody_radiance(wl_m[None, :], t)
        x = c2 / (wl_m[None, :] * t)
        dbdt = b * x / t * np.exp(x) / np.expm1(x)
        m = atmo.storage.get_derivative_mapping(f"wf_{name}_temperature_k")
        m.d_emission[:] = dbdt
        m.interp_dim = "altitude"


class SurfaceThermalEmission(Constituent):
    """Planck surface emission at a given surface temperature with
    emissivity (reference ``surface emission`` handling)."""

    def __init__(self, temperature_k: float, emissivity=1.0):
        self.temperature_k = float(temperature_k)
        self.emissivity = emissivity

    def add_to_atmosphere(self, atmo):
        wl_m = atmo.wavelengths_nm * 1e-9
        atmo.surface.emission += self.emissivity * planck_blackbody_radiance(
            wl_m, self.temperature_k
        )

    def register_derivative(self, atmo, name: str):
        pass


class VolumeEmissionRate(Constituent):
    """Monochromatic isotropic volume emission rate (airglow), specified on
    its own altitude grid in [photons / (m^3 s)] or radiance-rate units;
    emission source = VER / (4 pi)."""

    def __init__(self, altitudes_m, ver, wavelength_nm=None):
        self._altitudes = np.asarray(altitudes_m, dtype=np.float64)
        self.ver = np.asarray(ver, dtype=np.float64)
        self.wavelength_nm = wavelength_nm

    def add_to_atmosphere(self, atmo):
        interp = linear_interpolating_matrix(
            self._altitudes, atmo.model_geometry.altitudes(), "extend"
        )
        prof = interp @ self.ver / (4.0 * np.pi)
        if self.wavelength_nm is None:
            atmo.storage.emission_source += prof[:, None]
        else:
            widx = int(np.argmin(np.abs(atmo.wavelengths_nm
                                        - self.wavelength_nm)))
            atmo.storage.emission_source[:, widx] += prof

    def register_derivative(self, atmo, name: str):
        interp = linear_interpolating_matrix(
            self._altitudes, atmo.model_geometry.altitudes(), "extend"
        )
        m = atmo.storage.get_derivative_mapping(f"wf_{name}")
        m.d_emission[:] = 1.0 / (4.0 * np.pi)
        m.interpolator = interp.T
        m.interp_dim = f"{name}_altitude"


O2_MOLAR_MASS_KG_MOL = 31.9988e-3


class LineListVolumeEmissionRate(Constituent):
    """Spectrally resolved line-list volume emission rate.

    A total photon VER profile [photons m^-3 s^-1] is distributed over
    discrete emission lines and each line is Doppler-broadened with the
    atmosphere temperature (O2 molecular mass, matching the reference's
    A-band use case) onto the atmosphere wavelength grid. The emitted
    source is isotropic: emission_source += spectrum / 4pi, in per-nm
    spectral density. Role of the reference's
    ``rust/sasktran2-rs/src/constituent/types/
    line_list_volume_emission_rate.rs``.

    Parameters
    ----------
    altitudes_m : [A] grid of the VER profile
    photon_ver : [A] total photon VER
    wavelengths_nm : [L] line centers
    weights : [L] or [A, L] relative line weights (normalized per row)
    device : where the broadened spectra are computed (None: the GPU)
    """

    # elements of one [levels, lines, wavelengths] float64 block (64 MiB)
    max_block_elements = 2**23

    def __init__(self, altitudes_m, photon_ver, wavelengths_nm, weights,
                 molar_mass_kg_mol=O2_MOLAR_MASS_KG_MOL,
                 out_of_bounds_mode="zero", device=None):
        self._altitudes = np.atleast_1d(
            np.asarray(altitudes_m, dtype=np.float64)
        )
        self.photon_ver = np.atleast_1d(
            np.asarray(photon_ver, dtype=np.float64)
        )
        self.wavelengths_nm = np.atleast_1d(
            np.asarray(wavelengths_nm, dtype=np.float64)
        )
        w = np.asarray(weights, dtype=np.float64)
        if w.ndim == 1:
            w = np.broadcast_to(w, (self._altitudes.size, w.size)).copy()
        self.molar_mass = float(molar_mass_kg_mol)
        self._oob = out_of_bounds_mode
        self.device = resolve_device(device)

        if self._altitudes.size != self.photon_ver.size:
            msg = "altitudes_m and photon_ver must have the same length"
            raise ValueError(msg)
        if w.shape != (self._altitudes.size, self.wavelengths_nm.size):
            msg = "weights must be [len(altitudes), len(wavelengths)]"
            raise ValueError(msg)
        if self.wavelengths_nm.size == 0:
            msg = "Line-list emission requires at least one line"
            raise ValueError(msg)
        if np.any(~np.isfinite(self.wavelengths_nm)
                  | (self.wavelengths_nm <= 0)):
            msg = "Line wavelengths must be positive finite values"
            raise ValueError(msg)
        rowsum = w.sum(axis=1)
        if np.any(rowsum <= 0) or not np.all(np.isfinite(w)) or np.any(w < 0):
            msg = "Line weights must be non-negative with positive row sums"
            raise ValueError(msg)
        self.weights = w / rowsum[:, None]

    def _broadened_spectra(self, atmo, line_areas):
        """Doppler-broadened per-nm spectra [A_model, W] (numpy) from line
        areas [A_model, L] using the atmosphere temperature profile,
        summed over the lines on the device in blocks of levels."""
        from ..optical.lineshape import doppler_width

        if atmo.temperature_k is None:
            msg = "Line-list emission requires atmosphere.temperature_k"
            raise ValueError(msg)

        def dev(a):
            return torch.as_tensor(
                np.asarray(a, dtype=np.float64), device=self.device
            )

        # the wavenumbers on the host: torch divides a number by a tensor
        # through its reciprocal, which is not rounded as numpy's division,
        # and the line shape is a difference of nearby wavenumbers
        wavel = np.asarray(atmo.wavelengths_nm, dtype=np.float64)
        t = dev(atmo.temperature_k)                       # [A_model]
        nu_grid = dev(1.0e7 / wavel)                      # [W]
        nu_line = dev(1.0e7 / self.wavelengths_nm)        # [L]
        areas = dev(line_areas)                           # [A_model, L]
        step = max(1, self.max_block_elements
                   // (nu_line.numel() * nu_grid.numel()))
        blocks = []
        for i in range(0, t.numel(), step):
            # alpha_d [levels, L]
            alpha = doppler_width(
                nu_line[None, :], t[i:i + step, None], self.molar_mass
            )[:, :, None]
            x = (nu_grid[None, None, :] - nu_line[None, :, None]) / alpha
            gauss = torch.exp(-x * x) / (math.sqrt(math.pi) * alpha)
            blocks.append((areas[i:i + step, :, None] * gauss).sum(dim=1))
        # per-cm^-1 -> per-nm density
        spectra = torch.cat(blocks) * dev(1.0e7 / wavel**2)
        return spectra.cpu().numpy()

    def add_to_atmosphere(self, atmo):
        interp = linear_interpolating_matrix(
            self._altitudes, atmo.model_geometry.altitudes(), self._oob
        )
        line_ver = interp @ (self.weights * self.photon_ver[:, None])
        atmo.storage.emission_source += self._broadened_spectra(
            atmo, line_ver
        ) / (4.0 * np.pi)

    def _weights_on_model_grid(self, atmo):
        model_alts = atmo.model_geometry.altitudes()
        first = self.weights[0]
        if np.allclose(self.weights, first[None, :], atol=1e-14):
            return (
                np.broadcast_to(
                    first, (len(model_alts), first.size)
                ).copy(),
                linear_interpolating_matrix(
                    self._altitudes, model_alts, self._oob
                ),
            )
        if self._altitudes.size != len(model_alts) or not np.allclose(
            self._altitudes, model_alts, atol=1e-9
        ):
            msg = (
                "Altitude-dependent line weights require the emission "
                "altitude grid to match the model altitude grid"
            )
            raise ValueError(msg)
        return self.weights, np.eye(self._altitudes.size)

    def register_derivative(self, atmo, name: str):
        weights, interp = self._weights_on_model_grid(atmo)
        m = atmo.storage.get_derivative_mapping(f"wf_{name}_photon_ver")
        m.d_emission[:] += self._broadened_spectra(atmo, weights) / (
            4.0 * np.pi
        )
        m.interpolator = interp.T
        m.interp_dim = f"{name}_altitude"


class PopulationEmissionRate(Constituent):
    """Photochemical population-to-emission constituent: converts excited
    O2(b, v=0/1/2) populations (e.g. from
    :class:`~..photchem.models.Yankovsky`) into Doppler-broadened A-band
    and B-band line-list emission. Role of the reference's
    ``rust/sasktran2-rs/src/constituent/types/population_emission_rate.rs``.

    Parameters
    ----------
    populations : dict with ``altitude`` [m], ``temperature`` [K], and
        state number densities [m^-3] keyed by name (``O2(b)`` required;
        ``O2(b, v=1)``, ``O2(b, v=2)`` optional); an xarray Dataset with
        those variables also works.
    catalogue : a LineCatalogue of the O2 band region (a full 160-column
        HITRAN .par load so g' and quanta are available).
    species : only ``("O2",)`` is supported.
    line_weight_model : ``einstein_a_branching`` | ``hitran_line_strength``.
    device : where the line lists' spectra are computed (None: the GPU)
    """

    def __init__(self, populations, catalogue=None, species=("O2",),
                 line_weight_model="einstein_a_branching", db=None,
                 device=None):
        from ..photchem import emission as phem

        if catalogue is None:
            # reference parity: default to the cached HITRAN O2 line file
            if db is None:
                from ..database.hitran_line import HITRANLineDatabase

                db = HITRANLineDatabase()
            catalogue = db.load_catalogue("O2")
        if isinstance(species, str):
            species = [species]
        for s in species:
            if s.lower() != "o2":
                msg = f"Unsupported population emission species {s!r}"
                raise ValueError(msg)

        def get(name):
            try:
                v = populations[name]
            except (KeyError, IndexError):
                return None
            return np.asarray(getattr(v, "values", v), dtype=np.float64)

        alts = get("altitude")
        temp = get("temperature")
        if alts is None or temp is None:
            msg = "populations must contain 'altitude' and 'temperature'"
            raise ValueError(msg)
        o2_b0 = get("O2(b)")
        if o2_b0 is None:
            msg = "populations must contain the 'O2(b)' state"
            raise ValueError(msg)
        o2_b1, o2_b2 = get("O2(b, v=1)"), get("O2(b, v=2)")

        self.line_lists = []
        a_band = phem.oxygen_a_band_from_catalogue(catalogue)
        ver, w = phem.oxygen_a_band_line_list_weights_from_populations(
            a_band, temp, o2_b0, o2_b1, o2_b2, line_weight_model
        )
        self.line_lists.append(LineListVolumeEmissionRate(
            alts, ver, a_band.wavelength_nm, w, device=device
        ))
        try:
            b_band = phem.oxygen_b_band_from_catalogue(catalogue)
        except ValueError:
            b_band = None  # catalogue has no B-band lines
        if b_band is not None:
            ver, w = phem.oxygen_b_band_line_list_weights_from_populations(
                b_band, temp, o2_b1, line_weight_model
            )
            self.line_lists.append(LineListVolumeEmissionRate(
                alts, ver, b_band.wavelength_nm, w, device=device
            ))

    @property
    def num_line_list_emissions(self):
        return len(self.line_lists)

    def line_list_photon_ver(self, index=0):
        return self.line_lists[index].photon_ver

    def line_list_wavelengths_nm(self, index=0):
        return self.line_lists[index].wavelengths_nm

    def line_list_weights(self, index=0):
        return self.line_lists[index].weights

    def add_to_atmosphere(self, atmo):
        for ll in self.line_lists:
            ll.add_to_atmosphere(atmo)

    def register_derivative(self, atmo, name: str):
        # matches the reference: population emissions register no WFs
        pass
