"""Zawada et al. (2021) limb vector intercomparison harness.

Counterpart of ``sasktran2_tpu/test_util/zawada.py`` for the PyTorch port.
Runs the scenario suite of

    Zawada, D. et al.: Systematic comparison of vectorial spherical
    radiative transfer models in limb scattering geometry, Atmos. Meas.
    Tech. 14, 3953-3972, 2021, doi:10.5194/amt-14-3953-2021

through the port's public API against the published model data (the
upstream ``docs/performance_book/source/external_validation/
limb_vector_zawada_2021.ipynb`` analog). The input file
``zawada_AMT_rtm_comparison_data_v1.nc`` (zenodo record 4292303) is read
from ``<database_root>/validation/`` (or the root itself) under the
port's own root (``SASKTRAN2_TPU_TORCH_DB_ROOT``); ``download_zenodo_record``
fetches it there. ``h5py`` is imported only when the file is read.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def comparison_file() -> Path | None:
    """The zenodo intercomparison file if present locally, else None."""
    from ..database import database_root

    for cand in (
        database_root() / "validation" / "zawada_AMT_rtm_comparison_data_v1.nc",
        database_root() / "zawada_AMT_rtm_comparison_data_v1.nc",
    ):
        if cand.exists():
            return cand
    return None


def _read_group(path, group):
    """{name: array} + attribute-free coords from one HDF5 group."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        g = f[group]
        for k in g:
            out[k] = np.asarray(g[k])
    return out


def load_scenario(
    geometry_index: int,
    atmosphere_index: int,
    albedo_index: int,
    test_case: int,
    altitude_spacing: float = 500.0,
):
    """One intercomparison scenario -> dict with engine inputs and the
    published per-model radiances (mirrors the reference notebook's
    ``load_scenario``).

    atmosphere_index: 0 = Rayleigh, 1 = +ozone, 2 = +aerosol.
    test_case: 0 = single scatter, 1 = multiple scatter, 2 = +refraction.
    """
    import sasktran2_tpu_torch as sk

    path = comparison_file()
    if path is None:
        msg = ("zawada comparison file not present under the port's "
               "database root")
        raise FileNotFoundError(msg)

    geo = _read_group(path, "geometry_data")
    anc = _read_group(path, "ancillary_data")
    model = _read_group(path, "model_data")

    albedo = float(np.asarray(model["albedo"]).ravel()[albedo_index])

    tangent_sza = float(geo["tangent_sza"][geometry_index])
    tangent_saa = float(geo["tangent_saa"][geometry_index])
    tangent_alts_km = np.asarray(geo["tangent_altitude"])
    if tangent_alts_km.ndim > 1:
        tangent_alts_km = tangent_alts_km[geometry_index]

    alts = np.arange(0.0, 100001.0, altitude_spacing)

    def interp_anc(name):
        src_alt = np.asarray(anc["altitude"], dtype=np.float64)
        return np.interp(alts, src_alt, np.asarray(anc[name],
                                                   dtype=np.float64))

    config = sk.Config(num_stokes=3)
    geometry = sk.Geometry1D(
        cos_sza=float(np.cos(np.deg2rad(tangent_sza))),
        solar_azimuth=0.0,
        earth_radius_m=6371000.0,
        altitude_grid_m=alts,
        geometry_type=sk.GeometryType.Spherical,
    )
    viewing = sk.ViewingGeometry()
    for alt_km in tangent_alts_km:
        viewing.add_ray(sk.TangentAltitudeSolar(
            float(alt_km) * 1000.0,
            float(np.deg2rad(tangent_saa)),
            200000.0,
            float(np.cos(np.deg2rad(tangent_sza))),
        ))

    wavelengths_nm = np.asarray(anc["wavelength"], dtype=np.float64)
    atmo = sk.Atmosphere(
        geometry, config, wavelengths_nm=wavelengths_nm,
        calculate_derivatives=False,
    )
    atmo.pressure_pa = interp_anc("pressure")
    atmo.temperature_k = interp_anc("temperature")

    from ..optical.refraction import ciddor_index_of_refraction

    geometry.refractive_index = ciddor_index_of_refraction(
        atmo.temperature_k, atmo.pressure_pa, 0.0, 400.0, 600.0
    )

    atmo["brdf"] = sk.constituent.LambertianSurface(albedo)
    atmo["rayleigh"] = sk.constituent.Rayleigh(
        "manual",
        wavelengths_nm=wavelengths_nm,
        xs=np.asarray(anc["rayleigh_scattering_cross_section"]) * 1e-4,
        king_factor=np.ones_like(wavelengths_nm),
    )

    if atmosphere_index >= 1:
        from ..optical.database import OpticalDatabaseGenericAbsorber

        db = {
            "coords": {"wavelength_nm": wavelengths_nm},
            "data_vars": {
                "xs": (
                    ("wavelength_nm",),
                    np.asarray(anc["ozone_absorption_cross_section"])
                    * 1e-4,
                ),
            },
        }
        optical = OpticalDatabaseGenericAbsorber(db=db)
        vmr = interp_anc("ozone_numden") / interp_anc("air_numden")
        atmo["ozone"] = sk.constituent.VMRAltitudeAbsorber(
            optical, alts, vmr
        )

    if atmosphere_index == 2:
        from ..database.mie import MieDatabase
        from ..mie.distribution import LogNormalDistribution
        from ..mie.refractive import H2SO4

        dist = LogNormalDistribution().freeze(
            median_radius=80.0, mode_width=1.6
        )
        aerosol_optical = MieDatabase(
            dist, H2SO4(), wavelengths_nm=wavelengths_nm
        )
        atmo["aerosol"] = sk.constituent.NumberDensityScatterer(
            aerosol_optical, alts, interp_anc("aerosol_numden") * 1e6
        )

    if test_case == 0:
        config.single_scatter_source = sk.SingleScatterSource.Exact
        config.multiple_scatter_source = sk.MultipleScatterSource.NoSource
    else:
        config.single_scatter_source = sk.SingleScatterSource.Exact
        config.multiple_scatter_source = (
            sk.MultipleScatterSource.SuccessiveOrders
        )
        config.num_successive_orders_iterations = 50
        config.num_successive_orders_sza = 3
    if test_case == 2:
        config.los_refraction = True

    return {
        "config": config,
        "geometry": geometry,
        "viewing": viewing,
        "atmosphere": atmo,
        "model_data": model,
        "geometry_index": geometry_index,
    }


def percent_difference_vs_models(radiance, scenario, test_case):
    """Per-stokes percent difference of the engine radiance vs the
    published multi-model median ('mmm' when stored, else the per-model
    radiances), normalized by the I component as in the paper."""
    model = scenario["model_data"]
    key = "mmm" if "mmm" in model else "radiance"
    ref = np.asarray(model[key], dtype=np.float64)
    # stored layout: [..., wavelength, altitude, stokes]; slice this
    # scenario's solar/test-case axes upstream when present
    ref = ref[..., :3]
    rad = np.asarray(radiance)[..., :3]
    denom = ref[..., 0:1]
    return 100.0 * (rad - ref) / np.where(denom != 0, denom, 1.0)
