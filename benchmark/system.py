"""The system under test: ``sasktran2_tpu_torch``, built from a
configuration file and a run's state through its public API.

Nothing here reaches into the port beyond what a user writes; the
tracing of a traced run (``trace.py``) wraps its methods from outside.
"""

from __future__ import annotations

import numpy as np


def build_engine(sk, config, device):
    """(Engine, Config, Geometry1D) of the configuration, on ``device``."""
    g = config["geometry"]
    s = config["solver"]
    kw = {}
    if "num_do_sza" in s:
        kw["num_do_sza"] = s["num_do_sza"]
    cfg = sk.Config(
        num_streams=s["num_streams"],
        num_stokes=s["num_stokes"],
        multiple_scatter_source=getattr(sk.MultipleScatterSource,
                                        s["multiple_scatter_source"]),
        single_scatter_source=getattr(sk.SingleScatterSource,
                                      s["single_scatter_source"]),
        num_singlescatter_moments=s["num_singlescatter_moments"],
        dtype=s["dtype"],
        **kw,
    )
    geometry = sk.Geometry1D(
        cos_sza=g["cos_sza"],
        solar_azimuth=g["solar_azimuth"],
        earth_radius_m=g["earth_radius_m"],
        altitude_grid_m=np.linspace(g["altitude_min_m"], g["altitude_max_m"],
                                    g["num_altitudes"]),
        geometry_type=getattr(sk.GeometryType, g["geometry_type"]),
    )
    viewing = sk.ViewingGeometry()
    for r in config["rays"]:
        if r["kind"] == "GroundViewingSolar":
            viewing.add_ray(sk.GroundViewingSolar(
                cos_sza=r["cos_sza"], relative_azimuth=r["relative_azimuth"],
                cos_viewing_zenith=r["cos_viewing_zenith"],
                observer_altitude_m=r["observer_altitude_m"]))
        elif r["kind"] == "TangentAltitudeSolar":
            viewing.add_ray(sk.TangentAltitudeSolar(
                tangent_altitude_m=r["tangent_altitude_m"],
                relative_azimuth=r["relative_azimuth"],
                observer_altitude_m=r["observer_altitude_m"],
                cos_sza=r["cos_sza"]))
        else:
            msg = f"unknown ray kind {r['kind']!r}"
            raise ValueError(msg)
    return sk.Engine(cfg, geometry, viewing, device=device), cfg, geometry


def build_atmosphere(sk, cfg, geometry, state, jacobians):
    """US76 + Rayleigh + the seeded absorber + a Lambertian surface."""
    atmo = sk.Atmosphere(geometry, cfg, wavelengths_nm=state.wavelengths_nm,
                         calculate_derivatives=jacobians)
    atmo.pressure_pa = state.pressure_pa.copy()
    atmo.temperature_k = state.temperature_k.copy()
    atmo["rayleigh"] = sk.constituent.Rayleigh()
    atmo["absorber"] = sk.constituent.VMRAltitudeAbsorber(
        sk.optical.TabulatedCrossSectionAbsorber(*state.xs_table),
        state.altitudes_m, state.vmr.copy())
    atmo["surface"] = sk.constituent.LambertianSurface(state.albedo)
    return atmo


def set_call_inputs(atmo, vmr, albedo):
    atmo["absorber"].vmr = np.asarray(vmr, dtype=np.float64)
    atmo["surface"].albedo = np.atleast_1d(np.float64(albedo))


def pick(out, idx):
    """The outputs of one call at wavelength indices ``idx``: radiance
    [k, R] and each ``wf_*`` ([A, k, R] or [k, R]), numpy."""
    got = {}
    for name in out.keys():
        if name != "radiance" and not name.startswith("wf_"):
            continue
        arr = out[name].to_numpy()
        ax = out[name].dims.index("wavelength")
        got[name] = np.take(arr, idx, axis=ax)[..., 0].copy()
    return got
