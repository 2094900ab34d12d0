"""The inputs of a run, made from its seed: the one generator that every
traffic mix parameterises.

A configuration file fixes the geometry, the solver and how the
atmosphere is drawn; a traffic file fixes the wavelength grid, whether
the calls ask for weighting functions, how each call perturbs the state,
and how many answers the check compares. From the seed come the
absorber's cross section and mixing-ratio profile, the albedo, the
factors of every call and the answers sampled for the check. Every seed
gives the same sizes, so the work of a run does not depend on its seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# U.S. Standard Atmosphere 1976, seven layers to 86 km then isothermal
# (frozen copy of the port's ``climatology/us76.py``)
_G0, _R, _M, _RE = 9.80665, 8.31432, 28.9644e-3, 6356766.0
_LAYERS = [(0.0, -0.0065, 288.15), (11000.0, 0.0, 216.65),
           (20000.0, 0.0010, 216.65), (32000.0, 0.0028, 228.65),
           (47000.0, 0.0, 270.65), (51000.0, -0.0028, 270.65),
           (71000.0, -0.0020, 214.65), (84852.0, 0.0, 186.946)]


def _layer_step(p, h0, lr, t0, h):
    if lr == 0.0:
        return t0 + 0.0 * h, p * np.exp(-_G0 * _M * (h - h0) / (_R * t0))
    t = t0 + lr * (h - h0)
    return t, p * (t / t0) ** (-_G0 * _M / (_R * lr))


def us76(altitude_m):
    """(pressure [Pa], temperature [K]) at geometric altitudes [m]."""
    z = np.asarray(altitude_m, dtype=np.float64)
    h = _RE * z / (_RE + z)
    base = [101325.0]
    for (h0, lr, t0), (h1, _, _) in zip(_LAYERS[:-1], _LAYERS[1:]):
        base.append(float(_layer_step(base[-1], h0, lr, t0, h1)[1]))
    p = np.empty_like(h)
    t = np.empty_like(h)
    for i, (h0, lr, t0) in enumerate(_LAYERS):
        top = _LAYERS[i + 1][0] if i + 1 < len(_LAYERS) else np.inf
        sel = (h >= h0) & (h < top)
        t[sel], p[sel] = _layer_step(base[i], h0, lr, t0, h[sel])
    return p, t


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one named stream of a run's seed."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


def sinusoid_spectrum(gen, wl, log_lo, log_span, terms=8):
    """10 ** (log_lo + log_span s) on ``wl``: s the sum of ``terms``
    sinusoids of random amplitude (falling as 1 / f) and phase, scaled
    onto [0, 1] (after the port's ``scenarios._sinusoid_spectrum``)."""
    x = (wl - wl[0]) / (wl[-1] - wl[0])
    s = sum(gen.normal() / f * np.sin(2.0 * np.pi * f * x + gen.uniform(0.0, 6.3))
            for f in range(1, terms + 1))
    s = (s - s.min()) / (s.max() - s.min())
    return 10.0 ** (log_lo + log_span * s)


def grid(spec) -> np.ndarray:
    return np.linspace(spec["min"], spec["max"], spec["num"])


@dataclass
class State:
    """What both the program and the reference are handed."""

    wavelengths_nm: np.ndarray
    altitudes_m: np.ndarray
    pressure_pa: np.ndarray
    temperature_k: np.ndarray
    xs_table: tuple            # (wavelengths_nm, cross section m^2)
    vmr: np.ndarray            # the base profile
    albedo: float              # the base albedo


def make_state(config, traffic, seed) -> State:
    g = config["geometry"]
    alts = np.linspace(g["altitude_min_m"], g["altitude_max_m"],
                       g["num_altitudes"])
    p, t = us76(alts)
    atmo = config["atmosphere"]
    ab = atmo["absorber"]
    gen = rng(seed, 1)
    xs_wl = grid(ab["cross_section_nm"])
    xs = sinusoid_spectrum(gen, xs_wl, ab["log10_cross_section_min_m2"],
                           ab["log10_cross_section_span"])
    z0 = ab["peak_altitude_m"] + gen.uniform(-1.0, 1.0) * ab["peak_altitude_jitter_m"]
    width = ab["width_m"] * gen.uniform(0.8, 1.2)
    vmr = ab["peak_vmr"] * gen.uniform(0.8, 1.2) * np.exp(-((alts - z0) / width) ** 2)
    vmr = vmr + ab["floor_vmr"]
    sf = atmo["surface"]
    albedo = gen.uniform(sf["albedo_min"], sf["albedo_max"])
    wl = grid(traffic["wavelengths_nm"])
    return State(wl, alts, p, t, (xs_wl, xs), vmr, float(albedo))


def call_inputs(state: State, traffic, seed, i):
    """(vmr profile, albedo) of call ``i``: the base state scaled by the
    call's factors."""
    pert = traffic["perturb"]
    gen = rng(seed, 2, i)
    vmr = state.vmr * gen.uniform(*pert["vmr_scale"])
    albedo = state.albedo * gen.uniform(*pert["albedo_scale"])
    return vmr, float(albedo)


def check_wavelengths(traffic, seed, i, state):
    """The wavelength indices of call ``i`` that the check compares:
    ``wavelengths_per_call`` drawn from the seed, every wavelength of the
    grid alike."""
    W = len(state.wavelengths_nm)
    n = min(traffic["check"]["wavelengths_per_call"], W)
    return np.sort(rng(seed, 3, i).choice(W, size=n, replace=False))


def check_calls(traffic, seed, n_calls):
    """The calls the check compares: the last one and, drawn from the
    seed, up to ``calls`` - 1 others."""
    k = min(traffic["check"]["calls"], n_calls)
    others = rng(seed, 4).permutation(n_calls - 1)[: k - 1]
    return sorted({n_calls - 1, *others.tolist()})


def lanes(state: State, picks):
    """The reference's inputs for ``picks``: a list of (wavelength index,
    vmr profile, albedo), one a lane."""
    n = len(picks)
    A = len(state.altitudes_m)
    return {
        "wavelength_nm": state.wavelengths_nm[[w for w, _, _ in picks]],
        "pressure_pa": np.broadcast_to(state.pressure_pa, (n, A)).copy(),
        "temperature_k": np.broadcast_to(state.temperature_k, (n, A)).copy(),
        "vmr": np.stack([v for _, v, _ in picks]),
        "albedo": np.array([a for _, _, a in picks]),
        "xs_table": state.xs_table,
    }
