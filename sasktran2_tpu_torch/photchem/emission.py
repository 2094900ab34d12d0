"""Airglow emission models: transitions, band structure from HITRAN lines,
and the McDade empirical oxygen green-line model.

Role of the reference's ``rust/sasktran2-rs/src/photchem/emission.rs``:
convert excited-state populations into photon volume emission rates (VER)
and distribute band VER over individual rotational lines so the engine's
line-list emission constituent can place them on the spectral grid.

(Copy of ``sasktran2_tpu/photchem/emission.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

OXYGEN_GREEN_LINE_WAVELENGTH_NM = 557.7
OXYGEN_GREEN_LINE_EINSTEIN_A_S = 1.26
MCDADE_OXYGEN_GREEN_LINE_EINSTEIN_A_558_S = 1.18
MCDADE_OXYGEN_GREEN_LINE_EINSTEIN_A_1S_S = 1.35
MCDADE_OXYGEN_GREEN_LINE_C0 = 0.0
MCDADE_OXYGEN_GREEN_LINE_C1 = 211.0
MCDADE_OXYGEN_GREEN_LINE_C2 = 15.0
O2_A_BAND_CENTER_WAVELENGTH_NM = 762.0
O2_A_BAND_TOTAL_EINSTEIN_A_S = 7.58e-2
O2_B0_X0_EINSTEIN_A_S = 7.58e-2
O2_B1_X0_EINSTEIN_A_S = 7.0e-2
O2_B1_X1_EINSTEIN_A_S = 7.0e-2
O2_B2_X2_EINSTEIN_A_S = 5.4e-2
O2_A_BAND_MIN_WAVELENGTH_NM = 759.0
O2_A_BAND_MAX_WAVELENGTH_NM = 776.0
O2_B_BAND_MIN_WAVELENGTH_NM = 675.0
O2_B_BAND_MAX_WAVELENGTH_NM = 705.0

C2_CM_K = 1.4387768775039339  # h c / k_B [cm K]


@dataclass(frozen=True)
class EmissionTransition:
    """A single emission line: VER = A * upper-state population."""

    name: str
    upper_state: str
    lower_state: str
    wavelength_nm: float
    einstein_a_s: float

    def __post_init__(self):
        if not np.isfinite(self.wavelength_nm) or self.wavelength_nm <= 0:
            msg = f"Bad emission wavelength {self.wavelength_nm}"
            raise ValueError(msg)
        if not np.isfinite(self.einstein_a_s) or self.einstein_a_s < 0:
            msg = f"Bad Einstein-A {self.einstein_a_s}"
            raise ValueError(msg)

    def photon_ver(self, upper_population):
        """Photon VER [photons m^-3 s^-1] from population [m^-3]."""
        return np.asarray(upper_population, dtype=np.float64) * (
            self.einstein_a_s
        )


def oxygen_green_line_transition() -> EmissionTransition:
    return EmissionTransition(
        "oxygen_green_5577", "O(1S)", "O(1D)",
        OXYGEN_GREEN_LINE_WAVELENGTH_NM, OXYGEN_GREEN_LINE_EINSTEIN_A_S,
    )


def mcdade_oxygen_green_line_photon_ver(
    temperature_k, atomic_oxygen_density_m3, o2_density_m3, n2_density_m3
):
    """McDade et al. (1986) empirical green-line (557.7 nm) photon VER
    [photons m^-3 s^-1] from O/O2/N2 densities [m^-3] — the two-step
    Barth mechanism with empirically fitted quenching coefficients."""
    t = np.asarray(temperature_k, dtype=np.float64)
    o = np.asarray(atomic_oxygen_density_m3, dtype=np.float64)
    o2 = np.asarray(o2_density_m3, dtype=np.float64)
    n2 = np.asarray(n2_density_m3, dtype=np.float64)
    if not (t.shape == o.shape == o2.shape == n2.shape):
        msg = "Temperature, O, O2, and N2 profiles must share a shape"
        raise ValueError(msg)
    if np.any(~np.isfinite(t)) or np.any(t <= 0):
        msg = "Temperature must be positive and finite"
        raise ValueError(msg)
    for name, v in (("O", o), ("O2", o2), ("N2", n2)):
        if np.any(~np.isfinite(v)) or np.any(v < 0):
            msg = f"{name} density must be non-negative and finite"
            raise ValueError(msg)

    o_cm3 = o / 1.0e6
    o2_cm3 = o2 / 1.0e6
    n2_cm3 = n2 / 1.0e6

    denom = (
        MCDADE_OXYGEN_GREEN_LINE_C0
        + MCDADE_OXYGEN_GREEN_LINE_C1 * o_cm3
        + MCDADE_OXYGEN_GREEN_LINE_C2 * o2_cm3
    )
    k1 = 4.7e-33 * (300.0 / t) ** 2                      # cm^6/s
    three_k5 = 4.0e-12 * np.exp(-865.0 / t)              # cm^3/s
    branch = MCDADE_OXYGEN_GREEN_LINE_EINSTEIN_A_558_S / (
        MCDADE_OXYGEN_GREEN_LINE_EINSTEIN_A_1S_S + three_k5 * o2_cm3
    )
    safe = (o_cm3 > 0) & (denom > 0)
    ver_cm3 = np.where(
        safe,
        k1 * o_cm3**2 * (n2_cm3 + o2_cm3) * o_cm3
        / np.where(safe, denom, 1.0) * branch,
        0.0,
    )
    return ver_cm3 * 1.0e6


def mcdade_oxygen_green_line_o1s_population(
    temperature_k, atomic_oxygen_density_m3, o2_density_m3, n2_density_m3
):
    """Implied steady-state O(1S) population [m^-3]."""
    return mcdade_oxygen_green_line_photon_ver(
        temperature_k, atomic_oxygen_density_m3, o2_density_m3,
        n2_density_m3,
    ) / MCDADE_OXYGEN_GREEN_LINE_EINSTEIN_A_558_S


def photon_ver_from_state_profile(state_profiles, state_name, einstein_a_s):
    """VER profile = A * population profile, from a solved-state dict."""
    if state_name not in state_profiles:
        msg = f"Population state {state_name!r} is not available"
        raise KeyError(msg)
    return np.asarray(state_profiles[state_name], dtype=np.float64) * (
        einstein_a_s
    )


# ---------------------------------------------------------------------------
# Band emission from HITRAN line catalogues


#: HITRAN O2 isotopologue natural abundances (reference emission.rs
#: ``o2_hitran_isotope_abundance``)
O2_ISOTOPE_ABUNDANCE = {1: 0.9952616, 2: 0.00399141, 3: 0.0007422352}


@dataclass
class EmissionBand:
    """A vibrational emission band resolved into rotational lines.

    ``weights`` (normalized to 1) distribute the band VER over lines;
    two weighting models mirror the reference
    (``AEmissionLineWeightModel``):

    - *static* (``weights``): relative A-coefficients x isotope
      abundance, temperature-independent (reference emission.rs
      ``relative_weight = einstein_a * abundance``).
    - *einstein_a_branching* (:meth:`lte_weights`): LTE Boltzmann upper
      populations ``abundance * g' * exp(-c2 E'/T)`` times the upper-level
      branching ratio ``A_line / sum_A(same upper level)`` (reference
      ``oxygen_a_band_einstein_branching_line_weights``).
    """

    name: str
    upper_state: str
    lower_state: str
    total_einstein_a_s: float
    wavelength_nm: np.ndarray        # [nlines]
    einstein_a_line_s: np.ndarray    # [nlines]
    upper_energy_cminv: np.ndarray   # [nlines]
    weights: np.ndarray              # [nlines], sums to 1
    g_upper: np.ndarray | None = None          # [nlines] statistical weight
    iso_abundance: np.ndarray | None = None    # [nlines]
    upper_branching: np.ndarray | None = None  # [nlines] A/sum_A(level)
    lower_energy_cminv: np.ndarray | None = None   # [nlines]
    line_intensity: np.ndarray | None = None       # [nlines] S(296 K)
    upper_vib_state: np.ndarray | None = None      # [nlines] state labels

    @staticmethod
    def from_catalogue(
        name, upper_state, lower_state, total_einstein_a_s, catalogue,
        min_wavelength_nm, max_wavelength_nm,
        isotope_abundances=None, line_mask=None,
    ) -> "EmissionBand":
        """Build a band from a :class:`~..optical.line_absorber.
        LineCatalogue` by selecting lines inside a wavelength window.
        Requires the catalogue to carry Einstein-A coefficients
        (``load_hitran_par`` parses them, plus g' and isotopologue ids).

        ``isotope_abundances`` maps HITRAN isotopologue number to natural
        abundance (defaults to the O2 table)."""
        if min_wavelength_nm >= max_wavelength_nm:
            msg = "Invalid band wavelength range"
            raise ValueError(msg)
        a = getattr(catalogue, "einstein_a", None)
        if a is None:
            msg = "Line catalogue has no Einstein-A coefficients"
            raise ValueError(msg)
        wl = 1.0e7 / np.asarray(catalogue.nu0)
        keep = (
            (wl >= min_wavelength_nm)
            & (wl <= max_wavelength_nm)
            & np.isfinite(a)
            & (a > 0)
        )
        if line_mask is not None:
            keep = keep & np.asarray(line_mask, dtype=bool)
        if not np.any(keep):
            msg = (
                f"No lines with Einstein-A in [{min_wavelength_nm}, "
                f"{max_wavelength_nm}] nm"
            )
            raise ValueError(msg)
        order = np.argsort(wl[keep])
        wl_k = wl[keep][order]
        a_k = np.asarray(a)[keep][order]
        eup = (
            np.asarray(catalogue.elower)[keep][order]
            + np.asarray(catalogue.nu0)[keep][order]
        )

        abund_table = (
            O2_ISOTOPE_ABUNDANCE if isotope_abundances is None
            else isotope_abundances
        )
        iso = getattr(catalogue, "iso_id", None)
        if iso is not None:
            iso_k = np.asarray(iso)[keep][order]
            abund = np.array(
                [abund_table.get(int(i), 0.0) for i in iso_k]
            )
        else:
            iso_k = np.ones(wl_k.size, dtype=np.int64)
            abund = np.ones(wl_k.size)

        gp = getattr(catalogue, "g_upper", None)
        gp_k = None
        if gp is not None:
            gp_k = np.asarray(gp)[keep][order]
            if not np.any(np.isfinite(gp_k) & (gp_k > 0)):
                gp_k = None

        # Branching ratio: group lines sharing the same upper level —
        # identified physically by (isotopologue, upper energy) since a
        # level's E' = E'' + nu0 is identical for its P/R/Q branches
        # (reference groups by parsed upper quanta; energy matching avoids
        # a quanta parser and is exact to catalogue precision).
        branching = np.ones(wl_k.size)
        level_key = np.stack([iso_k.astype(np.float64),
                              np.round(eup, 2)], axis=1)
        _, level_idx = np.unique(level_key, axis=0, return_inverse=True)
        sums = np.zeros(level_idx.max() + 1)
        np.add.at(sums, level_idx, a_k)
        branching = a_k / sums[level_idx]

        w = a_k * abund
        if w.sum() <= 0:
            msg = "Emission band line weights sum to zero"
            raise ValueError(msg)
        w = w / w.sum()

        # per-line upper vibrational-state labels from the global quanta
        # (reference emission.rs o2_vibrational_state_name); without quanta
        # the whole band is one state group named after the band.
        qup = getattr(catalogue, "quanta_upper", None)
        if qup is not None:
            labels = np.array(
                [o2_vibrational_state_name(q) or upper_state
                 for q in np.asarray(qup)[keep][order]],
                dtype=object,
            )
        else:
            labels = np.array([upper_state] * wl_k.size, dtype=object)

        intensity = np.asarray(catalogue.intensity)[keep][order]
        elo = np.asarray(catalogue.elower)[keep][order]

        return EmissionBand(
            name, upper_state, lower_state, float(total_einstein_a_s),
            wl_k, a_k, eup, w,
            g_upper=gp_k, iso_abundance=abund, upper_branching=branching,
            lower_energy_cminv=elo, line_intensity=intensity,
            upper_vib_state=labels,
        )

    def lte_weights(self, temperature_k: float) -> np.ndarray:
        """Boltzmann line weights at one temperature (LTE within the
        upper vibrational state): ``abundance * g' * exp(-c2 E'/T) *
        branching``, normalized (reference emission.rs
        ``oxygen_a_band_einstein_branching_line_weights``). Requires the
        catalogue to have carried upper statistical weights g'."""
        if self.g_upper is None:
            msg = (
                "LTE line weights need upper statistical weights g' — "
                "load the catalogue from a full 160-column HITRAN .par "
                "record (columns 146:153)"
            )
            raise ValueError(msg)
        abund = (
            self.iso_abundance if self.iso_abundance is not None
            else np.ones_like(self.einstein_a_line_s)
        )
        branch = (
            self.upper_branching if self.upper_branching is not None
            else np.ones_like(self.einstein_a_line_s)
        )
        gp = np.where(np.isfinite(self.g_upper), self.g_upper, 0.0)
        x = abund * gp * np.exp(
            -C2_CM_K
            * (self.upper_energy_cminv - self.upper_energy_cminv.min())
            / float(temperature_k)
        ) * branch
        if x.sum() <= 0:
            msg = "LTE line weights sum to zero"
            raise ValueError(msg)
        return x / x.sum()

    def photon_ver(self, upper_population):
        """Band-integrated photon VER from the upper-state population."""
        return np.asarray(upper_population, dtype=np.float64) * (
            self.total_einstein_a_s
        )


def o2_vibrational_state_name(quanta: str) -> str:
    """Map an O2 global-quanta string to a population-state name
    (reference emission.rs ``o2_vibrational_state_name``): ``"b 0"`` ->
    ``"O2(b)"``, ``"X 0"`` -> ``"O2(X)"``, ``"b 1"`` -> ``"O2(b, v=1)"``."""
    tokens = str(quanta).split()
    if len(tokens) == 2:
        elec, vib = tokens
        if elec == "b" and vib == "0":
            return "O2(b)"
        if elec == "X" and vib == "0":
            return "O2(X)"
        return f"O2({elec}, v={vib})"
    return str(quanta).strip()


def _o2_vibrational_sequence_mask(catalogue, allowed):
    """Boolean mask of lines whose (upper, lower) global quanta match one of
    ``allowed`` — a set of ((elec', v'), (elec'', v'')) token tuples.
    Returns None when the catalogue has no quanta (no filtering possible)."""
    qup = getattr(catalogue, "quanta_upper", None)
    qlo = getattr(catalogue, "quanta_lower", None)
    if qup is None or qlo is None:
        return None
    if all(not str(q).strip() for q in np.asarray(qup)):
        return None  # catalogue carries no quanta — can't filter
    mask = np.zeros(len(qup), dtype=bool)
    for i, (u, lo) in enumerate(zip(np.asarray(qup), np.asarray(qlo))):
        ut, lt = tuple(str(u).split()), tuple(str(lo).split())
        mask[i] = (ut, lt) in allowed
    return mask


def oxygen_a_band_from_catalogue(catalogue) -> EmissionBand:
    """O2 A-band (~762 nm): b->X with v'=v'' in {0, 1} when the catalogue
    carries global quanta (reference emission.rs
    ``line_matches_o2_a_band_vibrational_sequence``); otherwise all lines
    in the wavelength window."""
    mask = _o2_vibrational_sequence_mask(
        catalogue,
        {(("b", "0"), ("X", "0")), (("b", "1"), ("X", "1"))},
    )
    return EmissionBand.from_catalogue(
        "oxygen_a_band", "O2(b)", "O2(X)",
        O2_A_BAND_TOTAL_EINSTEIN_A_S, catalogue,
        O2_A_BAND_MIN_WAVELENGTH_NM, O2_A_BAND_MAX_WAVELENGTH_NM,
        line_mask=mask,
    )


def oxygen_b_band_from_catalogue(catalogue) -> EmissionBand:
    """O2 B-band (b 1Sigma v'=1 -> X v''=0, ~689 nm)."""
    mask = _o2_vibrational_sequence_mask(
        catalogue, {(("b", "1"), ("X", "0"))}
    )
    return EmissionBand.from_catalogue(
        "oxygen_b_band", "O2(b, v=1)", "O2(X)",
        O2_B1_X0_EINSTEIN_A_S, catalogue,
        O2_B_BAND_MIN_WAVELENGTH_NM, O2_B_BAND_MAX_WAVELENGTH_NM,
        line_mask=mask,
    )


# ---------------------------------------------------------------------------
# Per-altitude line-weight models and population -> line-list conversion
# (reference emission.rs oxygen_a_band_lte_line_weights,
# line_list_weights_from_population_branches)


def _state_groups(band: EmissionBand):
    labels = (
        band.upper_vib_state
        if band.upper_vib_state is not None
        else np.array([band.upper_state] * band.wavelength_nm.size,
                      dtype=object)
    )
    groups = {}
    for i, lab in enumerate(labels):
        groups.setdefault(str(lab), []).append(i)
    return {k: np.array(v) for k, v in groups.items()}


def band_line_weights(band, temperature_k, model="einstein_a_branching"):
    """Temperature-dependent line weights [A, nlines], normalized to 1
    *within each upper vibrational state group* per altitude.

    Models (reference ``AEmissionLineWeightModel``):

    - ``einstein_a_branching``: LTE Boltzmann upper populations
      ``abundance * g' * exp(-c2 E'/T)`` times the per-level branching
      ratio (reference ``oxygen_a_band_einstein_branching_line_weights``).
    - ``hitran_line_strength``: emission weight from the HITRAN absorption
      line intensity, ``ln S + ln(296/T) + c2 E''(T-296)/(296 T)
      + 2 ln nu - c2 nu / T`` softmax-normalized per state (reference
      ``hitran_line_strength_emission_log_weight``).
    """
    t = np.atleast_1d(np.asarray(temperature_k, dtype=np.float64))
    nl = band.wavelength_nm.size
    weights = np.zeros((t.size, nl))
    nu = 1.0e7 / band.wavelength_nm

    for idx in _state_groups(band).values():
        if model == "einstein_a_branching":
            if band.g_upper is None:
                msg = (
                    "einstein_a_branching weights need upper statistical "
                    "weights g' from a full 160-column HITRAN record"
                )
                raise ValueError(msg)
            gp = np.where(np.isfinite(band.g_upper[idx]),
                          band.g_upper[idx], 0.0)
            abund = (
                band.iso_abundance[idx]
                if band.iso_abundance is not None else 1.0
            )
            branch = (
                band.upper_branching[idx]
                if band.upper_branching is not None else 1.0
            )
            eup = band.upper_energy_cminv[idx]
            x = (
                abund * gp * branch
                * np.exp(-C2_CM_K * (eup - eup.min())[None, :] / t[:, None])
            )
        elif model == "hitran_line_strength":
            if band.line_intensity is None or band.lower_energy_cminv is None:
                msg = "hitran_line_strength weights need S(296) and E''"
                raise ValueError(msg)
            s = band.line_intensity[idx]
            elo = band.lower_energy_cminv[idx]
            nug = nu[idx]
            logw = (
                np.log(np.maximum(s, 1e-300))[None, :]
                + np.log(296.0 / t)[:, None]
                + C2_CM_K * elo[None, :] * (t[:, None] - 296.0)
                / (t[:, None] * 296.0)
                + 2.0 * np.log(nug)[None, :]
                - C2_CM_K * nug[None, :] / t[:, None]
            )
            x = np.exp(logw - logw.max(axis=1, keepdims=True))
        else:
            msg = (
                f"Unknown line weight model {model!r}; expected "
                "'einstein_a_branching' or 'hitran_line_strength'"
            )
            raise ValueError(msg)
        rowsum = x.sum(axis=1, keepdims=True)
        if np.any(rowsum <= 0) or not np.all(np.isfinite(rowsum)):
            msg = "Line weight rows must sum to a positive finite value"
            raise ValueError(msg)
        weights[:, idx] = x / rowsum
    return weights


def line_list_weights_from_populations(
    band, temperature_k, branches, model="einstein_a_branching"
):
    """Combine per-state populations into a total photon VER profile and
    per-altitude normalized line weights.

    ``branches``: list of ``(state_name, population_or_None,
    einstein_a_s)``. Each line inherits the VER of its upper vibrational
    state (population x A_state) times its in-state weight; rows with zero
    total VER fall back to the band's static weights. Returns
    ``(photon_ver [A], weights [A, nlines])`` (reference emission.rs
    ``line_list_weights_from_population_branches``).
    """
    t = np.atleast_1d(np.asarray(temperature_k, dtype=np.float64))
    w_state = band_line_weights(band, t, model)  # [A, L]
    labels = (
        band.upper_vib_state
        if band.upper_vib_state is not None
        else np.array([band.upper_state] * band.wavelength_nm.size,
                      dtype=object)
    )

    state_ver = {}
    for name, pop, a_s in branches:
        if pop is None:
            continue
        pop = np.asarray(pop, dtype=np.float64)
        if pop.shape != t.shape:
            msg = f"Population {name!r} shape must match temperature"
            raise ValueError(msg)
        state_ver[name] = pop * a_s

    line_ver = np.zeros_like(w_state)
    for i, lab in enumerate(labels):
        sv = state_ver.get(str(lab))
        if sv is not None:
            line_ver[:, i] = sv * w_state[:, i]

    total = line_ver.sum(axis=1)
    fallback = band.weights / band.weights.sum()
    combined = np.where(
        total[:, None] > 0,
        line_ver / np.where(total[:, None] > 0, total[:, None], 1.0),
        fallback[None, :],
    )
    return total, combined


def oxygen_a_band_line_list_weights_from_populations(
    band, temperature_k, o2_b0, o2_b1=None, o2_b2=None,
    model="einstein_a_branching",
):
    """A-band line list from O2(b, v=0/1/2) populations (reference
    ``oxygen_a_band_line_list_weights_from_populations``)."""
    return line_list_weights_from_populations(
        band, temperature_k,
        [
            ("O2(b)", o2_b0, O2_B0_X0_EINSTEIN_A_S),
            ("O2(b, v=1)", o2_b1, O2_B1_X1_EINSTEIN_A_S),
            ("O2(b, v=2)", o2_b2, O2_B2_X2_EINSTEIN_A_S),
        ],
        model,
    )


def oxygen_b_band_line_list_weights_from_populations(
    band, temperature_k, o2_b1=None, model="einstein_a_branching",
):
    """B-band line list from the O2(b, v=1) population."""
    return line_list_weights_from_populations(
        band, temperature_k,
        [("O2(b, v=1)", o2_b1, O2_B1_X0_EINSTEIN_A_S)],
        model,
    )
