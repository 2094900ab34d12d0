"""Steady-state photochemical models and photolysis rates.

Role of the reference's ``rust/sasktran2-rs/src/photchem/models.rs``:

- :func:`calculate_photolysis_rate` integrates sigma * actinic flux over
  wavelength (with band windows, single-line evaluation, and TOA-rate
  renormalization) — the actinic flux comes straight from the engine's
  ``FluxType.Actinic`` observers.
- :class:`PhotochemicalModel` assembles the linear steady-state system for
  the excited-state populations (unimolecular losses, bimolecular
  loss/transfer against fixed background densities, photo-production) and
  solves it. TPU-twist: the system is built as a batched ``[nalt, n, n]``
  tensor over the whole altitude profile and solved in one batched
  ``solve`` instead of the reference's per-altitude LAPACK ``dgesv``.
- :class:`Yankovsky` is the O2/O3 dayglow model (photo-excitation of
  O2(a/b/X, v) and O(1D) plus the collisional cascade network).

(Copy of ``sasktran2_tpu/photchem/models.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

import numpy as np

from .types import ChemicalReaction, Molecule, PhotoReaction

LYMAN_ALPHA_WAVELENGTH_NM = 121.567
LYMAN_ALPHA_TOA_RATE_S = 3.40e-9
LYMAN_ALPHA_O1D_QUANTUM_YIELD = 0.53
LYMAN_ALPHA_TOA_FLUX_PHOTONS_M2_S = 3.2e15
O2_LYMAN_ALPHA_EFFECTIVE_CROSS_SECTION_M2 = (
    LYMAN_ALPHA_TOA_RATE_S / LYMAN_ALPHA_TOA_FLUX_PHOTONS_M2_S
)

OXYGEN_GREEN_LINE_EINSTEIN_A_S = 1.26


def wavelength_bin_widths(wavelength_nm):
    """Midpoint bin widths of a wavelength grid (edges use one-sided
    differences)."""
    wl = np.asarray(wavelength_nm, dtype=np.float64)
    if wl.size < 2:
        msg = "Need at least two wavelength points for photolysis integrals"
        raise ValueError(msg)
    if not np.all(np.isfinite(wl)):
        msg = "Wavelength grid contains non-finite values"
        raise ValueError(msg)
    d = np.empty_like(wl)
    d[0] = abs(wl[1] - wl[0])
    d[-1] = abs(wl[-1] - wl[-2])
    d[1:-1] = 0.5 * np.abs(wl[2:] - wl[:-2])
    return d


def _interp_rows(wavelength_nm, values, target_nm):
    """Linear interpolation of values[nwav, nalt] rows to one wavelength."""
    wl = np.asarray(wavelength_nm, dtype=np.float64)
    if target_nm < wl[0] or target_nm > wl[-1]:
        msg = (
            f"Cannot evaluate line photolysis at {target_nm} nm: grid spans "
            f"{wl[0]} to {wl[-1]} nm"
        )
        raise ValueError(msg)
    j = int(np.clip(np.searchsorted(wl, target_nm) - 1, 0, wl.size - 2))
    w = (target_nm - wl[j]) / (wl[j + 1] - wl[j])
    return (1.0 - w) * values[j] + w * values[j + 1]


def calculate_photolysis_rate(
    reaction: PhotoReaction, wavelength_nm, actinic_flux, cross_section
):
    """Photolysis rate profile J [1/s] for one photo reaction.

    Parameters
    ----------
    actinic_flux, cross_section : ``[nwav, nalt]`` arrays (photon actinic
        flux per nm and cross section in m^2). Negative values are clamped
        to zero as in the reference.

    If ``reaction.toa_rate_constant`` is set, the profile is rescaled so
    its top-of-atmosphere (last column) value equals it — the published J
    anchors the absolute scale while the RT supplies the altitude shape.
    """
    flux = np.clip(np.asarray(actinic_flux, dtype=np.float64), 0.0, None)
    xs = np.clip(np.asarray(cross_section, dtype=np.float64), 0.0, None)
    if flux.shape != xs.shape:
        msg = f"actinic flux {flux.shape} != cross section {xs.shape}"
        raise ValueError(msg)
    q = reaction.quantum_yield

    if reaction.line_center_nm is not None:
        flux_line = _interp_rows(wavelength_nm, flux, reaction.line_center_nm)
        if reaction.line_effective_cross_section_m2 is not None:
            xs_line = np.full(
                flux.shape[1], reaction.line_effective_cross_section_m2
            )
        else:
            xs_line = _interp_rows(
                wavelength_nm, xs, reaction.line_center_nm
            )
        rate = flux_line * xs_line
    else:
        d = wavelength_bin_widths(wavelength_nm)
        wl = np.asarray(wavelength_nm, dtype=np.float64)
        in_band = np.ones_like(wl, dtype=bool)
        if reaction.wavelength_range_nm is not None:
            lo, hi = reaction.wavelength_range_nm
            in_band = (wl >= lo) & (wl <= hi)
        weights = np.where(in_band, d, 0.0)
        rate = np.einsum("w,wz->z", weights, flux * xs)

    if reaction.toa_rate_constant > 0.0 and rate.size:
        ref = rate[-1]
        if np.isfinite(ref) and ref > 0.0:
            rate = rate * (reaction.toa_rate_constant / ref)
    return q * rate


class PhotochemicalModel:
    """Base class: a reaction network solved for steady-state excited-state
    populations, batched over an altitude profile.

    Species present in the user-supplied ``densities`` dict are background
    (fixed); everything else appearing in the network is solved for.
    """

    photo_reactions: list[PhotoReaction] = []
    chemical_reactions: list[ChemicalReaction] = []

    def molecules(self) -> list[Molecule]:
        mols: list[Molecule] = []
        for r in self.photo_reactions:
            mols.append(r.in_molecule)
            mols.extend(r.products)
        for r in self.chemical_reactions:
            mols.extend(r.reactants)
            mols.extend(r.products)
        unique: list[Molecule] = []
        for m in mols:
            if m not in unique:
                unique.append(m)
        return unique

    def required_photolysis_rates(self) -> list[str]:
        names = []
        mol_bases = {m.base for m in self.molecules()}
        for r in self.photo_reactions:
            if any(p.base in mol_bases for p in r.products):
                names.append(r.rate_name)
        return names

    # -- steady-state assembly -----------------------------------------
    def _lookup(self, densities: dict, mol: Molecule):
        v = densities.get(mol.name)
        if v is None:
            v = densities.get(mol.base)
        if v is None:
            msg = f"Density not provided for background species {mol.name!r}"
            raise KeyError(msg)
        return np.asarray(v, dtype=np.float64)

    def solve(self, temperature_k, densities, photolysis_rates):
        """Steady-state populations [m^-3].

        Parameters
        ----------
        temperature_k : ``[Z]`` profile (scalars broadcast).
        densities : dict of background species name -> ``[Z]`` number
            density in m^-3.
        photolysis_rates : dict ``rate_name -> [Z]`` (see
            :meth:`required_photolysis_rates`) or an array
            ``[n_photo, Z]`` ordered like ``self.photo_reactions``.

            Dict entries are *channel* rates shared by every branch with
            that name (e.g. all O3 Hartley branches share ``J_O3_``);
            the per-branch quantum yield is applied here. Array entries
            are *per-reaction* rates with the quantum yield already
            included — the reference convention, matching what
            :func:`calculate_photolysis_rate` returns per reaction
            (models.rs:186 zips one J per photo reaction).

        Returns
        -------
        dict of excited-state name -> ``[Z]`` population in m^-3.
        """
        t = np.atleast_1d(np.asarray(temperature_k, dtype=np.float64))
        nz = t.size
        bg = {k for k in densities}
        # Background species match on exact canonical name; only true
        # ground states (O2, O3, N2, CO2, O/O(3P)) may fall back to a
        # base-name density entry. Excited states sharing a base
        # (O2(b,v=*), O(1D), ...) are solved for.
        state = [
            m for m in self.molecules()
            if m.name not in bg and not (m.is_ground and m.base in bg)
        ]
        index = {m: i for i, m in enumerate(state)}
        n = len(state)
        a = np.zeros((nz, n, n))
        prod = np.zeros((nz, n))
        seen_losses: set = set()

        for r in self.chemical_reactions:
            if len(r.reactants) == 1:
                if r.einstein_a is None:
                    msg = f"Missing Einstein coefficient for {r}"
                    raise ValueError(msg)
                rate = r.einstein_a  # scalar
                src = r.reactants[0]
                if src in index:
                    i = index[src]
                    a[:, i, i] -= rate
                    for p in r.products:
                        if p in index:
                            a[:, index[p], i] += rate
                else:
                    nd = self._lookup(densities, src)
                    for p in r.products:
                        if p in index:
                            prod[:, index[p]] += rate * nd
            else:
                if r.rate is None:
                    msg = f"Missing rate constant for {r}"
                    raise ValueError(msg)
                src, collider = r.reactants
                if collider in index:
                    msg = (
                        f"Collider {collider.name!r} must be a background "
                        "species (nonlinear system otherwise)"
                    )
                    raise ValueError(msg)
                # rate constants are cm^3/s; densities arrive in m^-3
                coll_cm3 = self._lookup(densities, collider) / 1.0e6
                rate = r.rate(t) * coll_cm3  # [Z]
                if src in index:
                    i = index[src]
                    loss_key = (src, collider, r.rate)
                    if loss_key not in seen_losses:
                        seen_losses.add(loss_key)
                        a[:, i, i] -= rate
                    for p in r.products:
                        if p in index:
                            a[:, index[p], i] += rate * r.quantum_yield
                else:
                    nd = self._lookup(densities, src)
                    for p in r.products:
                        if p in index:
                            prod[:, index[p]] += (
                                rate * r.quantum_yield * nd
                            )

        for k, r in enumerate(self.photo_reactions):
            if isinstance(photolysis_rates, dict):
                j = photolysis_rates.get(r.rate_name)
                if j is None:
                    continue
                j = np.asarray(j, dtype=np.float64) * r.quantum_yield
            else:
                j = photolysis_rates[k]
            j = np.broadcast_to(np.asarray(j, dtype=np.float64), (nz,))
            nd = self._lookup(densities, r.in_molecule)
            for p in r.products:
                if p in index:
                    prod[:, index[p]] += j * nd

        # A x = -production  (production entered as negative sources in the
        # reference; equivalently x = A^{-1} (-prod) with A containing the
        # negative loss rates)
        x = np.linalg.solve(a, -prod[..., None])[..., 0]
        return {m.name: x[:, i] for m, i in index.items()}


class Yankovsky(PhotochemicalModel):
    """O2/O3 dayglow photochemistry (Yankovsky & Manuilova model family):
    photo-production of O(1D) and excited O2(a/b/X, v) states with the
    collisional/radiative cascade, for the 762 nm A-band, 1.27 um IR
    atmospheric band, and green-line scaffolding.

    Rate constants are physical data from the published model; the network
    is encoded declaratively below."""

    def __init__(self):
        pr = [
            PhotoReaction.parse("O2 + hv(SRC) -> O(3P) + O(1D)")
            .with_quantum_yield(1.0)
            .with_toa_rate_constant(2.60e-6)
            .with_wavelength_range_nm(130.0, 202.0),
            PhotoReaction.parse("O2 + hv(lyman-alpha) -> O(3P) + O(1D)")
            .with_quantum_yield(LYMAN_ALPHA_O1D_QUANTUM_YIELD)
            .with_toa_rate_constant(LYMAN_ALPHA_TOA_RATE_S)
            .with_line_center_nm(LYMAN_ALPHA_WAVELENGTH_NM)
            .with_line_effective_cross_section_m2(
                O2_LYMAN_ALPHA_EFFECTIVE_CROSS_SECTION_M2
            ),
        ]
        # O3 Hartley-band branches into O2(a, v) + O(1D)
        for v, q in [(5, 0.045), (4, 0.072), (3, 0.072), (2, 0.135),
                     (1, 0.135), (0, 0.441)]:
            pr.append(
                PhotoReaction.parse(f"O3 + hv -> O2(a, v={v}) + O(1D)")
                .with_quantum_yield(q)
                .with_toa_rate_constant(8.0e-3)
            )
        # remaining 10% of the O3 yield -> O2(X, v) + O(3P)
        for v in range(1, 36):
            pr.append(
                PhotoReaction.parse(f"O3 + hv -> O2(X, v={v}) + O(3P)")
                .with_quantum_yield(0.1 / 35.0)
                .with_toa_rate_constant(8.0e-3)
            )
        # resonant solar excitation bands
        for eq, k, center in [
            ("O2 + hv(762_nm_band) -> O2(b, v=0)", 5.35e-9, 762.0),
            ("O2 + hv(689_nm_band) -> O2(b, v=1)", 2.94e-10, 689.0),
            ("O2 + hv(629_nm_band) -> O2(b, v=2)", 7.94e-12, 629.0),
            ("O2 + hv(1.27_um_band) -> O2(a, v=0)", 1.54e-10, 1270.0),
        ]:
            pr.append(
                PhotoReaction.parse(eq)
                .with_toa_rate_constant(k)
                .with_band_center_nm(center, 10.0)
            )
        self.photo_reactions = pr

        def R(eq):
            return ChemicalReaction.parse(eq)

        cr = [
            R("O(1S) -> O(1D)").with_einstein(OXYGEN_GREEN_LINE_EINSTEIN_A_S),
            R("O(1D) -> O(3P)").with_einstein(9.0e-3),
            R("O(1D) + O(3P) -> O(3P) + O(3P)").with_rate(4.0e-12),
            R("O(1D) + O2 -> O2(b, v=1) + O(3P)")
            .with_rate(3.2e-11, b=67.0).with_quantum_yield(0.40),
            R("O(1D) + O2 -> O2(b, v=0) + O(3P)")
            .with_rate(3.2e-11, b=67.0).with_quantum_yield(0.55),
            R("O(1D) + O2 -> O2(a, v=0) + O(3P)")
            .with_rate(3.2e-11, b=67.0).with_quantum_yield(0.05),
            R("O(1D) + O3 -> O2 + O2").with_rate(2.4e-10),
            R("O(1D) + N2 -> N2 + O(3P)").with_rate(2.0e-11, b=107.0),
            # O2(b, v) cascade
            R("O2(b, v=2) -> O2(X, v=2)").with_einstein(5.4e-2),
            R("O2(b, v=2) + O(3P) -> O2(b, v=1) + O(3P)").with_rate(1.1e-11),
            R("O2(b, v=2) + O2 -> O2(X, v=2) + O2(b, v=0)")
            .with_rate(1.20e-11, b=-596.0),
            R("O2(b, v=2) + N2 -> O2(b, v=1) + N2").with_rate(2e-14),
            R("O2(b, v=2) + O3 -> O2 + O2 + O(3P)").with_rate(2.9e-10),
            R("O2(b, v=1) -> O2(X, v=1)").with_einstein(7.0e-2),
            R("O2(b, v=1) + O(3P) -> O2(b, v=0) + O(3P)").with_rate(4.5e-12),
            R("O2(b, v=1) + O2 -> O2(X, v=1) + O2(b, v=0)")
            .with_rate(4.20e-11, b=-312.0),
            R("O2(b, v=1) + N2 -> O2(b, v=0) + N2").with_rate(5.0e-13),
            R("O2(b, v=1) + O3 -> O2 + O2 + O(3P)").with_rate(3.0e-10),
            R("O2(b, v=0) -> O2").with_einstein(7.58e-2),
            R("O2(b, v=0) + O(3P) -> O2(a, v=0) + O(3P)")
            .with_rate(8.0e-14).with_quantum_yield(0.75),
            R("O2(b, v=0) + O(3P) -> O2 + O(3P)")
            .with_rate(8.0e-14).with_quantum_yield(0.25),
            R("O2(b, v=0) + O2 -> O2(a, v=0) + O2(X, v=3)")
            .with_rate(3.9e-17).with_quantum_yield(0.230),
            R("O2(b, v=0) + O2 -> O2(a, v=1) + O2(X, v=2)")
            .with_rate(3.9e-17).with_quantum_yield(0.525),
            R("O2(b, v=0) + O2 -> O2(a, v=2) + O2(X, v=1)")
            .with_rate(3.9e-17).with_quantum_yield(0.226),
            R("O2(b, v=0) + O2 -> O2(a, v=3) + O2")
            .with_rate(3.9e-17).with_quantum_yield(0.019),
            R("O2(b, v=0) + CO2 -> O2(a, v=0) + CO2").with_rate(4.2e-13),
            R("O2(b, v=0) + O3 -> O2(a, v=0) + O3")
            .with_rate(2.2e-11).with_quantum_yield(0.3),
            # O2(a, v) cascade
            R("O2(a, v=0) -> O2").with_einstein(2.58e-4),
            R("O2(a, v=2) + O2 -> O2(X, v=2) + O2(a, v=0)").with_rate(3.6e-11),
            R("O2(a, v=1) + O2 -> O2(X, v=1) + O2(a, v=0)").with_rate(5.6e-11),
            R("O2(a, v=1) + O3 -> O2 + O2 + O(3P)").with_rate(4.7e-12),
            R("O2(a, v=0) + O(3P) -> O2 + O(3P)").with_rate(6.5e-17),
            R("O2(a, v=0) + O2 -> O2(X, v=5) + O2")
            .with_rate(3.6e-18, b=-220.0).with_quantum_yield(0.014),
            R("O2(a, v=0) + O2 -> O2(X, v=4) + O2(X, v=1)")
            .with_rate(3.6e-18, b=-220.0).with_quantum_yield(0.214),
            R("O2(a, v=0) + O2 -> O2(X, v=3) + O2(X, v=2)")
            .with_rate(3.6e-18, b=-220.0).with_quantum_yield(0.772),
            R("O2(a, v=0) + O3 -> O2 + O3").with_rate(5.20e-11, b=-2840.0),
            R("O2(a, v=0) + N2 -> O2 + N2").with_rate(1.0e-20),
            # O2(X, v) relaxation
            R("O2(X, v=1) + O(3P) -> O2 + O(3P)").with_rate(3.0e-12),
            R("O2(X, v=1) + O2 -> O2 + O2").with_rate(4.2e-19, n=0.5),
            R("O2(X, v=1) + N2 -> O2 + N2").with_rate(4.20e-19, n=0.5),
        ]
        for v in range(1, 6):
            cr.append(R(f"O2(a, v={v}) -> O2").with_einstein(2.58e-4))
            cr.append(
                R(f"O2(a, v={v}) + O(3P) -> O2 + O(3P)").with_rate(1e-14)
            )
        for v in range(3, 6):
            cr.append(
                R(f"O2(a, v={v}) + O2 -> O2(X, v={v}) + O2(a, v=0)")
                .with_rate(3.6e-11)
            )
        for v in range(1, 31):
            cr.append(
                R(f"O3 + O(3P) -> O2(X, v={v}) + O2")
                .with_rate(5.60e-11, b=-1959.0)
            )
        for v in range(5, 36):
            cr.append(
                R(f"O2(X, v={v}) + O(3P) -> O2 + O(3P)")
                .with_rate(5.0e-11, n=0.5)
            )
        for v in range(2, 5):
            cr.append(
                R(f"O2(X, v={v}) + O(3P) -> O2 + O(3P)")
                .with_rate(1.1e-12 * np.exp(float(v)), n=1.0)
            )
        for v in range(2, 36):
            a0 = 2.0e-13 if v == 2 else 2.6e-13
            cr.append(
                R(f"O2(X, v={v}) + O2 -> O2(X, v={v - 1}) + O2(X, v=1)")
                .with_rate(a0)
            )
        for v in range(4, 21):
            cr.append(
                R(f"O2(X, v={v}) + O2 -> O2(X, v={v - 1}) + O2(X, v=1)")
                .with_rate(1.3e-12 * np.exp(-0.31 * v))
            )
        for v in range(21, 36):
            cr.append(
                R(f"O2(X, v={v}) + O2 -> O2(X, v={v - 1}) + O2")
                .with_rate(6.0e-17 * np.exp(0.2 * v), n=1.0)
            )
        for v in range(12, 18):
            cr.append(
                R(f"O2(X, v={v}) + N2 -> O2(X, v={v - 2}) + N2")
                .with_rate(3.6e-19 * np.exp(0.66 * v))
            )
        for v in range(18, 27):
            cr.append(
                R(f"O2(X, v={v}) + N2 -> O2(X, v={v - 2}) + N2")
                .with_rate(4.5e-13 * np.exp(-0.173 * v))
            )
        self.chemical_reactions = cr
