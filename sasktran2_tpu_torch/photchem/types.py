"""Photochemical reaction types.

Role of the reference's ``rust/sasktran2-rs/src/photchem/types.rs``:
molecules with electronic/vibrational excitation labels, unimolecular and
bimolecular chemical reactions with temperature-dependent rate constants,
and photo-reactions driven by actinic flux.

Reaction equations parse from strings with the same grammar the reference
uses, e.g. ``"O(1D) + O2 -> O2(b, v=1) + O(3P)"`` or
``"O2 + hv(lyman-alpha) -> O(3P) + O(1D)"``.

(Copy of ``sasktran2_tpu/photchem/types.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, replace

_MOLECULE_RE = re.compile(
    r"^\s*(?P<base>O2|O3|O|N2|CO2)"
    r"(?:\(\s*(?P<elec>[^,)]+?)\s*(?:,\s*v\s*=\s*(?P<v>\d+)\s*)?\))?\s*$"
)

#: molecules the network understands (reference ``MoleculeBase``)
MOLECULE_BASES = ("O2", "O3", "O", "N2", "CO2")


@dataclass(frozen=True)
class Molecule:
    """A molecule with optional electronic level and vibrational quantum
    number. Ground states format as the bare base name (``"O2"``); excited
    states as ``"O2(b, v=1)"`` / ``"O(1D)"``."""

    base: str
    elec: str = "X"
    v: int = 0

    @staticmethod
    def parse(text: str) -> "Molecule":
        m = _MOLECULE_RE.match(text)
        if m is None:
            msg = f"Cannot parse molecule from {text!r}"
            raise ValueError(msg)
        base = m.group("base")
        elec = m.group("elec")
        v = m.group("v")
        if elec is None:
            return Molecule(base)
        return Molecule(base, elec.strip(), int(v) if v is not None else 0)

    @property
    def name(self) -> str:
        """Canonical name used as the key in density/population dicts."""
        if self.base != "O" and self.elec == "X" and self.v == 0:
            return self.base
        if self.base == "O":
            if self.elec == "X":
                return "O"
            return f"O({self.elec})"
        if self.v == 0 and self.elec == "X":
            return self.base
        return f"{self.base}({self.elec}, v={self.v})"

    @property
    def is_ground(self) -> bool:
        """True for true ground states (``O2``, ``O3``, ``N2``, ``CO2``
        with elec X / v=0, and atomic ``O`` / ``O(3P)``). Only ground
        states may fall back to the base-name density entry — excited
        states sharing the base (``O2(b, v=0)``, ``O(1D)``) are solved-for
        species (reference types.rs: background matches canonical name)."""
        if self.base == "O":
            return self.elec in ("X", "3P")
        return self.elec == "X" and self.v == 0

    def __str__(self) -> str:  # pragma: no cover - convenience
        return self.name


def _split_side(side: str) -> list[str]:
    # split on '+' that separates species; careful not to split inside ()
    parts, depth, cur = [], 0, []
    for ch in side:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "+" and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


@dataclass(frozen=True)
class RateConstant:
    """Parametric rate constant ``a * (T/300)^n * exp(b / T)`` — covers
    every reaction rate in the Yankovsky network. Units: s^-1 for
    unimolecular, cm^3 s^-1 for bimolecular (reference convention:
    densities are supplied in m^-3 and converted to cm^-3 internally)."""

    a: float
    n: float = 0.0
    b: float = 0.0

    def __call__(self, temperature_k):
        import numpy as np

        t = np.asarray(temperature_k, dtype=np.float64)
        out = self.a * np.ones_like(t)
        if self.n != 0.0:
            out = out * (t / 300.0) ** self.n
        if self.b != 0.0:
            out = out * np.exp(self.b / t)
        return out


@dataclass(frozen=True)
class ChemicalReaction:
    """A unimolecular (Einstein-coefficient) or bimolecular reaction.

    For bimolecular reactions the second reactant must be a background
    (fixed-density) species — the steady-state system stays linear."""

    reactants: tuple[Molecule, ...]
    products: tuple[Molecule, ...]
    rate: RateConstant | None = None          # bimolecular k(T) [cm^3/s]
    einstein_a: float | None = None           # unimolecular rate [1/s]
    quantum_yield: float = 1.0

    @staticmethod
    def parse(equation: str) -> "ChemicalReaction":
        lhs, rhs = equation.split("->")
        reactants = tuple(Molecule.parse(p) for p in _split_side(lhs))
        products = tuple(Molecule.parse(p) for p in _split_side(rhs))
        if not (1 <= len(reactants) <= 2):
            msg = f"Reactions must have 1 or 2 reactants: {equation!r}"
            raise ValueError(msg)
        return ChemicalReaction(reactants, products)

    def with_rate(self, a, n=0.0, b=0.0) -> "ChemicalReaction":
        return replace(self, rate=RateConstant(a, n, b))

    def with_einstein(self, a_s: float) -> "ChemicalReaction":
        return replace(self, einstein_a=float(a_s))

    def with_quantum_yield(self, q: float) -> "ChemicalReaction":
        return replace(self, quantum_yield=float(q))


_HV_RE = re.compile(r"hv(\([^)]*\))?")


@dataclass(frozen=True)
class PhotoReaction:
    """Photo-dissociation/excitation ``X + hv(tag) -> products``.

    ``toa_rate_constant`` [1/s] rescales the integrated rate so the
    top-of-atmosphere value matches a published J; ``wavelength_range_nm``
    restricts the actinic integral to a band; ``line_center_nm`` switches
    to single-line evaluation at that wavelength (with an optional fixed
    effective cross section)."""

    in_molecule: Molecule
    products: tuple[Molecule, ...]
    tag: str = ""
    quantum_yield: float = 1.0
    toa_rate_constant: float = 0.0
    wavelength_range_nm: tuple[float, float] | None = None
    line_center_nm: float | None = None
    line_effective_cross_section_m2: float | None = None

    @staticmethod
    def parse(equation: str) -> "PhotoReaction":
        lhs, rhs = equation.split("->")
        tag_match = _HV_RE.search(lhs)
        tag = ""
        if tag_match is not None:
            grp = tag_match.group(1)
            tag = grp[1:-1] if grp else ""
            lhs = lhs[: tag_match.start()] + lhs[tag_match.end():]
        reactants = _split_side(lhs)
        if len(reactants) != 1:
            msg = f"Photo reactions need exactly one molecule: {equation!r}"
            raise ValueError(msg)
        products = tuple(Molecule.parse(p) for p in _split_side(rhs))
        return PhotoReaction(Molecule.parse(reactants[0]), products, tag=tag)

    def with_quantum_yield(self, q) -> "PhotoReaction":
        return replace(self, quantum_yield=float(q))

    def with_toa_rate_constant(self, k) -> "PhotoReaction":
        return replace(self, toa_rate_constant=float(k))

    def with_wavelength_range_nm(self, lo, hi) -> "PhotoReaction":
        return replace(self, wavelength_range_nm=(float(lo), float(hi)))

    def with_band_center_nm(self, center, half_width) -> "PhotoReaction":
        return replace(
            self,
            wavelength_range_nm=(center - half_width, center + half_width),
        )

    def with_line_center_nm(self, center) -> "PhotoReaction":
        return replace(self, line_center_nm=float(center))

    def with_line_effective_cross_section_m2(self, xs) -> "PhotoReaction":
        return replace(self, line_effective_cross_section_m2=float(xs))

    @property
    def rate_name(self) -> str:
        return f"J_{self.in_molecule.name}_{self.tag}"
