"""HITRAN line-list database accessor.

Role of the reference's ``src/sasktran2/database/hitran_line.py``
(HITRANLineDatabase: per-molecule line files fetched through hapi and
cached). Zero-egress build: line files must already exist under
``<database_root>/hitran/lines/`` as ``<MOLECULE>.par`` (or ``.data``);
``load_catalogue`` parses them into a
:class:`~..optical.line_absorber.LineCatalogue`.

(Copy of ``sasktran2_tpu/database/hitran_line.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

from pathlib import Path

from . import CachedDatabase


class HITRANLineDatabase(CachedDatabase):
    def __init__(self):
        super().__init__("hitran/lines")

    def path(self, molecule: str) -> Path:
        """Local line file for ``molecule`` (e.g. ``"O2"``)."""
        mol = str(molecule).upper()
        for suffix in (".par", ".data", ".txt"):
            p = super().path(mol + suffix)
            if p.exists():
                return p
        msg = (
            f"No HITRAN line file for {mol} under {super().path()}; this "
            f"build cannot download — place {mol}.par there (160-column "
            "HITRAN 2004 format)"
        )
        raise FileNotFoundError(msg)

    def load_catalogue(self, molecule: str, molar_mass_kg_mol=None):
        """Parse the molecule's line file into a LineCatalogue."""
        from ..optical.line_absorber import (
            MOLAR_MASS_KG_MOL,
            load_hitran_par,
        )

        mm = molar_mass_kg_mol or MOLAR_MASS_KG_MOL.get(
            str(molecule).upper()
        )
        if mm is None:
            msg = (
                f"Unknown molar mass for {molecule!r}; pass "
                "molar_mass_kg_mol explicitly"
            )
            raise ValueError(msg)
        return load_hitran_par(self.path(molecule), mm)
