"""HITRAN-style line-by-line absorption cross sections on the device.

Torch counterpart of ``sasktran2_tpu/optical/line_absorber.py``: given a
catalogue of spectral lines (center wavenumber, intensity at 296 K,
air/self-broadened widths, temperature exponent, pressure shift,
lower-state energy), cross sections on a wavenumber grid at arbitrary
(P, T) with Voigt line shapes, in float64 / complex128 as the reference
computes them.

The reference evaluates one atmosphere level per call, scanning chunks of
``line_chunk`` lines. Here a block of levels goes through each chunk
together: one [levels, chunk, grid] complex128 block (16 B per element)
holds at most ``max_block_elements`` elements, which fixes the number of
levels per block. Padding (nu0 = 1, zero intensity), chunking and the
level blocks change only the order of the float64 sums over lines.

The catalogue parsers and ``LineCatalogue`` are numpy copies of the
reference's, pinned to it by a test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .base import OpticalProperty
from .lineshape import doppler_width, voigt_profile, voigt_profile_complex

C2 = 1.4387768775039339  # h c / k_B [cm K]


@dataclass
class LineCatalogue:
    """Line parameters (HITRAN .par semantics, wavenumbers in cm^-1)."""

    nu0: np.ndarray            # line centers [cm^-1]
    intensity: np.ndarray      # S at 296 K [cm^-1 / (molec cm^-2)]
    gamma_air: np.ndarray      # air-broadened HWHM at 296 K, 1 atm [cm^-1]
    gamma_self: np.ndarray
    n_air: np.ndarray          # temperature exponent
    delta_air: np.ndarray      # pressure shift [cm^-1/atm]
    elower: np.ndarray         # lower-state energy [cm^-1]
    molar_mass: float          # [kg/mol]
    einstein_a: np.ndarray | None = None  # A coefficient [1/s] (emission)
    iso_id: np.ndarray | None = None      # HITRAN isotopologue number
    g_upper: np.ndarray | None = None     # upper statistical weight g'
    g_lower: np.ndarray | None = None     # lower statistical weight g''
    quanta_upper: np.ndarray | None = None  # global upper quanta (str)
    quanta_lower: np.ndarray | None = None  # global lower quanta (str)
    # first-order line-mixing (Rosenkranz) coupling tables [nT, nlines]
    # tabulated at coupling_temps (AER line files; NaN where uncoupled)
    y_coupling: np.ndarray | None = None
    g_coupling: np.ndarray | None = None
    coupling_temps: np.ndarray | None = None


class LineAbsorber(OpticalProperty):
    """Line-by-line absorber (cross sections in m^2/molecule), computed on
    ``device`` (None: the GPU, which must exist; the tests pass "cpu")."""

    # elements of one [levels, chunk, grid] block: 128 MiB of complex128,
    # 4 levels of a 4,096-point grid in chunks of 512 lines
    max_block_elements = 2**23

    def __init__(self, catalogue: LineCatalogue, partition_exponent=1.5,
                 line_chunk: int = 512, cutoff_cminv: float = 25.0,
                 enable_line_coupling: bool = False, device=None):
        self.cat = catalogue
        self.partition_exponent = partition_exponent
        self.line_chunk = line_chunk
        self.cutoff = cutoff_cminv
        self.enable_line_coupling = (
            enable_line_coupling and catalogue.y_coupling is not None
        )
        self.device = resolve_device(device)

    def cross_section_grid(self, wavenumber_cminv, pressure_pa, temperature_k,
                           self_vmr=0.0):
        """xs [len(P/T), len(grid)] in m^2, a numpy array. pressure/
        temperature arrays give one atmosphere level per row."""
        grid = torch.as_tensor(
            np.atleast_1d(np.asarray(wavenumber_cminv, dtype=np.float64)),
            device=self.device,
        )
        p = np.atleast_1d(np.asarray(pressure_pa, dtype=np.float64))
        t = np.atleast_1d(np.asarray(temperature_k, dtype=np.float64))
        per_level = self.line_chunk * grid.numel()
        step = max(1, self.max_block_elements // per_level)
        out = [
            self._xs_levels(grid, p[i:i + step], t[i:i + step], self_vmr)
            for i in range(0, len(p), step)
        ]
        return torch.cat(out).cpu().numpy()

    def _coupling(self, temperature_k):
        """Per-line Y(T), G(T) [L, nlines], interpolated on the host as the
        reference does (uncoupled lines: 0)."""
        cat = self.cat
        nlines = len(cat.nu0)
        ys, gs = [], []
        for t in temperature_k:
            if self.enable_line_coupling:
                ct = np.asarray(cat.coupling_temps, dtype=np.float64)
                tc = float(np.clip(t, ct[0], ct[-1]))
                j = int(np.clip(np.searchsorted(ct, tc) - 1, 0, ct.size - 2))
                f = (tc - ct[j]) / (ct[j + 1] - ct[j])
                y_line = (1 - f) * cat.y_coupling[j] + f * cat.y_coupling[j + 1]
                g_line = (1 - f) * cat.g_coupling[j] + f * cat.g_coupling[j + 1]
                ys.append(np.nan_to_num(y_line))
                gs.append(np.nan_to_num(g_line))
            else:
                ys.append(np.zeros(nlines))
                gs.append(np.zeros(nlines))
        return np.stack(ys), np.stack(gs)

    def _xs_levels(self, grid, pressure_pa, temperature_k, self_vmr):
        """Cross sections [L, G] (m^2, torch) of L levels at once."""
        cat = self.cat
        nlines = len(cat.nu0)
        chunk = self.line_chunk
        npad = (-nlines) % chunk
        dev = grid.device

        def pad(a, fill=0.0):
            a = np.asarray(a, dtype=np.float64)
            lead = a.shape[:-1]
            full = np.concatenate(
                [a, np.full(lead + (npad,), fill)], axis=-1)
            return torch.as_tensor(full, device=dev).reshape(
                lead + (-1, chunk))

        # pad with nu0=1 (not 0) so the stimulated-emission ratio and the
        # Doppler width stay finite; padded intensities are zero anyway
        nu0 = pad(cat.nu0, 1.0)
        s0 = pad(cat.intensity)
        ga = pad(cat.gamma_air)
        gs = pad(cat.gamma_self)
        na = pad(cat.n_air)
        da = pad(cat.delta_air)
        el = pad(cat.elower)
        y_line, g_line = self._coupling(temperature_k)
        yc = pad(y_line)  # [L, nchunk, chunk]
        gc = pad(g_line)

        tref = 296.0
        p_atm = torch.as_tensor(pressure_pa / 101325.0, device=dev)[:, None]
        t = torch.as_tensor(temperature_k, device=dev)[:, None]  # [L, 1]
        qratio = (tref / t) ** self.partition_exponent

        acc = torch.zeros((len(temperature_k), grid.numel()),
                          dtype=torch.float64, device=dev)
        for c in range(nu0.shape[0]):
            nu0c, s0c, gac, gsc = nu0[c], s0[c], ga[c], gs[c]
            nac, dac, elc = na[c], da[c], el[c]
            # temperature-scaled intensity (HITRAN convention):
            # S(T) = S(296) Q(296)/Q(T) exp(-c2 E"/T)/exp(-c2 E"/296)
            #        (1-exp(-c2 nu0/T))/(1-exp(-c2 nu0/296))
            s = (
                s0c
                * qratio
                * torch.exp(-C2 * elc / t)
                / torch.exp(-C2 * elc / tref)
                * (1.0 - torch.exp(-C2 * nu0c / t))
                / (1.0 - torch.exp(-C2 * nu0c / tref))
            )  # [L, chunk]
            gamma_l = (
                (tref / t) ** nac
                * (gac * (1.0 - self_vmr) + gsc * self_vmr)
                * p_atm
            )
            nu_shift = nu0c + dac * p_atm
            alpha_d = torch.clamp(
                doppler_width(nu_shift, t, cat.molar_mass), min=1e-12
            )
            g3 = grid[None, None, :]
            ns3 = nu_shift[:, :, None]
            dv = g3 - ns3
            if self.enable_line_coupling:
                re_v, im_v = voigt_profile_complex(
                    g3, ns3, alpha_d[:, :, None], gamma_l[:, :, None],
                )
                # sigma = S [(1 + P^2 G) ReW + P Y ImW] / (alpha sqrt(pi))
                prof = (
                    (1.0 + p_atm * p_atm * gc[:, c])[:, :, None] * re_v
                    + (p_atm * yc[:, c])[:, :, None] * im_v
                )
            else:
                prof = voigt_profile(
                    g3, ns3, alpha_d[:, :, None], gamma_l[:, :, None],
                )
            prof = torch.where(dv.abs() <= self.cutoff, prof,
                               torch.zeros((), dtype=prof.dtype, device=dev))
            acc = acc + (s[:, :, None] * prof).sum(dim=1)
        # cm^2 -> m^2
        return acc * 1e-4

    def cross_sections(self, wavelengths_nm, altitudes_m=None,
                       pressure_pa=None, temperature_k=None, **kwargs):
        wvn = 1e7 / np.asarray(wavelengths_nm, dtype=np.float64)
        order = np.argsort(wvn)
        xs = self.cross_section_grid(wvn[order], pressure_pa, temperature_k)
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        return xs[:, inv]


def _float_or_nan(text):
    try:
        return float(text)
    except ValueError:
        return float("nan")


def load_hitran_par(path, molar_mass_kg_mol):
    """Parse a HITRAN 160-character .par line file into a LineCatalogue
    (role of the reference's ``optical/line/hitran_loader.rs``). Statistical
    weights g'/g'' live in columns 146:153 / 153:160 of full records and
    feed emission line weighting; short records leave them NaN."""
    nu0, s, aa, ga, gs, na, da, el = [], [], [], [], [], [], [], []
    iso, gp, gpp, qup, qlo = [], [], [], [], []
    with open(path) as f:
        for line in f:
            if len(line) < 100:
                continue
            iso.append(int(line[2:3]) if line[2:3].strip() else 1)
            nu0.append(float(line[3:15]))
            s.append(float(line[15:25]))
            aa.append(float(line[25:35]))
            ga.append(float(line[35:40]))
            gs.append(float(line[40:45]))
            el.append(float(line[45:55]))
            na.append(float(line[55:59]))
            da.append(float(line[59:67]))
            # global upper/lower quanta, HITRAN2004 cols 68-82 / 83-97
            qup.append(line[67:82].strip() if len(line) >= 97 else "")
            qlo.append(line[82:97].strip() if len(line) >= 97 else "")
            gp.append(_float_or_nan(line[146:153]) if len(line) >= 153
                      else float("nan"))
            gpp.append(_float_or_nan(line[153:160]) if len(line) >= 154
                       else float("nan"))
    return LineCatalogue(
        nu0=np.array(nu0), intensity=np.array(s),
        gamma_air=np.array(ga), gamma_self=np.array(gs),
        n_air=np.array(na), delta_air=np.array(da),
        elower=np.array(el), molar_mass=molar_mass_kg_mol,
        einstein_a=np.array(aa), iso_id=np.array(iso, dtype=np.int64),
        g_upper=np.array(gp), g_lower=np.array(gpp),
        quanta_upper=np.array(qup, dtype=object),
        quanta_lower=np.array(qlo, dtype=object),
    )


#: AER line-coupling tabulation temperatures [K]
AER_COUPLING_TEMPS = np.array([200.0, 250.0, 296.0, 340.0])

# HITRAN F100 fixed-width field layout: molec_id, iso, nu, S, R,
# gamma_air, gamma_self, E'', n_air, delta_air, quanta/local-quanta
# fields, error codes, refs
_AER_WIDTHS = np.array([2, 1, 12, 10, 10, 5, 5, 10, 4, 8, 3, 3, 9, 9, 3, 6])
_AER_COLS = np.concatenate(([0], np.cumsum(_AER_WIDTHS)))


def load_aer_line_file(path, molar_mass_kg_mol):
    """Parse an AER line file (HITRAN F100 format with optional
    line-coupling continuation records) into a :class:`LineCatalogue`.

    Coupling records follow lines whose reference field ends in ``-N``;
    they carry first-order line-mixing Y and G at 200/250/296/340 K.
    Fortran ``D`` exponents are accepted.
    """
    nu0, s, ga, gs, na, da, el, iso = [], [], [], [], [], [], [], []
    qup, qlo = [], []
    y_rows, g_rows = [], []
    nan4 = [float("nan")] * 4

    def _f(text):
        return float(text.replace("D", "E").replace("d", "E"))

    with open(path) as f:
        lines = iter(f)
        for line in lines:
            if not line.strip() or line[0] in (">", "%"):
                continue
            fields = [
                line[_AER_COLS[i]:_AER_COLS[i + 1]]
                for i in range(len(_AER_WIDTHS))
            ]
            iso.append(int(fields[1]) if fields[1].strip() else 1)
            nu0.append(_f(fields[2]))
            s.append(_f(fields[3]))
            ga.append(_f(fields[5]))
            gs.append(_f(fields[6]))
            el.append(_f(fields[7]))
            na.append(_f(fields[8]))
            da.append(_f(fields[9]))
            qup.append(fields[10].strip())
            qlo.append(fields[11].strip())
            ref = fields[15]
            if ref[-2:-1] == "-":
                lc = next(lines)
                y_rows.append([_f(lc[3:15]), _f(lc[26:39]),
                               _f(lc[50:63]), _f(lc[74:87])])
                g_rows.append([_f(lc[15:26]), _f(lc[39:50]),
                               _f(lc[63:74]), _f(lc[87:98])])
            else:
                y_rows.append(nan4)
                g_rows.append(nan4)

    y = np.array(y_rows, dtype=np.float64).T  # [4, L]
    g = np.array(g_rows, dtype=np.float64).T
    has_coupling = np.any(np.isfinite(y))
    return LineCatalogue(
        nu0=np.array(nu0), intensity=np.array(s),
        gamma_air=np.array(ga), gamma_self=np.array(gs),
        n_air=np.array(na), delta_air=np.array(da),
        elower=np.array(el), molar_mass=molar_mass_kg_mol,
        iso_id=np.array(iso, dtype=np.int64),
        quanta_upper=np.array(qup, dtype=object),
        quanta_lower=np.array(qlo, dtype=object),
        y_coupling=y if has_coupling else None,
        g_coupling=g if has_coupling else None,
        coupling_temps=AER_COUPLING_TEMPS if has_coupling else None,
    )


#: molar masses [kg/mol] for common AER line-file species
MOLAR_MASS_KG_MOL = {
    "H2O": 18.010565e-3, "CO2": 43.98983e-3, "O3": 47.984745e-3,
    "N2O": 44.001062e-3, "CO": 27.994915e-3, "CH4": 16.0313e-3,
    "O2": 31.98983e-3, "NO": 29.997989e-3, "SO2": 63.961901e-3,
    "NO2": 45.992904e-3, "NH3": 17.026549e-3, "HNO3": 62.995644e-3,
    "N2": 28.006148e-3,
}


class AERLineAbsorber(LineAbsorber):
    """Line-by-line absorber from an AER line file with first-order
    Rosenkranz line mixing enabled. ``source`` is the path to the
    per-molecule AER data file; nothing is fetched."""

    def __init__(self, molecule: str, source, molar_mass_kg_mol=None,
                 **kwargs):
        mm = molar_mass_kg_mol or MOLAR_MASS_KG_MOL.get(molecule.upper())
        if mm is None:
            msg = (
                f"Unknown molar mass for {molecule!r}; pass "
                "molar_mass_kg_mol explicitly"
            )
            raise ValueError(msg)
        cat = load_aer_line_file(source, mm)
        super().__init__(cat, enable_line_coupling=True, **kwargs)
