"""Mie scattering on the device (torch, complex128 / float64).

Torch counterpart of ``sasktran2_tpu/optical/mie.py``: the D_n downward
recurrence from nmax + 15 and the Riccati-Bessel psi / chi upward
recurrences (chi clamped to +-1e250, so that the small-x members of a
batch whose nmax is set by its largest member stay finite) run as Python
loops over the multipole order with the size-parameter batch as the
vector axis. nmax is the reference's, taken per call from the largest
size parameter (one host sync per call).

Conventions (Bohren & Huffman): an, bn multipole coefficients;
Qext = 2/x^2 sum (2n+1) Re(an+bn); S1/S2 amplitude functions via the
pi_n/tau_n angular functions.

``mie_coefficients(..., own_nmax=True)`` starts each member's D_n
recurrence from that member's own nmax + 15 and drops its terms above
its own nmax, which makes each member the reference's call on that
member alone; ``integrate_mie`` uses it. The reference's
batch call keeps the terms up to the batch's nmax, and for a member far
below the batch's largest size parameter its unclamped psi recurrence
then loses the member: a wrong value or NaN (x = 0.007 and 0.01 beside
60). A lognormal of median radius 200 nm and mode
width 1.7 at 750 nm puts radii from 0.01 nm to 7.4 um in one call: the
reference's ``integrate_mie`` gives NaN and raises there. Without
``own_nmax`` the port computes what the reference's batch call computes,
which ``compute_mie``, ``mie_efficiencies`` and ``mie_amplitudes`` copy.
The two differ beyond the dropped terms: with ``own_nmax`` a large
member's D_n recurrence starts from its own nmax + 15, closer to |m x|
than the batch's start, and the member comes out as the reference's call
on it alone, not as the reference's batch (``tests/test_torch_mie.py``
holds both).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _nmax_for(x_max: float) -> int:
    return int(np.ceil(x_max + 4.05 * x_max ** (1.0 / 3.0) + 2.0)) + 1


def _complex_dtype(real_dtype):
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def mie_coefficients(x, m, nmax: int | None = None, own_nmax=False):
    """Mie an/bn for a batch of size parameters.

    x : [...] real size parameters (> 0), a tensor
    m : complex refractive index (scalar or broadcastable to x)
    own_nmax : zero each member's terms above its own nmax (the
        reference's formula applied per member)
    Returns (an, bn) each [..., nmax] complex.
    """
    x = torch.as_tensor(x)
    cdtype = _complex_dtype(x.dtype)
    if nmax is None:
        nmax = _nmax_for(float(x.max()))
    m = torch.as_tensor(m, dtype=cdtype, device=x.device)
    mx = m * x.to(cdtype)
    # each member's own nmax (the reference's formula per member)
    own = (torch.ceil(x + 4.05 * x ** (1.0 / 3.0) + 2.0) + 1.0
           if own_nmax else None)

    # downward recurrence D_{n-1} = n/mx - 1/(D_n + n/mx) from D_nstart = 0;
    # keep D_1..D_nmax. With own_nmax each member starts from its own
    # nstart (D stays 0 above it), as the member alone would.
    nstart = nmax + 15
    d = torch.zeros_like(mx)
    d_kept = [None] * nmax
    for n in range(nstart, 0, -1):
        rn = float(n) / mx
        d_next = rn - 1.0 / (d + rn)
        d = d_next if own is None else torch.where(n <= own + 15.0, d_next, d)
        if 1 <= n - 1 <= nmax:
            d_kept[n - 2] = d
    d_n = torch.stack(d_kept, dim=-1)  # D_1..D_nmax [..., nmax]

    # upward recurrences for psi_n(x), chi_n(x)
    p_prev, p_curr = torch.cos(x), torch.sin(x)     # psi_{-1}, psi_0
    c_prev, c_curr = -torch.sin(x), torch.cos(x)    # chi_{-1}, chi_0
    psi_0, chi_0 = p_curr, c_curr
    psis, chis = [], []
    for n in range(1, nmax + 1):
        fac = (2.0 * n - 1.0) / x
        p_next = fac * p_curr - p_prev
        # chi_n grows like (2n-1)!!/x^n for n >> x; clamped, the xi enters
        # only the a_n/b_n denominators, which then give ~0
        c_next = torch.clamp(fac * c_curr - c_prev, -1e250, 1e250)
        p_prev, p_curr, c_prev, c_curr = p_curr, p_next, c_curr, c_next
        psis.append(p_next)
        chis.append(c_next)
    psi = torch.stack(psis, dim=-1)  # psi_1..psi_nmax
    chi = torch.stack(chis, dim=-1)
    psi_nm1 = torch.cat([psi_0[..., None], psi[..., :-1]], dim=-1)
    chi_nm1 = torch.cat([chi_0[..., None], chi[..., :-1]], dim=-1)

    xi = torch.complex(psi, -chi)
    xi_nm1 = torch.complex(psi_nm1, -chi_nm1)

    nvec = torch.arange(1, nmax + 1, dtype=x.dtype, device=x.device)
    nx = (nvec / x[..., None]).to(cdtype)
    da = d_n / m + nx
    db = d_n * m + nx
    psi_c, psi_nm1_c = psi.to(cdtype), psi_nm1.to(cdtype)
    an = (da * psi_c - psi_nm1_c) / (da * xi - xi_nm1)
    bn = (db * psi_c - psi_nm1_c) / (db * xi - xi_nm1)
    if own is None:
        return an, bn
    # the terms above each member's own nmax are dropped, finite or not
    keep = nvec <= own[..., None]
    zero = torch.zeros((), dtype=cdtype, device=x.device)
    return torch.where(keep, an, zero), torch.where(keep, bn, zero)


def efficiencies_from_coefficients(x, an, bn):
    """(Qext, Qsca) from the multipole coefficients of size parameters x."""
    n = torch.arange(1, an.shape[-1] + 1, dtype=x.dtype, device=x.device)
    two_np1 = 2.0 * n + 1.0
    qext = 2.0 / (x * x) * (two_np1 * (an + bn).real).sum(dim=-1)
    qsca = 2.0 / (x * x) * (
        two_np1 * (an.abs() ** 2 + bn.abs() ** 2)
    ).sum(dim=-1)
    return qext, qsca


def mie_efficiencies(x, m, nmax: int | None = None):
    """(Qext, Qsca) for a batch of size parameters."""
    x = torch.as_tensor(x)
    an, bn = mie_coefficients(x, m, nmax)
    return efficiencies_from_coefficients(x, an, bn)


def _pi_tau(cos_theta, nmax):
    """Angular functions pi_n, tau_n for n = 1..nmax: [..., nmax]."""
    mu = torch.as_tensor(cos_theta)
    pi_nm1, pi_n = torch.zeros_like(mu), torch.ones_like(mu)
    pis, taus = [], []
    for n in range(1, nmax + 1):
        n = float(n)
        # pi_{n+1} = ((2n+1) mu pi_n - (n+1) pi_{n-1}) / n
        pi_np1 = ((2 * n + 1) * mu * pi_n - (n + 1) * pi_nm1) / n
        tau_n = n * mu * pi_n - (n + 1) * pi_nm1
        pis.append(pi_n)
        taus.append(tau_n)
        pi_nm1, pi_n = pi_n, pi_np1
    return torch.stack(pis, dim=-1), torch.stack(taus, dim=-1)


def amplitudes_from_coefficients(x, an, bn, cos_theta):
    """S1, S2 [B, T] from the coefficients [B, nmax] at cos_theta [T]: two
    complex matrix products over the multipole order."""
    nmax = an.shape[-1]
    pi_n, tau_n = _pi_tau(torch.as_tensor(cos_theta), nmax)  # [T, n]
    n = torch.arange(1, nmax + 1, dtype=x.dtype, device=x.device)
    fac = (2.0 * n + 1.0) / (n * (n + 1.0))
    pi_c, tau_c = pi_n.to(an.dtype).T, tau_n.to(an.dtype).T  # [n, T]
    af, bf = an * fac, bn * fac
    s1 = af @ pi_c + bf @ tau_c
    s2 = af @ tau_c + bf @ pi_c
    return s1, s2


def mie_amplitudes(x, m, cos_theta, nmax: int | None = None):
    """Scattering amplitudes S1, S2 at the given angles.

    x: [B] size parameters; cos_theta: [T]; returns S1, S2 [B, T] complex.
    """
    x = torch.as_tensor(x)
    an, bn = mie_coefficients(x, m, nmax)
    return amplitudes_from_coefficients(x, an, bn, cos_theta)


class MieOutput:
    """Container mirroring the reference's Mie output surface (numpy)."""

    def __init__(self, size_parameter, Qext, Qsca, S1=None, S2=None):
        self.size_parameter = np.asarray(size_parameter)
        self.Qext = np.asarray(Qext)
        self.Qsca = np.asarray(Qsca)
        self.S1 = None if S1 is None else np.asarray(S1)
        self.S2 = None if S2 is None else np.asarray(S2)


def compute_mie(size_parameters, refractive_index, cos_angles=None,
                device=None):
    """User-facing Mie evaluation on ``device`` (None: the GPU)."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.atleast_1d(size_parameters), dtype=torch.float64,
                        device=dev)
    an, bn = mie_coefficients(x, refractive_index)
    qext, qsca = efficiencies_from_coefficients(x, an, bn)
    s1 = s2 = None
    if cos_angles is not None:
        mu = torch.as_tensor(np.asarray(cos_angles, dtype=np.float64),
                             device=dev)
        s1, s2 = amplitudes_from_coefficients(x, an, bn, mu)
        s1, s2 = s1.cpu().numpy(), s2.cpu().numpy()
    return MieOutput(size_parameters, qext.cpu().numpy(), qsca.cpu().numpy(),
                     s1, s2)
