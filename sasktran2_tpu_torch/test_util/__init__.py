"""Test utilities of the PyTorch port (counterpart of
``sasktran2_tpu/test_util``): canned scenarios, the finite-difference
check of analytic weighting functions (``wf``) and the Zawada et al.
(2021) limb intercomparison harness (``zawada``)."""

from . import wf, zawada
from .scenarios import default_pure_scattering_atmosphere, test_aerosol_constituent

__all__ = [
    "default_pure_scattering_atmosphere",
    "test_aerosol_constituent",
    "wf",
    "zawada",
]
