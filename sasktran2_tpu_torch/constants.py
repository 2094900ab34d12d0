"""Physical constants (reference ``src/sasktran2/constants.py``).

(Copy of ``sasktran2_tpu/constants.py`` for the PyTorch port;
``tests/test_torch_host_copies.py`` pins it to the original.)
"""

from __future__ import annotations

K_BOLTZMANN = 1.380649e-23  # J/K
PLANCK = 6.62607015e-34  # J s
SPEED_OF_LIGHT = 299792458.0  # m/s
