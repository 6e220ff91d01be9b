"""The Voce material's inputs: a frozen copy.

Copied from ``exaconstit_tpu_torch/cases.py`` (its ``VOCE_PROPS`` and the
Voce parts of its options file) so that a change to the program cannot
change what the benchmark feeds it.  The material is the copper FCC
crystal with power-law slip and Voce hardening of ExaConstit's
``test/data/voce_full.toml``, ``voce_ea.toml`` and ``voce_pa.toml``.

A material's input module holds what ``cases.write_case`` writes for it
(the names of ``cases.MATERIAL_NAMES["inputs"]``): the props and initial
state vectors and ExaCMech's crystal and slip types.
"""

from __future__ import annotations

import numpy as np

# ExaCMech's order; the third value is the point solve's tolerance
PROPS = np.array([
    8.920e-6, 0.003435984, 1.0e-10,      # rho0, cv, solver tol
    168.4, 121.4, 75.2,                  # c11, c12, c44 (GPa)
    44.0, 0.02, 1.0,                     # mu, m, gdot_0
    400.0e-3, 17.0e-3, 122.4e-3,         # h0, g0, gs0
    0.0, 5.0e9, 17.0e-3,                 # xms, gam_s, hdn_init
    0.0, -1.0307952,                     # gruneisen, ref energy
])
# the state file's values (its length is the options file's num_vars)
INITIAL_STATE = np.zeros(24)
# [Model.ExaCMech]
XTAL_TYPE = "fcc"
SLIP_TYPE = "powervoce"
