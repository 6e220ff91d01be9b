"""Crystal elasticity in the deviatoric 5-vector basis (numpy tables).

Port of ``exaconstit_tpu.models.elasticity`` for the cubic crystals of
this slice; the deviatoric stiffness ``C_dev`` is a constant (5, 5)
table in the crystal frame and the bulk response goes to the EOS.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Elasticity:
    """Deviatoric elastic stiffness in the vecd basis + bulk modulus."""

    C_dev: np.ndarray  # (5, 5) crystal frame
    bulk: float


def cubic(c11: float, c12: float, c44: float) -> Elasticity:
    """Cubic crystal: vecd stiffness diag(c11-c12, c11-c12, 2c44 x3)."""
    d = np.diag([c11 - c12, c11 - c12, 2 * c44, 2 * c44,
                 2 * c44]).astype(float)
    return Elasticity(C_dev=d, bulk=(c11 + 2.0 * c12) / 3.0)
