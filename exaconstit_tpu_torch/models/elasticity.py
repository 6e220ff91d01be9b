"""Crystal elasticity in the deviatoric 5-vector basis (numpy tables).

Port of ``exaconstit_tpu.models.elasticity`` (cubic and hexagonal
crystals); the deviatoric stiffness ``C_dev`` is a constant (5, 5)
table in the crystal frame and the bulk response goes to the EOS.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.tensors import BASIS_DEV


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


def hexagonal(c11: float, c12: float, c13: float, c33: float,
              c44: float) -> Elasticity:
    """Hexagonal crystal (c axis along z): the full Voigt stiffness
    projected onto the deviatoric vecd basis, keeping the coupling of the
    two diagonal deviatoric modes.  c66 = (c11 - c12) / 2."""
    c66 = 0.5 * (c11 - c12)
    # full 6x6 stiffness in svec order [11,22,33,23,13,12], tensor strains
    C = np.zeros((6, 6))
    C[0, 0] = C[1, 1] = c11
    C[2, 2] = c33
    C[0, 1] = C[1, 0] = c12
    C[0, 2] = C[2, 0] = C[1, 2] = C[2, 1] = c13
    C[3, 3] = 2 * c44
    C[4, 4] = 2 * c44
    C[5, 5] = 2 * c66
    # vecd basis tensor k as tensor-strain svec components
    basis_svec = np.stack([
        [B[0, 0], B[1, 1], B[2, 2], B[1, 2], B[0, 2], B[0, 1]]
        for B in BASIS_DEV])
    sig = basis_svec @ C.T  # (5, 6): C : B_k
    # C_dev[l, k] = B_l : (C : B_k); shear entries count twice in the dot
    w = np.array([1.0, 1, 1, 2, 2, 2])
    C_dev = np.einsum("ls,s,ks->lk", basis_svec, w, sig)
    bulk = (2.0 * (c11 + c12) + 4.0 * c13 + c33) / 9.0
    return Elasticity(C_dev=C_dev, bulk=bulk)
