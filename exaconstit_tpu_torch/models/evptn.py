"""The crystal model definition and the svec/vecd tangent maps.

Port of the production part of ``exaconstit_tpu.models.evptn``: the
``EvptnModel`` dataclass with the fields the production staggered
component-major scheme reads (the reference's experimental knobs and
its vmap engine are not ported), and the constant svec <-> vecd maps the
tangent assembly uses.  The solve itself is ``evptn_cm``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import tensors as tn
from .elasticity import Elasticity
from .eos import EosConst
from .slip_geom import SlipGeom

_B = tn.BASIS_DEV
# M_SVEC_FROM_VECD[:, k] = svec components of basis tensor B_k
M_SVEC_FROM_VECD = np.stack(
    [[_B[k, 0, 0], _B[k, 1, 1], _B[k, 2, 2],
      _B[k, 1, 2], _B[k, 0, 2], _B[k, 0, 1]] for k in range(5)], axis=1)
# M_VECD_FROM_SVEC_ENG[k, :] maps an engineering-shear strain svec
# [e11, e22, e33, 2e23, 2e13, 2e12] to vecd(dev(eps))
M_VECD_FROM_SVEC_ENG = np.stack(
    [[_B[k, 0, 0], _B[k, 1, 1], _B[k, 2, 2],
      _B[k, 1, 2], _B[k, 0, 2], _B[k, 0, 1]] for k in range(5)], axis=0)

IDENT_VOL = np.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])


@dataclasses.dataclass(frozen=True)
class EvptnModel:
    """A crystal model = slip geometry + elasticity + kinetics + EOS, with
    the settings of the staggered sub-incremented point solve.

    One lagged pass per substep: solve (e, xi) against the substep's
    begin hardness, then update the hardness from a blend of the
    converged and begin-of-substep slip rates (``h_gd_blend``; 1 takes
    the converged rates alone, as the MTSDD models do).  The substep
    count is uniform over points, ``floor(dt * rate_ref / substep_cap)``
    clipped to [1, max_substeps], with rate_ref the kinetics' reference
    slip rate.  Under ``mixed_precision`` (the Voce models) the
    trust-region stage runs in f32 to ``fast_tol`` and ``refine_iters``
    f64 Newton steps reusing the stage's final Jacobian polish it;
    without it (MTSDD) the trust region runs in f64 to ``solver_tol``."""

    slip: SlipGeom
    elast: Elasticity
    kinetics: object  # kinetics.VocePL, KMBalD or SplineG
    eos: EosConst
    solver_tol: float = 1e-10
    solver_max_iter: int = 200
    substep_cap: float = 0.1
    max_substeps: int = 8
    h_gd_blend: float = 1.0
    mixed_precision: bool = True
    fast_tol: float = 1e-6
    refine_iters: int = 3

    @property
    def nslip(self):
        return self.slip.nslip

    @property
    def n_h(self):
        return self.kinetics.n_h
