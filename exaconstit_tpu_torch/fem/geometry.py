"""Geometric factors and field gradients, component-major.

Port of the ``*_cm`` functions of ``exaconstit_tpu.fem.geometry``: the
(nq, ne) batch axes are LAST everywhere.  Updated-Lagrangian: the
Jacobians are recomputed from the current coordinates every Newton
iteration.
"""

from __future__ import annotations

import torch


def jacobians_cm(el_x_cm, dshape):
    """el_x_cm (3, nen, ne), dshape (nq, nen, 3) -> J (3, 3, nq, ne),
    J[i, j] = dx_i/dxi_j."""
    return torch.einsum("ine,qnj->ijqe", el_x_cm, dshape)


def det_3x3_cm(J):
    """det of (3, 3, ...) component-major matrices."""
    return (J[0, 0] * (J[1, 1] * J[2, 2] - J[2, 1] * J[1, 2])
            - J[1, 0] * (J[0, 1] * J[2, 2] - J[2, 1] * J[0, 2])
            + J[2, 0] * (J[0, 1] * J[1, 2] - J[1, 1] * J[0, 2]))


def adjugate_3x3_cm(J):
    """adj(J) for (3, 3, ...) component-major matrices (J adj = det I)."""
    rows = [
        [J[1, 1] * J[2, 2] - J[1, 2] * J[2, 1],
         J[2, 1] * J[0, 2] - J[0, 1] * J[2, 2],
         J[0, 1] * J[1, 2] - J[1, 1] * J[0, 2]],
        [J[2, 0] * J[1, 2] - J[1, 0] * J[2, 2],
         J[0, 0] * J[2, 2] - J[0, 2] * J[2, 0],
         J[1, 0] * J[0, 2] - J[0, 0] * J[1, 2]],
        [J[1, 0] * J[2, 1] - J[2, 0] * J[1, 1],
         J[2, 0] * J[0, 1] - J[0, 0] * J[2, 1],
         J[0, 0] * J[1, 1] - J[0, 1] * J[1, 0]],
    ]
    return torch.stack([torch.stack(r) for r in rows])


def grad_calc_cm(el_field_cm, dshape, adj, detj):
    """Spatial gradient L[i, j] = df_i/dx_j, (3, 3, nq, ne), of a nodal
    field (3, nen, ne) given adj(J) (3, 3, nq, ne) and det J (nq, ne)."""
    g = torch.einsum("ine,qns,sjqe->ijqe", el_field_cm, dshape, adj)
    return g / detj[None, None]
