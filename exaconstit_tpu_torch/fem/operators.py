"""Mechanics operator on the component-major EA path.

Port of the ``*_cm`` part of ``exaconstit_tpu.fem.operators``:

* residual (internal force) F[i, a, e] = sum_q w dN_a/dx_j sigma_ji detJ;
* element-assembled (EA) stiffness blocks K (ndof, ndof, ne), dof =
  node*3 + comp, K[(a,i),(b,k)] = sum_q w dt detJ dN_a/dx_j C4[i,j,k,l]
  dN_b/dx_l with the 6x6 engineering-shear tangent expanded to the
  un-symmetrized C4;
* the EA matvec and the EA diagonal (the Jacobi preconditioner).

Layouts: el_x / el_u (3, nen, ne); stress (6, nq, ne); c6 (6, 6, nq, ne).
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import adjugate_3x3_cm, det_3x3_cm, jacobians_cm

# Voigt index pairs in svec order [11, 22, 33, 23, 13, 12]
_VOIGT = np.zeros((3, 3), dtype=int)
_VOIGT[0, 0], _VOIGT[1, 1], _VOIGT[2, 2] = 0, 1, 2
_VOIGT[1, 2] = _VOIGT[2, 1] = 3
_VOIGT[0, 2] = _VOIGT[2, 0] = 4
_VOIGT[0, 1] = _VOIGT[1, 0] = 5


def svec_to_mat33_cm(stress_cm):
    """(6, ...) svec -> (3, 3, ...) full symmetric tensor."""
    return stress_cm[torch.as_tensor(_VOIGT, device=stress_cm.device)]


def residual_force_cm(el_x_cm, dshape, qwts, stress_cm):
    """Internal nodal forces per element, (3, nen, ne): f[i, a, e]."""
    adj = adjugate_3x3_cm(jacobians_cm(el_x_cm, dshape))
    sig = svec_to_mat33_cm(stress_cm)  # (3, 3, nq, ne)
    return torch.einsum("q,qas,sjqe,jiqe->iae", qwts, dshape, adj, sig)


def _dndx_and_wts_cm(el_x_cm, dshape, qwts):
    J = jacobians_cm(el_x_cm, dshape)
    adj = adjugate_3x3_cm(J)
    det = det_3x3_cm(J)  # (nq, ne)
    dndx = torch.einsum("qns,sjqe->njqe", dshape, adj) / det[None, None]
    return dndx, det * qwts[:, None]


def assemble_ea_gradient_cm(el_x_cm, dshape, qwts, c6_cm, dt):
    """Per-element stiffness (ndof, ndof, ne) by nodal 3x3 blocks:
    K_ik[a, b] = sum_{q,l} w T[a, l] dndx[b, l] with
    T[a, l] = sum_j dndx[a, j] c6[voigt(i,j), voigt(k,l)]."""
    dndx, wts = _dndx_and_wts_cm(el_x_cm, dshape, qwts)  # (nen,3,q,e)
    w = (wts * dt)[None, None]
    nen = dndx.shape[0]
    blocks = []
    for i in range(3):
        row = []
        for k in range(3):
            T = torch.stack([
                sum(dndx[:, j] * c6_cm[_VOIGT[i, j], _VOIGT[k, ell]]
                    for j in range(3))
                for ell in range(3)], dim=1)  # (nen, 3, nq, ne)
            row.append(torch.einsum("alqe,blqe->abe", w * T, dndx))
        blocks.append(torch.stack(row))
    k9 = torch.stack(blocks)  # (3, 3, nen, nen, ne)
    return k9.permute(2, 0, 3, 1, 4).reshape(nen * 3, nen * 3, -1)


def apply_ea_gradient_cm(k_cm, el_u_cm):
    """y[i, a, e] = sum_b K[(a,i), b] u[b] per element."""
    nen = el_u_cm.shape[1]
    u = el_u_cm.transpose(0, 1).reshape(nen * 3, -1)  # (ndof, ne)
    y = torch.einsum("abe,be->ae", k_cm, u)
    return y.reshape(nen, 3, -1).transpose(0, 1)


def ea_diagonal_cm(k_cm, nen):
    """Per-element diagonal (3, nen, ne) of the EA blocks."""
    d = torch.diagonal(k_cm, dim1=0, dim2=1).T  # (ndof, ne)
    return d.reshape(nen, 3, -1).transpose(0, 1)


def quad_point_volumes_cm(el_x_cm, dshape, qwts):
    """detJ * w at each quadrature point (nq, ne)."""
    return det_3x3_cm(jacobians_cm(el_x_cm, dshape)) * qwts[:, None]
