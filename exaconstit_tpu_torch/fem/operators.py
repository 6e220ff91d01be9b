"""Mechanics operator, component-major.

Port of ``exaconstit_tpu.fem.operators``: the ``*_cm`` functions of the
EA path, and the point-major PA and B-bar functions rewritten with the
batch axes last like them:

* residual (internal force) F[i, a, e] = sum_q w dN_a/dx_j sigma_ji detJ;
* element-assembled (EA) stiffness blocks K (ndof, ndof, ne), dof =
  node*3 + comp, K[(a,i),(b,k)] = sum_q w dt detJ dN_a/dx_j C4[i,j,k,l]
  dN_b/dx_l with the 6x6 engineering-shear tangent expanded to the
  un-symmetrized C4;
* the EA matvec (``apply_ea``: on the card the kernel pair of
  ``ea_apply_cuda`` on the strided map of an order-1 brick, else the
  plain form), the masked apply (``masked_apply``) and the EA diagonal
  (the Jacobi preconditioner);
* partial assembly (PA): the per-point tensor D[i,s,k,t] = (w dt/detJ)
  adj[s,j] C4[i,j,k,l] adj[t,l], its matvec through the reference shape
  gradients, and the diagonal without forming EA blocks;
* B-bar (mean dilatation): the volumetric part of the B operator
  replaced by its element average, in the residual and in EA blocks of
  the same (ndof, ndof, ne) layout (the EA matvec and diagonal serve
  them).

Layouts: el_x / el_u (3, nen, ne); stress (6, nq, ne); c6 (6, 6, nq, ne);
the PA tensor (3, 3, 3, 3, nq, ne); shape gradients dndx (nen, 3, nq, ne).

The setup's contractions (the residual, the shape gradients, the EA
build) are fixed-order elementwise sums (``utils.tensors.fixed_dot``):
an element's outputs are computed by the same operations whatever the
batch of elements around it, so that a setup chunk, or one shard, gives
the whole mesh's or the stack's values bit for bit.  The card's f32
GEMMs, which ``einsum`` would call, round with the batch size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tensors import fixed_dot
from . import ea_apply_cuda
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


def _adj_gradients_cm(dshape, adj):
    """b[a, j, q, e] = sum_s dN_a/dxi_s adj[s, j]: detJ times the spatial
    shape gradients, (nen, 3, nq, ne)."""
    ds = dshape.permute(1, 0, 2)  # (nen, nq, 3)
    return fixed_dot((ds[:, None, :, s, None], adj[None, s])
                     for s in range(3))


def residual_force_cm(el_x_cm, dshape, qwts, stress_cm):
    """Internal nodal forces per element, (3, nen, ne): f[i, a, e] =
    sum_q w_q sum_j b[a, j, q] sigma[j, i, q], summed over (q, j) in
    order."""
    b = _adj_gradients_cm(dshape, adjugate_3x3_cm(jacobians_cm(el_x_cm,
                                                               dshape)))
    sig = svec_to_mat33_cm(stress_cm)  # (3, 3, nq, ne)
    wb = b * qwts[None, None, :, None]
    return fixed_dot((sig[j, :, q, None, :], wb[None, :, j, q])
                     for q in range(b.shape[2]) for j in range(3))


def _dndx_and_wts_cm(el_x_cm, dshape, qwts):
    J = jacobians_cm(el_x_cm, dshape)
    det = det_3x3_cm(J)  # (nq, ne)
    dndx = _adj_gradients_cm(dshape, adjugate_3x3_cm(J)) / det[None, None]
    return dndx, det * qwts[:, None]


def assemble_ea_gradient_cm(el_x_cm, dshape, qwts, c6_cm, dt):
    """Per-element stiffness (ndof, ndof, ne) by nodal 3x3 blocks:
    K_ik[a, b] = sum_{l,q} w T_ik[a, l] dndx[b, l] with
    T_ik[a, l] = sum_j dndx[a, j] c6[voigt(i,j), voigt(k,l)], one block
    row i at a time."""
    dndx, wts = _dndx_and_wts_cm(el_x_cm, dshape, qwts)  # (nen,3,q,e)
    w = wts * dt
    nen, _, nq, ne = dndx.shape
    voigt = torch.as_tensor(_VOIGT, device=c6_cm.device)
    K = dndx.new_empty((nen, 3, nen, 3, ne))  # [(a, i), (b, k)]
    for i in range(3):
        # wT[k, a, l, q, e] = w T_ik[a, l] for the three k of row i
        wT = fixed_dot((dndx[None, :, j, None],
                        c6_cm[_VOIGT[i, j]][voigt][:, None])
                       for j in range(3)) * w
        row = fixed_dot((wT[:, :, ell, q, None], dndx[None, None, :, ell, q])
                        for ell in range(3) for q in range(nq))
        K[:, i] = row.permute(1, 2, 0, 3)  # (k, a, b, e) -> (a, b, k, e)
    return K.reshape(nen * 3, nen * 3, ne)


def apply_ea_gradient_cm(k_cm, el_u_cm):
    """y[i, a, e] = sum_b K[(a,i), b] u[b] per element."""
    nen = el_u_cm.shape[1]
    u = el_u_cm.transpose(0, 1).reshape(nen * 3, -1)  # (ndof, ne)
    y = torch.einsum("abe,be->ae", k_cm, u)
    return y.reshape(nen, 3, -1).transpose(0, 1)


def apply_ea(k_cm, emap, x):
    """y = K x of the flat nodal field x over the element map ``emap``
    with the EA blocks.  On the card, on the strided map of an order-1
    brick with contiguous blocks, the hand-written kernel pair
    (``ea_apply_cuda.ea_apply``, which reads the blocks in place);
    elsewhere the plain form, ``apply_ea_plain``."""
    if ea_apply_cuda.engages(k_cm, emap, x):
        return ea_apply_cuda.ea_apply(k_cm, emap, x)
    return apply_ea_plain(k_cm, emap, x)


def apply_ea_plain(k_cm, emap, x):
    """``apply_ea``'s plain form: the blocks cast to x's dtype, the
    map's gather, the batched contraction and the map's scatter."""
    return emap.scatter_add(apply_ea_gradient_cm(k_cm.to(x.dtype),
                                                 emap.gather(x)))


def masked_apply(apply, x, ess, identity=True):
    """apply(x) with the essential dofs' columns taken out (x's entries
    there zeroed) and their rows replaced by identity rows, which take x's
    entries, or (``identity`` False: the GMG coarse levels) by zero rows."""
    xm = torch.where(ess, 0.0, x)
    return torch.where(ess, x if identity else xm, apply(xm))


def ea_diagonal_cm(k_cm, nen):
    """Per-element diagonal (3, nen, ne) of the EA blocks."""
    d = torch.diagonal(k_cm, dim1=0, dim2=1).T  # (ndof, ne)
    return d.reshape(nen, 3, -1).transpose(0, 1)


def quad_point_volumes_cm(el_x_cm, dshape, qwts):
    """detJ * w at each quadrature point (nq, ne)."""
    return det_3x3_cm(jacobians_cm(el_x_cm, dshape)) * qwts[:, None]


# -- partial assembly -------------------------------------------------------


def c6_to_c4_cm(c6_cm):
    """(6, 6, ...) -> the un-symmetrized (3, 3, 3, 3, ...) C4[i,j,k,l] =
    C6[voigt(i,j), voigt(k,l)]."""
    v = torch.as_tensor(_VOIGT, device=c6_cm.device)
    return c6_cm[v[:, :, None, None], v[None, None, :, :]]


def _pa_geometry(el_x_cm, dshape, qwts, dt):
    J = jacobians_cm(el_x_cm, dshape)
    return adjugate_3x3_cm(J), (qwts[:, None] * dt) / det_3x3_cm(J)


def assemble_pa_gradient_cm(el_x_cm, dshape, qwts, c6_cm, dt):
    """The PA tensor D (3, 3, 3, 3, nq, ne), D[i,s,k,t] = (w dt/detJ)
    sum_{j,l} adj[s,j] C4[i,j,k,l] adj[t,l], contiguous (element
    fastest: the einsum leaves it point-major, and the scaling writes it
    out in this order at no extra memory)."""
    adj, scale = _pa_geometry(el_x_cm, dshape, qwts, dt)
    t = torch.einsum("sjqe,ijklqe->isklqe", adj, c6_to_c4_cm(c6_cm))
    d = torch.einsum("isklqe,tlqe->isktqe", t, adj)
    return torch.mul(d, scale, out=d.new_empty(d.shape))


def apply_pa_gradient_cm(d_pa, dshape, el_u_cm):
    """y[i, a, e] = sum_{q,s} dN_a/dxi_s sum_{k,t} D[i,s,k,t] h[k,t] with
    h[k,t] = sum_b u[k,b] dN_b/dxi_t, per point."""
    nq, ne = d_pa.shape[4:]
    h = torch.einsum("kbe,qbt->ktqe", el_u_cm, dshape)
    t = (d_pa.reshape(9, 9, nq, ne) * h.reshape(1, 9, nq, ne)).sum(dim=1)
    return torch.einsum("qas,isqe->iae", dshape, t.reshape(3, 3, nq, ne))


def pa_diagonal_cm(el_x_cm, dshape, qwts, c6_cm, dt):
    """Assembled diagonal (3, nen, ne) without EA blocks: diag[i, a] =
    sum_q (w dt/detJ) b[a,s] C4[i,s,i,t] b[a,t], b = dshape adj."""
    adj, scale = _pa_geometry(el_x_cm, dshape, qwts, dt)
    b = torch.einsum("qar,rsqe->asqe", dshape, adj)
    c4 = c6_to_c4_cm(c6_cm)
    c4ii = torch.stack([c4[i, :, i] for i in range(3)])  # (3, 3, 3, q, e)
    return torch.einsum("qe,asqe,istqe,atqe->iae", scale, b, c4ii, b)


# -- B-bar (mean dilatation) ------------------------------------------------


def bbar_mean_gradient_cm(dndx, wts):
    """Element-averaged shape gradients eDS (nen, 3, ne) from the point
    gradients (nen, 3, nq, ne) and volumes (nq, ne)."""
    return torch.einsum("qe,ajqe->aje", wts, dndx) / torch.sum(wts, dim=0)


def residual_force_bbar_cm(el_x_cm, dshape, qwts, stress_cm):
    """Internal forces (3, nen, ne) with the B-bar operator:
    f[i, a] = sum_q w detJ [dN_a/dx_j sig_ji + (eDS_ai - dN_a/dx_i)
    tr(sig)/3]."""
    dndx, wts = _dndx_and_wts_cm(el_x_cm, dshape, qwts)
    eds = bbar_mean_gradient_cm(dndx, wts)
    sig = svec_to_mat33_cm(stress_cm)
    f_std = torch.einsum("qe,ajqe,jiqe->iae", wts, dndx, sig)
    tr = stress_cm[0] + stress_cm[1] + stress_cm[2]
    dcorr = eds[:, :, None] - dndx  # (nen, 3, nq, ne)
    f_cor = torch.einsum("qe,qe,aiqe->iae", wts, tr / 3.0, dcorr)
    return f_std + f_cor


def bbar_matrices_cm(dndx, eds):
    """B-bar matrices (6, nen*3, nq, ne): svec rows with engineering
    shear, dofs node-major (a*3 + i)."""
    nen, _, nq, ne = dndx.shape
    c = (eds[:, :, None] - dndx) / 3.0  # (nen, 3, nq, ne)
    B = dndx.new_zeros((6, nen, 3, nq, ne))
    for r in range(3):
        B[r] = c
        B[r, :, r] += dndx[:, r]
    dx, dy, dz = dndx[:, 0], dndx[:, 1], dndx[:, 2]
    B[3, :, 1], B[3, :, 2] = dz, dy
    B[4, :, 0], B[4, :, 2] = dz, dx
    B[5, :, 0], B[5, :, 1] = dy, dx
    return B.reshape(6, nen * 3, nq, ne)


def assemble_ea_gradient_bbar_cm(el_x_cm, dshape, qwts, c6_cm, dt):
    """Per-element B-bar stiffness (ndof, ndof, ne): B^T (C dt w) B."""
    dndx, wts = _dndx_and_wts_cm(el_x_cm, dshape, qwts)
    B = bbar_matrices_cm(dndx, bbar_mean_gradient_cm(dndx, wts))
    cb = torch.einsum("mnqe,nbqe->mbqe", c6_cm, B)
    return torch.einsum("qe,maqe,mbqe->abe", wts * dt, B, cb)


def bbar_vgrad_correction_cm(el_v_cm, dndx, wts):
    """Mean-dilatation velocity gradient (3, 3, nq, ne): the volumetric
    part of L at each point replaced by its element average."""
    L = torch.einsum("kne,njqe->kjqe", el_v_cm, dndx)
    tr_q = L[0, 0] + L[1, 1] + L[2, 2]
    tr_avg = torch.einsum("qe,qe->e", wts, tr_q) / torch.sum(wts, dim=0)
    corr = (tr_avg - tr_q) / 3.0
    eye = torch.eye(3, dtype=L.dtype, device=L.device)
    return L + corr * eye[:, :, None, None]
