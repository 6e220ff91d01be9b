"""Reference-element shape functions and quadrature for hexahedra.

H1 Lagrange elements of arbitrary order on the [0,1]^3 reference cube with
lexicographic tensor node ordering, and tensor Gauss-Legendre quadrature of
order ``2*p + 1`` (p+1 points per direction) — the integration rule the
reference uses everywhere (``intOrder = 2*order + 1``,
src/mechanics_driver.cpp:433, src/mechanics_integrators.cpp:59).

Tables are computed once with numpy (host) and used as constants inside
jitted computations.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..mesh.voxel import lobatto_points


def gauss_legendre_01(n: int):
    """n-point Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def lagrange_basis_1d(nodes: np.ndarray, x: np.ndarray):
    """Values and derivatives of the Lagrange basis at points x.

    Returns (vals, ders) with shape (len(x), len(nodes)).
    """
    n = len(nodes)
    m = len(x)
    vals = np.ones((m, n))
    ders = np.zeros((m, n))
    for i in range(n):
        for j in range(n):
            if j == i:
                continue
            vals[:, i] *= (x - nodes[j]) / (nodes[i] - nodes[j])
        # derivative by sum-over-missing-factor
        for k in range(n):
            if k == i:
                continue
            term = np.ones(m) / (nodes[i] - nodes[k])
            for j in range(n):
                if j == i or j == k:
                    continue
                term *= (x - nodes[j]) / (nodes[i] - nodes[j])
            ders[:, i] += term
    return vals, ders


@dataclasses.dataclass(frozen=True)
class RefElement:
    """Shape-function tables for an order-p hex element."""

    order: int
    qpts: np.ndarray  # (nqpts, 3) quadrature points in [0,1]^3
    qwts: np.ndarray  # (nqpts,)
    shape: np.ndarray  # (nqpts, nnodes) N_a(xi_q)
    dshape: np.ndarray  # (nqpts, nnodes, 3) dN_a/dxi_j at xi_q

    @property
    def nqpts(self):
        return self.qpts.shape[0]

    @property
    def nnodes(self):
        return self.shape.shape[1]


@functools.lru_cache(maxsize=8)
def ref_element(order: int) -> RefElement:
    p = order
    nodes1d = lobatto_points(p)
    nq1 = p + 1  # points for exactness of order 2p+1
    q1, w1 = gauss_legendre_01(nq1)
    v1, d1 = lagrange_basis_1d(nodes1d, q1)  # (nq1, p+1)

    # tensor products, both qpts and nodes lexicographic (x fastest)
    nq = nq1 ** 3
    nn = (p + 1) ** 3
    qpts = np.empty((nq, 3))
    qwts = np.empty(nq)
    shape = np.empty((nq, nn))
    dshape = np.empty((nq, nn, 3))
    iq = 0
    for kz in range(nq1):
        for ky in range(nq1):
            for kx in range(nq1):
                qpts[iq] = (q1[kx], q1[ky], q1[kz])
                qwts[iq] = w1[kx] * w1[ky] * w1[kz]
                ia = 0
                for az in range(p + 1):
                    for ay in range(p + 1):
                        for ax in range(p + 1):
                            shape[iq, ia] = v1[kx, ax] * v1[ky, ay] * v1[kz, az]
                            dshape[iq, ia, 0] = d1[kx, ax] * v1[ky, ay] * v1[kz, az]
                            dshape[iq, ia, 1] = v1[kx, ax] * d1[ky, ay] * v1[kz, az]
                            dshape[iq, ia, 2] = v1[kx, ax] * v1[ky, ay] * d1[kz, az]
                            ia += 1
                iq += 1
    return RefElement(order=p, qpts=qpts, qwts=qwts, shape=shape,
                      dshape=dshape)
