"""Plain finite-element pieces of the reference: mesh, trilinear hex
shape functions, velocity gradients, internal forces and averages.

Point-major (element, quadrature point, ...) einsums in float64, written
from the element's definition: order-1 Lagrange hexahedra on [0, 1]^3
with local nodes lexicographic (x fastest) and the 2 x 2 x 2
Gauss-Legendre rule, points lexicographic too.  Updated Lagrangian: the
gradients are taken at the end-of-step coordinates.  Imports nothing of
the program.
"""

from __future__ import annotations

import numpy as np
import torch

from ..inputs.cases import brick

_G = (0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0))


def shape_gradients():
    """dN_a/dxi_j at the 8 Gauss points, (8 points, 8 nodes, 3), and the
    weights (8,)."""
    ds = np.zeros((8, 8, 3))
    for q in range(8):
        xi = (_G[q & 1], _G[(q >> 1) & 1], _G[(q >> 2) & 1])
        for a in range(8):
            bits = (a & 1, (a >> 1) & 1, (a >> 2) & 1)
            f = [t if b else 1.0 - t for t, b in zip(xi, bits)]
            df = [1.0 if b else -1.0 for b in bits]
            ds[q, a] = (df[0] * f[1] * f[2], f[0] * df[1] * f[2],
                        f[0] * f[1] * df[2])
    return ds, np.full(8, 0.125)


def read_mfem_mesh(path):
    """(coords (nn, 3), conn (ne, 8) lexicographic, element attributes,
    boundary node sets) of an ASCII MFEM v1.0 hex mesh."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    i = lines.index("elements")
    ne = int(lines[i + 1])
    el = np.array([ln.split() for ln in lines[i + 2:i + 2 + ne]], dtype=np.int64)
    i = lines.index("boundary")
    nb = int(lines[i + 1])
    bd = np.array([ln.split() for ln in lines[i + 2:i + 2 + nb]], dtype=np.int64)
    i = lines.index("vertices")
    nn = int(lines[i + 1])
    coords = np.array([ln.split() for ln in lines[i + 3:i + 3 + nn]],
                      dtype=np.float64)
    # MFEM hex vertices (0,0,0) (1,0,0) (1,1,0) (0,1,0) then the top face
    conn = el[:, 2:][:, [0, 1, 3, 2, 4, 5, 7, 6]]
    bdr = {int(a): np.unique(bd[bd[:, 0] == a, 2:]) for a in np.unique(bd[:, 0])}
    return coords, conn, el[:, 0], bdr


def load_mesh(inputs):
    """The mesh both sides run: the brick, or the mesh file written for
    the case.  Returns (coords, conn, grain id per element, bdr)."""
    if inputs.get("mesh_file"):
        return read_mfem_mesh(inputs["mesh_file"])
    coords, conn, bdr = brick(inputs["ncuts"])
    return coords, conn, np.asarray(inputs["grains"]), bdr


class Element:
    """Shape gradients and weights on a device."""

    def __init__(self, device, dtype=torch.float64):
        ds, w = shape_gradients()
        self.ds = torch.as_tensor(ds, dtype=dtype, device=device)
        self.w = torch.as_tensor(w, dtype=dtype, device=device)

    def geometry(self, el_x):
        """(dN/dx (ne, 8 points, 8 nodes, 3), w det J (ne, 8)) at element
        coordinates el_x (ne, 8, 3)."""
        J = torch.einsum("eai,qaj->eqij", el_x, self.ds)
        dndx = torch.einsum("qas,eqsj->eqaj", self.ds, torch.linalg.inv(J))
        return dndx, torch.linalg.det(J) * self.w

    @staticmethod
    def velocity_gradient(el_v, dndx):
        """L_ij = dv_i/dx_j, (ne, 8, 3, 3)."""
        return torch.einsum("eai,eqaj->eqij", el_v, dndx)

    @staticmethod
    def internal_force(dndx, wdet, sigma):
        """f[e, a, i] = sum_q w det J dN_a/dx_j sigma_ji."""
        return torch.einsum("eq,eqaj,eqji->eai", wdet, dndx, sigma)
