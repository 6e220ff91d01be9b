"""Finite-element space: numbering, essential dofs, and the gather /
scatter-add between nodal and element vectors.

Port of ``exaconstit_tpu.fem.space`` plus the element maps of the
reference driver (``driver.py:237-291``), both component-major with one
interface (``gather``, ``scatter_add``):

* ``StructuredMap``: on a voxel brick with lexicographic x-fastest node
  and element numbering, each local node (li, lj, lk) of every element
  sits at a fixed stride-p offset of the nodal grid, so the gather is
  (p+1)^3 strided slices and the scatter-add is (p+1)^3 in-place adds on
  strided views;
* ``IndexMap``: any conforming mesh (mesh files).  The gather indexes
  the connectivity; the scatter-add reads a node -> (local node,
  element) incidence table built once on the host, padded to the
  largest valence, and sums its slots one after another.

Neither uses atomics: each sums in the same order on every run and
device (``index_add_`` on CUDA does not, and the Newton path follows
the rounding, ROADMAP C7).  Both sum a node's contributions in
ascending local-node order, so they agree bitwise on a voxel brick.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh.voxel import HexMesh
from .reference import RefElement, ref_element


@dataclasses.dataclass
class FESpace:
    mesh: HexMesh
    ref: RefElement
    conn: np.ndarray  # (nelems, nen) int32

    @classmethod
    def create(cls, mesh: HexMesh) -> "FESpace":
        return cls(mesh=mesh, ref=ref_element(mesh.order),
                   conn=np.asarray(mesh.conn))

    @property
    def num_nodes(self):
        return self.mesh.num_nodes

    @property
    def num_elems(self):
        return self.mesh.num_elems

    @property
    def nqpts(self):
        return self.ref.nqpts

    @property
    def nnodes_per_elem(self):
        return self.ref.nnodes

    def ess_mask(self, active: dict) -> np.ndarray:
        """Boolean (num_nodes, 3) mask of constrained dofs.

        active: {bdr_attr: (bool, bool, bool)} component activation."""
        mask = np.zeros((self.num_nodes, 3), dtype=bool)
        for attr, comps in active.items():
            nodes = self.mesh.bdr_nodes.get(int(attr))
            if nodes is None:
                continue
            for c in range(3):
                if comps[c]:
                    mask[nodes, c] = True
        return mask


class StructuredMap:
    """Strided E <-> T maps of an (nx, ny, nz) order-p voxel grid for
    component-major fields: flat (3*nn,) nodal vectors [vx | vy | vz] and
    (3, nen, ne) element vectors, local nodes in lexicographic order."""

    def __init__(self, grid, order=1):
        self.nx, self.ny, self.nz = (int(v) for v in grid)
        self.p = int(order)
        p = self.p
        self.nodes = (self.nz * p + 1, self.ny * p + 1, self.nx * p + 1)
        self.loff = [(li, lj, lk) for lk in range(p + 1)
                     for lj in range(p + 1) for li in range(p + 1)]

    def _slices(self, li, lj, lk):
        p = self.p
        return (slice(lk, lk + (self.nz - 1) * p + 1, p),
                slice(lj, lj + (self.ny - 1) * p + 1, p),
                slice(li, li + (self.nx - 1) * p + 1, p))

    def gather(self, tvec):
        """Flat (3*nn,) nodal field -> (3, nen, ne) element vectors."""
        x3 = tvec.reshape(3, *self.nodes)
        return torch.stack([x3[(slice(None),) + self._slices(*o)]
                            .reshape(3, -1) for o in self.loff], dim=1)

    def scatter_add(self, evec):
        """(3, nen, ne) element vectors -> flat (3*nn,) sums."""
        out = evec.new_zeros((3, *self.nodes))
        f = evec.reshape(3, len(self.loff), self.nz, self.ny, self.nx)
        for a, o in enumerate(self.loff):
            out[(slice(None),) + self._slices(*o)] += f[:, a]
        return out.reshape(-1)


class IndexMap:
    """E <-> T maps of any conforming mesh from its connectivity
    ``conn`` (ne, nen), for the same component-major fields as
    ``StructuredMap``.  The incidence table lists, for each node, its
    occurrences as flat indices a*ne + e into the (nen, ne) element
    axes, ascending, padded with the index of a zero slot."""

    def __init__(self, conn, num_nodes, device="cpu"):
        conn_t = np.ascontiguousarray(np.asarray(conn, dtype=np.int64).T)
        nen, ne = conn_t.shape
        self.nn = int(num_nodes)
        flat = conn_t.reshape(-1)
        order = np.argsort(flat, kind="stable")  # ascending a*ne + e
        counts = np.bincount(flat, minlength=self.nn)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(flat.size) - np.repeat(start, counts)
        table = np.full((int(counts.max()), self.nn), nen * ne,
                        dtype=np.int64)
        table[slot, flat[order]] = order
        self.valence = table.shape[0]
        self.conn_t = torch.as_tensor(conn_t, device=device)
        self.table = torch.as_tensor(table, device=device)

    def gather(self, tvec):
        """Flat (3*nn,) nodal field -> (3, nen, ne) element vectors."""
        return tvec.reshape(3, self.nn)[:, self.conn_t]

    def scatter_add(self, evec):
        """(3, nen, ne) element vectors -> flat (3*nn,) sums, slot by
        slot in the table's order."""
        ev = torch.cat([evec.reshape(3, -1), evec.new_zeros((3, 1))], dim=1)
        parts = ev[:, self.table]  # (3, valence, nn)
        out = parts[:, 0]
        for k in range(1, self.valence):
            out = out + parts[:, k]
        return out.reshape(-1)
