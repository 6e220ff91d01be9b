"""Structured voxel (Cartesian hex) mesh generation.

Replaces the reference's use of mfem::Mesh::MakeCartesian3D + uniform
refinement + ExaConstit boundary-attribute re-tagging
(src/mechanics_driver.cpp:236-317, 1196-1231).

ExaConstit boundary-attribute convention (setBdrConditions,
mechanics_driver.cpp:1196-1231):
    1 = z = 0   (bottom)      4 = z = Lz  (top)
    2 = x = 0   (left)        5 = x = Lx  (right)
    3 = y = 0   (front)       6 = y = Ly  (back)

Elements and nodes are ordered lexicographically, x fastest then y then z,
matching MakeCartesian3D with sfc_ordering=false — required so that the
grain-map file (one grain id per coarse element) lines up
(mechanics_driver.cpp:247-281).

Uniform refinement is realized by generating the fine Cartesian mesh
directly and inheriting each fine element's attribute from its parent
coarse voxel — equivalent to MFEM's UniformRefinement for this topology.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HexMesh:
    """A (possibly high-order) nodal hex mesh.

    Node coordinates are the reference configuration of the order-``order``
    isoparametric FE nodes; ``conn`` uses lexicographic local node ordering
    within each element (x fastest, then y, then z).
    """

    coords: np.ndarray  # (nnodes, 3) float64
    conn: np.ndarray  # (nelems, (order+1)**3) int32
    elem_attr: np.ndarray  # (nelems,) int32 (grain ids; 1 if untagged)
    bdr_nodes: dict  # attr(int) -> np.ndarray of node ids
    order: int
    # (nx, ny, nz) element grid when the mesh is a structured voxel brick
    # with lexicographic x-fastest node AND element numbering (the
    # make_cartesian_mesh layout); None for file/unstructured meshes.
    # Enables the slice-based (scatter-free) gather/assembly path.
    structure: tuple | None = None

    @property
    def num_nodes(self):
        return self.coords.shape[0]

    @property
    def num_elems(self):
        return self.conn.shape[0]

    @property
    def nodes_per_elem(self):
        return self.conn.shape[1]


def lobatto_points(p: int) -> np.ndarray:
    """Gauss-Lobatto-Legendre points on [0, 1] (p+1 points)."""
    if p == 1:
        return np.array([0.0, 1.0])
    # roots of derivative of Legendre P_p plus endpoints, on [-1,1]
    from numpy.polynomial import legendre as npleg

    c = np.zeros(p + 1)
    c[p] = 1.0
    dleg = npleg.legder(c)
    interior = npleg.legroots(dleg)
    x = np.concatenate([[-1.0], np.sort(interior), [1.0]])
    return 0.5 * (x + 1.0)


def make_cartesian_mesh(ncuts, lengths, order: int = 1,
                        grain_map: np.ndarray | None = None,
                        ref_levels: int = 0) -> HexMesh:
    """Build a structured hex mesh of ``ncuts`` voxels refined ``ref_levels``x.

    grain_map: per *coarse* element attribute (len prod(ncuts)), x-fastest.
    """
    ncuts = np.asarray(ncuts, dtype=int)
    lengths = np.asarray(lengths, dtype=float)
    scale = 2 ** ref_levels
    nx, ny, nz = (int(n) * scale for n in ncuts)

    p = order
    # global FE nodes on the tensor grid refined by the intra-element GLL pts
    t = lobatto_points(p)  # (p+1,) on [0,1]
    def axis_coords(n, L):
        # n elements, nodes at i/n + GLL offsets; unique points: n*p+1
        base = np.arange(n) / n
        pts = (base[:, None] + t[None, :] / n).ravel()
        # drop duplicated shared endpoints
        keep = np.ones(pts.shape, dtype=bool)
        keep[p::p + 1] = False  # each element contributes p+1 pts; endpoint
        # simpler: build unique directly
        uniq = np.empty(n * p + 1)
        for e in range(n):
            uniq[e * p:(e + 1) * p + 1] = base[e] + t / n
        return uniq * L

    xs = axis_coords(nx, lengths[0])
    ys = axis_coords(ny, lengths[1])
    zs = axis_coords(nz, lengths[2])
    npx, npy, npz = nx * p + 1, ny * p + 1, nz * p + 1

    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    # lexicographic x-fastest global numbering: id = i + npx*(j + npy*k)
    coords = np.stack(
        [X.transpose(2, 1, 0).ravel(), Y.transpose(2, 1, 0).ravel(),
         Z.transpose(2, 1, 0).ravel()], axis=-1)

    def gid(i, j, k):
        return i + npx * (j + npy * k)

    nelems = nx * ny * nz
    nen = (p + 1) ** 3
    conn = np.empty((nelems, nen), dtype=np.int32)
    e = 0
    # local node ordering: lexicographic (x fastest, then y, then z)
    li, lj, lk = np.meshgrid(np.arange(p + 1), np.arange(p + 1),
                             np.arange(p + 1), indexing="ij")
    li = li.transpose(2, 1, 0).ravel()
    lj = lj.transpose(2, 1, 0).ravel()
    lk = lk.transpose(2, 1, 0).ravel()
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                conn[e] = gid(i * p + li, j * p + lj, k * p + lk)
                e += 1

    # element attributes from the coarse grain map
    if grain_map is not None:
        grain_map = np.asarray(grain_map).astype(np.int64).ravel()
        cx, cy, cz = (int(n) for n in ncuts)
        assert grain_map.size == cx * cy * cz, (
            f"grain map size {grain_map.size} != {cx*cy*cz}")
        ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                 indexing="ij")
        ii = ii.transpose(2, 1, 0).ravel() // scale
        jj = jj.transpose(2, 1, 0).ravel() // scale
        kk = kk.transpose(2, 1, 0).ravel() // scale
        coarse_id = ii + cx * (jj + cy * kk)
        elem_attr = grain_map[coarse_id].astype(np.int32)
    else:
        elem_attr = np.ones(nelems, dtype=np.int32)

    # boundary node sets, ExaConstit attribute convention
    I, J, K = np.meshgrid(np.arange(npx), np.arange(npy), np.arange(npz),
                          indexing="ij")
    I = I.transpose(2, 1, 0).ravel()
    J = J.transpose(2, 1, 0).ravel()
    K = K.transpose(2, 1, 0).ravel()
    ids = np.arange(coords.shape[0])
    bdr_nodes = {
        1: ids[K == 0],
        2: ids[I == 0],
        3: ids[J == 0],
        4: ids[K == npz - 1],
        5: ids[I == npx - 1],
        6: ids[J == npy - 1],
    }

    return HexMesh(coords=coords, conn=conn, elem_attr=elem_attr,
                   bdr_nodes=bdr_nodes, order=p, structure=(nx, ny, nz))
