"""MFEM v1.0 mesh file reader (conforming all-hex meshes).

Covers the reference's `Mesh.type = "cubit"`/`"other"` paths
(src/mechanics_driver.cpp:239-241) for conforming all-hex meshes with
element attributes (grain ids) and boundary quads with attributes, e.g.
the output of the reference's scripts/meshing/mesh_generator.cpp.
Uniform refinement and isoparametric order promotion (p_refinement > 1)
match the reference's UniformRefinement + SetCurvature treatment of file
meshes (src/mechanics_driver.cpp:307-311, 334-340).

Supported: MFEM v1.0 ASCII, 3-D, hexahedral elements (geometry type 5),
quad boundary elements (geometry type 3), any element/boundary
attributes.  Unsupported (loud error): other element geometries
(tet/wedge/pyramid), NURBS/curved `nodes` sections, non-conforming
meshes.

A verbatim copy of exaconstit_tpu/mesh/mfem_io.py apart from this
paragraph: it imports only numpy.
"""

from __future__ import annotations

import numpy as np

from .voxel import HexMesh, lobatto_points

# MFEM local vertex numbering for hexes: bottom quad CCW, then top quad.
# Our lexicographic order-1 local ordering is
# (0,0,0),(1,0,0),(0,1,0),(1,1,0),(0,0,1),(1,0,1),(0,1,1),(1,1,1)
# MFEM hex vertices:
# 0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0) 4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)
_MFEM_TO_LEX = np.array([0, 1, 3, 2, 4, 5, 7, 6])


_GEOM_NAMES = {0: "point", 1: "segment", 2: "triangle", 3: "quad",
               4: "tetrahedron", 5: "hexahedron", 6: "wedge", 7: "pyramid"}


def read_mfem_mesh(path: str, ref_levels: int = 0,
                   order: int = 1) -> HexMesh:
    """Read an MFEM v1.0 hex mesh; optionally refine and promote order.

    ``order`` > 1 places Gauss-Lobatto isoparametric nodes on each
    (tri-linearly mapped) hex, deduplicated across shared faces/edges —
    the equivalent of the reference's higher-order H1 space on a file
    mesh (p_refinement, src/mechanics_driver.cpp:334-340).
    """
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    i = 0
    if lines and lines[0].startswith("MFEM mesh v1."):
        if lines[0] not in ("MFEM mesh v1.0", "MFEM mesh v1.1"):
            raise ValueError(
                f"unsupported MFEM mesh format '{lines[0]}' in {path}: "
                "only ASCII v1.0/v1.1 conforming meshes are supported")

    def seek(tag):
        nonlocal i
        while i < len(lines) and lines[i] != tag:
            if lines[i] == "nodes":
                raise ValueError(
                    f"{path} has a 'nodes' (curved/high-order geometry) "
                    "section, which this reader does not support; supply "
                    "the linear mesh and use Mesh.p_refinement instead")
            i += 1
        if i >= len(lines):
            raise ValueError(f"section {tag} not found in {path}")
        i += 1

    seek("dimension")
    dim = int(lines[i]); i += 1
    if dim != 3:
        raise ValueError(f"{path} is {dim}-D; only 3-D meshes supported")

    seek("elements")
    ne = int(lines[i]); i += 1
    attrs = np.empty(ne, dtype=np.int32)
    conn = np.empty((ne, 8), dtype=np.int64)
    for e in range(ne):
        parts = lines[i].split(); i += 1
        attrs[e] = int(parts[0])
        geom = int(parts[1])
        if geom != 5:
            raise ValueError(
                f"element {e} in {path} has geometry type {geom} "
                f"({_GEOM_NAMES.get(geom, 'unknown')}); only hexahedral "
                "meshes are supported (re-mesh with hex elements, e.g. "
                "Neper -format msh + neper_v4_mesh.py, or mesh_generator)")
        verts = np.array([int(p) for p in parts[2:10]])
        conn[e] = verts[np.argsort(_MFEM_TO_LEX)]  # reorder to lex local

    seek("boundary")
    nb = int(lines[i]); i += 1
    bdr = {}
    for b in range(nb):
        parts = lines[i].split(); i += 1
        attr = int(parts[0])
        geom = int(parts[1])
        if geom != 3:
            raise ValueError(
                f"boundary element {b} in {path} has geometry type {geom} "
                f"({_GEOM_NAMES.get(geom, 'unknown')}); only quad boundary "
                "elements are supported")
        verts = [int(p) for p in parts[2:6]]
        bdr.setdefault(attr, set()).update(verts)

    seek("vertices")
    nv = int(lines[i]); i += 1
    # curved/high-order meshes carry only the vertex COUNT here and put
    # the coordinates in a trailing 'nodes' (GridFunction) section — the
    # seek() guard above never reaches it ('vertices' precedes 'nodes'),
    # so detect the missing coordinate block right here
    while i < len(lines) and not lines[i]:
        i += 1
    if i >= len(lines) or lines[i] == "nodes":
        raise ValueError(
            f"{path} has a 'nodes' (curved/high-order geometry) "
            "section, which this reader does not support; supply "
            "the linear mesh and use Mesh.p_refinement instead")
    vdim_line = lines[i]
    if len(vdim_line.split()) == 1:
        i += 1  # vdim on its own line
        while i < len(lines) and not lines[i]:
            i += 1
        if i >= len(lines) or lines[i] == "nodes":
            raise ValueError(
                f"{path} has a 'nodes' (curved/high-order geometry) "
                "section, which this reader does not support; supply "
                "the linear mesh and use Mesh.p_refinement instead")
    coords = np.empty((nv, 3))
    for v in range(nv):
        coords[v] = [float(x) for x in lines[i].split()[:3]]
        i += 1

    bdr_nodes = {a: np.array(sorted(s), dtype=np.int64)
                 for a, s in bdr.items()}
    mesh = HexMesh(coords=coords, conn=conn.astype(np.int32),
                   elem_attr=attrs, bdr_nodes=bdr_nodes, order=1)
    for _ in range(ref_levels):
        mesh = refine_hex_mesh(mesh)
    if order > 1:
        mesh = promote_mesh_order(mesh, order)
    return mesh


# lexicographic local corner (i, j, k) offsets for a linear hex
_LEX = np.array([[i, j, k] for k in (0, 1) for j in (0, 1) for i in (0, 1)])


def promote_mesh_order(mesh: HexMesh, p: int) -> HexMesh:
    """Linear hex mesh -> order-``p`` isoparametric nodal mesh.

    New nodes sit at the tri-linear image of the Gauss-Lobatto lattice of
    each element (the reference's H1 space of order p on a straight-sided
    mesh).  Shared edge/face nodes are deduplicated by their (vertex id,
    barycentric weight) signature, so conforming neighbors agree exactly.
    Boundary-attribute node sets extend to new nodes supported entirely
    on that attribute's vertices (the refine_hex_mesh rule).
    """
    if mesh.order != 1:
        raise ValueError("promote_mesh_order expects a linear mesh")
    if p == 1:
        return mesh
    conn = np.asarray(mesh.conn)
    coords = np.asarray(mesh.coords)
    ne = conn.shape[0]
    gll = lobatto_points(p)
    # symmetrize: legroots-derived Gauss-Lobatto points are not exactly
    # mirror-symmetric (~1 ulp), so orientation-flipped neighbor elements
    # would compute weights differing at the last bit — which can straddle
    # the rounded dedup key below and silently crack the mesh.  Averaging
    # with the reversed complement makes mirrored weights bitwise equal.
    gll = 0.5 * (gll + 1.0 - gll[::-1])
    n1 = p + 1

    # tri-linear vertex weights at each lattice point (lex vertex order)
    lat = np.array([[x, y, z] for z in gll for y in gll for x in gll])
    wts = np.empty((n1 ** 3, 8))
    for a, (dx, dy, dz) in enumerate(_LEX):
        wts[:, a] = (np.where(dx, lat[:, 0], 1 - lat[:, 0])
                     * np.where(dy, lat[:, 1], 1 - lat[:, 1])
                     * np.where(dz, lat[:, 2], 1 - lat[:, 2]))

    new_nodes = {}
    new_coords = [coords]
    nv = coords.shape[0]
    fine_conn = np.empty((ne, n1 ** 3), dtype=np.int64)
    node_support = {}  # new id -> set of parent vertex ids

    for e in range(ne):
        verts = conn[e]
        for a in range(n1 ** 3):
            w = wts[a]
            nz = w > 1e-14
            if nz.sum() == 1 and abs(w[nz][0] - 1.0) < 1e-12:
                fine_conn[e, a] = verts[int(np.argmax(w))]
                continue
            key = tuple(sorted(
                (int(verts[b]), round(float(w[b]), 12))
                for b in range(8) if nz[b]))
            nid = new_nodes.get(key)
            if nid is None:
                nid = nv + len(new_nodes)
                new_nodes[key] = nid
                new_coords.append(
                    (w[None, :] @ coords[verts]).reshape(1, 3))
                node_support[nid] = {int(verts[b]) for b in range(8)
                                     if nz[b]}
            fine_conn[e, a] = nid

    all_coords = np.concatenate(new_coords, axis=0)
    bdr_nodes = {}
    for attr, ids in mesh.bdr_nodes.items():
        s = set(int(i) for i in np.asarray(ids))
        extra = [nid for nid, sup in node_support.items()
                 if sup <= s]
        bdr_nodes[attr] = np.array(sorted(s | set(extra)), dtype=np.int64)
    return HexMesh(coords=all_coords, conn=fine_conn.astype(np.int32),
                   elem_attr=np.asarray(mesh.elem_attr),
                   bdr_nodes=bdr_nodes, order=p)


def refine_hex_mesh(mesh: HexMesh) -> HexMesh:
    """One level of uniform refinement of a linear hex mesh (1 -> 8).

    Generic-topology equivalent of MFEM's UniformRefinement as used by the
    reference for file meshes (src/mechanics_driver.cpp:307-311): new
    nodes at edge/face/cell midpoints (deduplicated across elements),
    child elements inherit the parent's attribute, and boundary-attribute
    node sets extend to any new node all of whose parent nodes carry the
    attribute.
    """
    assert mesh.order == 1, "refine before promoting the order"
    conn = np.asarray(mesh.conn)
    coords = np.asarray(mesh.coords)
    nv = coords.shape[0]
    new_nodes = {}  # frozenset(parent ids) -> new id
    new_coords = [coords]

    def node_for(ids):
        key = tuple(sorted(int(i) for i in ids))
        if len(key) == 1:
            return key[0]
        nid = new_nodes.get(key)
        if nid is None:
            nid = nv + len(new_nodes)
            new_nodes[key] = nid
            new_coords.append(coords[list(key)].mean(axis=0, keepdims=True))
        return nid

    ne = conn.shape[0]
    fine_conn = np.empty((8 * ne, 8), dtype=np.int64)
    fine_attr = np.empty(8 * ne, dtype=np.int32)

    def corner(e, i, j, k):
        # parent corner ids participating in the fine (i,j,k)/2 position
        ids = set()
        for di in ((0, 1) if i == 1 else (i // 2,)):
            for dj in ((0, 1) if j == 1 else (j // 2,)):
                for dk in ((0, 1) if k == 1 else (k // 2,)):
                    loc = di + 2 * dj + 4 * dk
                    ids.add(int(conn[e, loc]))
        return node_for(ids)

    c = 0
    for e in range(ne):
        for ck in (0, 1):
            for cj in (0, 1):
                for ci in (0, 1):
                    fine_conn[c] = [corner(e, ci + o[0], cj + o[1],
                                           ck + o[2]) for o in _LEX]
                    fine_attr[c] = mesh.elem_attr[e]
                    c += 1
    all_coords = np.concatenate(new_coords, axis=0)

    bdr_nodes = {}
    for attr, ids in mesh.bdr_nodes.items():
        s = set(int(i) for i in np.asarray(ids))
        extra = [nid for key, nid in new_nodes.items()
                 if all(p in s for p in key)]
        bdr_nodes[attr] = np.array(sorted(s | set(extra)), dtype=np.int64)

    return HexMesh(coords=all_coords, conn=fine_conn.astype(np.int32),
                   elem_attr=fine_attr, bdr_nodes=bdr_nodes, order=1)
