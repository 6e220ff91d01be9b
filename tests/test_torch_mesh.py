"""PyTorch port against the JAX package: mesh files and the index
gather/scatter.

* the copied MFEM reader against the reference's on the unit hex, plain,
  refined and order-promoted: exactly equal meshes;
* ``IndexMap`` against ``StructuredMap`` on voxel bricks of order 1 and 2
  (bitwise: both sum a node's contributions in ascending local-node
  order) and against the reference driver's index scatter on a mesh
  file (1e-15 of the result's scale);
* ``cases.write_mfem_mesh``: a voxel brick written and read back by both
  readers is the brick (nodes, elements, attributes, boundary sets).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from exaconstit_tpu.config import options as J_OPT
from exaconstit_tpu.driver import MechSystem as JMechSystem
from exaconstit_tpu.mesh import mfem_io as J_IO
from exaconstit_tpu.models.ecmech import build_model
from exaconstit_tpu_torch.cases import voronoi_grains, write_mfem_mesh
from exaconstit_tpu_torch.fem.space import IndexMap, StructuredMap
from exaconstit_tpu_torch.mesh import mfem_io as T_IO
from exaconstit_tpu_torch.mesh.voxel import make_cartesian_mesh

UNIT_HEX_MESH = """MFEM mesh v1.0

dimension
3

elements
1
7 5 0 1 2 3 4 5 6 7

boundary
6
1 3 0 3 2 1
4 3 4 5 6 7
2 3 0 4 7 3
5 3 1 2 6 5
3 3 0 1 5 4
6 3 3 7 6 2

vertices
8
3
0 0 0
1 0 0
1 1 0
0 1 0
0 0 1
1 0 1
1 1 1
0 1 1
"""

VOCE_PROPS = np.array([
    8.920e-6, 0.003435984, 1.0e-10, 168.4, 121.4, 75.2, 44.0, 0.02, 1.0,
    400.0e-3, 17.0e-3, 122.4e-3, 0.0, 5.0e9, 17.0e-3, 0.0, -1.0307952])


def _same_mesh(a, b):
    for name in ("coords", "conn", "elem_attr"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)))
    assert a.order == b.order
    assert sorted(a.bdr_nodes) == sorted(b.bdr_nodes)
    for k in a.bdr_nodes:
        np.testing.assert_array_equal(np.sort(a.bdr_nodes[k]),
                                      np.sort(b.bdr_nodes[k]))


@pytest.mark.parametrize("ref_levels,order", [(0, 1), (2, 1), (0, 3),
                                              (1, 2)])
def test_reader_matches_reference(tmp_path, ref_levels, order):
    path = tmp_path / "hex.mesh"
    path.write_text(UNIT_HEX_MESH)
    t = T_IO.read_mfem_mesh(str(path), ref_levels=ref_levels, order=order)
    _same_mesh(t, J_IO.read_mfem_mesh(str(path), ref_levels=ref_levels,
                                      order=order))
    assert t.structure is None
    assert t.num_elems == 8 ** ref_levels
    assert t.num_nodes == (2 ** ref_levels * order + 1) ** 3


@pytest.mark.parametrize("order", [1, 2])
def test_index_map_matches_structured(order):
    mesh = make_cartesian_mesh((3, 2, 4), [1.0, 1.0, 1.0], order=order)
    smap = StructuredMap(mesh.structure, order)
    imap = IndexMap(mesh.conn, mesh.num_nodes)
    assert imap.valence == 8
    rng = np.random.default_rng(order)
    t = torch.tensor(rng.normal(size=3 * mesh.num_nodes))
    assert torch.equal(imap.gather(t), smap.gather(t))
    ev = torch.tensor(rng.normal(size=(3, mesh.conn.shape[1],
                                       mesh.num_elems)))
    assert torch.equal(imap.scatter_add(ev), smap.scatter_add(ev))


@pytest.mark.parametrize("ref_levels,order", [(1, 1), (1, 2)])
def test_index_map_matches_reference_scatter(tmp_path, ref_levels, order):
    """Against the JAX driver's index gather and scatter-add (its
    component-major maps on a mesh without a voxel structure)."""
    path = tmp_path / "hex.mesh"
    path.write_text(UNIT_HEX_MESH)
    mesh = J_IO.read_mfem_mesh(str(path), ref_levels=ref_levels, order=order)
    rng = np.random.default_rng(7)
    mesh.coords = mesh.coords + rng.normal(size=mesh.coords.shape) * 0.01
    opt = J_OPT.ExaOptions()
    opt.mech_type = J_OPT.MechType.EXACMECH
    opt.xtal_type = J_OPT.XtalType.FCC
    opt.slip_type = J_OPT.SlipType.POWERVOCE
    opt.assembly = J_OPT.Assembly.EA
    opt.solver = J_OPT.KrylovSolver.PCG
    js = JMechSystem(opt, mesh, build_model(opt, VOCE_PROPS))
    assert js.use_cm and not js.use_struct
    imap = IndexMap(mesh.conn, mesh.num_nodes)
    t = rng.normal(size=3 * mesh.num_nodes)
    np.testing.assert_array_equal(imap.gather(torch.tensor(t)).numpy(),
                                  np.asarray(js._gather_cm(jnp.asarray(t))))
    ev = rng.normal(size=(3, mesh.conn.shape[1], mesh.num_elems))
    got = imap.scatter_add(torch.tensor(ev)).numpy()
    want = np.asarray(js._scatter_add_cm(jnp.asarray(ev)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-15 * np.abs(want).max())


@pytest.mark.parametrize("ncuts", [(1, 1, 1), (3, 4, 2)])
def test_write_mfem_mesh_round_trip(tmp_path, ncuts):
    grains = voronoi_grains(ncuts, 5, seed=1)
    mesh = make_cartesian_mesh(ncuts, [1.0, 2.0, 0.5], grain_map=grains)
    path = tmp_path / "brick.mesh"
    write_mfem_mesh(str(path), mesh)
    for reader in (T_IO.read_mfem_mesh, J_IO.read_mfem_mesh):
        _same_mesh(reader(str(path)), mesh)
    nx, ny, nz = ncuts
    nb = 2 * (nx * ny + ny * nz + nx * nz)
    assert f"boundary\n{nb}\n" in path.read_text()
    if ncuts == (1, 1, 1):
        # the unit hex's faces, corner by corner, as the reference's
        # fixture orients them (its vertices are numbered otherwise)
        def faces(text, lengths):
            lines = text.split("boundary\n")[1].splitlines()
            coords = text.split("vertices\n")[1].splitlines()[2:]
            xyz = [tuple(float(c) / L for c, L in zip(ln.split(), lengths))
                   for ln in coords if ln.strip()]
            return {int(r[0]): [xyz[int(v)] for v in r[2:]]
                    for r in (ln.split() for ln in lines[1:7])}
        assert faces(path.read_text(), (1.0, 2.0, 0.5)) == faces(
            UNIT_HEX_MESH, (1.0, 1.0, 1.0))
