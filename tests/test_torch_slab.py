"""The port's slab partition and halo-exchange scatter against the JAX
package's (``exaconstit_tpu.parallel.slab``).

* ``build_slab_partition`` equals the reference's array for array on
  voxel bricks and on a mesh file's element order, and refuses the same
  non-adjacent sharing;
* ``SlabMap.scatter_add`` (local index scatter + halo exchange over 8
  stacked shards) equals the dense scatter on every copy of every node
  (atol 1e-12) and the reference's ``SlabOps.scatter_add_halo`` under
  ``shard_map`` on 8 virtual devices (atol 1e-12);
* the owner-masked dot equals the global one and the reference's
  (rtol 1e-12);
* one matvec's halo exchange moves 2 x m_halo x 3 x itemsize bytes per
  shard boundary, m_halo one node plane, whatever the slab axis's
  length: the counterpart of ``tests/test_slab_comm.py``, which reads
  the compiled HLO.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from exaconstit_tpu.parallel import slab as J_SLAB
from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.mesh.mfem_io import read_mfem_mesh
from exaconstit_tpu_torch.mesh.voxel import make_cartesian_mesh
from exaconstit_tpu_torch.models.ecmech import build_model
from exaconstit_tpu_torch.parallel import slab as T_SLAB
from exaconstit_tpu_torch.parallel.sharding import ShardLayout
from exaconstit_tpu_torch.parallel.slab_system import SlabMechSystem


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    return Mesh(np.array(jax.devices()[:8]), ("shards",))


def _voxel(ncuts):
    return make_cartesian_mesh(ncuts, [1.0, 1.0, 1.0], order=1)


def _mesh_file(tmp_path):
    path = str(tmp_path / "mesh.mesh")
    cases.write_mfem_mesh(path, _voxel((2, 3, 4)))
    return read_mfem_mesh(path)


@pytest.mark.parametrize("name,n_shards", [
    ("2x2x8", 8), ("4x4x4", 2), ("4x4x4", 4), ("mesh file 2x3x4", 4)])
def test_partition_matches_reference(name, n_shards, tmp_path):
    if name.startswith("mesh file"):
        mesh = _mesh_file(tmp_path)
    else:
        mesh = _voxel([int(c) for c in name.split("x")])
    conn = np.asarray(mesh.conn)
    got = T_SLAB.build_slab_partition(conn, mesh.num_nodes, n_shards)
    want = J_SLAB.build_slab_partition(conn, mesh.num_nodes, n_shards)
    for field in T_SLAB.SlabPartition.__dataclass_fields__:
        a, b = getattr(got, field), getattr(want, field)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    # every real element once; each node owned exactly once
    assert sorted(got.elem_perm[got.elem_mask.reshape(-1) > 0]) == \
        list(range(mesh.num_elems))
    owners = np.zeros(mesh.num_nodes)
    for s in range(n_shards):
        real = got.glob_nodes[s] >= 0
        owners[got.glob_nodes[s][real]] += got.owner_mask[s, :got.n_loc][real]
    np.testing.assert_array_equal(owners, 1.0)


def test_nonadjacent_sharing_rejected():
    mesh = _voxel([2, 2, 2])
    conn = np.asarray(mesh.conn)
    scrambled = conn[np.random.default_rng(0).permutation(len(conn))]
    for pkg in (T_SLAB, J_SLAB):
        with pytest.raises(ValueError, match="non-adjacent"):
            pkg.build_slab_partition(scrambled, mesh.num_nodes, 4)
    # a 4^3 brick over 8 shards splits z-layers
    with pytest.raises(ValueError, match="non-adjacent"):
        T_SLAB.build_slab_partition(np.asarray(_voxel([4, 4, 4]).conn),
                                    _voxel([4, 4, 4]).num_nodes, 8)


def _slab_map(mesh, n_shards):
    part = T_SLAB.build_slab_partition(np.asarray(mesh.conn), mesh.num_nodes,
                                       n_shards)
    return part, T_SLAB.SlabMap(part, ShardLayout.create(n_shards, "cpu"))


def _local_to_cm(part, loc):
    """(S, n_loc + 1, 3) host blocks -> the flat component-major stack."""
    return torch.as_tensor(np.moveaxis(loc, -1, 0).reshape(-1))


def _cm_to_local(part, flat):
    return np.moveaxis(flat.numpy().reshape(3, part.n_shards,
                                            part.n_loc + 1), 0, -1)


def test_scatter_halo_matches_dense_and_reference(mesh8):
    mesh = _voxel([3, 4, 8])
    conn = np.asarray(mesh.conn)
    part, smap = _slab_map(mesh, 8)
    rng = np.random.default_rng(1)
    evec = rng.normal(size=(mesh.num_elems, conn.shape[1], 3))
    dense = np.zeros((mesh.num_nodes, 3))
    np.add.at(dense, conn.reshape(-1), evec.reshape(-1, 3))

    # the port: (3, nen, S * ne_per) element vectors in partition order
    ev_perm = evec[part.elem_perm]
    got = smap.scatter_add(torch.as_tensor(ev_perm.transpose(2, 1, 0)))
    loc = _cm_to_local(part, got)
    np.testing.assert_allclose(T_SLAB.to_global(part, loc, mesh.num_nodes),
                               dense, rtol=0, atol=1e-12)
    # every copy of a shared node is complete; trash rows zero
    for s in range(part.n_shards):
        real = part.glob_nodes[s] >= 0
        np.testing.assert_allclose(loc[s, :part.n_loc][real],
                                   dense[part.glob_nodes[s][real]],
                                   rtol=0, atol=1e-12)
    assert not loc[:, part.trash].any()

    # the reference under shard_map on 8 virtual devices
    ops = J_SLAB.SlabOps(part, mesh8)
    blk = (ev_perm * part.elem_mask.reshape(-1)[:, None, None]).reshape(
        part.n_shards, part.ne_per, conn.shape[1], 3)

    @partial(shard_map, mesh=mesh8, in_specs=(P("shards"),) * 6,
             out_specs=P("shards"))
    def scat(e, cl, su, rd, sd, ru):
        return ops.scatter_add_halo(e[0], cl[0], su[0], rd[0], sd[0],
                                    ru[0])[None]

    want = np.asarray(scat(jnp.asarray(blk), ops.conn_local, ops.send_up,
                           ops.recv_dn, ops.send_dn, ops.recv_up))
    np.testing.assert_allclose(loc, want, rtol=0, atol=1e-12)


def test_owner_masked_dot(mesh8):
    mesh = _voxel([2, 3, 8])
    part, smap = _slab_map(mesh, 8)
    rng = np.random.default_rng(2)
    a = rng.normal(size=(mesh.num_nodes, 3))
    b = rng.normal(size=(mesh.num_nodes, 3))
    a_loc, b_loc = T_SLAB.to_local(part, a), T_SLAB.to_local(part, b)
    got = float(smap.dot(_local_to_cm(part, a_loc), _local_to_cm(part, b_loc)))
    np.testing.assert_allclose(got, float((a * b).sum()), rtol=1e-12)

    ops = J_SLAB.SlabOps(part, mesh8)

    @partial(shard_map, mesh=mesh8, in_specs=(P("shards"),) * 3,
             out_specs=P())
    def dot(al, bl, om):
        return ops.dot(al[0], bl[0], om[0])

    want = float(dot(jnp.asarray(a_loc), jnp.asarray(b_loc), ops.owner_mask))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _halo_system(nz):
    opt = T_OPT.ExaOptions()
    opt.mech_type = T_OPT.MechType.EXACMECH
    opt.xtal_type = T_OPT.XtalType.FCC
    opt.slip_type = T_OPT.SlipType.POWERVOCE
    opt.assembly = T_OPT.Assembly.EA
    opt.solver = T_OPT.KrylovSolver.PCG
    mesh = _voxel([2, 2, nz])
    return SlabMechSystem(opt, mesh, build_model(opt, cases.VOCE_PROPS), 8,
                          device="cpu")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_halo_bytes_per_matvec_are_one_plane(dtype, monkeypatch):
    """Bytes that cross each shard boundary in one matvec (the partials
    shifted along the shard axis), at nz 8 and 16."""
    sent = []
    exchange = ShardLayout.exchange

    def counting(layout, up, dn):
        boundaries = layout.n_shards - 1
        sent.append((up[:, :-1].nbytes + dn[:, 1:].nbytes) / boundaries)
        return exchange(layout, up, dn)

    monkeypatch.setattr(ShardLayout, "exchange", counting)
    itemsize = torch.finfo(dtype).bits // 8
    for nz in (8, 16):
        sysm = _halo_system(nz)
        nen = sysm.fes.ref.nnodes
        k = torch.zeros((3 * nen, 3 * nen, sysm.ne), dtype=dtype)
        x = torch.zeros(3 * sysm.emap.ntot, dtype=dtype)
        sent.clear()
        sysm.apply_k(k, x)
        # one exchange; a node plane of the 2x2 cross-section is 3x3 nodes
        assert sysm.part.m_halo == 9
        assert sent == [2 * 9 * 3 * itemsize]
        assert sysm.emap.halo_bytes(dtype) == sent[0]
