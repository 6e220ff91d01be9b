"""PyTorch port against the JAX package: FE space, structured
gather/scatter, geometry and the component-major EA operators (f64,
1e-13 of each result's scale)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from exaconstit_tpu.config import options as J_OPT
from exaconstit_tpu.driver import MechSystem as JMechSystem
from exaconstit_tpu.fem import geometry as J_GEO
from exaconstit_tpu.fem import operators as J_OPS
from exaconstit_tpu.fem.space import FESpace as JFESpace
from exaconstit_tpu.mesh.voxel import make_cartesian_mesh
from exaconstit_tpu.models.ecmech import build_model
from exaconstit_tpu_torch.fem import geometry as T_GEO
from exaconstit_tpu_torch.fem import operators as T_OPS
from exaconstit_tpu_torch.fem.space import FESpace as TFESpace
from exaconstit_tpu_torch.fem.space import StructuredMap
from exaconstit_tpu_torch.mesh.voxel import \
    make_cartesian_mesh as t_make_mesh

VOCE_PROPS = np.array([
    8.920e-6, 0.003435984, 1.0e-10, 168.4, 121.4, 75.2, 44.0, 0.02, 1.0,
    400.0e-3, 17.0e-3, 122.4e-3, 0.0, 5.0e9, 17.0e-3, 0.0, -1.0307952])
TOL = 1e-13
GRID = (3, 2, 4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(1.0, np.max(np.abs(b))))


@pytest.mark.parametrize("order", [1, 2])
def test_fespace_tables(order):
    jf = JFESpace.create(make_cartesian_mesh(GRID, [1.0, 2.0, 1.5],
                                             order=order))
    tf = TFESpace.create(t_make_mesh(GRID, [1.0, 2.0, 1.5], order=order))
    np.testing.assert_array_equal(tf.conn, np.asarray(jf.conn))
    np.testing.assert_array_equal(tf.ref.dshape, jf.ref.dshape)
    np.testing.assert_array_equal(tf.ref.qwts, jf.ref.qwts)
    assert (tf.num_nodes, tf.num_elems, tf.nqpts, tf.nnodes_per_elem) == (
        jf.num_nodes, jf.num_elems, jf.nqpts, jf.nnodes_per_elem)
    assert sorted(tf.mesh.bdr_nodes) == sorted(jf.mesh.bdr_nodes)
    for k in jf.mesh.bdr_nodes:
        np.testing.assert_array_equal(tf.mesh.bdr_nodes[k],
                                      jf.mesh.bdr_nodes[k])
    active = {1: (False, False, True), 2: (True, False, False),
              4: (True, True, True)}
    np.testing.assert_array_equal(tf.ess_mask(active), jf.ess_mask(active))


def _jax_system(order):
    opt = J_OPT.ExaOptions()
    opt.mech_type = J_OPT.MechType.EXACMECH
    opt.xtal_type = J_OPT.XtalType.FCC
    opt.slip_type = J_OPT.SlipType.POWERVOCE
    opt.assembly = J_OPT.Assembly.EA
    opt.solver = J_OPT.KrylovSolver.PCG
    mesh = make_cartesian_mesh(GRID, [1.0, 1.0, 1.0], order=order)
    return JMechSystem(opt, mesh, build_model(opt, VOCE_PROPS)), mesh


@pytest.mark.parametrize("order", [1, 2])
def test_structured_gather_scatter(order):
    """The strided maps against the reference driver's structured maps
    and against a plain index gather / np.add.at."""
    js, mesh = _jax_system(order)
    assert js.use_struct
    smap = StructuredMap(mesh.structure, order)
    rng = np.random.default_rng(order)
    nn, ne = mesh.num_nodes, mesh.num_elems
    nen = mesh.conn.shape[1]
    t = rng.normal(size=3 * nn)
    got = smap.gather(torch.tensor(t)).numpy()
    _close(got, js._gather_cm(jnp.asarray(t)), 0.0)
    np.testing.assert_array_equal(got, t.reshape(3, nn)[:, mesh.conn.T])
    ev = rng.normal(size=(3, nen, ne))
    got = smap.scatter_add(torch.tensor(ev)).numpy()
    _close(got, js._scatter_add_cm(jnp.asarray(ev)))
    ref = np.zeros((3, nn))
    np.add.at(ref, (slice(None), mesh.conn.T.reshape(-1)),
              ev.reshape(3, -1))
    _close(got, ref.reshape(-1))


def _elements(seed=0):
    """Perturbed current coordinates (3, 8, ne) of a voxel grid, a
    velocity field, a stress and a tangent (random symmetric + 2I)."""
    rng = np.random.default_rng(seed)
    mesh = make_cartesian_mesh(GRID, [1.0, 1.0, 1.0], order=1)
    x = mesh.coords + rng.normal(size=mesh.coords.shape) * 0.02
    el_x = x.T[:, mesh.conn.T]
    el_v = rng.normal(size=el_x.shape)
    nq, ne = 8, mesh.num_elems
    stress = rng.normal(size=(6, nq, ne))
    c6 = rng.normal(size=(6, 6, nq, ne))
    c6 = 0.5 * (c6 + c6.transpose(1, 0, 2, 3)) \
        + 2.0 * np.eye(6)[:, :, None, None]
    from exaconstit_tpu.fem.reference import ref_element
    ref = ref_element(1)
    return el_x, el_v, stress, c6, ref.dshape, ref.qwts


def test_geometry_cm():
    el_x, el_v, _, _, dshape, _ = _elements(1)
    Jj = J_GEO.jacobians_cm(jnp.asarray(el_x), jnp.asarray(dshape))
    Jt = T_GEO.jacobians_cm(torch.tensor(el_x), torch.tensor(dshape))
    _close(Jt.numpy(), Jj)
    adj_j, det_j = J_GEO.adjugate_3x3_cm(Jj), J_GEO.det_3x3_cm(Jj)
    adj_t, det_t = T_GEO.adjugate_3x3_cm(Jt), T_GEO.det_3x3_cm(Jt)
    _close(adj_t.numpy(), adj_j)
    _close(det_t.numpy(), det_j)
    _close(T_GEO.grad_calc_cm(torch.tensor(el_v), torch.tensor(dshape),
                              adj_t, det_t).numpy(),
           J_GEO.grad_calc_cm(jnp.asarray(el_v), jnp.asarray(dshape),
                              adj_j, det_j))


OPERATORS = ["residual_force_cm", "assemble_ea_gradient_cm",
             "apply_ea_gradient_cm", "ea_diagonal_cm",
             "quad_point_volumes_cm"]


@pytest.mark.parametrize("name", OPERATORS)
def test_operators_cm(name):
    el_x, el_v, stress, c6, dshape, qwts = _elements(2)
    dt = 0.1
    J = lambda a: jnp.asarray(a)  # noqa: E731
    T = lambda a: torch.tensor(a)  # noqa: E731
    k_j = J_OPS.assemble_ea_gradient_cm(J(el_x), J(dshape), J(qwts), J(c6),
                                        dt)
    k_t = T_OPS.assemble_ea_gradient_cm(T(el_x), T(dshape), T(qwts), T(c6),
                                        dt)
    if name == "residual_force_cm":
        got = T_OPS.residual_force_cm(T(el_x), T(dshape), T(qwts), T(stress))
        ref = J_OPS.residual_force_cm(J(el_x), J(dshape), J(qwts), J(stress))
    elif name == "assemble_ea_gradient_cm":
        got, ref = k_t, k_j
        # the blocks are symmetric for a symmetric tangent
        _close(got.numpy(), got.numpy().transpose(1, 0, 2))
    elif name == "apply_ea_gradient_cm":
        got = T_OPS.apply_ea_gradient_cm(k_t, T(el_v))
        ref = J_OPS.apply_ea_gradient_cm(k_j, J(el_v))
    elif name == "ea_diagonal_cm":
        got = T_OPS.ea_diagonal_cm(k_t, 8)
        ref = J_OPS.ea_diagonal_cm(k_j, 8)
    else:
        got = T_OPS.quad_point_volumes_cm(T(el_x), T(dshape), T(qwts))
        ref = J_OPS.quad_point_volumes_cm(J(el_x), J(dshape), J(qwts))
    _close(got.numpy(), ref)


def test_ea_build_f32():
    """The production f32 block build: same blocks to f32 rounding."""
    el_x, _, _, c6, dshape, qwts = _elements(3)
    f32 = np.float32
    k_j = J_OPS.assemble_ea_gradient_cm(
        *[jnp.asarray(a.astype(f32)) for a in (el_x, dshape, qwts, c6)], 0.1)
    k_t = T_OPS.assemble_ea_gradient_cm(
        *[torch.tensor(a.astype(f32)) for a in (el_x, dshape, qwts, c6)], 0.1)
    assert k_t.dtype == torch.float32
    _close(k_t.numpy(), k_j, 1e-5)
