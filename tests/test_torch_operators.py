"""PyTorch port against the JAX package: the partial-assembly (PA) and
B-bar operators.

The port writes them component-major (batch axes last); the reference's
are point-major.  Each is fed the same seeded inputs on a perturbed
voxel mesh of order 1 and 2 and compared through a transpose, to 1e-13
of the result's scale (f64): the PA tensor, its apply and its diagonal;
the B-bar mean shape gradient, residual force, EA blocks and
velocity-gradient correction.  And the PA apply equals the EA apply of
the same tangent.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from exaconstit_tpu.fem import operators as J_OPS
from exaconstit_tpu.fem.reference import ref_element
from exaconstit_tpu_torch.fem import operators as T_OPS
from exaconstit_tpu_torch.mesh.voxel import make_cartesian_mesh

TOL = 1e-13
DT = 0.37


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


def _inputs(order, seed=0):
    """Point-major (JAX) and component-major (port) views of perturbed
    element coordinates, a velocity, a stress and a tangent."""
    rng = np.random.default_rng(seed + order)
    mesh = make_cartesian_mesh((3, 2, 2), [1.0, 1.0, 1.0], order=order)
    x = mesh.coords + rng.normal(size=mesh.coords.shape) * 0.02
    ref = ref_element(order)
    ne, nq = mesh.num_elems, ref.nqpts
    el_x = x[mesh.conn]  # (ne, nen, 3)
    el_v = rng.normal(size=el_x.shape)
    stress = rng.normal(size=(ne, nq, 6))
    c6 = rng.normal(size=(ne, nq, 6, 6))
    c6 = 0.5 * (c6 + c6.transpose(0, 1, 3, 2)) + 2.0 * np.eye(6)
    pm = dict(el_x=el_x, el_v=el_v, stress=stress, c6=c6,
              dshape=ref.dshape, qwts=ref.qwts)
    cm = dict(el_x=el_x.transpose(2, 1, 0), el_v=el_v.transpose(2, 1, 0),
              stress=stress.transpose(2, 1, 0),
              c6=c6.transpose(2, 3, 1, 0), dshape=ref.dshape,
              qwts=ref.qwts)
    return ({k: jnp.asarray(v) for k, v in pm.items()},
            {k: torch.tensor(np.ascontiguousarray(v)) for k, v in cm.items()})


def _to_pm(t, perm):
    return t.numpy().transpose(perm)


CASES = ["pa_tensor", "pa_apply", "pa_diagonal", "pa_equals_ea",
         "bbar_mean_gradient", "bbar_residual", "bbar_blocks",
         "bbar_vgrad_correction"]


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("name", CASES)
def test_operator(name, order):
    pm, cm = _inputs(order)
    args_pm = (pm["el_x"], pm["dshape"], pm["qwts"], pm["c6"], DT)
    args_cm = (cm["el_x"], cm["dshape"], cm["qwts"], cm["c6"], DT)
    if name == "pa_tensor":
        _close(_to_pm(T_OPS.assemble_pa_gradient_cm(*args_cm),
                      (5, 4, 0, 1, 2, 3)),
               J_OPS.assemble_pa_gradient(*args_pm))
    elif name == "pa_apply":
        d_pm = J_OPS.assemble_pa_gradient(*args_pm)
        d_cm = T_OPS.assemble_pa_gradient_cm(*args_cm)
        _close(_to_pm(T_OPS.apply_pa_gradient_cm(d_cm, cm["dshape"],
                                                 cm["el_v"]), (2, 1, 0)),
               J_OPS.apply_pa_gradient(d_pm, pm["dshape"], pm["el_v"]))
    elif name == "pa_diagonal":
        _close(_to_pm(T_OPS.pa_diagonal_cm(*args_cm), (2, 1, 0)),
               J_OPS.pa_diagonal(*args_pm))
    elif name == "pa_equals_ea":
        y_pa = T_OPS.apply_pa_gradient_cm(
            T_OPS.assemble_pa_gradient_cm(*args_cm), cm["dshape"],
            cm["el_v"])
        k = T_OPS.assemble_ea_gradient_cm(*args_cm)
        _close(y_pa.numpy(), T_OPS.apply_ea_gradient_cm(k, cm["el_v"]))
        nen = cm["el_x"].shape[1]
        _close(T_OPS.pa_diagonal_cm(*args_cm).numpy(),
               T_OPS.ea_diagonal_cm(k, nen))
    elif name == "bbar_mean_gradient":
        dndx, wts = T_OPS._dndx_and_wts_cm(*args_cm[:3])
        _close(_to_pm(T_OPS.bbar_mean_gradient_cm(dndx, wts), (2, 0, 1)),
               J_OPS.bbar_mean_gradient(*args_pm[:3]))
    elif name == "bbar_residual":
        _close(_to_pm(T_OPS.residual_force_bbar_cm(
            cm["el_x"], cm["dshape"], cm["qwts"], cm["stress"]), (2, 1, 0)),
            J_OPS.residual_force_bbar(pm["el_x"], pm["dshape"], pm["qwts"],
                                      pm["stress"]))
    elif name == "bbar_blocks":
        k = T_OPS.assemble_ea_gradient_bbar_cm(*args_cm)
        _close(_to_pm(k, (2, 0, 1)), J_OPS.assemble_ea_gradient_bbar(*args_pm))
        # the EA matvec and diagonal serve the B-bar blocks
        nen = cm["el_x"].shape[1]
        k_pm = J_OPS.assemble_ea_gradient_bbar(*args_pm)
        _close(_to_pm(T_OPS.apply_ea_gradient_cm(k, cm["el_v"]), (2, 1, 0)),
               J_OPS.apply_ea_gradient(k_pm, pm["el_v"]))
        _close(_to_pm(T_OPS.ea_diagonal_cm(k, nen), (2, 1, 0)),
               J_OPS.ea_diagonal(k_pm, nen))
    else:
        dndx, wts = T_OPS._dndx_and_wts_cm(*args_cm[:3])
        jd, jw = J_OPS._dndx_and_wts(*args_pm[:3])
        _close(_to_pm(T_OPS.bbar_vgrad_correction_cm(cm["el_v"], dndx, wts),
                      (3, 2, 0, 1)),
               J_OPS.bbar_vgrad_correction(pm["el_v"], jd, jw))
