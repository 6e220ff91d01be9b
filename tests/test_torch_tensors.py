"""PyTorch port against the JAX package: tensor conventions and the
component-major small-matrix helpers of the point solve (f64, 1e-14).

Inputs come from numpy seeds and go to both packages as numpy arrays."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from exaconstit_tpu.models import evptn_cm as J_CM
from exaconstit_tpu.utils import tensors as J_TN
from exaconstit_tpu_torch.models import evptn_cm as T_CM
from exaconstit_tpu_torch.utils import tensors as T_TN

N = 37
TOL = 1e-14


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    scale = max(1.0, float(np.max(np.abs(b))))
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_basis_dev_identical():
    np.testing.assert_array_equal(T_TN.BASIS_DEV, J_TN.BASIS_DEV)


def _sym(rng, n):
    a = rng.normal(size=(n, 3, 3))
    return 0.5 * (a + np.swapaxes(a, 1, 2))


def test_vecd_deff():
    t = _rng(1).normal(size=(N, 5))
    _close(T_TN.vecd_deff(torch.tensor(t)).numpy(),
           J_TN.vecd_deff(jnp.asarray(t)))


CM_HELPERS = {
    "quat_multiply_cm": lambda rng: (_unit_quats(rng, N).T,
                                     _unit_quats(rng, N).T),
    "expmap_to_quat_cm": lambda rng: (np.concatenate(
        [rng.normal(size=(N - 2, 3)) * 0.1, np.zeros((1, 3)),
         np.full((1, 3), 1e-13)]).T,),
    "quat_to_rmat_cm": lambda rng: (_unit_quats(rng, N).T,),
    "vecd_to_mat_cm": lambda rng: (rng.normal(size=(5, N)),),
    "mat_to_vecd_cm": lambda rng: (_sym(rng, N).transpose(1, 2, 0),),
    "mm_cm": lambda rng: (rng.normal(size=(4, 3, N)),
                          rng.normal(size=(3, 5, N))),
    "mv_cm": lambda rng: (rng.normal(size=(4, 3, N)),
                          rng.normal(size=(3, N))),
    "rot_T_mat_rot_cm": lambda rng: (rng.normal(size=(3, 3, N)),
                                     rng.normal(size=(3, 3, N))),
    "vecd_to_svec_cm": lambda rng: (rng.normal(size=(5, N)),),
    "_vecd_rot5_cm": lambda rng: (np.asarray(J_CM.quat_to_rmat_cm(
        jnp.asarray(_unit_quats(rng, N).T))),),
}


@pytest.mark.parametrize("name", sorted(CM_HELPERS))
def test_cm_helpers(name):
    args = CM_HELPERS[name](_rng(2))
    got = getattr(T_CM, name)(*[torch.tensor(a) for a in args])
    ref = getattr(J_CM, name)(*[jnp.asarray(a) for a in args])
    _close(got.numpy(), ref)


@pytest.mark.parametrize("shape", [(6, 5), (5, 3)])
def test_const_mm(shape):
    rng = _rng(3)
    C = rng.normal(size=shape)
    C[0, 1] = 0.0  # the reference skips zero entries
    x = rng.normal(size=(shape[1], 4, N))
    _close(T_CM.const_mm_cm(C, torch.as_tensor(x)).numpy(),
           J_CM.const_mm_cm(C, jnp.asarray(x)))
    xr = rng.normal(size=(3, shape[0], N))
    _close(T_CM.const_mm_r_cm(torch.as_tensor(xr), C).numpy(),
           J_CM.const_mm_r_cm(jnp.asarray(xr), C))


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_solve_dense_cm_eq(rhs):
    """Row-equilibrated Gauss-Jordan with rows scaled over six decades
    (the dt * slope rows of the point Jacobian)."""
    rng = _rng(4)
    A = rng.normal(size=(8, 8, N)) + 4.0 * np.eye(8)[:, :, None]
    A *= 10.0 ** rng.uniform(-3, 3, size=(8, 1, N))
    b = rng.normal(size=(8, N) if rhs == "vector" else (8, 5, N))
    got = T_CM.solve_dense_cm_eq(torch.as_tensor(A), torch.as_tensor(b))
    ref = J_CM.solve_dense_cm_eq(jnp.asarray(A), jnp.asarray(b))
    x = np.asarray(ref)
    # 1e-13 of each lane's solution scale: cond(A) after equilibration
    # is O(10), and the two eliminations round in different orders
    scale = np.max(np.abs(x), axis=0, keepdims=True)
    assert np.all(np.abs(got.numpy() - x) <= 1e-13 * np.maximum(scale, 1.0))
    # and it solves the system
    if rhs == "vector":
        np.testing.assert_allclose(np.einsum("ijn,jn->in", A, got.numpy()),
                                   b, rtol=0, atol=1e-12 * np.abs(A).max())
