"""PyTorch port against the JAX package: PCG, mixed-precision PCG and the
geometric multigrid V-cycle on EA systems built by both packages; MINRES
and GMRES on those and on dense SPD, symmetric indefinite and
nonsymmetric systems; and that a V-cycle leaves no reference cycle
holding its hierarchy."""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from exaconstit_tpu.fem import operators as J_OPS
from exaconstit_tpu.fem.reference import ref_element
from exaconstit_tpu.mesh.voxel import make_cartesian_mesh
from exaconstit_tpu.solvers import gmg as J_GMG
from exaconstit_tpu.solvers import krylov as J_KRY
from exaconstit_tpu_torch.fem import operators as T_OPS
from exaconstit_tpu_torch.fem.space import StructuredMap
from exaconstit_tpu_torch.solvers import gmg as T_GMG
from exaconstit_tpu_torch.solvers import krylov as T_KRY


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_power_start(monkeypatch):
    """The port's seeded power-iteration start replaced by the JAX
    package's (jax.random key 0), so both estimate the same lambda_max."""
    def start(n, dtype, device):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        v = np.array(jax.random.normal(jax.random.PRNGKey(0), (n,), jdt))
        return torch.as_tensor(v, device=device)

    monkeypatch.setattr(T_GMG, "_power_start", start)


def ea_system(grid, seed=0):
    """EA blocks of an elastic cube (isotropic + seeded anisotropy,
    perturbed nodes), uniaxial-test essential dofs, a seeded rhs; all as
    numpy (k (24, 24, ne), ess (3*nn,), b (3*nn,))."""
    rng = np.random.default_rng(seed)
    mesh = make_cartesian_mesh(grid, [1.0, 1.0, 1.0], order=1)
    x = mesh.coords + rng.normal(size=mesh.coords.shape) * 0.01 / max(grid)
    el_x = x.T[:, mesh.conn.T]
    lam, mu = 100.0, 50.0
    c = np.zeros((6, 6))
    c[:3, :3] = lam
    c += np.diag([2 * mu] * 3 + [mu] * 3)
    a = rng.normal(size=(6, 6, 8, mesh.num_elems)) * 5.0
    c6 = c[:, :, None, None] + 0.5 * (a + a.transpose(1, 0, 2, 3))
    ref = ref_element(1)
    k = np.asarray(J_OPS.assemble_ea_gradient_cm(
        jnp.asarray(el_x), jnp.asarray(ref.dshape), jnp.asarray(ref.qwts),
        jnp.asarray(c6), 1.0))
    ess = np.zeros((mesh.num_nodes, 3), bool)
    ess[mesh.bdr_nodes[1], 2] = True
    ess[mesh.bdr_nodes[2], 0] = True
    ess[mesh.bdr_nodes[3], 1] = True
    ess[mesh.bdr_nodes[4], 2] = True
    ess = ess.T.reshape(-1)
    b = np.where(ess, 0.0, rng.normal(size=ess.size))
    return mesh, k, ess, b


def operators(mesh, k, ess):
    """(jax matvec, jax diag, torch matvec, torch diag) of the masked EA
    operator: identity rows/cols at essential dofs."""
    conn_T = mesh.conn.T
    nn = mesh.num_nodes
    smap = StructuredMap(mesh.structure)

    def j_mv(kk, x):
        x0 = jnp.where(ess, 0.0, x)
        el = J_OPS.apply_ea_gradient_cm(kk, x0.reshape(3, nn)[:, conn_T])
        y = jnp.zeros((3, nn), x.dtype).at[:, conn_T.reshape(-1)].add(
            el.reshape(3, -1)).reshape(-1)
        return jnp.where(ess, x, y)

    ess_t = torch.tensor(ess)

    def t_mv(kk, x):
        y = smap.scatter_add(T_OPS.apply_ea_gradient_cm(
            kk, smap.gather(torch.where(ess_t, 0.0, x))))
        return torch.where(ess_t, x, y)

    dloc = np.asarray(J_OPS.ea_diagonal_cm(jnp.asarray(k), 8))
    d = np.zeros((3, nn))
    np.add.at(d, (slice(None), conn_T.reshape(-1)), dloc.reshape(3, -1))
    diag = np.where(ess, 1.0, d.reshape(-1))
    return j_mv, t_mv, diag, ess_t


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_pcg_jacobi_f64():
    """f64 PCG with Jacobi, tol 1e-10: same iterations, same solution."""
    mesh, k, ess, b = ea_system((4, 4, 4))
    j_mv, t_mv, diag, _ = operators(mesh, k, ess)
    kj, kt = jnp.asarray(k), torch.tensor(k)
    xj, itj, okj, _ = J_KRY.pcg(lambda x: j_mv(kj, x),
                                lambda v: v / jnp.asarray(diag),
                                jnp.asarray(b), 1e-10, 1e-30, 500)
    xt, itt, okt, rel = T_KRY.pcg(lambda x: t_mv(kt, x),
                                  lambda v: v / torch.tensor(diag),
                                  torch.tensor(b), 1e-10, 1e-30, 500)
    assert bool(okj) and okt and rel <= 1e-10
    assert itt == int(itj)
    assert _rel(xt.numpy(), xj) < 1e-10


def test_pcg_refined_jacobi():
    """Mixed precision: f32 inner PCG on the f32 blocks, f64 replay.  The
    two inner solves round differently in f32, so the outer iterates are
    not the same numbers: both must meet the f64 criterion (rel 1e-10)
    and agree with each other to the accuracy that buys (1e-8 rel of the
    solution, cond(D^-1 K) ~ 1e2 times the tolerance)."""
    mesh, k, ess, b = ea_system((4, 4, 4), seed=1)
    j_mv, t_mv, diag, _ = operators(mesh, k, ess)
    kj, kt = jnp.asarray(k), torch.tensor(k)
    kj32, kt32 = kj.astype(jnp.float32), kt.float()
    dj, dt = jnp.asarray(diag), torch.tensor(diag)
    xj, itj, okj, _ = J_KRY.pcg_refined(
        lambda x: j_mv(kj, x), lambda v: v / dj, lambda x: j_mv(kj32, x),
        lambda v: v / dj.astype(jnp.float32), jnp.asarray(b), 1e-10, 1e-30,
        500)
    xt, itt, okt, rel = T_KRY.pcg_refined(
        lambda x: t_mv(kt, x), lambda v: v / dt, lambda x: t_mv(kt32, x),
        lambda v: v / dt.float(), torch.tensor(b), 1e-10, 1e-30, 500)
    assert bool(okj) and okt and rel <= 1e-10
    assert xt.dtype == torch.float64
    assert abs(itt - int(itj)) <= 2
    assert _rel(xt.numpy(), xj) < 1e-8
    # and it solves the f64 system
    r = torch.tensor(b) - t_mv(kt, xt)
    assert float(torch.linalg.vector_norm(r)) < 1e-8 * np.linalg.norm(b)


GMG_GRID = (16, 8, 8)  # the smallest family of grids that coarsens


def test_gmg_meta_and_transfer():
    jm, tm = J_GMG.GMGMeta(GMG_GRID), T_GMG.GMGMeta(GMG_GRID)
    assert tm.grids == jm.grids == [(16, 8, 8), (8, 4, 4)]
    assert (tm.coarse_dense, tm.nlevels, tm.usable) == (
        jm.coarse_dense, jm.nlevels, jm.usable)
    np.testing.assert_array_equal(tm.wd, jm.wd)
    np.testing.assert_array_equal(T_GMG._grid_conn(*tm.grids[1]),
                                  J_GMG._grid_conn(*jm.grids[1]))
    rng = np.random.default_rng(5)
    fine = rng.normal(size=(3, 17 * 9 * 9))
    coarse = rng.normal(size=(3, 9 * 5 * 5))
    np.testing.assert_allclose(
        T_GMG._prolong(torch.tensor(coarse), GMG_GRID).numpy(),
        np.asarray(J_GMG._prolong(jnp.asarray(coarse), GMG_GRID)),
        rtol=0, atol=1e-15)
    r = T_GMG._restrict(torch.tensor(fine), GMG_GRID).numpy()
    np.testing.assert_allclose(
        r, np.asarray(J_GMG._restrict(jnp.asarray(fine), GMG_GRID)),
        rtol=0, atol=1e-14)
    # restriction is the adjoint of prolongation
    lhs = np.sum(fine * T_GMG._prolong(torch.tensor(coarse),
                                       GMG_GRID).numpy())
    assert abs(lhs - np.sum(r * coarse)) < 1e-12 * abs(lhs)


def _hierarchies(k, ess, b, mesh):
    j_mv, t_mv, diag, ess_t = operators(mesh, k, ess)
    kj, kt = jnp.asarray(k), torch.tensor(k)
    jlev = J_GMG.build_hierarchy(J_GMG.GMGMeta(GMG_GRID), kj,
                                 jnp.asarray(ess), lambda x: j_mv(kj, x),
                                 jnp.asarray(diag))
    tlev = T_GMG.build_hierarchy(T_GMG.GMGMeta(GMG_GRID), kt, ess_t,
                                 lambda x: t_mv(kt, x), torch.tensor(diag))
    return jlev, tlev, j_mv, t_mv


def test_gmg_hierarchy_and_v_cycle(jax_power_start):
    """f64: the Galerkin coarse blocks, the Chebyshev bounds and one
    V-cycle agree to 1e-10 relative."""
    mesh, k, ess, b = ea_system(GMG_GRID, seed=2)
    jlev, tlev, _, _ = _hierarchies(k, ess, b, mesh)
    assert len(jlev) == len(tlev) == 2
    for jl, tl in zip(jlev, tlev):
        assert abs(float(tl["lmax"]) - float(jl["lmax"])) < 1e-12 * float(
            jl["lmax"])
        assert _rel(tl["dinv"].numpy(), jl["dinv"]) < 1e-13
        np.testing.assert_array_equal(tl["ess"].numpy(), np.asarray(jl["ess"]))
    z_j = J_GMG.v_cycle(jlev, jnp.asarray(b), coarse_dense=True)
    z_t = T_GMG.v_cycle(tlev, torch.tensor(b))
    assert _rel(z_t.numpy(), z_j) < 1e-10


def test_v_cycle_leaves_no_reference_cycle():
    """A V-cycle keeps no reference to its hierarchy once it returns: with
    the cycle collector off, dropping the levels frees them at once.  A
    V-cycle that recursed through a closure calling itself was a reference
    cycle holding every level, the fine blocks included, on the device
    until the collector ran."""
    mesh, k, ess, b = ea_system(GMG_GRID, seed=2)
    _, t_mv, diag, ess_t = operators(mesh, k, ess)
    kt = torch.tensor(k)
    levels = T_GMG.build_hierarchy(T_GMG.GMGMeta(GMG_GRID), kt, ess_t,
                                   lambda x: t_mv(kt, x), torch.tensor(diag))
    assert len(levels) == 2
    coarse = weakref.ref(levels[-1]["dinv"])
    gc.collect()
    gc.disable()
    try:
        z = T_GMG.v_cycle(levels, torch.tensor(b))
        assert bool(torch.isfinite(z).all())
        del levels
        assert coarse() is None
    finally:
        gc.enable()


def test_dense_coarse_solve_not_positive_definite(jax_power_start):
    """A coarsest-level matrix that is not positive definite (the negated
    Galerkin blocks) gives an all-NaN direct solve in both packages, not
    an exception, so PCG stops on breakdown and Newton can retry."""
    mesh, k, ess, b = ea_system(GMG_GRID, seed=2)
    jlev, _, _, _ = _hierarchies(k, ess, b, mesh)
    jl = dict(jlev[-1], k=-jlev[-1]["k"])
    nn = jl["nn"]
    chol = T_GMG._dense_factor(-torch.tensor(np.asarray(jlev[-1]["k"])),
                               np.asarray(jl["conn"]),
                               torch.tensor(np.asarray(jl["ess"])), nn)
    rc = np.random.default_rng(0).normal(size=3 * nn)
    z_t = T_GMG._dense_solve(dict(chol=chol), torch.tensor(rc))
    assert np.isnan(np.asarray(J_GMG._dense_solve(jl, jnp.asarray(rc)))).all()
    assert bool(torch.isnan(z_t).all())


def test_pcg_gmg_f64(jax_power_start):
    """f64 PCG preconditioned by the V-cycle: same iterations, solution
    to 1e-10 relative."""
    mesh, k, ess, b = ea_system(GMG_GRID, seed=3)
    jlev, tlev, j_mv, t_mv = _hierarchies(k, ess, b, mesh)
    kj, kt = jnp.asarray(k), torch.tensor(k)
    xj, itj, okj, _ = J_KRY.pcg(lambda x: j_mv(kj, x),
                                lambda v: J_GMG.v_cycle(jlev, v),
                                jnp.asarray(b), 1e-10, 1e-30, 200)
    xt, itt, okt, _ = T_KRY.pcg(lambda x: t_mv(kt, x),
                                lambda v: T_GMG.v_cycle(tlev, v),
                                torch.tensor(b), 1e-10, 1e-30, 200)
    assert bool(okj) and okt
    assert itt == int(itj) < 30
    assert _rel(xt.numpy(), xj) < 1e-10


def _dense_system(kind):
    """(A, b, precond diagonal or None) as in tests/test_krylov.py."""
    if kind == "spd":
        rng = np.random.default_rng(0)
        A = rng.normal(size=(64, 64))
        A = A @ A.T + 64 * np.eye(64)
        return A, rng.normal(size=64), np.diag(A)
    if kind == "indefinite":
        rng = np.random.default_rng(3)
        Q, _ = np.linalg.qr(rng.normal(size=(48, 48)))
        lam = np.concatenate([np.linspace(1, 10, 40),
                              -np.linspace(1, 3, 8)])
        return Q @ np.diag(lam) @ Q.T, rng.normal(size=48), None
    rng = np.random.default_rng(4)  # nonsymmetric
    return rng.normal(size=(40, 40)) + 8 * np.eye(40), rng.normal(size=40), \
        None


@pytest.mark.parametrize("solver,kind", [
    ("minres", "spd"), ("gmres", "spd"), ("minres", "indefinite"),
    ("gmres", "indefinite"), ("gmres", "nonsymmetric"), ("minres", "ea"),
    ("gmres", "ea")])
def test_minres_gmres(solver, kind):
    """MINRES and GMRES (f64) against the JAX package's: the same
    iteration counts and solutions to 1e-10 rel, on the dense systems of
    tests/test_krylov.py and on the masked EA system with Jacobi."""
    tol, max_iter, kw = 1e-12, 600, {}
    if kind == "ea":
        mesh, k, ess, b = ea_system((4, 4, 4), seed=2)
        j_mv, t_mv, diag, _ = operators(mesh, k, ess)
        kj, kt = jnp.asarray(k), torch.tensor(k)
        jmv, tmv = (lambda x: j_mv(kj, x)), (lambda x: t_mv(kt, x))
        tol = 1e-10
    else:
        A, b, diag = _dense_system(kind)
        Aj, At = jnp.asarray(A), torch.tensor(A)
        jmv, tmv = (lambda v: Aj @ v), (lambda v: At @ v)
        if kind == "nonsymmetric":
            tol, max_iter, kw = 1e-13, 400, dict(restart=20)
    if diag is None:
        jpc, tpc = (lambda v: v), (lambda v: v)
    else:
        dj, dt = jnp.asarray(1.0 / diag), torch.tensor(1.0 / diag)
        jpc, tpc = (lambda v: dj * v), (lambda v: dt * v)
    xj, itj, okj, relj = getattr(J_KRY, solver)(jmv, jpc, jnp.asarray(b),
                                                tol, 1e-30, max_iter, **kw)
    xt, itt, okt, relt = getattr(T_KRY, solver)(tmv, tpc, torch.tensor(b),
                                                tol, 1e-30, max_iter, **kw)
    assert bool(okj) and okt and relt <= tol and float(relj) <= tol
    assert itt == int(itj)
    assert _rel(xt.numpy(), xj) < 1e-10


@pytest.mark.parametrize("solver", ["minres", "gmres"])
def test_minres_gmres_cap_and_zero_rhs(solver):
    """A capped solve reads unconverged with rel_reduction above the
    tolerance; a zero right-hand side returns x = 0 after 0 iterations."""
    A, b, _ = _dense_system("spd")
    At = torch.tensor(A)
    fn = getattr(T_KRY, solver)
    kw = dict(restart=3) if solver == "gmres" else {}
    x, it, ok, rel = fn(lambda v: At @ v, lambda v: v, torch.tensor(b),
                        1e-14, 1e-300, 3, **kw)
    assert it == 3 and not ok and rel > 1e-14
    x, it, ok, rel = fn(lambda v: At @ v, lambda v: v, torch.zeros(64),
                        1e-10, 1e-30, 100)
    assert ok and it == 0 and not x.any()
