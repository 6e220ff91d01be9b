"""PyTorch port against the JAX package: one Newton-Krylov solve of a
small FCC Voce problem (``__graft_entry__._tiny_problem`` on both sides).

* pinned: f64 EA build and Jacobi on both sides (the reference through
  EXACONSTIT_EA_ASM_F32=0 and EXACONSTIT_PRECOND=jacobi, the port through
  ``ea_asm_f32=False`` and ``krylov_precond="jacobi"``), Newton driven to
  rel 1e-9: 1e-10 relative, same NR and Krylov iteration counts;
* production defaults (f32 EA build, GMG where the grid coarsens, the
  input's Newton tolerance): 1e-6 relative, the Newton tolerance level.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.driver import MechSystem
from exaconstit_tpu_torch.mesh.voxel import make_cartesian_mesh
from exaconstit_tpu_torch.models.ecmech import build_model
from exaconstit_tpu_torch.solvers import gmg as T_GMG


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)

    def start(n, dtype, device):  # the JAX package's power-iteration start
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        v = np.array(jax.random.normal(jax.random.PRNGKey(0), (n,), jdt))
        return torch.as_tensor(v, device=device)

    monkeypatch.setattr(T_GMG, "_power_start", start)
    yield
    torch.set_num_threads(n)


def port_problem(ncuts, precond="auto", ea_asm_f32=None):
    """The port's twin of ``_tiny_problem``: same options, mesh, seeded
    orientations and uniaxial BCs, in host (point-major) arrays."""
    opt = T_OPT.ExaOptions()
    opt.mech_type = T_OPT.MechType.EXACMECH
    opt.xtal_type = T_OPT.XtalType.FCC
    opt.slip_type = T_OPT.SlipType.POWERVOCE
    opt.assembly = T_OPT.Assembly.EA
    opt.solver = T_OPT.KrylovSolver.PCG
    opt.krylov_rel_tol, opt.krylov_abs_tol, opt.krylov_iter = 1e-7, 1e-27, 200
    opt.krylov_precond = precond
    mesh = make_cartesian_mesh(ncuts, [1.0, 1.0, 1.0], order=1)
    model = build_model(opt, graft._VOCE_PROPS)
    system = MechSystem(opt, mesh, model, device="cpu",
                        ea_asm_f32=ea_asm_f32)
    rng = np.random.default_rng(0)
    q = rng.normal(size=(mesh.num_elems, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = model.init_state(np.repeat(q, system.nq, axis=0)).reshape(
        mesh.num_elems, system.nq, -1)
    ess = np.zeros((mesh.num_nodes, 3), dtype=bool)
    ess[mesh.bdr_nodes[1], 2] = True
    ess[mesh.bdr_nodes[2], 0] = True
    ess[mesh.bdr_nodes[3], 1] = True
    ess[mesh.bdr_nodes[4], 2] = True
    v0 = np.zeros((mesh.num_nodes, 3))
    v0[mesh.bdr_nodes[4], 2] = 1e-3
    return (system, system.to_node(v0), system.to_node(mesh.coords),
            system.to_state(state), ess)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def solve_both(ncuts, dt, nr_rel_tol=None, pinned=False):
    js, jv, jx, jst, jess = graft._tiny_problem(list(ncuts))
    ts, tv, tx, tst, tess = port_problem(
        ncuts, precond="jacobi" if pinned else "auto",
        ea_asm_f32=False if pinned else None)
    if nr_rel_tol is not None:
        js.opt.newton_rel_tol = ts.opt.newton_rel_tol = nr_rel_tol
        js.opt.newton_abs_tol = ts.opt.newton_abs_tol = 1e-14
    assert ts.precond_kind == js.precond_kind
    out_j = js.newton_solve(jv, jx, jst, dt, jess, verbose=False)
    with torch.inference_mode():
        out_t = ts.newton_solve(tv, tx, tst, dt, tess, verbose=False)
    assert bool(out_j[3]) and out_t[3]
    return js, ts, out_j, out_t


def test_newton_pinned_f64_jacobi(monkeypatch):
    monkeypatch.setenv("EXACONSTIT_EA_ASM_F32", "0")
    monkeypatch.setenv("EXACONSTIT_PRECOND", "jacobi")
    js, ts, out_j, out_t = solve_both((4, 4, 4), 0.1, nr_rel_tol=1e-9,
                                      pinned=True)
    assert not js._ea_asm_f32 and js.precond_kind == "jacobi"
    sj, st = js.last_newton_stats, ts.last_newton_stats
    assert st["nr_iters"] == sj["nr_iters"]
    assert st["krylov_iters"] == sj["krylov_iters"]
    for a, b in zip(out_t[:3], out_j[:3]):
        assert _rel(a.numpy(), b) < 1e-10


@pytest.mark.parametrize("ncuts,precond", [((4, 4, 4), "jacobi"),
                                           ((16, 8, 8), "gmg")])
def test_newton_production_defaults(ncuts, precond):
    """f32 EA build, f32 lagged tangent and f32 inner PCG on both sides,
    GMG on the grid that coarsens: agreement at the Newton tolerance."""
    js, ts, out_j, out_t = solve_both(ncuts, 0.1)
    assert ts.precond_kind == precond and ts.ea_asm_f32
    for a, b in zip(out_t[:3], out_j[:3]):
        assert _rel(a.numpy(), b) < 1e-6
