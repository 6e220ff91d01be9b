"""PyTorch port against the JAX package: one Newton-Krylov solve of a
small FCC Voce problem (``__graft_entry__._tiny_problem`` on both sides).

* pinned: f64 EA build and Jacobi on both sides (the reference through
  EXACONSTIT_EA_ASM_F32=0 and EXACONSTIT_PRECOND=jacobi, the port through
  ``ea_asm_f32=False`` and ``krylov_precond="jacobi"``), Newton driven to
  rel 1e-9: 1e-10 relative, same NR and Krylov iteration counts;
* production defaults (f32 EA build, GMG where the grid coarsens, the
  input's Newton tolerance): 1e-6 relative, the Newton tolerance level.

And the ``Simulation`` loop on the in-repo Voce case at 4^3: automatic
time stepping (the same dt sequence, average stress to 1e-6) with the
additional averages (every file to 1e-6 of its largest entry, the
plastic deformation rate lagging one step), the retry logic of the
automatic step on a stubbed Newton solve, and the configurations once
refused.  And ``make_step``, the fixed-Newton step, against the
reference's ``make_jit_step``.

And the point-major half: ``model_setup`` against the reference's
point-major update (pure f64, 1e-10), and the case from a mesh file
(EA, PA), with B-bar, GMRES and MINRES through both packages'
``Simulation`` with Newton and Krylov driven to rel 1e-10 (1e-8).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from exaconstit_tpu.config import options as J_OPT
from exaconstit_tpu.driver import Simulation as JSimulation
from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.driver import MechSystem, Simulation
from exaconstit_tpu_torch.fem.space import IndexMap
from exaconstit_tpu_torch.models.umat import UmatModel
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


def port_problem(ncuts, precond="auto", ea_asm_f32=None, device="cpu",
                 **system):
    """The port's twin of ``_tiny_problem``: same options, mesh, seeded
    orientations and uniaxial BCs, in host (point-major) arrays
    (``system``: more ``MechSystem`` arguments)."""
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
    system = MechSystem(opt, mesh, model, device=device,
                        ea_asm_f32=ea_asm_f32, **system)
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


AUTO = dict(dt_start=0.1, dt_min=0.05, dt_scale=0.25, t_final=0.5)


def test_auto_dt_and_additional_averages(tmp_path):
    """Automatic time stepping grows dt by newton_iter * dt_scale / nit:
    both packages take the same steps (1e-12) to t_final and write them to
    the dt file; average stress, plastic work, deformation gradient and
    plastic deformation rate agree to 1e-6 of each file's largest entry
    (the files print 6 digits)."""
    toml = cases.write_voce_case(tmp_path / "case", (4, 4, 4), None,
                                 ngrains=12, auto_dt=AUTO,
                                 additional_avgs=True)
    out = {}
    for name, opts, sim_cls, kw in (("jax", J_OPT, JSimulation, {}),
                                    ("torch", T_OPT, Simulation,
                                     {"device": "cpu"})):
        wd = tmp_path / name
        wd.mkdir()
        with torch.inference_mode():
            sim = sim_cls(opts.parse_options(toml), workdir=str(wd), **kw)
            t_end = sim.run(verbose=False)
        assert abs(t_end - AUTO["t_final"]) < 1e-12
        out[name] = {f: np.loadtxt(wd / f, ndmin=2) for f in (
            "auto_dt_out.txt", "avg_stress.txt", "avg_pl_work.txt",
            "avg_def_grad.txt", "avg_dp_tensor.txt")}
    j, t = out["jax"], out["torch"]
    dts = t["auto_dt_out.txt"].ravel()
    assert len(dts) >= 3 and dts[1] > dts[0] and abs(dts.sum() - 0.5) < 1e-9
    np.testing.assert_allclose(dts, j["auto_dt_out.txt"].ravel(), rtol=0,
                               atol=1e-12)
    for f in j:
        assert t[f].shape == j[f].shape, f
        assert _rel(t[f], j[f]) < 1e-6, f
    n = len(dts)
    assert t["avg_stress.txt"].shape == (n, 6)
    assert t["avg_def_grad.txt"].shape == (n, 9)
    # F_zz - 1 is the applied strain 1e-3 * t; the plastic work grows
    np.testing.assert_allclose(t["avg_def_grad.txt"][:, 8],
                               1 + 1e-3 * np.cumsum(dts), rtol=1e-5)
    assert (np.diff(t["avg_pl_work.txt"].ravel()) > 0).all()
    # Dp reads the state the step began from: zero after step 1, and
    # after step k what the state held after step k - 1
    dp = t["avg_dp_tensor.txt"]
    assert not dp[0].any() and np.abs(dp[-1]).max() > 1e-5


class _StubSystem:
    """newton_solve that fails a set number of times, then converges in
    ``nit`` iterations; records the dt of every call."""

    def __init__(self, real, fails, nit):
        self.real, self.fails, self.nit, self.dts = real, fails, nit, []
        self.last_newton_stats = {}

    def __getattr__(self, name):
        return getattr(self.real, name)

    def newton_solve(self, v, x_beg, state, dt, ess_mask, verbose=True):
        self.dts.append(dt)
        conv = len(self.dts) > self.fails
        return v, self.real_stress, state, conv, self.nit, 0.0


@pytest.mark.parametrize("fails,ok", [(0, True), (2, True), (3, False)])
def test_auto_dt_retries(tmp_path, fails, ok):
    """A failed solve is retried at dt * dt_scale, at most twice, from the
    velocity the step began with; the step returns the dt it took and
    sets the next one to dt * newton_iter * dt_scale / nit, never below
    dt_min."""
    toml = cases.write_voce_case(tmp_path / "case", (2, 2, 2), None,
                                 ngrains=4, auto_dt=dict(AUTO, dt_min=0.03,
                                                         dt_scale=0.5))
    sim = Simulation(T_OPT.parse_options(toml), workdir=str(tmp_path),
                     device="cpu")
    stub = _StubSystem(sim.system, fails, nit=5)
    stub.real_stress = sim.stress
    sim.advance(1, 0.1, verbose=False)  # a real first step (with SolveInit)
    sim.system = stub
    if not ok:
        with pytest.raises(RuntimeError, match="did not converge"):
            sim.advance(2, 0.1, verbose=False)
        assert stub.dts == [0.1, 0.05, 0.03]
        return
    dt = sim.advance(2, 0.1, verbose=False)
    assert stub.dts == [0.1, 0.05, 0.03][:fails + 1] and dt == stub.dts[-1]
    assert sim.dt_auto_cur == pytest.approx(max(dt * 25 * 0.5 / 5, 0.03))
    written = np.loadtxt(tmp_path / "auto_dt_out.txt").ravel()
    assert written[-1] == pytest.approx(dt)


@pytest.mark.parametrize("what,match", [
    ("umat", "UMAT"), ("mesh", "mesh files"), ("f32", "precision")])
def test_simulation_still_refuses(tmp_path, what, match):
    """The three configurations the port refused before (UMAT materials,
    mesh files, precisions other than f64) all build now, with the
    element map, operator, model and floating type they ask for."""
    toml = cases.write_voce_case(tmp_path / "case", (2, 2, 2), (0.1,),
                                 ngrains=4, additional_avgs=True,
                                 paraview=True, checkpoint_steps=1,
                                 mesh_file=what == "mesh")
    if what == "umat":
        toml = cases.write_umat_case(tmp_path / "umat", (2, 2, 2), (0.1,))
    opt = T_OPT.parse_options(toml)
    if what == "f32":
        sim = Simulation(opt, workdir=str(tmp_path), device="cpu")
        assert sim.system.dtype == torch.float64
        opt.precision = "f32"
        sim = Simulation(opt, workdir=str(tmp_path), device="cpu")
        assert match == "precision" and sim.system.dtype == torch.float32
        for t in (sim.x_ref, sim.v, sim.state, sim.stress,
                  sim.system.dshape, sim.system.qwts):
            assert t.dtype == torch.float32
        return
    sim = Simulation(opt, workdir=str(tmp_path), device="cpu")
    if what == "umat":
        assert opt.mech_type == T_OPT.MechType.UMAT
        assert isinstance(sim.model, UmatModel) and sim.system.point_major
    else:
        assert opt.mesh_type == T_OPT.MeshType.OTHER
        assert sim.mesh.structure is None
        assert isinstance(sim.system.emap, IndexMap)


def test_model_setup_point_major():
    """The point-major ``model_setup`` (``evptn.batched_update`` on the
    component-major engine) against the reference's point-major one
    (``evptn._outputs_from_solution`` under vmap, ``tangent_cm``), pure
    f64 on both sides and both cold: stress, end state and tangent to
    1e-10 rel, at dt 0.1 (one substep) and 1.0 (ten)."""
    import dataclasses

    from exaconstit_tpu.models.ecmech import build_model as j_build
    from exaconstit_tpu_torch.models.convert import (arrays_from_model,
                                                     ecmech_from_reference)
    opt = J_OPT.ExaOptions()
    opt.mech_type = J_OPT.MechType.EXACMECH
    opt.xtal_type = J_OPT.XtalType.FCC
    opt.slip_type = J_OPT.SlipType.POWERVOCE
    jm = j_build(opt, graft._VOCE_PROPS)
    jm = dataclasses.replace(jm, evptn=dataclasses.replace(
        jm.evptn, mixed_precision=False))
    tm = ecmech_from_reference(arrays_from_model(jm))
    assert not tm.evptn.mixed_precision
    rng = np.random.default_rng(5)
    n = 64
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = jm.init_state(q)
    L = rng.normal(size=(n, 3, 3)) * 1e-3
    for dt in (0.1, 1.0):
        want = jm.model_setup(dt, jnp.asarray(L), jnp.asarray(state))
        with torch.inference_mode():
            got = tm.model_setup(dt, torch.tensor(L), torch.tensor(state))
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert _rel(a.numpy(), b) < 1e-10
    with torch.inference_mode():
        out = tm.model_setup(0.1, torch.tensor(L), torch.tensor(state),
                             compute_tangent=False)
    assert out[2] is None


VARIANTS = {"mesh_file_EA": dict(mesh_file=True),
            "mesh_file_PA": dict(mesh_file=True, assembly="PA"),
            "BBar": dict(integ_model="BBAR"),
            "GMRES": dict(krylov_solver="GMRES"),
            "MINRES": dict(krylov_solver="MINRES")}


@pytest.mark.parametrize("name", VARIANTS)
def test_simulation_variants_tight(name, tmp_path):
    """The in-repo Voce case at 4^3 through both packages' ``Simulation``
    with Newton driven to rel 1e-10 and Krylov to rel 1e-10: a mesh file
    (the index scatter; EA, or PA with cold point solves and the f64
    build), B-bar, GMRES and MINRES.  Stress and state to 1e-8 rel."""
    options = VARIANTS[name]
    toml = cases.write_voce_case(tmp_path / "case", (4, 4, 4), (0.1, 0.2),
                                 ngrains=20, **options)
    out = {}
    for tag, opts, sim_cls, kw in (("jax", J_OPT, JSimulation, {}),
                                   ("torch", T_OPT, Simulation,
                                    {"device": "cpu"})):
        opt = opts.parse_options(toml)
        opt.newton_rel_tol, opt.newton_abs_tol = 1e-10, 1e-16
        opt.krylov_rel_tol = 1e-10
        wd = tmp_path / tag
        wd.mkdir()
        with torch.inference_mode():
            sim = sim_cls(opt, workdir=str(wd), **kw)
            sim.run(verbose=False)
        out[tag] = (sim.system.from_stress(sim.stress),
                    sim.system.from_state(sim.state))
        if tag == "torch":
            sysm = sim.system
            assert isinstance(sysm.emap, IndexMap) == options.get(
                "mesh_file", False)
            assert sysm.point_major == (name in ("mesh_file_PA", "BBar"))
            assert sysm.precond_kind == "jacobi"
    for a, b in zip(out["torch"], out["jax"]):
        assert _rel(a, b) < 1e-8


def test_make_step_matches_make_jit_step(monkeypatch):
    """The fixed-Newton step (2 setup-plus-Krylov updates, no line
    search, the point solution carried warm, then a final setup) against
    the reference's ``make_jit_step`` at 4^3, dt 0.1, pinned f64 EA build
    and Jacobi on both sides.  Two Newton iterations leave the tangent's
    rounding in the result (the Voce tangent is computed in f32, as in
    the reference), so v, x_cur, stress and end state agree to 1e-6 rel
    (measured: v 1.9e-7, stress 3.6e-7) and the final residual norm to
    1e-5 rel (5.8e-7)."""
    monkeypatch.setenv("EXACONSTIT_EA_ASM_F32", "0")
    monkeypatch.setenv("EXACONSTIT_PRECOND", "jacobi")
    js, jv, jx, jst, jess = graft._tiny_problem([4, 4, 4])
    ts, tv, tx, tst, tess = port_problem((4, 4, 4), precond="jacobi",
                                         ea_asm_f32=False)
    want = js.make_jit_step(2)(jv, jx, jst, 0.1, js._ess_flat(jess))
    with torch.inference_mode():
        got = ts.make_step(2)(tv, tx, tst, 0.1, tess)
    assert got[4].ndim == 0
    for a, b in zip(got[:4], want[:4]):
        assert _rel(a.numpy(), b) < 1e-6
    assert abs(float(got[4]) / float(want[4]) - 1.0) < 1e-5
