"""The port's ``SlabMechSystem`` (8 slab shards stacked on one device)
against the JAX package's (8 virtual devices) and against the port's
single-device ``MechSystem``, on the reference test's crystal problem
(``tests/test_slab_system.py``: 2x2x8 voxels, seeded quaternions, FCC
Voce, uniaxial BCs, Jacobi-PCG to rel 1e-10, the f64 EA build on the
single-device side).

Newton is driven to rel 1e-9 on every side: the two packages' f32
lagged tangents round differently (the first setup's diagonal, an EA
block sum, differs by rel 2.8e-7, as it does between the two
single-device systems), so their Newton paths part at the 1e-10 level
and only a tight stop compares the converged solutions.

Bars, the reference test's: the first setup's residual atol 1e-12,
stress 1e-11, state 1e-10 (its diagonal rtol 1e-6, the tangent's f32
rounding); the Krylov solve of the reference's own first-setup system
through the port's slab (its operator, diagonal and residual carried
across) atol 2e-12 in the same iterations; the converged velocity atol
2e-12, stress 1e-11, state 1e-10; the volume averages rtol 1e-12 / atol
1e-14; ``solve_init`` atol 1e-11.  PA and B-bar through the slab against
the single device: the slab warm-starts their point solves as the
reference's slab does, the single device starts them cold, so velocity
atol 1e-11 and stress and state atol 1e-9.  And the configurations the
slab refuses, and those it does not take, which run on the
replicated-node element sharding as the JAX ``Simulation`` picks it.
"""

import numpy as np
import pytest
import torch

import jax
import torch.distributed as dist

from exaconstit_tpu.config import options as J_OPT
from exaconstit_tpu.driver import Simulation as JSimulation
from exaconstit_tpu.mesh.voxel import make_cartesian_mesh as j_mesh
from exaconstit_tpu.models.ecmech import build_model as j_build_model
from exaconstit_tpu.parallel.sharding import make_device_mesh
from exaconstit_tpu.parallel.slab_system import \
    SlabMechSystem as JSlabMechSystem
from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.config.options import parse_options
from exaconstit_tpu_torch.driver import MechSystem, Simulation
from exaconstit_tpu_torch.mesh.voxel import make_cartesian_mesh
from exaconstit_tpu_torch.models.ecmech import build_model
from exaconstit_tpu_torch.parallel.slab_system import SlabMechSystem

DT = 0.05


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _options(opt_mod, assembly="EA", integ="FULL"):
    opt = opt_mod.ExaOptions()
    opt.mech_type = opt_mod.MechType.EXACMECH
    opt.xtal_type = opt_mod.XtalType.FCC
    opt.slip_type = opt_mod.SlipType.POWERVOCE
    opt.assembly = opt_mod.Assembly[assembly]
    opt.integ_type = opt_mod.IntegrationType[integ]
    opt.solver = opt_mod.KrylovSolver.PCG
    opt.krylov_rel_tol, opt.krylov_abs_tol, opt.krylov_iter = \
        1e-10, 1e-30, 300
    opt.krylov_precond = "jacobi"
    opt.newton_rel_tol, opt.newton_abs_tol = 1e-9, 1e-14
    return opt


def _host_problem(mesh, model, nq):
    """Seeded state, essential mask and start velocity, host arrays."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(mesh.num_elems, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = model.init_state(np.repeat(q, nq, axis=0)).reshape(
        mesh.num_elems, nq, -1)
    ess = np.zeros((mesh.num_nodes, 3), dtype=bool)
    ess[mesh.bdr_nodes[1], 2] = True
    ess[mesh.bdr_nodes[2], 0] = True
    ess[mesh.bdr_nodes[3], 1] = True
    ess[mesh.bdr_nodes[4], 2] = True
    v0 = np.zeros((mesh.num_nodes, 3))
    v0[mesh.bdr_nodes[4], 2] = 1e-3
    return state, ess, v0


def _port(assembly="EA", integ="FULL", shards=8):
    opt = _options(T_OPT, assembly, integ)
    mesh = make_cartesian_mesh([2, 2, 8], [1.0, 1.0, 1.0], order=1)
    model = build_model(opt, cases.VOCE_PROPS)
    if shards is None:
        sysm = MechSystem(opt, mesh, model, device="cpu", ea_asm_f32=False)
    else:
        sysm = SlabMechSystem(opt, mesh, model, shards, device="cpu")
    return (sysm, mesh) + _host_problem(mesh, model, sysm.nq)


def _start(sysm, mesh, state, v0):
    return sysm.to_node(v0), sysm.to_node(mesh.coords), sysm.to_state(state)


@pytest.fixture(scope="module")
def reference():
    """The JAX slab on 8 virtual devices: the first setup, its Krylov
    solve, the Newton solve and solve_init, in host arrays."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    import __graft_entry__ as graft
    opt = _options(J_OPT)
    mesh = j_mesh([2, 2, 8], [1.0, 1.0, 1.0], order=1)
    model = j_build_model(opt, graft._VOCE_PROPS)
    slab = JSlabMechSystem(opt, mesh, model, make_device_mesh(8))
    state, ess, v0 = _host_problem(mesh, model, slab.fes.nqpts)
    v, x, st = slab.to_node(v0), slab.to_node(mesh.coords), \
        slab.to_state(state)
    nsub = slab._compute_nsub(v, x, DT)
    ess_l = slab.to_ess(ess)
    r, k_data, diag, stress, state_end, _ = slab._setup(
        v, x, st, DT, ess_l, True, nsub, slab._warm_zeros(st.dtype), False)
    c, kit, kconv, _ = slab._krylov(k_data, diag, r, ess_l)
    assert kconv
    nodes = lambda a: slab.to_global_nodes(np.asarray(a).reshape(-1, 3))
    # the first-setup system in the port's slab layout (one rank, the
    # same partition order): EA blocks (24, 24, ne), flat (3, S, nl1)
    stacked = lambda a: np.moveaxis(np.asarray(a).reshape(
        slab.part.n_shards, slab.part.n_loc + 1, 3), -1, 0).reshape(-1)
    out = dict(system=(np.asarray(k_data).transpose(1, 2, 0),
                       stacked(diag), stacked(r)),
               r=nodes(r), diag=nodes(diag), c=nodes(c), kit=int(kit),
               stress=slab.unpermute_elems(stress),
               state=slab.unpermute_elems(state_end),
               max_deff=float(slab._max_deff(v, x, DT)))
    vs, stress_s, state_s, conv, it, _ = slab.newton_solve(
        v, x, st, DT, ess, verbose=False)
    assert conv
    out.update(v=slab.to_global_nodes(vs),
               n_stress=slab.unpermute_elems(stress_s),
               n_state=slab.unpermute_elems(state_s),
               avg=np.asarray(slab._vol_avg(
                   stress_s, slab._gather(x + DT * vs), True)),
               krylov=slab.last_newton_stats["krylov_iters"])
    v_new = v0.copy()
    v_new[mesh.bdr_nodes[4], 2] = 2e-3
    out["init"] = slab.to_global_nodes(slab.solve_init(
        v, slab.to_node(v_new), x, st, 0.02, ess))
    return out


@pytest.fixture(scope="module")
def port():
    """The same through the port's slab over 8 stacked shards."""
    sysm, mesh, state, ess, v0 = _port()
    out = {}
    with torch.inference_mode():
        v, x, st = _start(sysm, mesh, state, v0)
        ess_l = sysm.to_ess(ess)
        xw = torch.zeros((8, sysm.npts), dtype=sysm.dtype)
        r, k_data, diag, stress, state_end, _ = sysm.setup(
            v, x, st, DT, ess_l, True, sysm.compute_nsub(DT), xw, False)
        out.update(r=sysm.from_node(r), diag=sysm.from_node(diag),
                   stress=sysm.from_stress(stress),
                   state=sysm.from_state(state_end),
                   max_deff=float(sysm.max_deff(v, x, DT)))
        vs, stress_s, state_s, conv, _, _ = sysm.newton_solve(
            v, x, st, DT, ess, verbose=False)
        assert conv
        out.update(v=sysm.from_node(vs), n_stress=sysm.from_stress(stress_s),
                   n_state=sysm.from_state(state_s),
                   avg=sysm.vol_avg(stress_s.reshape(6, sysm.nq, -1),
                                    sysm.emap.gather(x + DT * vs)).numpy(),
                   krylov=sysm.last_newton_stats["krylov_iters"])
        v_new = v0.copy()
        v_new[mesh.bdr_nodes[4], 2] = 2e-3
        out["init"] = sysm.from_node(sysm.solve_init(
            v, sysm.to_node(v_new), x, st, 0.02, ess))
    return out


@pytest.fixture(scope="module")
def single():
    """The port's single-device system at the slab's numerics."""
    sysm, mesh, state, ess, v0 = _port(shards=None)
    with torch.inference_mode():
        v, x, st = _start(sysm, mesh, state, v0)
        vs, stress_s, state_s, conv, _, _ = sysm.newton_solve(
            v, x, st, DT, ess, verbose=False)
        assert conv
        v_new = v0.copy()
        v_new[mesh.bdr_nodes[4], 2] = 2e-3
        return dict(
            v=sysm.from_node(vs), n_stress=sysm.from_stress(stress_s),
            n_state=sysm.from_state(state_s),
            avg=sysm.vol_avg(stress_s.reshape(6, sysm.nq, -1),
                             sysm.emap.gather(x + DT * vs)).numpy(),
            krylov=sysm.last_newton_stats["krylov_iters"],
            max_deff=float(sysm.max_deff(v, x, DT)),
            init=sysm.from_node(sysm.solve_init(
                v, sysm.to_node(v_new), x, st, 0.02, ess)))


def test_setup_matches_reference_slab(reference, port):
    np.testing.assert_allclose(port["r"], reference["r"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(port["diag"], reference["diag"], rtol=1e-6)
    np.testing.assert_allclose(port["stress"], reference["stress"], rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(port["state"], reference["state"], rtol=0,
                               atol=1e-10)


def test_krylov_matches_reference_slab(reference):
    """The reference slab's first-setup system solved by the port's
    slab: mixed-precision PCG with Jacobi through the halo-exchange
    matvec and the owner-masked dot."""
    sysm, mesh, _, ess, _ = _port()
    k_data, diag, r = (torch.tensor(a) for a in reference["system"])
    with torch.inference_mode():
        c, kit, conv, _ = sysm.krylov_solve(k_data, diag, r,
                                            sysm.to_ess(ess))
    assert conv and kit == reference["kit"]
    np.testing.assert_allclose(sysm.from_node(c), reference["c"], rtol=0,
                               atol=2e-12)


@pytest.mark.parametrize("against", ["reference slab", "port single"])
def test_newton_matches(against, reference, port, single):
    want = reference if against == "reference slab" else single
    # the same Newton iterations (a Krylov count may differ by one near
    # the rounding floor: the slab sums its dots in another order)
    assert len(port["krylov"]) == len(want["krylov"])
    np.testing.assert_allclose(port["v"], want["v"], rtol=0, atol=2e-12)
    np.testing.assert_allclose(port["n_stress"], want["n_stress"], rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(port["n_state"], want["n_state"], rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(port["avg"], want["avg"], rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("against", ["reference slab", "port single"])
def test_solve_init_and_max_deff_match(against, reference, port, single):
    """One linear solve on the first setup's operator: atol 1e-11 against
    the port's single device (the same operator); against the reference
    slab its tangent's f32 rounding (rel 2.8e-7 in the operator) carries
    into the solution, so 1e-6 of the largest velocity."""
    want = reference if against == "reference slab" else single
    atol = (1e-11 if against == "port single"
            else 1e-6 * np.abs(want["init"]).max())
    np.testing.assert_allclose(port["init"], want["init"], rtol=0,
                               atol=atol)
    np.testing.assert_allclose(port["max_deff"], want["max_deff"],
                               rtol=1e-12)


@pytest.mark.parametrize("assembly,integ", [("PA", "FULL"), ("EA", "BBAR")])
def test_pa_and_bbar_through_slab_match_single(assembly, integ):
    got, want = {}, {}
    for shards, out in ((8, got), (None, want)):
        sysm, mesh, state, ess, v0 = _port(assembly, integ, shards)
        with torch.inference_mode():
            v, x, st = _start(sysm, mesh, state, v0)
            vs, stress, state_end, conv, _, _ = sysm.newton_solve(
                v, x, st, DT, ess, verbose=False)
        assert conv
        out.update(v=sysm.from_node(vs), stress=sysm.from_stress(stress),
                   state=sysm.from_state(state_end))
    np.testing.assert_allclose(got["v"], want["v"], rtol=0, atol=1e-11)
    np.testing.assert_allclose(got["stress"], want["stress"], rtol=0,
                               atol=1e-9)
    # the point solve's iteration counts (slot 3) follow the warm start
    keep = np.arange(got["state"].shape[-1]) != 3
    np.testing.assert_allclose(got["state"][..., keep],
                               want["state"][..., keep], rtol=0, atol=1e-9)


def test_process_group_of_one_rank_changes_nothing(port):
    """With a (gloo) process group of one rank every reduction and
    gather goes through it; the results are the local ones, bitwise."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        sysm, mesh, state, ess, v0 = _port()
        assert sysm.layout.distributed
        with torch.inference_mode():
            v, x, st = _start(sysm, mesh, state, v0)
            vs, stress, _, conv, _, _ = sysm.newton_solve(
                v, x, st, DT, ess, verbose=False)
        assert conv
        np.testing.assert_array_equal(sysm.from_node(vs), port["v"])
        np.testing.assert_array_equal(sysm.from_stress(stress),
                                      port["n_stress"])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode,family,options,match", [
    ("slab", "voce", dict(krylov_solver="GMRES"), "requires an ExaCMech"),
    ("slab", "umat", {}, "requires an ExaCMech"),
])
def test_configurations_the_slab_refuses(mode, family, options, match,
                                         tmp_path):
    toml = _case(tmp_path, mode, family, **options)
    with pytest.raises(ValueError, match=match):
        Simulation(parse_options(toml), workdir=str(tmp_path), device="cpu",
                   shards=8)


def _case(tmp_path, mode, family, ncuts=(2, 2, 8), **options):
    if family == "umat":
        return cases.write_umat_case(str(tmp_path / "case"), ncuts, (0.1,),
                                     parallel_mode=mode, **options)
    return cases.write_voce_case(str(tmp_path / mode), ncuts, (0.1,),
                                 ngrains=4, parallel_mode=mode, **options)


def _mode_and_run(toml, tmp_path, shards=8):
    """The mode the JAX ``Simulation`` picks on 8 devices (built, not
    run) and the port's over ``shards`` (built and run one step)."""
    want = JSimulation(J_OPT.parse_options(toml), workdir=str(tmp_path),
                       device_mesh=make_device_mesh(8)).parallel_mode
    with torch.inference_mode():
        sim = Simulation(parse_options(toml), workdir=str(tmp_path),
                         device="cpu", shards=shards)
        sim.run(verbose=False)
    assert len(sim.step_stats) == 1
    assert np.isfinite(sim.system.from_stress(sim.stress)).all()
    return sim.parallel_mode, want


@pytest.mark.parametrize("mode,family", [("replicated", "voce"),
                                         ("auto", "umat")])
def test_configurations_the_slab_does_not_take_run_replicated(
        mode, family, tmp_path):
    """"replicated", and "auto" with a UMAT (which the slab does not
    cover), take the replicated-node element sharding over 8 shards, as
    the JAX ``Simulation`` does on 8 devices, and run."""
    got, want = _mode_and_run(_case(tmp_path, mode, family), tmp_path)
    assert got == want == "replicated"


def test_unpartitionable_mesh_under_auto_names_a13b(tmp_path, capsys):
    """A 4^3 brick over 8 shards splits z-layers: "slab" stops on the
    partition; "auto" prints why and the reference's fallback notice and
    takes the replicated-node element sharding (ROADMAP A13b), as the JAX
    ``Simulation`` does on 8 devices; without shards both run on one
    device."""
    toml = _case(tmp_path, "slab", "voce", ncuts=(4, 4, 4))
    with pytest.raises(ValueError, match="non-adjacent"):
        Simulation(parse_options(toml), workdir=str(tmp_path), device="cpu",
                   shards=8)
    toml = _case(tmp_path, "auto", "voce", ncuts=(4, 4, 4))
    capsys.readouterr()
    got, want = _mode_and_run(toml, tmp_path)
    assert got == want == "replicated"
    notices = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("slab partition unavailable")]
    assert len(notices) == 2 and notices[0] == notices[1]
    assert notices[0].endswith("; using replicated-node element sharding")
    for mode in ("slab", "auto"):
        sim = Simulation(parse_options(_case(tmp_path, mode, "voce",
                                             ncuts=(4, 4, 4))),
                         workdir=str(tmp_path), device="cpu")
        assert sim.parallel_mode == "single"


def test_make_step_through_slab_matches_single():
    """The fixed-Newton step (2 Newton iterations, the reference's
    ``make_jit_step`` that ``dryrun_multichip`` runs on the slab) over 8
    shards against the single device: velocity atol 1e-12; both final
    residual norms at the rounding floor (below 1e-10), within 1e-14."""
    got = {}
    for shards in (8, None):
        sysm, mesh, state, ess, v0 = _port(shards=shards)
        with torch.inference_mode():
            v, x, st = _start(sysm, mesh, state, v0)
            v, x_cur, stress, _, rnorm = sysm.make_step(2)(
                v, x, st, 0.01, sysm.to_ess(ess))
        assert rnorm.ndim == 0 and bool(torch.isfinite(stress).all())
        got[shards] = (sysm.from_node(v), float(rnorm))
    np.testing.assert_allclose(got[8][0], got[None][0], rtol=0, atol=1e-12)
    assert got[8][1] < 1e-10 and got[None][1] < 1e-10
    assert abs(got[8][1] - got[None][1]) < 1e-14


@pytest.mark.parametrize("assembly,integ", [("EA", "FULL"), ("PA", "FULL"),
                                            ("EA", "BBAR")])
def test_slab_map_gives_the_device_mesh_numbers(assembly, integ):
    """Handed the slab's element map, ``MechSystem`` takes the reference
    slab's numbers: no GMG even where it is asked for and the one device
    takes it, a warm point solve on every assembly (no point-major half),
    the f64 EA build, and the rank's stacked element count."""
    opt = _options(T_OPT, assembly, integ)
    opt.krylov_precond = "gmg"
    mesh = make_cartesian_mesh([8, 8, 16], [1.0, 1.0, 1.0], order=1)
    model = build_model(opt, cases.VOCE_PROPS)
    one = MechSystem(opt, mesh, model, device="cpu")
    slab = SlabMechSystem(opt, mesh, model, 4, device="cpu")
    assert one.point_major == (assembly == "PA" or integ == "BBAR")
    assert one.precond_kind == ("gmg" if not one.point_major else "jacobi")
    assert slab.precond_kind == "jacobi" and slab.gmg_meta is None
    assert not slab.point_major and not slab.ea_asm_f32
    assert slab.ne == slab.layout.s_local * slab.part.ne_per == 1024
    assert slab.npts == slab.ne * slab.nq
