"""The port's replicated-node element sharding (``MechSystem`` on a
``parallel/replicated.ReplicatedMap``, 8 shards stacked on the CPU)
against the JAX package's ``MechSystem(device_mesh=make_device_mesh(8))``
and ``Simulation(device_mesh=...)`` on 8 virtual devices, and against
the port's own single-device system.  3x3x3 voxels give 27 elements over
8 shards: 5 pad elements (copies of element 0), a whole shard of them.

* ``make_step(2)`` (the reference's ``make_jit_step``, ``dryrun_multichip``
  leg 1 and ``tests/test_sharding.py::test_sharded_step_matches_single_
  device``) on ``__graft_entry__._tiny_problem([3, 3, 3])``'s problem at
  dt 0.01: against the JAX step on the device mesh, velocity and the real
  elements' stress to 1e-6 rel (the two packages' f32 lagged tangents
  round differently, rel 2.8e-7, and two Newton iterations at Krylov rel
  1e-7 keep it), the final residual norms (at the rounding floor, below
  1e-10) within 1e-12 of each other, as the reference's own test holds
  them; against the port's
  single device at the same numerics (Jacobi, the f32 EA build, the
  index map), velocity atol 1e-12 and stress 1e-11.
* ``vol_avg`` over padded shards (``test_vol_average_sharded``) of a
  seeded field whose pad rows are 1e6: rtol 1e-12 against the JAX device
  mesh's and the single device's, and an all-ones field averages to 1;
  the masked ``max_deff`` against the reference's ``_max_deff`` (1e-10).
* ``Simulation`` with ``parallel_mode = "replicated"`` over 8 shards
  against the JAX ``Simulation`` on 8 devices, two steps of the in-repo
  cases: average stress to rel 1e-6 of its largest entry (the repo's
  convention, the Newton tolerance level) for Voce, the elastic UMAT,
  GMRES, MINRES, PA, B-bar and a mesh file; the end state's pad rows are
  element 0's (the UMAT sees no degenerate point).
* The counterpart of ``tests/test_slab_production.py::test_parallel_mode_
  replicated_knob`` on an in-repo case the slab could take.
* A checkpoint of the JAX replicated run on 8 devices (32 rows, pads
  included) resumes in the port's replicated run over 8 shards, and the
  port's in the JAX one, each to rel 1e-6 of the other package's
  uninterrupted run; the port also resumes it over 3 shards and on one
  device (the reference needs the same padding, ROADMAP C11).
"""

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as graft
from exaconstit_tpu.config import options as J_OPT
from exaconstit_tpu.driver import Simulation as JSimulation
from exaconstit_tpu.io import checkpoint as J_CK
from exaconstit_tpu.parallel.sharding import make_device_mesh
from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.driver import MechSystem, Simulation
from exaconstit_tpu_torch.io import checkpoint as T_CK
from exaconstit_tpu_torch.mesh.voxel import make_cartesian_mesh
from exaconstit_tpu_torch.models.ecmech import build_model
from exaconstit_tpu_torch.parallel.replicated import ReplicatedMap
from exaconstit_tpu_torch.parallel.sharding import ShardLayout

NCUTS = (3, 3, 3)
SHARDS = 8
DT = 0.01

pytestmark = pytest.mark.skipif(len(jax.devices()) < SHARDS,
                                reason="needs 8 JAX devices")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def port_problem(shards=SHARDS):
    """The port's twin of ``_tiny_problem(NCUTS)``: its options, mesh,
    seeded orientations and BCs, replicated over ``shards`` (None: one
    device at the same numerics, Jacobi and the index map)."""
    opt = T_OPT.ExaOptions()
    opt.mech_type = T_OPT.MechType.EXACMECH
    opt.xtal_type = T_OPT.XtalType.FCC
    opt.slip_type = T_OPT.SlipType.POWERVOCE
    opt.assembly = T_OPT.Assembly.EA
    opt.solver = T_OPT.KrylovSolver.PCG
    opt.krylov_rel_tol, opt.krylov_abs_tol, opt.krylov_iter = 1e-7, 1e-27, 200
    opt.krylov_precond = "jacobi"
    mesh = make_cartesian_mesh(NCUTS, [1.0, 1.0, 1.0], order=1)
    model = build_model(opt, graft._VOCE_PROPS)
    emap = None if shards is None else ReplicatedMap(
        mesh.conn, mesh.num_nodes, ShardLayout.create(shards, "cpu"))
    sysm = MechSystem(opt, mesh, model, device="cpu", emap=emap)
    rng = np.random.default_rng(0)
    q = rng.normal(size=(mesh.num_elems, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = model.init_state(np.repeat(q, sysm.nq, axis=0)).reshape(
        mesh.num_elems, sysm.nq, -1)
    ess = np.zeros((mesh.num_nodes, 3), dtype=bool)
    ess[mesh.bdr_nodes[1], 2] = True
    ess[mesh.bdr_nodes[2], 0] = True
    ess[mesh.bdr_nodes[3], 1] = True
    ess[mesh.bdr_nodes[4], 2] = True
    v0 = np.zeros((mesh.num_nodes, 3))
    v0[mesh.bdr_nodes[4], 2] = 1e-3
    return (sysm, sysm.to_node(v0), sysm.to_node(mesh.coords),
            sysm.to_state(state), sysm.to_ess(ess))


def _field(ne_pad, nq):
    """A seeded (ne_pad, nq, 6) point field with 1e6 in the pad rows."""
    f = np.random.default_rng(4).normal(size=(ne_pad, nq, 6))
    f[np.prod(NCUTS):] = 1e6
    return f


@pytest.fixture(scope="module")
def reference():
    """The JAX system on the 8-device mesh: ``make_jit_step(2)``, the
    volume average of ``_field`` and ``_max_deff`` at the start."""
    js, jv, jx, jst, jess = graft._tiny_problem(
        list(NCUTS), device_mesh=make_device_mesh(SHARDS))
    assert js.ne_pad == 32 and js.precond_kind == "jacobi"
    out = js.make_jit_step(2)(jv, jx, jst, DT, jess)
    ne, nq = js.fes.num_elems, js.fes.nqpts
    field = js.to_state(_field(js.ne_pad, nq)).reshape(6, nq, js.ne_pad)
    return dict(
        v=np.asarray(out[0]), stress=js.from_stress(out[2])[:ne],
        rnorm=float(out[4]),
        avg=np.asarray(js._vol_avg(field, js._gather_cm(jx), True)),
        max_deff=float(js._max_deff(jv, jx, DT)))


@pytest.fixture(scope="module")
def port():
    """The port's replicated system and its single device, each through
    ``make_step(2)`` and the same volume average and deformation rate."""
    out = {}
    for shards in (SHARDS, None):
        sysm, v, x, st, ess = port_problem(shards)
        with torch.inference_mode():
            got = sysm.make_step(2)(v, x, st, DT, ess)
            # the device field as it stands, pad rows included
            field = torch.tensor(_field(32, sysm.nq)[:sysm.ne].transpose(
                2, 1, 0))
            out[shards] = dict(
                system=sysm, v=sysm.from_node(got[0]).T.reshape(-1),
                stress=sysm.from_stress(got[2])[:27], rnorm=float(got[4]),
                finite=bool(torch.isfinite(got[2]).all()),
                avg=sysm.vol_avg(field, sysm.emap.gather(x)).numpy(),
                ones=sysm.vol_avg(torch.ones_like(field),
                                  sysm.emap.gather(x)).numpy(),
                max_deff=float(sysm.max_deff(v, x, DT)))
    return out


def test_replicated_system_keeps_one_device_numerics(port):
    """On the replicated map the system keeps the point-major half, the
    f32 EA build and the warm starts of one device, never takes GMG, and
    holds the rank's padded elements: 8 shards of 4."""
    sysm = port[SHARDS]["system"]
    assert isinstance(sysm.emap, ReplicatedMap) and type(sysm) is MechSystem
    assert sysm.ne == 32 and sysm.npts == 32 * 8 and sysm.emap.ne_per == 4
    assert int(sysm.emap.real.sum()) == 27
    assert sysm.ea_asm_f32 and not sysm.point_major
    assert sysm.precond_kind == "jacobi" and sysm.gmg_meta is None
    assert port[SHARDS]["finite"]


def test_make_step_matches_device_mesh(reference, port):
    got = port[SHARDS]
    assert _rel(got["v"], reference["v"]) < 1e-6
    assert _rel(got["stress"], reference["stress"]) < 1e-6
    # both final residuals at the rounding floor: absolute, as the
    # reference's own sharded-against-single test compares them
    assert got["rnorm"] < 1e-10 and reference["rnorm"] < 1e-10
    assert abs(got["rnorm"] - reference["rnorm"]) < 1e-12


def test_make_step_matches_single_device(port):
    got, want = port[SHARDS], port[None]
    np.testing.assert_allclose(got["v"], want["v"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["stress"], want["stress"], rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("against", ["device mesh", "single device"])
def test_vol_avg_and_max_deff_over_padded_shards(against, reference, port):
    want = reference if against == "device mesh" else port[None]
    got = port[SHARDS]
    np.testing.assert_allclose(got["avg"], want["avg"], rtol=1e-12)
    np.testing.assert_allclose(got["ones"], 1.0, rtol=1e-12)
    np.testing.assert_allclose(got["max_deff"], want["max_deff"],
                               rtol=1e-10)


VARIANTS = {
    "voce": ("voce", {}),
    "umat": ("umat", {}),
    "GMRES": ("voce", dict(krylov_solver="GMRES")),
    "MINRES": ("voce", dict(krylov_solver="MINRES")),
    "PA": ("voce", dict(assembly="PA")),
    "BBAR": ("voce", dict(integ_model="BBAR")),
    "mesh_file": ("voce", dict(mesh_file=True)),
}


def write_case(path, family, dts=(0.1, 0.2), **options):
    if family == "umat":
        return cases.write_umat_case(str(path), NCUTS, (0.5, 0.5)[:len(dts)],
                                     parallel_mode="replicated", **options)
    return cases.write_voce_case(str(path), NCUTS, dts, ngrains=4, seed=2,
                                 parallel_mode="replicated", **options)


@pytest.mark.parametrize("name", VARIANTS)
def test_simulation_matches_device_mesh(name, tmp_path):
    family, options = VARIANTS[name]
    toml = write_case(tmp_path / "case", family, **options)
    rows = {}
    for tag in ("jax", "torch"):
        wd = tmp_path / tag
        wd.mkdir()
        if tag == "jax":
            sim = JSimulation(J_OPT.parse_options(toml), workdir=str(wd),
                              device_mesh=make_device_mesh(SHARDS))
            sim.run(verbose=False)
        else:
            with torch.inference_mode():
                sim = Simulation(T_OPT.parse_options(toml), workdir=str(wd),
                                 device="cpu", shards=SHARDS)
                sim.run(verbose=False)
            sysm = sim.system
            assert isinstance(sysm.emap, ReplicatedMap)
            assert sysm.point_major == (name in ("umat", "PA", "BBAR"))
            state = sysm.from_state(sim.state)
            assert state.shape[0] == 32 and np.isfinite(state).all()
            # the pad points are element 0's, the UMAT's too
            np.testing.assert_array_equal(state[27:], np.repeat(
                state[:1], 5, axis=0))
        assert sim.parallel_mode == "replicated"
        rows[tag] = np.loadtxt(wd / "avg_stress.txt", ndmin=2)
    assert rows["torch"].shape == rows["jax"].shape == (2, 6)
    assert _rel(rows["torch"], rows["jax"]) < 1e-6


def test_parallel_mode_replicated_knob(tmp_path):
    """``parallel_mode = "replicated"`` takes the replicated-node system
    even on a mesh the slab partitions (2x2x8 over 8 shards), as the
    reference's ``Simulation`` does on a device mesh."""
    toml = cases.write_voce_case(str(tmp_path / "case"), (2, 2, 8), (0.1,),
                                 ngrains=4, parallel_mode="replicated")
    sim = Simulation(T_OPT.parse_options(toml), workdir=str(tmp_path),
                     device="cpu", shards=SHARDS)
    assert sim.parallel_mode == "replicated"
    assert type(sim.system) is MechSystem
    assert isinstance(sim.system.emap, ReplicatedMap)


@pytest.fixture(scope="module")
def restarts(tmp_path_factory):
    """The Voce case for 2 steps of dt 0.1, run by both packages over 8
    shards, each writing a checkpoint after step 1."""
    tmp = tmp_path_factory.mktemp("replicated_ck")
    toml = write_case(tmp / "case", "voce", (0.1, 0.1))
    resume = write_case(tmp / "resume", "voce", (0.1, 0.1), restart=True)
    out = dict(tmp=tmp, resume=resume)
    for tag in ("jax", "torch"):
        wd = tmp / tag
        wd.mkdir()
        if tag == "jax":
            sim = JSimulation(J_OPT.parse_options(toml), workdir=str(wd),
                              device_mesh=make_device_mesh(SHARDS))
            t = sim.advance(1, 0.1, verbose=False)
            sim.write_averages()
            J_CK.save_checkpoint(str(wd / "ck1" / "checkpoint.npz"), sim, t,
                                 1)
            sim.advance(2, 0.1, verbose=False)
            sim.write_averages()
        else:
            with torch.inference_mode():
                sim = Simulation(T_OPT.parse_options(toml), workdir=str(wd),
                                 device="cpu", shards=SHARDS)
                t = sim.advance(1, 0.1, verbose=False)
                sim.write_averages()
                T_CK.save_checkpoint(str(wd / "ck1" / "checkpoint.npz"), sim,
                                     t, 1)
                sim.advance(2, 0.1, verbose=False)
                sim.write_averages()
        out[tag] = np.loadtxt(wd / "avg_stress.txt", ndmin=2)
    return out


def _resume_port(restarts, ckpt, name, shards):
    wd = restarts["tmp"] / name
    (wd / "checkpoint").mkdir(parents=True)
    with np.load(ckpt) as ck:
        np.savez_compressed(wd / "checkpoint" / "checkpoint.npz", **ck)
    with torch.inference_mode():
        sim = Simulation(T_OPT.parse_options(restarts["resume"]),
                         workdir=str(wd), device="cpu", shards=shards)
        sim.run(verbose=False)
    assert len(sim.step_times) == 1
    return np.loadtxt(wd / "avg_stress.txt", ndmin=2)


@pytest.mark.parametrize("shards", [SHARDS, 3, None])
def test_port_resumes_reference_replicated_checkpoint(restarts, shards):
    ckpt = restarts["tmp"] / "jax" / "ck1" / "checkpoint.npz"
    with np.load(ckpt) as ck:
        assert ck["state"].shape[0] == ck["stress"].shape[0] == 32
    rows = _resume_port(restarts, ckpt, f"t_from_jax_{shards}", shards)
    assert _rel(rows, restarts["jax"][1:]) < 1e-6


def test_reference_resumes_port_replicated_checkpoint(restarts):
    ckpt = restarts["tmp"] / "torch" / "ck1" / "checkpoint.npz"
    with np.load(ckpt) as ck:
        assert ck["state"].shape[0] == ck["stress"].shape[0] == 32
    opt = J_OPT.parse_options(restarts["resume"])
    wd = restarts["tmp"] / "jax_from_t"
    wd.mkdir()
    sim = JSimulation(opt, workdir=str(wd),
                      device_mesh=make_device_mesh(SHARDS))
    assert J_CK.load_checkpoint(str(ckpt), sim)[1] == 1
    sim.advance(2, 0.1, verbose=False)
    sim.write_averages()
    rows = np.loadtxt(wd / "avg_stress.txt", ndmin=2)
    assert _rel(rows, restarts["torch"][1:]) < 1e-6
