"""PyTorch port against the JAX package: the element-chunked setup, the
EA-block storage rule and the last construction-time switches of
``MechSystem``.

* The chunked setup and line-search residual: the port's (4 chunks)
  against the JAX package's at rel 1e-9 (both with the pure-f64 point
  solve, so that the six outputs are f64 throughout), and against the
  port's whole setup at rtol 0, atol 1e-12, the reference's own bar
  (``tests/test_setup_chunks.py``), at production defaults.
* ``setup_chunk_count`` against the JAX system's ``_setup_nc``, and the
  counts at 48^3, 64^3 and 96^3 and on the point-major half.
* The storage rule: f32 blocks with the f64 build's diagonal above
  ``EA_F32_POINTS`` points; the 4^3 MTSDD case with stored f32 blocks
  through both packages' ``Simulation`` at the MTSDD parity bar.
* ``EXACONSTIT_WARM_START=0`` (``MechSystem``, ``make_step``,
  ``SlabMechSystem``), ``EXACONSTIT_TPU_NO_CM=1``,
  ``EXACONSTIT_EA_ASM_F32``, ``EXACONSTIT_PRECOND``, ``opt.mixed_krylov
  = False`` and ``rebuild_krylov``, each against the JAX package.
* One ``cuda`` test: a chunked setup at 16^3 on the card against the
  whole one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
import test_torch_driver as TD
import test_torch_slab_system as TS
from exaconstit_tpu.config import options as J_OPT
from exaconstit_tpu.driver import Simulation as JSimulation
from exaconstit_tpu.mesh.voxel import make_cartesian_mesh as j_mesh
from exaconstit_tpu.models import ecmech as J_EC
from exaconstit_tpu.parallel.sharding import make_device_mesh
from exaconstit_tpu.parallel.slab_system import \
    SlabMechSystem as JSlabMechSystem
from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch import driver as T_DRV
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.driver import (MechSystem, Simulation,
                                         setup_chunk_count)
from exaconstit_tpu_torch.mesh.voxel import make_cartesian_mesh
from exaconstit_tpu_torch.models.ecmech import build_model
from exaconstit_tpu_torch.parallel.replicated import ReplicatedMap
from exaconstit_tpu_torch.parallel.sharding import ShardLayout
from exaconstit_tpu_torch.parallel.slab_system import SlabMechSystem
from test_torch_driver import _one_thread, _rel, port_problem  # noqa: F401

DT = 0.05
NAMES = ("residual", "EA blocks", "diagonal", "stress", "end state",
         "point solution")


def _f64_point_solve(monkeypatch):
    """Both packages' Voce model with the pure-f64 point solve, so that
    every output of a setup is f64 (the mixed solve's f32 stage and
    tangent differ between the packages by f32 rounding)."""
    def pure(build):
        def build_f64(opt, props):
            m = build(opt, props)
            return dataclasses.replace(m, evptn=dataclasses.replace(
                m.evptn, mixed_precision=False))
        return build_f64

    monkeypatch.setattr(J_EC, "build_model", pure(J_EC.build_model))
    monkeypatch.setattr(TD, "build_model", pure(TD.build_model))


def _velocity(v0):
    """The start velocity and a seeded perturbation, so that the point
    solve has plastic work (the reference's chunk test's)."""
    noise = np.random.default_rng(0).standard_normal(tuple(v0.shape))
    return noise


def _port_setup(ts, tv, tx, tst, tess, residual=False):
    v = tv + 0.01 * torch.as_tensor(_velocity(tv))
    xw = torch.zeros((8, ts.npts), dtype=ts.dtype)
    ess = ts.to_ess(tess)
    with torch.inference_mode():
        if residual:
            return (ts.residual_only(v, tx, tst, DT, ess, 1, xw, False),)
        return ts.setup(v, tx, tst, DT, ess, True, 1, xw, False)


# -- the chunked setup --------------------------------------------------------


@pytest.mark.parametrize("ncuts", [(4, 4, 2), (4, 4, 4)])
def test_chunked_setup_matches_reference(ncuts, monkeypatch):
    """The port's setup and line-search residual in 4 element chunks
    against the JAX package's, the six outputs at rel 1e-9."""
    monkeypatch.setenv("EXACONSTIT_SETUP_CHUNKS", "4")
    _f64_point_solve(monkeypatch)
    js, jv, jx, jst, jess = graft._tiny_problem(list(ncuts))
    ts, tv, tx, tst, tess = port_problem(ncuts)
    assert js._setup_nc == ts.setup_chunks == 4
    assert not js._ea_asm_f32 and not ts.ea_asm_f32
    vj = jv + 0.01 * jnp.asarray(_velocity(jv))
    xw, ok = js._warm_zeros(jst.dtype), jnp.asarray(False)
    want = js._setup(vj, jx, jst, DT, jess, True, 1, xw, ok)
    want_r = js._residual_only(vj, jx, jst, DT, jess, 1, xw, ok)
    got = _port_setup(ts, tv, tx, tst, tess)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == torch.float64, name
        assert _rel(a.numpy(), b) < 1e-9, name
    got_r = _port_setup(ts, tv, tx, tst, tess, residual=True)[0]
    assert _rel(got_r.numpy(), want_r) < 1e-9


@pytest.mark.parametrize("residual", [False, True],
                         ids=["setup", "residual"])
@pytest.mark.parametrize("ncuts", [(4, 4, 2), (4, 4, 4)])
def test_chunked_setup_matches_whole(ncuts, residual, monkeypatch):
    """At production defaults (the mixed point solve, the f32 EA build)
    4 chunks against 1: rtol 0, atol 1e-12, with one point solve per
    chunk over its quarter of the points."""
    whole = port_problem(ncuts, setup_chunks=1)
    chunked = port_problem(ncuts, setup_chunks=4)
    assert whole[0].setup_chunks == 1 and chunked[0].setup_chunks == 4
    calls = []
    model_setup_cm = type(chunked[0].model).model_setup_cm

    def counted(self, dt, vgrad, state, **kw):
        calls.append(vgrad.shape[-1])
        return model_setup_cm(self, dt, vgrad, state, **kw)

    monkeypatch.setattr(type(chunked[0].model), "model_setup_cm", counted)
    want = _port_setup(*whole, residual=residual)
    calls.clear()
    got = _port_setup(*chunked, residual=residual)
    assert calls == [chunked[0].npts // 4] * 4
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12,
                                   err_msg=f"chunked setup differs: {name}")


@pytest.mark.parametrize("ncuts,requested,sharded,count", [
    ((4, 4, 4), "auto", False, 1),
    ((4, 4, 2), "4", False, 4),
    ((4, 4, 2), "3", False, 2),
    ((4, 4, 4), "4", False, 4),
    ((4, 4, 4), "3", False, 2),
    ((4, 4, 4), "4", True, 1)],
    ids=["auto-64", "4-32", "3-32", "4-64", "3-64", "sharded"])
def test_chunk_count_matches_reference(ncuts, requested, sharded, count,
                                       monkeypatch):
    """``setup_chunk_count`` and the count ``MechSystem`` picks from
    ``EXACONSTIT_SETUP_CHUNKS`` against the JAX system's ``_setup_nc``
    (a sharded map: the JAX device mesh of 8, the port's replicated map
    over 8 shards)."""
    monkeypatch.setenv("EXACONSTIT_SETUP_CHUNKS", requested)
    js = graft._tiny_problem(
        list(ncuts), device_mesh=make_device_mesh(8) if sharded else None)[0]
    ne = js.fes.num_elems
    assert js._setup_nc == count
    assert setup_chunk_count(ne, 8, requested, sharded) == count
    emap = None
    if sharded:
        mesh = make_cartesian_mesh(list(ncuts), [1.0] * 3, order=1)
        emap = ReplicatedMap(mesh.conn, mesh.num_nodes,
                             ShardLayout.create(8, "cpu"))
    assert port_problem(ncuts, emap=emap)[0].setup_chunks == count


def _voce_opt(**over):
    opt = T_OPT.ExaOptions()
    opt.mech_type = T_OPT.MechType.EXACMECH
    opt.xtal_type = T_OPT.XtalType.FCC
    opt.slip_type = T_OPT.SlipType.POWERVOCE
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


@pytest.mark.parametrize("edge,chunks,ea_f32", [
    (48, 4, False), (64, 8, True), (96, 27, True)])
def test_production_meshes(edge, chunks, ea_f32, monkeypatch):
    """On a 48^3, 64^3 and 96^3 brick one device takes the reference's
    4, 8 and 27 chunks (of 221,184, 262,144 and 262,144 points); above
    1,500,000 points the f64 build's blocks are stored in f32 (here with
    the f64 EA build, ``EXACONSTIT_EA_ASM_F32=0``).  At 64^3 the
    point-major half (PA, B-bar, the per-point engine; a UMAT below)
    takes one chunk and keeps the run's dtype, and a sharded map takes
    one chunk and stores f32 blocks by the global point count."""
    monkeypatch.setenv("EXACONSTIT_EA_ASM_F32", "0")
    mesh = make_cartesian_mesh([edge] * 3, [1.0] * 3, order=1)
    opt = _voce_opt()
    model = build_model(opt, cases.VOCE_PROPS)
    sysm = MechSystem(opt, mesh, model, device="cpu")
    assert sysm.setup_chunks == chunks
    assert sysm.npts // chunks == (221_184 if edge == 48 else 262_144)
    assert sysm.ea_f32 == ea_f32 and not sysm.ea_asm_f32
    assert sysm.ea_dtype == (torch.float32 if ea_f32 else torch.float64)
    if edge != 64:
        return
    per_point = dataclasses.replace(model, evptn=dataclasses.replace(
        model.evptn, hardness_mode="coupled"))
    assert per_point.point_major
    for o, m in ((_voce_opt(assembly=T_OPT.Assembly.PA), model),
                 (_voce_opt(integ_type=T_OPT.IntegrationType.BBAR), model),
                 (opt, per_point)):
        s = MechSystem(o, mesh, m, device="cpu")
        assert s.point_major and s.setup_chunks == 1 and not s.ea_f32
    emap = ReplicatedMap(mesh.conn, mesh.num_nodes,
                         ShardLayout.create(2, "cpu"))
    s = MechSystem(opt, mesh, model, device="cpu", emap=emap)
    assert s.setup_chunks == 1 and s.ea_f32  # global points, pads in


def test_umat_takes_one_chunk(tmp_path, monkeypatch):
    """A UMAT is the point-major half: one chunk whatever is asked."""
    monkeypatch.setenv("EXACONSTIT_SETUP_CHUNKS", "4")
    toml = cases.write_umat_case(tmp_path / "case", (8, 8, 8), (0.5,))
    sim = Simulation(T_OPT.parse_options(toml), workdir=str(tmp_path),
                     device="cpu")
    s = sim.system
    assert s.point_major and s.setup_chunks == 1 and not s.ea_f32


# -- the EA-block storage rule -----------------------------------------------


@pytest.mark.parametrize("limit,f32", [(512, False), (511, True)],
                         ids=["at-limit", "above-limit"])
def test_storage_auto_rule(limit, f32, monkeypatch):
    """"auto" stores f32 blocks above ``EA_F32_POINTS`` points, not at it
    (the reference: 1,500,000 points keep f64, 1,500,001 take f32): the
    4^3 brick's 512 points at a limit of 512 and of 511."""
    assert T_DRV.EA_F32_POINTS == 1_500_000
    monkeypatch.setattr(T_DRV, "EA_F32_POINTS", limit)
    ts = port_problem((4, 4, 4), ea_asm_f32=False)[0]
    assert ts.ea_f32 == f32
    mixed = port_problem((4, 4, 4))[0]  # the f32 build implies f32 blocks
    assert mixed.ea_asm_f32 and mixed.ea_f32


@pytest.mark.parametrize("chunks", [1, 4])
def test_stored_blocks_are_the_f64_build_cast(chunks):
    """f32 storage: the blocks are the f64 build's cast to f32 and the
    diagonal is the f64 build's, bitwise; every other output equal."""
    f64 = port_problem((4, 4, 4), ea_asm_f32=False, ea_f32=False,
                       setup_chunks=chunks)
    f32 = port_problem((4, 4, 4), ea_asm_f32=False, ea_f32=True,
                       setup_chunks=chunks)
    want, got = _port_setup(*f64), _port_setup(*f32)
    assert want[1].dtype == torch.float64 and got[1].dtype == torch.float32
    assert torch.equal(got[1], want[1].to(torch.float32))
    for name, a, b in zip(NAMES, got, want):
        if name != "EA blocks":
            assert torch.equal(a, b), name


@pytest.mark.parametrize("variable", ["1", "0"])
def test_storage_switch_matches_reference(variable, monkeypatch):
    """``EXACONSTIT_EA_F32`` forces the storage on both sides."""
    monkeypatch.setenv("EXACONSTIT_EA_F32", variable)
    monkeypatch.setenv("EXACONSTIT_EA_ASM_F32", "0")
    js = graft._tiny_problem([4, 4, 4])[0]
    ts = port_problem((4, 4, 4))[0]
    f32 = variable == "1"
    assert (js._ea_dtype == jnp.float32) == f32 == ts.ea_f32


def test_mtsdd_with_f32_blocks_matches_reference(tmp_path, monkeypatch):
    """The 4^3 copper MTSDD case (pure f64 point solve, the f64 EA build)
    with its blocks stored in f32 on both sides (``EXACONSTIT_EA_F32=1``,
    ``EXACONSTIT_EA_ASM_F32=0``): the port's Krylov solves get f32
    blocks, and the average stress agrees at the MTSDD parity bar,
    1e-8 rel."""
    monkeypatch.setenv("EXACONSTIT_EA_F32", "1")
    monkeypatch.setenv("EXACONSTIT_EA_ASM_F32", "0")
    toml = cases.write_mtsdd_case(tmp_path / "case", (4, 4, 4),
                                  (0.1, 0.1, 0.2), ngrains=12)
    seen = []
    krylov = MechSystem.krylov_solve

    def record(self, k_data, *args):
        seen.append(k_data.dtype)
        return krylov(self, k_data, *args)

    monkeypatch.setattr(MechSystem, "krylov_solve", record)
    out = {}
    for name, opts, sim_cls, kw in (("jax", J_OPT, JSimulation, {}),
                                    ("torch", T_OPT, Simulation,
                                     {"device": "cpu"})):
        wd = tmp_path / name
        wd.mkdir()
        with torch.inference_mode():
            sim = sim_cls(opts.parse_options(str(toml)), workdir=str(wd),
                          **kw)
            sim.run(verbose=False)
        out[name] = np.loadtxt(wd / "avg_stress.txt", ndmin=2)
        if name == "jax":
            assert sim.system._ea_dtype == jnp.float32
            assert not sim.system._ea_asm_f32
        else:
            assert sim.system.ea_f32 and not sim.system.ea_asm_f32
    assert seen and set(seen) == {torch.float32}
    assert out["torch"].shape == (3, 6) and np.isfinite(out["torch"]).all()
    assert _rel(out["torch"], out["jax"]) < 1e-8


# -- the remaining switches ---------------------------------------------------

PINNED = dict(EXACONSTIT_EA_ASM_F32="0", EXACONSTIT_PRECOND="jacobi")


def _tight(*systems):
    for s in systems:
        s.opt.newton_rel_tol, s.opt.newton_abs_tol = 1e-9, 1e-14


def _newton(js, jv, jx, jst, jess, ts, tv, tx, tst, tess, dt=0.1):
    want = js.newton_solve(jv, jx, jst, dt, jess, verbose=False)
    with torch.inference_mode():
        got = ts.newton_solve(tv, tx, tst, dt, tess, verbose=False)
    assert bool(want[3]) and got[3]
    return want, got


def _same_newton(want, got, js, ts, rtol, krylov_slack=0):
    assert ts.last_newton_stats["nr_iters"] == js.last_newton_stats[
        "nr_iters"]
    kt = np.array(ts.last_newton_stats["krylov_iters"])
    kj = np.array(js.last_newton_stats["krylov_iters"])
    assert kt.shape == kj.shape and np.abs(kt - kj).max() <= krylov_slack
    for f, a, b in zip(("node", "stress", "state"), got[:3], want[:3]):
        assert _rel(getattr(ts, "from_" + f)(a),
                    getattr(js, "from_" + f)(b)) < rtol, f


SWITCHES = ["warm_start", "make_step", "slab", "no_cm", "variables",
            "plain_pcg", "rebuild_krylov"]


@pytest.mark.parametrize("case", SWITCHES)
def test_switch_matches_reference(case, monkeypatch):
    """Each construction-time switch of the JAX ``MechSystem`` against
    the port's, at the reference's own numbers (Newton at rel 1e-9, the
    f64 EA build, Jacobi, unless the case is about them):

    * warm_start: ``EXACONSTIT_WARM_START=0`` on ``MechSystem``, every
      point solve cold: the Newton counts equal, solution, stress and
      end state (its per-point iteration counts included) rel 1e-10;
    * make_step: the same switch on the fixed-Newton step against
      ``make_jit_step``, at ``test_make_step_matches_make_jit_step``'s
      bars (the f32 tangent's rounding stays in two Newton updates);
    * slab: the same switch on ``SlabMechSystem`` against the JAX slab
      over 8 shards (2x2x8: the slab takes whole z-layers), at
      ``test_torch_slab_system``'s Newton bars;
    * no_cm: ``EXACONSTIT_TPU_NO_CM=1``, the point-major half (cold point
      solves, the f64 EA build, Jacobi), rel 1e-10;
    * variables: ``EXACONSTIT_EA_ASM_F32=0`` and ``EXACONSTIT_PRECOND=
      jacobi`` read by a port system built with its defaults, rel 1e-10;
    * plain_pcg: ``opt.mixed_krylov = False`` (plain f64 PCG), rel 1e-10;
    * rebuild_krylov: a 16x8x8 system built with Jacobi, swapped to GMG
      on both sides (Newton at the case's tolerance: the same Newton
      count, Krylov counts within one, rel 1e-9), and back to Jacobi (a
      fresh Jacobi system's Krylov solve, bitwise)."""
    for k, v in PINNED.items():
        monkeypatch.setenv(k, v)
    if case in ("warm_start", "make_step", "slab"):
        monkeypatch.setenv("EXACONSTIT_WARM_START", "0")
    if case == "no_cm":
        monkeypatch.setenv("EXACONSTIT_TPU_NO_CM", "1")
    if case == "slab":
        return _slab_cold(monkeypatch)
    ncuts = (16, 8, 8) if case == "rebuild_krylov" else (4, 4, 4)
    j = graft._tiny_problem(list(ncuts))
    t = port_problem(ncuts)
    js, ts = j[0], t[0]
    if case != "rebuild_krylov":
        _tight(js, ts)
    if case == "make_step":
        assert not js.warm_start and not ts.warm_start
        want = js.make_jit_step(2)(*j[1:4], 0.1, js._ess_flat(j[4]))
        with torch.inference_mode():
            got = ts.make_step(2)(*t[1:4], 0.1, t[4])
        for a, b in zip(got[:4], want[:4]):
            assert _rel(a.numpy(), b) < 1e-6
        assert abs(float(got[4]) / float(want[4]) - 1.0) < 1e-5
        return
    if case == "warm_start":
        assert not js.warm_start and not ts.warm_start
    if case == "no_cm":
        assert not js.use_cm and ts.point_major
    if case == "variables":
        assert not ts.ea_asm_f32 and ts.precond_kind == "jacobi"
    if case == "plain_pcg":
        for s in (js, ts):
            s.opt.mixed_krylov = False
            s.rebuild_krylov("jacobi")
        assert not ts.mixed_krylov
    if case == "rebuild_krylov":
        assert js.precond_kind == ts.precond_kind == "jacobi"
        for s in (js, ts):
            s.rebuild_krylov("gmg")
        assert js.precond_kind == ts.precond_kind == "gmg"
        want, got = _newton(*j, *t)
        # the f32 V-cycles round apart: a Krylov count may differ by one
        # deep in the Newton solve (measured: solution 3.3e-11, stress
        # 3.7e-10 rel)
        _same_newton(want, got, js, ts, 1e-9, krylov_slack=1)
        # and back: the live system's Jacobi solve is a fresh Jacobi
        # system's, bitwise (the JAX one takes Jacobi too)
        for s in (js, ts):
            s.rebuild_krylov("jacobi")
        assert js.precond_kind == ts.precond_kind == "jacobi"
        fresh = port_problem(ncuts)[0]
        assert fresh.precond_kind == "jacobi"
        r, k_data, diag = _port_setup(*t)[:3]
        ess = ts.to_ess(t[4])
        with torch.inference_mode():
            a = ts.krylov_solve(k_data, diag, r, ess)
            b = fresh.krylov_solve(k_data, diag, r, ess)
        assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
        return
    want, got = _newton(*j, *t)
    _same_newton(want, got, js, ts, 1e-10)
    if case == "warm_start":
        # the switch matters: warm point solves end in other iteration
        # counts at the same solution
        warm = port_problem(ncuts, warm_start=True)
        _tight(warm[0])
        with torch.inference_mode():
            st = warm[0].newton_solve(*warm[1:4], 0.1, warm[4],
                                      verbose=False)[2]
        it = ts.model.IND_NFEVAL
        assert not torch.equal(st[it], got[2][it])


def _slab_cold(monkeypatch):
    opt = TS._options(J_OPT)
    mesh = j_mesh([2, 2, 8], [1.0, 1.0, 1.0], order=1)
    model = J_EC.build_model(opt, graft._VOCE_PROPS)
    slab = JSlabMechSystem(opt, mesh, model, make_device_mesh(8))
    assert not slab.warm_start
    state, ess, v0 = TS._host_problem(mesh, model, slab.fes.nqpts)
    v, x, st = (slab.to_node(v0), slab.to_node(mesh.coords),
                slab.to_state(state))
    vs, stress, state_end, conv, _, _ = slab.newton_solve(
        v, x, st, TS.DT, ess, verbose=False)
    assert conv
    sysm, tmesh, tstate, tess, tv0 = TS._port()
    assert isinstance(sysm, SlabMechSystem) and not sysm.warm_start
    with torch.inference_mode():
        out = sysm.newton_solve(*TS._start(sysm, tmesh, tstate, tv0), TS.DT,
                                tess, verbose=False)
    assert out[3]
    assert len(sysm.last_newton_stats["krylov_iters"]) == len(
        slab.last_newton_stats["krylov_iters"])
    np.testing.assert_allclose(sysm.from_node(out[0]),
                               slab.to_global_nodes(vs), rtol=0, atol=2e-12)
    np.testing.assert_allclose(sysm.from_stress(out[1]),
                               slab.unpermute_elems(stress), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(sysm.from_state(out[2]),
                               slab.unpermute_elems(state_end), rtol=0,
                               atol=1e-10)


# -- on the card --------------------------------------------------------------


@pytest.mark.cuda
def test_chunked_setup_on_the_card(tmp_path):
    """At 16^3 on the card, from phase 20's kind of start (the in-repo
    Voce case's first step: its boundary velocities and the BC
    corrector), one setup in 4 chunks against the whole one: bitwise
    equal, or the f64 outputs within rel 1e-10 (chip_smoke's phase 20
    bar) and the f32-built blocks and the diagonal taken from them within
    1e-5.  cuBLAS picks its f32 GEMM per batch size, so the f32 tangent's
    and the f32 EA build's products round per chunk; at 64^3 (phase 20)
    only the last chunk's did, 1.4e-7 of the largest block, but here
    every chunk's batch is a quarter of the whole's and the blocks part
    by up to 2.7e-6 (measured on an H100), above phase 20's 1e-6.  The
    kernel launches once per chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from exaconstit_tpu_torch.solvers import dogleg_cuda
    toml = cases.write_voce_case(tmp_path / "case", (16, 16, 16), (0.01,))
    with torch.inference_mode():
        sim = Simulation(T_OPT.parse_options(toml), workdir=str(tmp_path),
                         device="cuda")
        sysm = sim.system
        sim.cur_bcs = sim.bc_steps[1]
        sim.update_velocity()
        ess = sysm.to_ess(sim.cur_bcs.ess_mask)
        v = sysm.solve_init(torch.zeros_like(sim.v), sim.v, sim.x_beg,
                            sim.state, 0.01, ess)
        xw = torch.zeros((8, sysm.npts), dtype=sysm.dtype, device="cuda")
        outs = {}
        for chunks in (1, 4):
            s = MechSystem(sim.opt, sim.mesh, sim.model, device="cuda",
                           setup_chunks=chunks)
            before = dogleg_cuda.KERNEL.launches
            outs[chunks] = s.setup(v, sim.x_beg, sim.state, 0.01, ess, True,
                                   s.compute_nsub(0.01), xw, False)
            assert dogleg_cuda.KERNEL.launches - before == chunks
    f32_built = ("EA blocks", "diagonal") if s.ea_asm_f32 else ("EA blocks",)
    for name, a, b in zip(NAMES, outs[4], outs[1]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if torch.equal(a, b):
            continue
        bar = 1e-5 if name in f32_built else 1e-10
        assert float((a - b).abs().max() / b.abs().max()) < bar, name
