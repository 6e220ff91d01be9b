"""PyTorch port against the JAX package: the rest of the point update.

``solvers.linalg_small.solve_dense`` and ``solvers.dogleg.dogleg_solve``
(the reference's per-point solvers, batched here as masked loops), the
kinetics' closed-form hardness partials against ``jax.jvp``, the
``EvptnModel`` knobs and the converter, ``model_setup`` for every knob
variant over the Voce, KMBalD (BCC MTSDD) and SplineG (FCC MTSDD)
kinetics across three steps, the coupled tangent against central
differences, and a 4^3 ``MechSystem`` Newton solve with the coupled
hardness on the per-point engine."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from exaconstit_tpu.config import options as J_OPT
from exaconstit_tpu.driver import MechSystem as JMechSystem
from exaconstit_tpu.mesh.voxel import make_cartesian_mesh as j_mesh
from exaconstit_tpu.models import ecmech as J_EC
from exaconstit_tpu.models import evptn as J_EV
from exaconstit_tpu.solvers.dogleg import dogleg_solve as j_dogleg
from exaconstit_tpu.solvers.linalg_small import solve_dense as j_solve
from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.driver import MechSystem
from exaconstit_tpu_torch.mesh.voxel import make_cartesian_mesh
from exaconstit_tpu_torch.models import ecmech as T_EC
from exaconstit_tpu_torch.models import evptn as T_EV
from exaconstit_tpu_torch.models import kinetics as T_KIN
from exaconstit_tpu_torch.models.convert import (arrays_from_model,
                                                 ecmech_from_reference)
from exaconstit_tpu_torch.solvers.dogleg import dogleg_solve
from exaconstit_tpu_torch.solvers.linalg_small import solve_dense

TEMP_K = 298.0
# family -> (lattice, slip type); the MTSDD copper set builds SplineG
# kinetics on FCC and KMBalD (athermal strength) on BCC
FAMILIES = {"voce": ("FCC", "POWERVOCE"), "kmbald": ("BCC", "MTSDD"),
            "splineg": ("FCC", "MTSDD")}
KNOBS = {
    "vmap": dict(engine="vmap"),
    "tangent_coupled": dict(tangent_mode="coupled"),
    "hardness_coupled": dict(hardness_mode="coupled"),
    "stagger_2": dict(stagger_iters=2),
    "h_once": dict(h_per_substep=False),
    "theta_half": dict(flow_theta=0.5),
    "rot_begin": dict(rot_frame="begin"),
    "h_before": dict(h_order="before", h_gd_blend=1.0),
    "gd_begin": dict(h_gd_source="gd_begin", h_gd_blend=1.0),
    "h_forward": dict(h_gd_source="h_forward", h_gd_blend=1.0),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opts(mod, xtal, slip):
    opt = mod.ExaOptions()
    opt.mech_type = mod.MechType.EXACMECH
    opt.xtal_type = getattr(mod.XtalType, xtal)
    opt.slip_type = getattr(mod.SlipType, slip)
    opt.temp_k = TEMP_K
    return opt


def models(family, **knobs):
    """Both packages' models of ``family`` with ``knobs`` set on each.
    The MTSDD families solve to 1e-13, as in test_torch_mtsdd.py, so that
    a comparison measures the port and not where the stop test fell."""
    xtal, slip = FAMILIES[family]
    props = cases.VOCE_PROPS if slip == "POWERVOCE" else cases.MTSDD_PROPS
    if slip == "MTSDD":
        knobs = dict(knobs, solver_tol=1e-13)
    jm = J_EC.build_model(_opts(J_OPT, xtal, slip), props)
    tm = T_EC.build_model(_opts(T_OPT, xtal, slip), props)
    return (dataclasses.replace(jm, evptn=dataclasses.replace(jm.evptn,
                                                              **knobs)),
            dataclasses.replace(tm, evptn=dataclasses.replace(tm.evptn,
                                                              **knobs)))


def point_inputs(jm, n=12, seed=4):
    """Velocity gradient (n, 3, 3) near uniaxial tension and a state
    part-way through loading (random orientations, elastic strain and
    hardness above its initial value)."""
    rng = np.random.default_rng(seed)
    vgrad = rng.normal(size=(n, 3, 3)) * 3e-4
    vgrad[:, 2, 2] += 1e-3
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = jm.init_state(q)
    s[:, jm.IND_ESTRAIN:jm.IND_ESTRAIN + 5] = rng.normal(size=(n, 5)) * 5e-5
    s[:, jm.IND_HARD] *= rng.uniform(1.0, 1.5, size=n)
    return vgrad, s


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# ---------------------------------------------------------------------------
# the small solvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [None, 5])
def test_solve_dense(k):
    """Pivoted Gauss-Jordan per point against the vmapped reference, 12
    random 9x9 systems (row scales spread over 1e-6..1e6): 1e-12."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(12, 9, 9)) * 10.0 ** rng.uniform(-6, 6,
                                                          size=(12, 9, 1))
    b = rng.normal(size=(12, 9) if k is None else (12, 9, k))
    got = solve_dense(torch.tensor(A), torch.tensor(b)).numpy()
    want = np.asarray(jax.vmap(j_solve)(jnp.asarray(A), jnp.asarray(b)))
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-12


def _test_system(xp, x, A, c, b):
    """r = A x + c x^3 - b and its Jacobian, in the array module xp."""
    if xp is torch:
        r = torch.einsum("nij,nj->ni", A, x) + c * x ** 3 - b
        J = A + torch.diag_embed(3.0 * c * x ** 2)
        return r, J
    r = A @ x + c * x ** 3 - b
    return r, A + jnp.diag(3.0 * c * x ** 2)


@pytest.mark.parametrize("max_iter", [100, 4])
def test_dogleg_solve(max_iter):
    """The masked batched dogleg against ``jax.vmap(dogleg_solve)`` on 12
    cubic systems of 6 unknowns: the same iterations and flags per lane;
    at max_iter 100 every lane converges and x, J agree to 1e-10; at 4
    most lanes stop at the cap, mid-solve, where an iterate carries its
    steps' rounding uncontracted: 1e-8."""
    rng = np.random.default_rng(1)
    n = 12
    A = rng.normal(size=(n, 6, 6)) + 4.0 * np.eye(6)
    c = rng.uniform(0.5, 2.0, size=(n, 6))
    b = rng.normal(size=(n, 6)) * 10.0 ** rng.uniform(-1, 1.5, size=(n, 1))
    x0 = np.zeros((n, 6))
    tA, tc, tb = (torch.tensor(a) for a in (A, c, b))
    x, ok, it, nrm, J = dogleg_solve(
        lambda x: _test_system(torch, x, tA, tc, tb), torch.tensor(x0),
        tol=1e-11, max_iter=max_iter, return_jac=True)

    def one(A1, c1, b1, x01):
        return j_dogleg(lambda x: _test_system(jnp, x, A1, c1, b1), x01,
                        tol=1e-11, max_iter=max_iter, return_jac=True)

    xj, okj, itj, nrmj, Jj = jax.vmap(one)(*(jnp.asarray(a)
                                            for a in (A, c, b, x0)))
    np.testing.assert_array_equal(it.numpy(), np.asarray(itj))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    bar = 1e-10 if max_iter == 100 else 1e-8
    assert _rel(x.numpy(), xj) < bar
    assert _rel(J.numpy(), Jj) < bar
    if max_iter == 100:
        assert ok.all() and int(it.max()) > 3
    else:
        assert not ok.all() and int(it.max()) == 4


# ---------------------------------------------------------------------------
# kinetics: the closed-form hardness partials and the remaining updates
# ---------------------------------------------------------------------------


KIN_CASES = {
    "voce": ("voce", {}),
    "voce_nl_one_minus": ("voce", dict(voce_exponent=1.7, form="one_minus")),
    "voce_exponential": ("voce", dict(h_scheme="exponential",
                                      xms=0.05, gam_s=1e-3)),
    "kmbald": ("kmbald", {}),
    "kmbald_fcc": ("kmbald_fcc", {}),
    "splineg": ("splineg", {}),
}


def kinetics_pair(name):
    family, upd = KIN_CASES[name]
    if family == "kmbald_fcc":  # the file's raw KMBalD constants on FCC
        props = cases.MTSDD_PROPS
        jk = J_EC.kinetics.KMBalD.from_props(props, n_elastic=3)
        tk = T_KIN.KMBalD.from_props(props, n_elastic=3)
    else:
        jm, tm = models(family)
        jk, tk = jm.evptn.kinetics, tm.evptn.kinetics
    return dataclasses.replace(jk, **upd), dataclasses.replace(tk, **upd)


@pytest.mark.parametrize("name", list(KIN_CASES))
def test_kinetics_hardness_partials(name):
    """gdots_dh and h_residual_partials (the coupled system's h column and
    row, closed form here) against jax.jvp of the reference's gdots and
    h_residual; update_h and, where the reference has it,
    update_h_explicit: 1e-9 rel of the largest entry (the partials are
    formulas of the same values in another order)."""
    jk, tk = kinetics_pair(name)
    rng = np.random.default_rng(2)
    n, S = 24, 12
    h = np.array(jk.init_hardness()).reshape(1, 1) * rng.uniform(
        1.0, 1.6, size=(1, n))
    sign = np.sign(rng.normal(size=(S, n)))
    u = rng.uniform(-0.2, 1.2, size=(S, n))
    if isinstance(jk, J_EC.kinetics.VocePL):  # |tau| / g around 1
        taus = sign * h * (0.8 + 0.3 * u)
    else:  # across the thermal window lo < |tau| < lo + norm
        g = np.asarray(jk._strength(jnp.asarray(h.T))).T
        lo, norm = (g, jk.tau_a) if jk.g_athermal else (jk.tau_a, g)
        taus = sign * (lo + u * norm)
    gd = np.asarray(jk.gdots(jnp.asarray(taus.T), jnp.asarray(h.T),
                             TEMP_K)).T
    dt = 0.05
    h_n = h * 0.97
    jt, jh, jhn = (jnp.asarray(a.T) for a in (taus, h, h_n))
    _, dgd = jax.jvp(lambda hh: jk.gdots(jt, hh, TEMP_K), (jh,),
                     (jnp.ones_like(jh),))
    got = tk.gdots_dh(torch.tensor(taus), torch.tensor(h), TEMP_K)
    assert np.abs(np.asarray(dgd)).max() > 0.0
    assert _rel(got.numpy(), np.asarray(dgd).T) < 1e-9
    jgd = jnp.asarray(gd.T)
    _, drh_dh = jax.jvp(lambda hh: jk.h_residual(hh, jhn, jgd, dt, TEMP_K),
                        (jh,), (jnp.ones_like(jh),))
    sgn = jnp.sign(jgd)
    nnz = jnp.sum(sgn * sgn, axis=-1, keepdims=True)
    _, drh_dg = jax.jvp(lambda gg: jk.h_residual(jh, jhn, gg, dt, TEMP_K),
                        (jgd,), (sgn,))
    t_dh, t_ds = tk.h_residual_partials(
        torch.tensor(h), torch.tensor(h_n), torch.tensor(gd), dt, TEMP_K)
    assert _rel(t_dh.numpy(), np.asarray(drh_dh).T) < 1e-9
    assert _rel(t_ds.numpy(), np.asarray(drh_dg / nnz).T) < 1e-9
    args_t = (torch.tensor(h_n), torch.tensor(gd), dt, TEMP_K)
    args_j = (jhn, jgd, dt, TEMP_K)
    assert _rel(tk.h_residual(torch.tensor(h), *args_t[:3]).numpy(),
                np.asarray(jk.h_residual(jh, *args_j)).T) < 1e-12
    assert _rel(tk.update_h(*args_t).numpy(),
                np.asarray(jk.update_h(*args_j)).T) < 1e-12
    if hasattr(jk, "update_h_explicit"):
        assert _rel(tk.update_h_explicit(*args_t).numpy(),
                    np.asarray(jk.update_h_explicit(*args_j)).T) < 1e-13


# ---------------------------------------------------------------------------
# the model's knobs, the converter and the engines' dispatch
# ---------------------------------------------------------------------------


def test_knob_fields_converter_and_dispatch():
    """Every field of the reference's EvptnModel but its Pallas switches,
    with the reference's defaults and __post_init__ rule; the converter
    carries the knobs; ``supports_cm`` and ``point_major`` follow the
    reference's engine rule; ``model_setup_cm`` refuses what the cm
    engine does not cover, and ``with_solution`` the per-point engine."""
    jm, tm = models("voce")
    jf = {f.name: f.default for f in dataclasses.fields(J_EV.EvptnModel)}
    tf = {f.name: f.default for f in dataclasses.fields(T_EV.EvptnModel)}
    assert set(jf) - set(tf) == {"use_pallas", "pallas_min_batch"}
    assert set(tf) - set(jf) == {"ift_tangents"}
    for k in set(jf) & set(tf):
        assert tf[k] == jf[k], k
    with pytest.raises(ValueError, match="h_gd_blend"):
        dataclasses.replace(tm.evptn, h_order="before")
    knobs = dict(engine="vmap", hardness_mode="coupled", stagger_iters=3,
                 h_per_substep=False, flow_theta=0.5,
                 h_gd_source="h_forward", h_gd_blend=1.0, rot_frame="begin",
                 h_order="before", tangent_mode="coupled")
    jk = dataclasses.replace(jm, evptn=dataclasses.replace(jm.evptn,
                                                           **knobs))
    conv = ecmech_from_reference(arrays_from_model(jk))
    for k, v in knobs.items():
        assert getattr(conv.evptn, k) == v, k
    assert conv.evptn.ift_tangents is False
    assert conv.supports_cm == jk.supports_cm is False and conv.point_major
    assert tm.supports_cm and not tm.point_major
    vgrad, s = point_inputs(jm, n=4)
    with torch.inference_mode():
        with pytest.raises(NotImplementedError):
            conv.model_setup_cm(0.1, torch.tensor(vgrad).permute(1, 2, 0),
                                torch.tensor(s.T))
        with pytest.raises(ValueError, match="with_solution"):
            conv.model_setup(0.1, torch.tensor(vgrad), torch.tensor(s),
                             with_solution=True)
        for knob, v in knobs.items():
            upd = {knob: v, "h_gd_blend": 1.0}
            one = dataclasses.replace(tm, evptn=dataclasses.replace(
                tm.evptn, **upd))
            ref = dataclasses.replace(jm, evptn=dataclasses.replace(
                jm.evptn, **upd))
            assert one.supports_cm == ref.supports_cm, knob


# ---------------------------------------------------------------------------
# model_setup for every knob variant
# ---------------------------------------------------------------------------


# (family, knob) -> the stress/state bar where it is not 1e-9, and the
# lanes whose iteration counts may differ over the three steps
LOOSER = {("kmbald", "hardness_coupled"): (1e-8, 0),
          ("kmbald", "theta_half"): (1e-9, 2),
          ("splineg", "hardness_coupled"): (1e-9, 8)}


def variant_knobs(family):
    """The knobs ``model_setup`` is held to the reference with for
    ``family`` (the reference's KMBalD has no explicit update)."""
    return [k for k in KNOBS if not (family == "kmbald"
                                     and k == "h_forward")]


def check_model_setup_variant(family, knob):
    """``model_setup`` (point-major, through ``batched_update``) for one
    knob over three dt 0.2 steps (2 substeps each), 12 points, the state
    carried: stress and state (but the iteration counts) to 1e-9 rel of
    the largest entry, the tangent to 1e-6 (Voce's component-major
    tangents are f32, about 4e-7 apart; the per-point engine's are f64).
    The iteration counts are equal but where ``LOOSER`` says: the fully
    coupled MTSDD solves take 35 to 190 trust-region iterations and a
    lane's path follows the Jacobian's rounding (the KMBalD one lands
    6e-9 apart at its 1e-13 tolerance), and so does the trapezoidal
    KMBalD flow.  The reference's update is jitted once and called three
    times."""
    jm, tm = models(family, **KNOBS[knob])
    assert tm.supports_cm == jm.supports_cm
    vgrad, s = point_inputs(jm)
    ref = jax.jit(lambda L, st: jm.model_setup(0.2, L, st))
    sj, st = jnp.asarray(s), torch.tensor(s)
    bar, lanes = LOOSER.get((family, knob), (1e-9, 0))
    it = tm.IND_NFEVAL
    differ = 0
    for _ in range(3):
        oj = ref(jnp.asarray(vgrad), sj)
        with torch.inference_mode():
            ot = tm.model_setup(0.2, torch.tensor(vgrad), st)
        (a0, a1, a2), (b0, b1, b2) = [np.asarray(o) for o in oj], \
            [o.numpy() for o in ot]
        assert np.isfinite(b0).all() and np.isfinite(b2).all()
        assert _rel(b0, a0) < bar
        assert _rel(np.delete(b1, it, 1), np.delete(a1, it, 1)) < bar
        assert _rel(b2, a2) < 1e-6
        differ += int((b1[:, it] != a1[:, it]).sum())
        sj, st = oj[1], ot[1]
    assert differ <= lanes
    gd = b1[:, tm.ind_gdot:tm.ind_gdot + tm.nslip]
    assert np.abs(gd).max() > 1e-4  # plastic flow under way


@pytest.mark.parametrize("knob", variant_knobs("voce"))
def test_model_setup_variants_voce(knob):
    """Every knob on the Voce model (mixed precision, the production
    setting); the MTSDD families are in test_torch_point_variants_*.py."""
    check_model_setup_variant("voce", knob)


# ---------------------------------------------------------------------------
# the coupled tangent and the coupled hardness through the FEM driver
# ---------------------------------------------------------------------------


def test_coupled_tangent_fd():
    """The port's counterpart of tests/test_material.py::
    test_consistent_tangent_fd on the in-repo Voce case: with the fully
    coupled hardness the implicit-function tangent of the per-point
    engine matches central differences of the whole point update (5e-3 of
    the largest entry, the reference's bar) after 15 steps of uniaxial
    tension, and is symmetric (it is held to the reference's in
    test_model_setup_variants_voce[hardness_coupled])."""
    _, tm = models("voce", hardness_mode="coupled")
    N, dt = 4, 0.1
    state = torch.tensor(tm.init_state(np.tile([[1.0, 0, 0, 0]], (N, 1))))
    Lm = np.diag([-5e-4, -5e-4, 1e-3])

    def setup(L, st, tangent):
        with torch.inference_mode():
            return tm.model_setup(dt, torch.tensor(np.tile(L, (N, 1, 1))),
                                  st, compute_tangent=tangent)

    st = state
    for _ in range(15):
        _, st, _ = setup(Lm, st, False)
    _, _, tg = setup(Lm, st, True)
    tg = tg[0].numpy()
    np.testing.assert_allclose(tg, tg.T, atol=1e-8)
    fd = np.zeros((6, 6))
    eps = 1e-9
    for c, (i, j) in enumerate([(0, 0), (1, 1), (2, 2), (1, 2), (0, 2),
                                (0, 1)]):
        dL = np.zeros((3, 3))
        if i == j:
            dL[i, j] = eps / dt
        else:  # engineering shear split symmetrically
            dL[i, j] = dL[j, i] = 0.5 * eps / dt
        sp, _, _ = setup(Lm + dL, st, False)
        sm, _, _ = setup(Lm - dL, st, False)
        fd[:, c] = (sp[0].numpy() - sm[0].numpy()) / (2 * eps)
    assert np.abs(tg - fd).max() / np.abs(fd).max() < 5e-3


def _systems(ncuts, knobs):
    """Both packages' MechSystem on the seeded 4^3 Voce problem (the
    reference's __graft_entry__._tiny_problem, rebuilt here around a model
    with ``knobs``), with uniaxial tension BCs."""
    out = []
    for mod, mesh_fn, sys_cls in ((J_OPT, j_mesh, JMechSystem),
                                  (T_OPT, make_cartesian_mesh, MechSystem)):
        opt = _opts(mod, "FCC", "POWERVOCE")
        opt.assembly = mod.Assembly.EA
        opt.solver = mod.KrylovSolver.PCG
        opt.krylov_rel_tol, opt.krylov_abs_tol, opt.krylov_iter = \
            1e-10, 1e-27, 400
        opt.newton_rel_tol, opt.newton_abs_tol = 1e-9, 1e-14
        mesh = mesh_fn(ncuts, [1.0, 1.0, 1.0], order=1)
        build = J_EC.build_model if mod is J_OPT else T_EC.build_model
        model = build(opt, cases.VOCE_PROPS)
        model = dataclasses.replace(model, evptn=dataclasses.replace(
            model.evptn, **knobs))
        kw = {} if mod is J_OPT else dict(device="cpu")
        system = sys_cls(opt, mesh, model, **kw)
        rng = np.random.default_rng(0)
        q = rng.normal(size=(mesh.num_elems, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        state = model.init_state(np.repeat(q, 8, axis=0)).reshape(
            mesh.num_elems, 8, -1)
        ess = np.zeros((mesh.num_nodes, 3), dtype=bool)
        for face, comp in ((1, 2), (2, 0), (3, 1), (4, 2)):
            ess[mesh.bdr_nodes[face], comp] = True
        v0 = np.zeros((mesh.num_nodes, 3))
        v0[mesh.bdr_nodes[4], 2] = 1e-3
        out.append((system, system.to_node(v0),
                    system.to_node(mesh.coords), system.to_state(state),
                    system.to_ess(ess)))
    return out


def test_mech_system_coupled_hardness():
    """A 4^3 Newton solve (dt 0.1, Newton to rel 1e-9) with the fully
    coupled hardness: the port's MechSystem takes the point-major path
    and the per-point engine through ``model_setup`` (f64 EA build,
    Jacobi), as the reference's does; velocity, stress and state to
    1e-8 rel, the same Newton iterations."""
    (js, jv, jx, jst, jess), (ts, tv, tx, tst, tess) = _systems(
        (4, 4, 4), dict(hardness_mode="coupled"))
    assert ts.point_major and not js.use_cm
    assert ts.precond_kind == js.precond_kind == "jacobi"
    assert not ts.ea_asm_f32
    out_j = js.newton_solve(jv, jx, jst, 0.1, jess, verbose=False)
    with torch.inference_mode():
        out_t = ts.newton_solve(tv, tx, tst, 0.1, tess, verbose=False)
    assert bool(out_j[3]) and out_t[3]
    assert (ts.last_newton_stats["nr_iters"]
            == js.last_newton_stats["nr_iters"])
    v_t, s_t, st_t = (ts.from_node(out_t[0]), ts.from_stress(out_t[1]),
                      ts.from_state(out_t[2]))
    v_j, s_j, st_j = (js.from_node(out_j[0]), js.from_stress(out_j[1]),
                      js.from_state(out_j[2]))
    it = ts.model.IND_NFEVAL  # the point solves' iteration counts
    assert _rel(v_t, v_j) < 1e-8
    assert _rel(s_t, s_j) < 1e-8
    assert _rel(np.delete(st_t, it, -1), np.delete(st_j, it, -1)) < 1e-8
