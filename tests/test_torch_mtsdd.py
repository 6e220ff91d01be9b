"""PyTorch port against the JAX package: the MTSDD / BCC / HCP families.

Slip geometry and hexagonal elasticity, the ``KMBalD`` and ``SplineG``
kinetics (FCC, BCC with ``g_athermal``, per-slip HCP; both precisions),
the model factory for every lattice x slip type, ``model_setup_cm``
through the pure-f64 point solve, the MTSDD drivers, and the three
repairs of the point solve (``strength_floor`` in the initial guess,
``gam_wo`` as the substep rate, ``temp_k`` threaded to the kinetics)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from exaconstit_tpu.config import options as J_OPT
from exaconstit_tpu.driver import Simulation as JSimulation
from exaconstit_tpu.models import ecmech as J_EC
from exaconstit_tpu.models import elasticity as J_EL
from exaconstit_tpu.models import evptn_cm as J_CM
from exaconstit_tpu.models import kinetics as J_KIN
from exaconstit_tpu.models import slip_geom as J_SG
from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.driver import Simulation as TSimulation
from exaconstit_tpu_torch.models import ecmech as T_EC
from exaconstit_tpu_torch.models import elasticity as T_EL
from exaconstit_tpu_torch.models import evptn_cm as T_CM
from exaconstit_tpu_torch.models import kinetics as T_KIN
from exaconstit_tpu_torch.models import slip_geom as T_SG
from exaconstit_tpu_torch.models.convert import (arrays_from_model,
                                                 ecmech_from_reference)
from exaconstit_tpu_torch.solvers import dogleg_cuda

VOCE_NL_PROPS = np.insert(cases.VOCE_PROPS, 12, 1.7)
# Voce reads three elastic constants, so the HCP Voce sets carry five
VOCE_HCP = np.concatenate([cases.VOCE_PROPS[:3],
                           [162.4, 92.0, 69.0, 180.7, 46.7],
                           cases.VOCE_PROPS[6:]])
TEMP_K = 298.0


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


def props_for(xtal, slip):
    if slip == "MTSDD":
        return cases.hcp_mtsdd_props() if xtal == "HCP" else cases.MTSDD_PROPS
    return cases.VOCE_PROPS if slip == "POWERVOCE" else VOCE_NL_PROPS


def models(xtal, slip="MTSDD"):
    props = props_for(xtal, slip)
    return (J_EC.build_model(_opts(J_OPT, xtal, slip), props),
            T_EC.build_model(_opts(T_OPT, xtal, slip), props))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("xtal,nslip", [("fcc", 12), ("bcc", 12),
                                        ("hcp", 24)])
def test_slip_geometry(xtal, nslip):
    j, t = J_SG.get_slip_geom(xtal), T_SG.get_slip_geom(xtal)
    assert t.name == j.name and t.nslip == nslip
    np.testing.assert_allclose(t.P, j.P, rtol=0, atol=1e-14)
    np.testing.assert_allclose(t.Q, j.Q, rtol=0, atol=1e-14)
    with pytest.raises(ValueError):
        T_SG.get_slip_geom("sc")


def test_hexagonal_elasticity():
    c = (162.4, 92.0, 69.0, 180.7, 46.7)
    j, t = J_EL.hexagonal(*c), T_EL.hexagonal(*c)
    np.testing.assert_allclose(t.C_dev, j.C_dev, rtol=0, atol=1e-14 * 200)
    assert abs(t.bulk - j.bulk) <= 1e-14 * j.bulk


# ---------------------------------------------------------------------------
# kinetics
# ---------------------------------------------------------------------------


def kinetics_inputs(jk, nslip, dtype, seed):
    """Resolved shears around the flow stress with the edge cases in the
    first columns: tau = 0, below the Peierls stress, and far past the
    strength (x clipped at 1)."""
    rng = np.random.default_rng(seed)
    n = 48
    h = np.array(jk.init_hardness()).reshape(1, 1) * rng.uniform(
        1.0, 3.0, size=(1, n))
    g = np.asarray(jk._strength(jnp.asarray(h.T))).T  # (1 or S, n)
    # tau_eff = |tau| - lo is normalised by norm: the thermal window is
    # lo < |tau| < lo + norm
    lo, norm = (g, jk.tau_a) if jk.g_athermal else (jk.tau_a, g)
    lo = np.broadcast_to(lo, (nslip, n))
    norm = np.broadcast_to(norm, (nslip, n))
    taus = (lo + rng.uniform(-0.2, 1.0, size=(nslip, n)) * norm) \
        * rng.choice([-1.0, 1.0], size=(nslip, n))
    taus[:, 0] = 0.0
    taus[:, 1] = 0.5 * jk.tau_a
    taus[:, 2] = (lo + norm)[:, 2]
    taus[:, 3] = 5.0 * taus[:, 2]
    return taus.astype(dtype), h.astype(dtype)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("xtal", ["FCC", "BCC", "HCP"])
def test_mtsdd_rates(xtal, dtype):
    """gdots, the closed-form slope, strength_floor and operating_ratio.
    f64 to 1e-12 relative, f32 to 1e-5; where one side is exactly zero
    the other is too.  Per-slip HCP in f32 holds 1e-4: the reference
    promotes its per-slip f64 parameter arrays against f32 inputs and so
    computes the exponent c_1 mu / T (1 - x) ~ 300 in f64, while the port
    stays in f32, where that exponent carries 300 roundings."""
    jm, tm = models(xtal)
    jk, tk = jm.evptn.kinetics, tm.evptn.kinetics
    npdt = np.float64 if dtype == "f64" else np.float32
    taus, h = kinetics_inputs(jk, jm.nslip, npdt, 7)
    rtol = 1e-12 if dtype == "f64" else (1e-4 if xtal == "HCP" else 1e-5)
    gd_j, sl_j = jk.gdots_slope(jnp.asarray(taus.T), jnp.asarray(h.T),
                                TEMP_K)
    gd_t, sl_t = tk.gdots_slope(torch.tensor(taus), torch.tensor(h), TEMP_K)
    g_t = tk.gdots(torch.tensor(taus), torch.tensor(h), TEMP_K)
    assert gd_t.dtype == torch.tensor(taus).dtype
    assert torch.equal(g_t, gd_t)
    for got, ref in ((gd_t, gd_j), (sl_t, sl_j)):
        got, ref = got.numpy(), np.asarray(ref).T
        np.testing.assert_array_equal(got == 0.0, ref == 0.0)
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)
    # tau = 0 and below the Peierls stress: no slip at all
    assert not gd_t[:, :2].any() and not sl_t[:, :2].any()
    assert gd_t[:, 2:4].abs().min() > 0
    np.testing.assert_allclose(
        tk.strength_floor(torch.tensor(h)).numpy(),
        np.asarray(jk.strength_floor(jnp.asarray(h.T))), rtol=rtol)
    deff = np.random.default_rng(8).uniform(1e-7, 1e-1, size=30).astype(npdt)
    np.testing.assert_allclose(
        tk.operating_ratio(torch.tensor(deff)).numpy(),
        np.asarray(jk.operating_ratio(jnp.asarray(deff))), rtol=rtol)


@pytest.mark.parametrize("pq", [(1.0, 1.0), (0.5, 1.5)],
                         ids=["p=q=1", "p=0.5,q=1.5"])
@pytest.mark.parametrize("xtal", ["FCC", "BCC", "HCP"])
def test_mtsdd_rates_general_exponents(xtal, pq):
    """The uncalibrated KMBalD law, with the NaN-safe powers when p and q
    are not 1: x = 0 and x = 1 give exact zeros on both sides."""
    jm, tm = models(xtal)
    fields = {f.name: getattr(jm.evptn.kinetics, f.name)
              for f in dataclasses.fields(J_KIN.KMBalD)}
    fields.update(p=pq[0], q=pq[1])
    jk, tk = J_KIN.KMBalD(**fields), T_KIN.KMBalD(**fields)
    taus, h = kinetics_inputs(jk, jm.nslip, np.float64, 9)
    gd_j, sl_j = jk.gdots_slope(jnp.asarray(taus.T), jnp.asarray(h.T), 250.)
    gd_t, sl_t = tk.gdots_slope(torch.tensor(taus), torch.tensor(h), 250.)
    assert np.isfinite(sl_t.numpy()).all()
    np.testing.assert_array_equal(sl_t.numpy() == 0, np.asarray(sl_j).T == 0)
    np.testing.assert_allclose(gd_t.numpy(), np.asarray(gd_j).T, rtol=1e-12)
    np.testing.assert_allclose(sl_t.numpy(), np.asarray(sl_j).T, rtol=1e-12)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("xtal", ["FCC", "BCC", "HCP"])
def test_mtsdd_hardness(xtal, dtype):
    """update_h (20 Newton steps; 30 for the spline map) and h_residual,
    from rates spanning the shear-rate floor."""
    jm, tm = models(xtal)
    jk, tk = jm.evptn.kinetics, tm.evptn.kinetics
    npdt = np.float64 if dtype == "f64" else np.float32
    rng = np.random.default_rng(10)
    n = 40
    h = (np.array(jk.init_hardness()).reshape(1, 1)
         * rng.uniform(1.0, 2.5, size=(1, n))).astype(npdt)
    gd = (rng.normal(size=(jm.nslip, n))
          * 10.0 ** rng.uniform(-13, -2, size=(1, n))).astype(npdt)
    gd[:, 0] = 0.0
    dt = rng.uniform(0.01, 0.5, size=n).astype(npdt)
    rtol = 1e-12 if dtype == "f64" else 1e-5
    got = tk.update_h(torch.tensor(h), torch.tensor(gd), torch.tensor(dt),
                      TEMP_K)
    ref = jk.update_h(jnp.asarray(h.T), jnp.asarray(gd.T),
                      jnp.asarray(dt[:, None]), TEMP_K)
    assert got.shape == (1, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).T, rtol=rtol)
    assert float(got[0, 0]) == float(h[0, 0])  # no slip, no hardening
    h_try = (h * 1.01).astype(npdt)
    r_t = tk.h_residual(torch.tensor(h_try), torch.tensor(h),
                        torch.tensor(gd), torch.tensor(dt), TEMP_K)
    r_j = jk.h_residual(jnp.asarray(h_try.T), jnp.asarray(h.T),
                        jnp.asarray(gd.T), jnp.asarray(dt[:, None]), TEMP_K)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j).T, rtol=rtol,
                               atol=rtol * float(np.abs(h).max()))


def test_spline_map_at_and_outside_the_knots():
    """The hardening map at every knot exactly, between knots and on the
    flat extrapolation either side."""
    jm, tm = models("FCC")
    jk, tk = jm.evptn.kinetics, tm.evptn.kinetics
    assert isinstance(tk, T_KIN.SplineG)
    kn = np.asarray(jk.g_knots)
    g = np.concatenate([kn, 0.5 * (kn[1:] + kn[:-1]),
                        [0.5 * kn[0], kn[0] - 1e-12, kn[-1] + 1e-12,
                         2 * kn[-1]]])[None]
    f_t, df_t = tk._f(torch.tensor(g))
    f_j, df_j = jk._f(jnp.asarray(g.T))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j).T, rtol=1e-13)
    np.testing.assert_allclose(df_t.numpy(), np.asarray(df_j).T, rtol=1e-13)
    assert not df_t[0, -4:].any()


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------


def assert_same_model(tm, jm):
    a, b = arrays_from_model(tm), arrays_from_model(jm)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(b[k], (str, bool, int)):
            assert a[k] == b[k], k
        else:
            np.testing.assert_allclose(np.asarray(a[k], float),
                                       np.asarray(b[k], float), rtol=0,
                                       atol=1e-14 * (1 + np.max(np.abs(
                                           np.asarray(b[k], float)))),
                                       err_msg=k)
    assert type(tm.evptn.kinetics).__name__ == type(jm.evptn.kinetics).__name__
    assert (tm.nslip, tm.n_h, tm.num_state) == (jm.nslip, jm.n_h,
                                                jm.num_state)


@pytest.mark.parametrize("slip", ["POWERVOCE", "POWERVOCENL", "MTSDD"])
@pytest.mark.parametrize("xtal", ["FCC", "BCC", "HCP"])
def test_build_model_every_family(xtal, slip):
    if xtal == "HCP" and slip != "MTSDD":
        # the option schema has no HCP Voce model, and Voce reads three
        # elastic constants; the factory still builds what it is given,
        # as the reference's does
        props = VOCE_HCP if slip == "POWERVOCE" else np.insert(VOCE_HCP, 14,
                                                               1.7)
        with pytest.raises(Exception):
            J_OPT._validate_model(_opts(J_OPT, xtal, slip))
        jm = J_EC.build_model(_opts(J_OPT, xtal, slip), props)
        tm = T_EC.build_model(_opts(T_OPT, xtal, slip), props)
    else:
        jm, tm = models(xtal, slip)
    assert_same_model(tm, jm)
    assert tm.evptn.mixed_precision == (slip != "MTSDD")
    assert tm.evptn.h_gd_blend == (1.0 if slip == "MTSDD" else 0.99608)
    assert tm.qf_mapping == jm.qf_mapping
    assert tm.num_state == 13 + 1 + (24 if xtal == "HCP" else 12) + 2
    rng = np.random.default_rng(0)
    q = rng.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_array_equal(tm.init_state(q), jm.init_state(q))
    for dt in (0.01, 0.1, 0.195, 0.5, 1.0, 3.0):
        assert tm.substep_counts(dt) == int(jm.substep_counts(dt)), dt
    # the converter carries the reference's model across unchanged
    assert_same_model(ecmech_from_reference(arrays_from_model(jm)), jm)


def test_mtsdd_calibration_rows():
    """The copper set's (k1, k2_0) select the calibrated rows: a free-form
    hardening map for FCC, the four evolution constants for BCC; HCP and
    any other parameter set keep the file's constants."""
    _, fcc = models("FCC")
    _, bcc = models("BCC")
    _, hcp = models("HCP")
    kf, kb, kh = (m.evptn.kinetics for m in (fcc, bcc, hcp))
    assert type(kf) is T_KIN.SplineG and len(kf.g_knots) == 12
    assert kf.c1 == cases.MTSDD_PROPS[8] * 1.0359223763912433
    assert type(kb) is T_KIN.KMBalD and kb.g_athermal
    assert (kb.k1, kb.k2_0, kb.prod_exponent, kb.recov_exponent) == (
        64.331, 702.32, 0.0, 1.0)
    assert type(kh) is T_KIN.KMBalD and not kh.g_athermal
    assert (kh.k1, kh.k2_0) == (3e-4, 5e-5) and kh.go.shape == (24,)
    other = cases.MTSDD_PROPS.copy()
    other[17] = 100.0  # k1 of another parameter set
    ko = T_EC.build_model(_opts(T_OPT, "FCC", "MTSDD"), other).evptn.kinetics
    assert type(ko) is T_KIN.KMBalD and ko.k1 == 100.0


def test_mtsdd_substeps_use_gam_wo():
    """The substep count reads gam_wo for the kinetics without a gdot0."""
    props = cases.MTSDD_PROPS.copy()
    props[12] = 4.0  # gam_wo
    props[17] = 1e-3  # off the calibrated row: plain KMBalD
    jm = J_EC.build_model(_opts(J_OPT, "FCC", "MTSDD"), props)
    tm = T_EC.build_model(_opts(T_OPT, "FCC", "MTSDD"), props)
    assert not hasattr(tm.evptn.kinetics, "gdot0")
    for dt in (0.01, 0.05, 0.1, 0.3):
        assert tm.substep_counts(dt) == int(jm.substep_counts(dt))
    assert tm.substep_counts(0.1) == 4


# ---------------------------------------------------------------------------
# the point solve
# ---------------------------------------------------------------------------


def point_inputs(tm, n, seed):
    """Velocity gradient (3, 3, n) and a state (nsv, n) part-way through
    loading: random orientations, an elastic strain near yield and a
    hardness above its initial value."""
    rng = np.random.default_rng(seed)
    vgrad = rng.normal(size=(3, 3, n)) * 3e-4
    vgrad[2, 2] += 1e-3
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = tm.init_state(q)
    s[:, tm.IND_ESTRAIN:tm.IND_ESTRAIN + 5] = rng.normal(size=(n, 5)) * 5e-5
    s[:, tm.IND_HARD] *= rng.uniform(1.0, 1.5, size=n)
    return vgrad, s.T.copy()


def run_setup(jm, tm, dt, n=64, seed=4):
    vgrad, s = point_inputs(tm, n, seed)
    out_j = jm.model_setup_cm(dt, jnp.asarray(vgrad), jnp.asarray(s),
                              with_solution=True)
    with torch.inference_mode():
        out_t = tm.model_setup_cm(dt, torch.tensor(vgrad), torch.tensor(s),
                                  with_solution=True)
    return [np.asarray(a) for a in out_j], [a.numpy() for a in out_t]


def with_solver_tol(model, tol):
    return dataclasses.replace(model, evptn=dataclasses.replace(
        model.evptn, solver_tol=tol))


@pytest.mark.parametrize("dt", [0.1, 1.0])
@pytest.mark.parametrize("xtal", ["FCC", "BCC", "HCP"])
def test_model_setup_mtsdd(xtal, dt):
    """Stress, state and the 6x6 lagged tangent through the pure-f64 point
    solve, 64 points; dt 1.0 takes 8 substeps (floor(1.0 / 0.1) = 10,
    clipped to max_substeps).  Both sides solve to 1e-13 here, so that
    the comparison measures the port and not where the stop test fell:
    1e-9 rel of the largest entry.  Iteration counts are equal in the
    single-substep solves; over 8 substeps a trust-region path of some
    400 iterations may part on a few lanes (at most 5 of 64) and still
    end at the same root."""
    jm, tm = (with_solver_tol(m, 1e-13) for m in models(xtal))
    assert tm.substep_counts(dt) == (1 if dt == 0.1 else 8)
    (sj, stj, cj, xj), (st, stt, ct, xt) = run_setup(jm, tm, dt)
    assert np.isfinite(st).all() and np.isfinite(ct).all()
    assert _rel(st, sj) < 1e-9
    assert _rel(ct, cj) < 1e-9
    assert _rel(xt, xj) < 1e-9
    for name, (lo, n) in tm.qf_mapping.items():
        assert _rel(stt[lo:lo + n], stj[lo:lo + n]) < 1e-9, name
    it = tm.IND_NFEVAL
    assert int((stt[it] != stj[it]).sum()) <= (0 if dt == 0.1 else 5)
    # plastic flow is under way: this is not an elastic comparison
    assert np.abs(stt[tm.ind_gdot:tm.ind_gdot + tm.nslip]).max() > 1e-5


@pytest.mark.parametrize("xtal", ["FCC", "BCC", "HCP"])
def test_model_setup_mtsdd_at_the_case_tolerance(xtal):
    """The same at the parameter set's own solver tolerance (1e-8 for the
    copper set, 1e-10 for the HCP set) and dt 0.1.  Two solves that stop
    at |r| < tol agree to about tol over the strain scale, not to
    rounding: 1e-8 rel."""
    jm, tm = models(xtal)
    assert tm.evptn.solver_tol == jm.evptn.solver_tol >= 1e-10
    (sj, stj, cj, xj), (st, stt, ct, xt) = run_setup(jm, tm, 0.1)
    assert _rel(st, sj) < 1e-8
    assert _rel(ct, cj) < 1e-8
    assert _rel(xt, xj) < 1e-8
    for name, (lo, n) in tm.qf_mapping.items():
        assert _rel(stt[lo:lo + n], stj[lo:lo + n]) < 1e-8, name


def test_mtsdd_never_reaches_the_stage(monkeypatch):
    """An MTSDD model is pure f64: its point solve never calls the f32
    stage wrapper, and the wrapper refuses it."""
    _, tm = models("FCC")
    assert tm.evptn.mixed_precision is False

    def boom(*a, **k):
        raise AssertionError("dogleg_stage called for an MTSDD model")

    monkeypatch.setattr(dogleg_cuda, "dogleg_stage", boom)
    vgrad, s = point_inputs(tm, 8, 1)
    with torch.inference_mode():
        stress, _, _ = tm.model_setup_cm(0.25, torch.tensor(vgrad),
                                         torch.tensor(s))
    assert torch.isfinite(stress).all()
    monkeypatch.undo()
    x0 = torch.zeros(8, 4, dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        dogleg_cuda.dogleg_stage(tm.evptn, x0, x0[:1], x0[0], x0[:5],
                                 x0[:3], x0[:5], x0[:4],
                                 torch.ones(4, dtype=torch.bool), 1e-6, 10)
    # and a 24-system model cannot reach the 12-system kernel
    _, hcp = models("HCP")
    with pytest.raises(NotImplementedError):
        dogleg_cuda.kernel_params(hcp.evptn, 1e-6, 10)


# ---------------------------------------------------------------------------
# the three repairs, each on an input where the fault showed
# ---------------------------------------------------------------------------


def test_initial_guess_uses_the_slip_strength():
    """A KMBalD model's hardness is a dislocation density (9e-4): the
    initial guess must scale the trial stress by the slip strength
    go + s sqrt(rho), not by the density."""
    jm, tm = models("BCC")
    n = 16
    rng = np.random.default_rng(3)
    d = rng.normal(size=(5, n)) * 1e-3
    q = rng.normal(size=(4, n))
    q /= np.linalg.norm(q, axis=0)
    e = rng.normal(size=(5, n)) * 1e-3  # far outside the flow surface
    h = np.full((1, n), 9e-4)
    dts = np.full(n, 0.1)
    deff = np.sqrt(2.0 / 3.0 * np.sum(d * d, axis=0))
    ref = J_CM._initial_guess_cm(
        jm.evptn, jnp.asarray(dts), J_CM.vecd_to_mat_cm(jnp.asarray(d)),
        jnp.asarray(deff), jnp.asarray(e), jnp.asarray(q), jnp.asarray(h))
    t = [torch.tensor(a) for a in (dts, d, deff, e, q, h)]
    got = T_CM._initial_guess_cm(tm.evptn, t[0], T_CM.vecd_to_mat_cm(t[1]),
                                 t[2], t[3], t[4], t[5])
    assert _rel(got.numpy(), ref) < 1e-12
    # scaled back onto the flow surface: max |tau| is near the strength,
    # an order of magnitude above the density
    PC = tm.evptn.slip.P @ tm.evptn.elast.C_dev
    tau_max = np.abs(PC @ got.numpy()).max(axis=0)
    assert (tau_max > 5e-3).all()


def test_temperature_reaches_the_kinetics():
    """MTSDD rates depend on temperature: at 500 K the port gives the
    reference's stress at 500 K, which is not its own at 298 K."""
    jm, tm = models("HCP")
    hot = [dataclasses.replace(m, temp_k=500.0) for m in (jm, tm)]
    (sj, *_), (st, *_) = run_setup(*hot, 0.25, n=16)
    assert _rel(st, sj) < 1e-9
    vgrad, s = point_inputs(tm, 16, 4)
    with torch.inference_mode():
        cold, _, _ = tm.model_setup_cm(0.25, torch.tensor(vgrad),
                                       torch.tensor(s))
    assert _rel(cold.numpy(), st) > 1e-3


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def run_both(toml, tmp_path, fname="avg_stress.txt"):
    outs = []
    for name, opts, sim_cls, kw in (("jax", J_OPT, JSimulation, {}),
                                    ("torch", T_OPT, TSimulation,
                                     {"device": "cpu"})):
        wd = tmp_path / name
        wd.mkdir()
        with torch.inference_mode():
            sim = sim_cls(opts.parse_options(str(toml)), workdir=str(wd),
                          **kw)
            sim.run(verbose=False)
        outs.append(np.loadtxt(wd / fname, ndmin=2))
    return outs


def test_driver_mtsdd_fcc(tmp_path):
    """The copper MTSDD case at 4^3, 3 fixed steps across yield: average
    stress to 1e-8 rel of its largest entry."""
    toml = cases.write_mtsdd_case(tmp_path / "case", (4, 4, 4),
                                  (0.1, 0.1, 0.2), ngrains=12)
    ref, got = run_both(toml, tmp_path)
    assert got.shape == (3, 6) and np.isfinite(got).all()
    assert _rel(got, ref) < 1e-8


HCP_TOML = """
Version = "0.6.0"
[Properties]
    temperature = 298
    [Properties.Matl_Props]
        floc = "props_hcp_mts.txt"
        num_props = 95
    [Properties.State_Vars]
        floc = "state_hcp_mts.txt"
        num_vars = 36
    [Properties.Grain]
        ori_state_var_loc = 9
        ori_stride = 4
        ori_type = "quat"
        num_grains = 8
        ori_floc = "hcp_quats.ori"
        grain_floc = "grains8.txt"
[BCs]
    constant_strain_rate = true
    essential_ids = [1, 2, 3, 4]
    essential_comps = [-3, -1, -2, -3]
    essential_vel_grad = [[-0.0005, 0.0, 0.0],
                          [0.0, -0.0005, 0.0],
                          [0.0, 0.0, 0.001]]
[Model]
    mech_type = "exacmech"
    cp = true
    [Model.ExaCMech]
        xtal_type = "hcp"
        slip_type = "mtsdd"
[Time]
    [Time.Fixed]
        dt = 0.25
        t_final = 2.0
[Visualizations]
    steps = 100
    visit = false
    floc = "./hcp_p"
    avg_stress_fname = "hcp_stress.txt"
[Solvers]
    assembly = "EA"
    rtmodel = "CPU"
    [Solvers.NR]
        iter = 30
        rel_tol = 1e-5
        abs_tol = 1e-8
    [Solvers.Krylov]
        iter = 200
        rel_tol = 1e-7
        abs_tol = 1e-27
        solver = "PCG"
[Mesh]
    type = "auto"
    [Mesh.Auto]
        length = [1.0, 1.0, 1.0]
        ncuts = [2, 2, 2]
"""


def test_driver_hcp_velocity_gradient(tmp_path):
    """The HCP case of the reference's own driver test: 2^3, 8 grains, the
    95-value per-slip set, 8 fixed steps of 0.25 under velocity-gradient
    boundary conditions.  Average stress to 1e-8 rel."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(8, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.savetxt(tmp_path / "hcp_quats.ori", q)
    np.savetxt(tmp_path / "grains8.txt", np.arange(1, 9))
    np.savetxt(tmp_path / "props_hcp_mts.txt", cases.hcp_mtsdd_props())
    np.savetxt(tmp_path / "state_hcp_mts.txt", np.zeros(36))
    (tmp_path / "case.toml").write_text(HCP_TOML)
    ref, got = run_both(tmp_path / "case.toml", tmp_path, "hcp_stress.txt")
    assert got.shape == (8, 6) and np.isfinite(got).all()
    assert _rel(got, ref) < 1e-8
    # plasticity developed: well below the elastic line at the last step
    assert got[-1, 2] < 0.5 * 180.7 * 2e-3
