"""PyTorch port against the JAX package: the FCC power-law Voce material.

Kinetics (both precisions, including the exponent cap), the model
factory and the converter, the state layout, and the staggered point
solve + ``model_setup_cm`` in pure f64 (``mixed_precision=False`` on
both sides) and in the production mixed mode."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from exaconstit_tpu.config import options as J_OPT
from exaconstit_tpu.models import ecmech as J_EC
from exaconstit_tpu.models import evptn_cm as J_CM
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.models import ecmech as T_EC
from exaconstit_tpu_torch.models import evptn_cm as T_CM
from exaconstit_tpu_torch.models.convert import (arrays_from_model,
                                                 ecmech_from_reference,
                                                 state_from_reference)

VOCE_PROPS = np.array([
    8.920e-6, 0.003435984, 1.0e-10, 168.4, 121.4, 75.2, 44.0, 0.02, 1.0,
    400.0e-3, 17.0e-3, 122.4e-3, 0.0, 5.0e9, 17.0e-3, 0.0, -1.0307952])
# POWERVOCENL inserts the Voce exponent after gs0
VOCE_NL_PROPS = np.insert(VOCE_PROPS, 12, 1.7)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opts(mod, slip):
    opt = mod.ExaOptions()
    opt.mech_type = mod.MechType.EXACMECH
    opt.xtal_type = mod.XtalType.FCC
    opt.slip_type = getattr(mod.SlipType, slip)
    return opt


def models(slip="POWERVOCE", mixed=True):
    props = VOCE_PROPS if slip == "POWERVOCE" else VOCE_NL_PROPS
    jm = J_EC.build_model(_opts(J_OPT, slip), props)
    tm = T_EC.build_model(_opts(T_OPT, slip), props)
    if not mixed:
        jm = dataclasses.replace(jm, evptn=dataclasses.replace(
            jm.evptn, mixed_precision=False))
        tm = dataclasses.replace(tm, evptn=dataclasses.replace(
            tm.evptn, mixed_precision=False))
    return jm, tm


SCALARS = ("solver_tol", "fast_tol", "refine_iters", "solver_max_iter",
           "substep_cap", "max_substeps", "h_gd_blend", "mixed_precision")


def reference_arrays(jm):
    """The JAX model flattened into the converter's dict of arrays."""
    return arrays_from_model(jm)


def assert_same_model(a, b):
    ea, eb = a.evptn, b.evptn
    np.testing.assert_array_equal(ea.elast.C_dev, eb.elast.C_dev)
    np.testing.assert_array_equal(ea.slip.P, eb.slip.P)
    np.testing.assert_array_equal(ea.slip.Q, eb.slip.Q)
    assert ea.elast.bulk == eb.elast.bulk
    assert ea.kinetics == eb.kinetics
    assert ea.eos == eb.eos
    for k in SCALARS:
        assert getattr(ea, k) == getattr(eb, k), k
    assert (a.temp_k, a.nslip, a.n_h) == (b.temp_k, b.nslip, b.n_h)


@pytest.mark.parametrize("slip", ["POWERVOCE", "POWERVOCENL"])
def test_build_model_and_converter(slip):
    jm, tm = models(slip)
    # the factory builds the reference's production scheme: these are
    # the defaults of every knob (the other settings are held to the
    # reference in test_torch_point_variants*.py)
    ev = jm.evptn
    assert (ev.engine, ev.hardness_mode, ev.stagger_iters, ev.h_per_substep,
            ev.tangent_mode, ev.flow_theta, ev.h_gd_source, ev.rot_frame,
            ev.h_order) == ("cm", "staggered", 1, True, "lagged", 1.0,
                            "converged", "end", "after")
    assert (ev.kinetics.form, ev.kinetics.h_scheme) == ("sat_ratio",
                                                       "backward_euler")
    conv = ecmech_from_reference(reference_arrays(jm))
    assert_same_model(conv, tm)
    np.testing.assert_array_equal(tm.evptn.slip.P, ev.slip.P)
    assert tm.evptn.h_gd_blend == ev.h_gd_blend == 0.99608
    vgrad, s = point_inputs(tm, 8, 6)
    with torch.inference_mode():
        outs = [m.model_setup_cm(0.25, torch.tensor(vgrad), torch.tensor(s))
                for m in (conv, tm)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_state_layout_init_and_substeps():
    jm, tm = models()
    assert tm.qf_mapping == jm.qf_mapping
    assert tm.num_state == jm.num_state == 28
    rng = np.random.default_rng(0)
    q = rng.normal(size=(11, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_array_equal(tm.init_state(q), jm.init_state(q))
    for dt in (0.01, 0.1, 0.195, 0.25, 0.5, 0.99, 1.0, 3.0):
        assert tm.substep_counts(dt) == int(jm.substep_counts(dt)), dt


def test_state_from_reference():
    rng = np.random.default_rng(1)
    s = rng.normal(size=(27, 40))
    t = state_from_reference(s, device="cpu")
    assert t.dtype == torch.float64 and t.shape == (27, 40)
    np.testing.assert_array_equal(t.numpy(), s)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_voce_rates(dtype):
    """gdots and the closed-form slope across the exponent cap (|tau|/g up
    to 6: log-rate 90, past the f32 cap of 25 and the f64 cap of 80).
    f64 to 1e-13 relative; f32 to 2e-5 relative, the rounding of
    exp(50 log r) between two libm's (the exponent amplifies a 1-ulp log
    difference by up to 50 |log r|), with an absolute floor of 1e-30 for
    the subnormal rates XLA flushes to zero."""
    jm, tm = models()
    rng = np.random.default_rng(2)
    npdt = np.float64 if dtype == "f64" else np.float32
    g = rng.uniform(0.017, 0.03, size=(1, 64))
    taus = (g * rng.uniform(-6, 6, size=(12, 64))).astype(npdt)
    taus[0, 0] = 0.0
    g = g.astype(npdt)
    jk, tk = jm.evptn.kinetics, tm.evptn.kinetics
    rtol, atol = (1e-13, 0.0) if dtype == "f64" else (2e-5, 1e-30)
    gd_j, sl_j = jk.gdots_slope(jnp.asarray(taus.T), jnp.asarray(g.T), 300.)
    gd_t, sl_t = tk.gdots_slope(torch.tensor(taus), torch.tensor(g))
    assert gd_t.dtype == (torch.float64 if dtype == "f64" else torch.float32)
    np.testing.assert_allclose(gd_t.numpy(), np.asarray(gd_j).T, rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(sl_t.numpy(), np.asarray(sl_j).T, rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(
        tk.gdots(torch.tensor(taus), torch.tensor(g)).numpy(),
        np.asarray(jk.gdots(jnp.asarray(taus.T), jnp.asarray(g.T), 300.)).T,
        rtol=rtol, atol=atol)


@pytest.mark.parametrize("slip", ["POWERVOCE", "POWERVOCENL"])
def test_voce_hardness_update(slip):
    jm, tm = models(slip)
    jk, tk = jm.evptn.kinetics, tm.evptn.kinetics
    rng = np.random.default_rng(3)
    h = rng.uniform(0.017, 0.05, size=(1, 30))
    gd = rng.normal(size=(12, 30)) * 0.1
    dt = rng.uniform(0.01, 0.5, size=30)
    got = tk.update_h(torch.tensor(h), torch.tensor(gd), torch.tensor(dt))
    ref = jk.update_h(jnp.asarray(h.T), jnp.asarray(gd.T),
                      jnp.asarray(dt[:, None]), 300.)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).T, rtol=1e-13)
    deff = rng.uniform(1e-6, 1e-2, size=30)
    np.testing.assert_allclose(
        tk.operating_ratio(torch.tensor(deff)).numpy(),
        np.asarray(jk.operating_ratio(jnp.asarray(deff))), rtol=1e-14)


def point_inputs(tm, n, seed):
    """Velocity gradient (3, 3, n) and a state (nsv, n) part-way through
    loading: random orientations, elastic strain and hardness."""
    rng = np.random.default_rng(seed)
    vgrad = rng.normal(size=(3, 3, n)) * 1e-3
    vgrad[2, 2] += 1e-3
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = tm.init_state(q)
    s[:, tm.IND_ESTRAIN:tm.IND_ESTRAIN + 5] = rng.normal(size=(n, 5)) * 2e-4
    s[:, tm.IND_HARD] = 0.017 + rng.uniform(0, 0.01, size=n)
    return vgrad, s.T.copy()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def run_setup(jm, tm, dt, n=40, seed=4, warm=False):
    vgrad, s = point_inputs(tm, n, seed)
    kw_j, kw_t = {}, {}
    if warm:
        # a warm start from a nearby solution (the previous Newton
        # iteration's in the driver), compared per point with the default
        _, _, _, xw = jm.model_setup_cm(dt, jnp.asarray(vgrad * 0.97),
                                        jnp.asarray(s), with_solution=True)
        kw_j = dict(x_warm=xw, warm_ok=jnp.asarray(True))
        kw_t = dict(x_warm=torch.tensor(np.asarray(xw)), warm_ok=True)
    out_j = jm.model_setup_cm(dt, jnp.asarray(vgrad), jnp.asarray(s),
                              with_solution=True, **kw_j)
    with torch.inference_mode():
        out_t = tm.model_setup_cm(dt, torch.tensor(vgrad), torch.tensor(s),
                                  with_solution=True, **kw_t)
    return [np.asarray(a) for a in out_j], [a.numpy() for a in out_t]


@pytest.mark.parametrize("dt", [0.1, 0.25])
def test_staggered_solve_f64(dt):
    """Pure f64 on both sides: the dogleg converges to solver_tol 1e-10
    from the same start with the same steps, so the two solutions agree
    to ~1e-12; iteration counts are equal."""
    jm, tm = models(mixed=False)
    vgrad, s = point_inputs(tm, 40, 5)
    nsub = jm.substep_counts(dt)
    d = 0.5 * (vgrad + vgrad.transpose(1, 0, 2))
    d_vecd = np.einsum("kij,ijn->kn", T_CM.tn.BASIS_DEV, d)
    w = 0.5 * np.stack([vgrad[2, 1] - vgrad[1, 2], vgrad[0, 2] - vgrad[2, 0],
                        vgrad[1, 0] - vgrad[0, 1]])
    e, q, h = s[4:9], s[9:13], s[13:14]
    ref = J_CM.solve_staggered_cm_core(
        jm.evptn, dt, jnp.asarray(d_vecd), jnp.asarray(w), jnp.asarray(e),
        jnp.asarray(q), jnp.asarray(h), 300.0,
        jnp.full((40,), nsub, jnp.int32))
    got = T_CM.solve_staggered_cm_core(
        tm.evptn, dt, *[torch.tensor(a) for a in (d_vecd, w, e, q, h)],
        300.0, torch.full((40,), int(nsub), dtype=torch.int32))
    assert int(nsub) == int(dt / 0.1 + 1e-9)
    assert np.asarray(ref[4]).all() and got[4].all()
    for a, b in zip(got[:3], ref[:3]):
        assert _rel(a.numpy(), b) < 1e-10
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))


def test_model_setup_f64(dt=0.25):
    """Stress, state and the 6x6 lagged tangent, pure f64: 1e-10 rel."""
    jm, tm = models(mixed=False)
    (sj, stj, cj, xj), (st, stt, ct, xt) = run_setup(jm, tm, dt)
    assert _rel(st, sj) < 1e-10
    assert _rel(stt, stj) < 1e-10
    assert _rel(ct, cj) < 1e-10
    assert _rel(xt, xj) < 1e-10


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_model_setup_mixed(warm, dt=0.25):
    """Production mixed mode.  The f32 stages (XLA vs torch) differ in f32
    rounding, and the 3 f64 polish steps contract that to the f64
    solution: x to atol 5e-9 and hardness to rtol 1e-8 (the reference's
    own Pallas-vs-XLA bars).  Stress follows x (bar 1e-8 rel).  The lagged
    tangent is computed in f32 on both sides, so it agrees to f32
    rounding of an equilibrated 8x8 solve: 1e-4 rel."""
    jm, tm = models()
    (sj, stj, cj, xj), (st, stt, ct, xt) = run_setup(jm, tm, dt, warm=warm)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=5e-9)
    h = tm.IND_HARD
    np.testing.assert_allclose(stt[h], stj[h], rtol=1e-8)
    assert _rel(st, sj) < 1e-8
    assert _rel(ct, cj) < 1e-4
