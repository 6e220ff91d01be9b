"""PyTorch port against the JAX package: forward-mode parameter
sensitivities of the point update.

Kinetics parameters as dual 0-d tensors of ``torch.autograd.forward_ad``
(``dataclasses.replace(kin, h0=dual)``) through ``ECMechModel.model_setup``
over three steps, against ``jax.jvp`` of the reference's: the Voce model
in mixed precision (the f32 stage detached, the f64 polish carrying the
implicit-function tangent), the MTSDD models in pure f64 with
``ift_tangents`` off (the trust region and ``SplineG``'s hardness Newton
detached) and on (straight-through corrections; the reference's
``EXACONSTIT_IFT_TANGENTS=1``).  And the value path with dual inputs
equal to the one without, the stage's detachment, and the zero tangents
at the guarded points of the NaN-safe helpers."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

from exaconstit_tpu.models import evptn_cm as J_CM
from exaconstit_tpu.utils import tensors as J_TN
from exaconstit_tpu_torch.models import evptn_cm as T_CM
from exaconstit_tpu_torch.solvers import dogleg_cuda

from test_torch_point_variants import models, point_inputs

DT, STEPS = 0.1, 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _with(model, kin, **knobs):
    return dataclasses.replace(model, evptn=dataclasses.replace(
        model.evptn, kinetics=kin, **knobs))


def _split(kin, fields, theta):
    """kinetics with ``fields`` read off the flat parameter vector theta
    (a field of k entries takes k)."""
    upd, i = {}, 0
    for f in fields:
        k = np.size(getattr(kin, f))
        upd[f] = theta[i] if np.ndim(getattr(kin, f)) == 0 else \
            theta[i:i + k]
        i += k
    return dataclasses.replace(kin, **upd)


def _theta0(kin, fields):
    return np.concatenate([np.atleast_1d(np.asarray(getattr(kin, f),
                                                    float))
                           for f in fields])


def jax_jvps(jm, fields, L, s, directions, ift, monkeypatch):
    """(stress (STEPS, N, 6), end state, their tangents per direction)
    of the reference's STEPS-step curve, one jitted jvp of one step
    reused for every step and direction; the IFT switch is read while
    tracing, so each setting gets its own jitted function."""
    monkeypatch.setenv("EXACONSTIT_IFT_TANGENTS", "1" if ift else "0")
    kin0 = jm.evptn.kinetics

    def step(theta, st):
        m = _with(jm, _split(kin0, fields, theta))
        stress, st, _ = m.model_setup(DT, jnp.asarray(L), st)
        return stress, st

    f = jax.jit(lambda th, st, dth, dst: jax.jvp(step, (th, st),
                                                 (dth, dst)))
    th = jnp.asarray(_theta0(kin0, fields))
    tans = []
    for d in directions:
        st, dst, ys, dys = jnp.asarray(s), jnp.zeros(s.shape), [], []
        for _ in range(STEPS):
            (y, st), (dy, dst) = f(th, st, jnp.asarray(d), dst)
            ys.append(y)
            dys.append(dy)
        tans.append((np.asarray(jnp.stack(dys)), np.asarray(dst)))
    return np.asarray(jnp.stack(ys)), np.asarray(st), tans


def port_curve(tm, fields, L, s, theta, inference=False):
    """The port's STEPS-step curve at kinetics ``theta`` (floats, or dual
    tensors inside a ``fwAD.dual_level``)."""
    m = _with(tm, _split(tm.evptn.kinetics, fields, theta))
    st, out = torch.tensor(s), []
    ctx = torch.inference_mode() if inference else torch.enable_grad()
    with ctx:
        for _ in range(STEPS):
            stress, st, _ = m.model_setup(DT, torch.tensor(L), st)
            out.append(stress)
    return torch.stack(out), st


def port_jvp(tm, fields, L, s, direction, **knobs):
    tm = _with(tm, tm.evptn.kinetics, **knobs)
    theta0 = _theta0(tm.evptn.kinetics, fields)
    with fwAD.dual_level():
        th = fwAD.make_dual(torch.tensor(theta0), torch.tensor(direction))
        y, st = port_curve(tm, fields, L, s, th)
        out = []
        for t in (y, st):
            u = fwAD.unpack_dual(t)
            out.append((u.primal.clone(),
                        torch.zeros_like(u.primal) if u.tangent is None
                        else u.tangent.clone()))
    return out


# ---------------------------------------------------------------------------
# Voce, mixed precision
# ---------------------------------------------------------------------------


VOCE_FIELDS = ("h0", "gs0", "g0")


def test_voce_mixed_jvp(monkeypatch):
    """Tangents of stress and end state in h0, gs0 and g0 against
    jax.jvp (1e-9 of the largest tangent; measured about 1e-12: both
    detach the f32 stage, so the tangent is the f64 polish's), and the
    values equal bitwise to the port's run without dual inputs."""
    jm, tm = models("voce")
    L, s = point_inputs(jm)
    dirs = list(np.eye(len(VOCE_FIELDS)))
    y_j, st_j, tans_j = jax_jvps(jm, VOCE_FIELDS, L, s, dirs, False,
                                 monkeypatch)
    y0, st0 = port_curve(tm, VOCE_FIELDS, L, s,
                         _theta0(tm.evptn.kinetics, VOCE_FIELDS).tolist(),
                         inference=True)
    assert _rel(y0.numpy(), y_j) < 1e-9
    for d, (dy_j, ds_j) in zip(dirs, tans_j):
        (y, dy), (st, ds) = port_jvp(tm, VOCE_FIELDS, L, s, d)
        assert torch.equal(y, y0) and torch.equal(st, st0)
        assert np.abs(dy_j).max() > 0.0
        assert _rel(dy.numpy(), dy_j) < 1e-9
        assert _rel(ds.numpy(), ds_j) < 1e-9


@pytest.mark.parametrize("family", ["voce", "splineg"])
def test_model_setup_cm_jvp_matches_model_setup(family):
    """The component-major entry point under forward-mode AD: its
    stress, end state and their tangents (in xm, or c1 with
    ift_tangents) are those of ``model_setup`` on the same points, and
    its values those of the call without duals."""
    _, tm = models(family)
    field = "xm" if family == "voce" else "c1"
    tm = _with(tm, tm.evptn.kinetics, ift_tangents=family == "splineg")
    L, s = point_inputs(tm)
    val = float(getattr(tm.evptn.kinetics, field))
    with torch.inference_mode():
        y0, st0, _ = tm.model_setup_cm(
            DT, torch.tensor(L).permute(1, 2, 0), torch.tensor(s.T))
    with fwAD.dual_level():
        p = fwAD.make_dual(torch.tensor(val, dtype=torch.float64),
                           torch.tensor(1.0, dtype=torch.float64))
        m = _with(tm, dataclasses.replace(tm.evptn.kinetics, **{field: p}))
        outs = [m.model_setup_cm(DT, torch.tensor(L).permute(1, 2, 0),
                                 torch.tensor(s.T))[:2],
                [a.T for a in m.model_setup(DT, torch.tensor(L),
                                            torch.tensor(s))[:2]]]
        (y_c, st_c), (y_p, st_p) = [[fwAD.unpack_dual(a) for a in o]
                                    for o in outs]
    assert torch.equal(y_c.primal, y0) and torch.equal(st_c.primal, st0)
    for a, b in ((y_c, y_p), (st_c, st_p)):
        assert _rel(a.primal.numpy(), b.primal.numpy()) < 1e-12
        assert np.abs(b.tangent.numpy()).max() > 0.0
        assert _rel(a.tangent.numpy(), b.tangent.numpy()) < 1e-10


def test_voce_jvp_in_xm_against_central_difference():
    """The rate sensitivity xm: the reference cannot take this jvp in
    mixed precision (an f64 tangent of xm promotes its f32 stage's
    while_loop carry, a TypeError), so the port's tangent is held to a
    central difference of its own curve (h = 1e-6 xm): 1e-5 of the
    largest tangent."""
    jm, tm = models("voce")
    L, s = point_inputs(jm)
    (_, dy), (_, ds) = port_jvp(tm, ("xm",), L, s, np.ones(1))
    xm = tm.evptn.kinetics.xm
    h = 1e-6 * xm
    yp, sp = port_curve(tm, ("xm",), L, s, [xm + h], inference=True)
    ym, sm = port_curve(tm, ("xm",), L, s, [xm - h], inference=True)
    fd_y = (yp - ym).numpy() / (2 * h)
    assert np.abs(fd_y).max() > 0.0
    assert _rel(dy.numpy(), fd_y) < 1e-5
    it = tm.IND_NFEVAL
    fd_s = np.delete((sp - sm).numpy() / (2 * h), it, 1)
    assert _rel(np.delete(ds.numpy(), it, 1), fd_s) < 1e-5


# ---------------------------------------------------------------------------
# MTSDD, pure f64, with and without the implicit-function tangents
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ift", [False, True], ids=["detached", "ift"])
def test_splineg_model_setup_jvp(ift, monkeypatch):
    """The FCC MTSDD model (SplineG's hardening map): tangents in c1 and
    in every knot value of the map (log_f) against jax.jvp over three
    steps, 1e-9 of the largest tangent (measured about 1e-12).  Detached
    (the reference's production), the map's tangents are zero: the
    trust region and SplineG.update_h's Newton iteration are cut; so the
    port's update_h must detach its 30 Newton steps, or its tangent
    differs.  With ift_tangents the straight-through corrections carry
    the implicit-function tangent; the values stay bitwise those of the
    run without duals."""
    jm, tm = models("splineg")
    fields = ("c1", "log_f")
    kin = tm.evptn.kinetics
    L, s = point_inputs(jm)
    n = len(_theta0(kin, fields))
    dirs = [np.eye(n)[0], np.eye(n)[2], np.eye(n)[5]]
    y_j, st_j, tans_j = jax_jvps(jm, fields, L, s, dirs, ift, monkeypatch)
    y0, st0 = port_curve(tm, fields, L, s, _theta0(kin, fields),
                         inference=True)
    assert _rel(y0.numpy(), y_j) < 1e-9
    for d, (dy_j, ds_j) in zip(dirs, tans_j):
        (y, dy), (st, ds) = port_jvp(tm, fields, L, s, d, ift_tangents=ift)
        assert torch.equal(y, y0) and torch.equal(st, st0)
        scale = max(np.abs(dy_j).max(), np.abs(ds_j).max(), 1e-300)
        assert np.abs(dy.numpy() - dy_j).max() <= 1e-9 * scale
        assert np.abs(ds.numpy() - ds_j).max() <= 1e-9 * scale
        # detached, stress has no tangent (the solution carries none)
        assert (np.abs(dy_j).max() > 0.0) == ift


def test_kmbald_model_setup_jvp(monkeypatch, ift=True):
    """The BCC MTSDD model (KMBalD) with ift_tangents: tangents in k1 and
    k2_0 against jax.jvp, 1e-8 of the largest tangent (the density update
    is differentiated through its 20 Newton steps on both sides).  The
    effective shear rate slots are left out: the reference's per-point
    outputs take the plain square root of the plastic rate there, whose
    tangent is NaN at the elastic points (the port's guarded one gives
    0)."""
    jm, tm = models("kmbald")
    fields = ("k1", "k2_0")
    L, s = point_inputs(jm)
    dirs = list(np.eye(2))
    _, _, tans_j = jax_jvps(jm, fields, L, s, dirs, ift, monkeypatch)
    keep = np.arange(2, tm.num_state)
    for d, (dy_j, ds_j) in zip(dirs, tans_j):
        (_, dy), (_, ds) = port_jvp(tm, fields, L, s, d, ift_tangents=ift)
        ds_j = ds_j[:, keep]
        scale = max(np.abs(dy_j).max(), np.abs(ds_j).max(), 1e-300)
        assert np.isfinite(dy.numpy()).all() and np.isfinite(ds.numpy()).all()
        assert np.abs(dy.numpy() - dy_j).max() <= 1e-8 * scale
        assert np.abs(ds.numpy()[:, keep] - ds_j).max() <= 1e-8 * scale


def test_per_point_engine_jvp(monkeypatch):
    """The per-point engine (Voce, fully coupled hardness, f64): its
    masked trust region is differentiated through, as the reference's
    vmapped while_loop is; tangents in h0 and gs0 to 1e-8 of the largest
    tangent."""
    jm, tm = models("voce", hardness_mode="coupled")
    fields = ("h0", "gs0")
    L, s = point_inputs(jm)
    dirs = list(np.eye(2))
    _, _, tans_j = jax_jvps(jm, fields, L, s, dirs, False, monkeypatch)
    for d, (dy_j, ds_j) in zip(dirs, tans_j):
        (_, dy), (_, ds) = port_jvp(tm, fields, L, s, d)
        scale = np.abs(dy_j).max()
        assert scale > 0.0
        assert np.abs(dy.numpy() - dy_j).max() <= 1e-8 * scale


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ift", [False, True], ids=["detached", "ift"])
def test_splineg_update_h_jvp(ift, monkeypatch):
    """SplineG.update_h alone: tangents in the begin strength, the slip
    rates and a knot value of the map against jax.jvp (1e-10 rel): zero
    when detached, the clamped-denominator straight-through tangent with
    ift_tangents."""
    jm, tm = models("splineg")
    jk, tk = jm.evptn.kinetics, tm.evptn.kinetics
    rng = np.random.default_rng(3)
    n = 10
    h = 0.012 + 0.015 * rng.uniform(size=(1, n))
    gd = rng.normal(size=(12, n)) * 10.0 ** rng.uniform(-6, -2,
                                                        size=(1, n))
    th = rng.normal(size=(1, n))
    lf = np.asarray(jk.log_f, float)
    dlf = np.eye(len(lf))[3]
    monkeypatch.setenv("EXACONSTIT_IFT_TANGENTS", "1" if ift else "0")

    def ref(hh, gg, ff):
        k = dataclasses.replace(jk, log_f=ff)
        return k.update_h(hh, gg, 0.05, 298.0)

    g_j, dg_j = jax.jvp(ref, (jnp.asarray(h.T), jnp.asarray(gd.T),
                              jnp.asarray(lf)),
                        (jnp.asarray(th.T), jnp.asarray(gd.T),
                         jnp.asarray(dlf)))
    with fwAD.dual_level():
        k = dataclasses.replace(tk, log_f=fwAD.make_dual(
            torch.tensor(lf), torch.tensor(dlf)))
        g = k.update_h(fwAD.make_dual(torch.tensor(h), torch.tensor(th)),
                       fwAD.make_dual(torch.tensor(gd), torch.tensor(gd)),
                       0.05, 298.0, ift_tangents=ift)
        u = fwAD.unpack_dual(g)
        primal = u.primal.numpy()
        tangent = (np.zeros_like(primal) if u.tangent is None
                   else u.tangent.numpy())
    np.testing.assert_array_equal(
        primal, tk.update_h(torch.tensor(h), torch.tensor(gd), 0.05,
                            298.0).numpy())
    assert _rel(primal, np.asarray(g_j).T) < 1e-13
    dg_j = np.asarray(dg_j).T
    if ift:
        assert np.abs(dg_j).max() > 0.0
        assert _rel(tangent, dg_j) < 1e-10
    else:
        assert not np.abs(dg_j).any() and not np.abs(tangent).any()


def test_stage_is_detached():
    """The f32 stage (here its plain version, the CPU's path) gives
    outputs without a forward-mode tangent or a gradient, computed from
    the primal inputs and a primal model: equal to the call without
    duals."""
    jm, tm = models("voce")
    ev = tm.evptn
    rng = np.random.default_rng(5)
    N = 8
    f32 = torch.float32
    d = torch.tensor(rng.normal(size=(5, N)) * 1e-3, dtype=f32)
    w = torch.tensor(rng.normal(size=(3, N)) * 1e-4, dtype=f32)
    e = torch.tensor(rng.normal(size=(5, N)) * 1e-4, dtype=f32)
    q = rng.normal(size=(4, N))
    q = torch.tensor(q / np.linalg.norm(q, axis=0), dtype=f32)
    h = torch.full((1, N), 0.02, dtype=f32)
    dts = torch.full((N,), 0.1, dtype=f32)
    x0 = torch.zeros(8, N, dtype=f32)
    x0[:5] = e
    active = torch.ones(N, dtype=torch.bool)
    args = (x0, h, dts, d, w, e, q, active, 1e-6, 200)
    want = dogleg_cuda.dogleg_stage(ev, *args)
    with fwAD.dual_level():
        kin = dataclasses.replace(ev.kinetics, xm=fwAD.make_dual(
            torch.tensor(ev.kinetics.xm, dtype=torch.float64),
            torch.tensor(1.0, dtype=torch.float64)))
        dual_h = fwAD.make_dual(h, torch.ones_like(h))
        got = dogleg_cuda.dogleg_stage(
            dataclasses.replace(ev, kinetics=kin), x0, dual_h, *args[2:])
        for a in (got[0], got[4]):
            assert fwAD.unpack_dual(a).tangent is None
        got = [fwAD.unpack_dual(a).primal if a is not None else None
               for a in got]
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    hg = h.clone().requires_grad_(True)
    out = dogleg_cuda.dogleg_stage(ev, x0, hg, *args[2:])
    assert not out[0].requires_grad and not out[4].requires_grad


def test_guarded_points_have_zero_tangents():
    """The NaN-safe helpers give the reference's finite tangents where
    they guard: the square root at 0 (``_safe_sqrt``, the reference's
    ``_sqrt_ad_safe``: tangent 0), the exponential map at xi = 0 and the
    log map at the identity (the double-where branches)."""
    s = np.array([0.0, 0.0, 2.5e-3, 4.0])
    ts = np.array([1.0, -2.0, 3.0, 0.5])
    _, want = jax.jvp(J_CM._sqrt_ad_safe, (jnp.asarray(s),),
                      (jnp.asarray(ts),))
    xi = np.array([[0.0, 1e-14, 0.3], [0.0, -2e-13, 0.1], [0.0, 0.0, -0.2]])
    txi = np.array([[1.0, 0.5, 0.2], [-1.0, 2.0, 0.1], [0.5, 1.0, 0.3]])
    _, want_q = jax.jvp(lambda a: J_TN.expmap_to_quat(a.T).T,
                        (jnp.asarray(xi),), (jnp.asarray(txi),))
    q = np.array([[1.0, 1.0, 0.9], [0.0, 1e-15, 0.3], [0.0, 0.0, 0.2],
                  [0.0, 0.0, -0.1]])
    tq = np.array([[0.1, 0.2, 0.3], [1.0, -1.0, 0.5], [0.5, 0.3, 0.2],
                   [-0.2, 0.4, 0.1]])
    _, want_x = jax.jvp(lambda a: J_TN.quat_to_expmap(a.T).T,
                        (jnp.asarray(q),), (jnp.asarray(tq),))
    with fwAD.dual_level():
        def tangent(fn, a, t):
            out = fwAD.unpack_dual(fn(fwAD.make_dual(
                torch.tensor(a), torch.tensor(t))))
            return out.primal.numpy(), out.tangent.numpy()

        v, got = tangent(T_CM._safe_sqrt, s, ts)
        _, got_q = tangent(T_CM.expmap_to_quat_cm, xi, txi)
        _, got_x = tangent(T_CM.quat_to_expmap_cm, q, tq)
    assert np.isfinite(got).all() and got[0] == got[1] == 0.0
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-14)
    assert float(T_CM._safe_sqrt(torch.tensor(np.nan))) == 0.0
    np.testing.assert_allclose(got_q, np.asarray(want_q), rtol=1e-12,
                               atol=1e-15)
    assert np.isfinite(got_x).all()
    np.testing.assert_allclose(got_x, np.asarray(want_x), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.cuda
def test_kernel_stage_and_jvp_on_the_card(monkeypatch):
    """On the card the stage is the CUDA kernel, inside the same
    ``DetachedStage``: a mixed-precision Voce JVP there launches it once
    per step, gives the values of the run without duals, and its
    tangents equal the CPU's to 1e-6 of the largest (the kernel's and the
    plain stage's f32 Jacobians differ in rounding, and the f64 polish
    leaves that much in the tangent)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _, tm = models("voce")
    L, s = point_inputs(tm)
    d = np.eye(len(VOCE_FIELDS))[0]
    (y_c, dy_c), _ = port_jvp(tm, VOCE_FIELDS, L, s, d)
    before = dogleg_cuda.KERNEL.launches
    theta0 = _theta0(tm.evptn.kinetics, VOCE_FIELDS)
    with fwAD.dual_level():
        th = fwAD.make_dual(torch.tensor(theta0, device="cuda"),
                            torch.tensor(d, device="cuda"))
        m = _with(tm, _split(tm.evptn.kinetics, VOCE_FIELDS, th))
        st, out = torch.tensor(s, device="cuda"), []
        for _ in range(STEPS):
            stress, st, _ = m.model_setup(DT, torch.tensor(L, device="cuda"),
                                          st)
            out.append(stress)
        u = fwAD.unpack_dual(torch.stack(out))
        y_g, dy_g = u.primal.cpu(), u.tangent.cpu()
    assert dogleg_cuda.KERNEL.launches == before + STEPS
    with torch.inference_mode():
        st, out = torch.tensor(s, device="cuda"), []
        for _ in range(STEPS):
            stress, st, _ = tm.model_setup(DT, torch.tensor(L, device="cuda"),
                                           st)
            out.append(stress)
    assert torch.equal(torch.stack(out).cpu(), y_g)
    assert _rel(y_g.numpy(), y_c.numpy()) < 1e-8
    assert _rel(dy_g.numpy(), dy_c.numpy()) < 1e-6
