"""The crystal model definition, the svec/vecd tangent maps and the
per-point engine.

Port of ``exaconstit_tpu.models.evptn``: the ``EvptnModel`` dataclass
with every setting of the reference, the constant svec <-> vecd maps the
tangent assembly uses, and the per-point engine (``engine="vmap"``, the
fully implicit ``hardness_mode="coupled"`` and the scheme knobs the
component-major engine does not cover), with ``batched_update`` choosing
between the engines as the reference's does.

The reference writes the per-point engine for one point and vmaps it.
Here each function takes the whole batch in the last axis (``x (8, N)``,
``h (nh, N)``, ``J (8, 8, N)``), and the trust-region loops are the
masked loops of ``solvers.dogleg``.  The rotation columns of the point
Jacobian and every partial the tangents need are in closed form (the
reference takes them by ``jax.jacfwd``), so the engine runs under
``torch.autograd.forward_ad`` too.  This engine launches no kernel: its
trust region is the plain ``dogleg_solve``, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..solvers.dogleg import dogleg_solve
from ..utils import tensors as tn
from ..utils.tensors import const
from . import evptn_cm as cm
from .elasticity import Elasticity
from .eos import EosConst
from .slip_geom import SlipGeom

_B = tn.BASIS_DEV
# M_SVEC_FROM_VECD[:, k] = svec components of basis tensor B_k
M_SVEC_FROM_VECD = np.stack(
    [[_B[k, 0, 0], _B[k, 1, 1], _B[k, 2, 2],
      _B[k, 1, 2], _B[k, 0, 2], _B[k, 0, 1]] for k in range(5)], axis=1)
# M_VECD_FROM_SVEC_ENG[k, :] maps an engineering-shear strain svec
# [e11, e22, e33, 2e23, 2e13, 2e12] to vecd(dev(eps))
M_VECD_FROM_SVEC_ENG = np.stack(
    [[_B[k, 0, 0], _B[k, 1, 1], _B[k, 2, 2],
      _B[k, 1, 2], _B[k, 0, 2], _B[k, 0, 1]] for k in range(5)], axis=0)

IDENT_VOL = np.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])


@dataclasses.dataclass(frozen=True)
class EvptnModel:
    """A crystal model = slip geometry + elasticity + kinetics + EOS, with
    the settings of the point solve.

    Production (the defaults, the component-major engine): one lagged
    pass per substep, solving (e, xi) against the substep's begin
    hardness and then updating the hardness from a blend of the
    converged and begin-of-substep slip rates (``h_gd_blend``; 1 takes
    the converged rates alone).  The substep count is uniform over
    points, ``floor(dt * rate_ref / substep_cap)`` clipped to
    [1, max_substeps].  Under ``mixed_precision`` the trust-region stage
    runs in f32 to ``fast_tol`` and ``refine_iters`` f64 Newton steps
    reusing the stage's final Jacobian polish it; without it the trust
    region runs in f64 to ``solver_tol``.

    The other knobs, as the reference defines them:

    * ``hardness_mode``: "staggered", or "coupled" (one dogleg over
      (e, xi, h), the fully implicit update, per-point engine);
    * ``stagger_iters``: (e, xi) | h passes per substep;
    * ``h_per_substep``: False freezes h at its step-begin value for
      every substep and updates it once over the full dt from the final
      slip rates;
    * ``flow_theta``: the plastic-flow weight of the strain update (1
      backward Euler, 0.5 trapezoidal; per-point engine);
    * ``h_gd_source``: the slip rates of the hardness update,
      "converged", "gd_begin" (the substep's begin state) or
      "h_forward" (converged rates, explicit update; per-point engine);
    * ``rot_frame``: the lattice frame of the applied rates, "end"
      (implicit, through q_end(xi)) or "begin" (per-point engine);
    * ``h_order``: "after" the solve, or "before" it from the begin-state
      rates (per-point engine);
    * ``engine``: "cm" (component-major, the CUDA stage) or "vmap" (the
      per-point engine); configurations the cm engine does not cover run
      on the per-point engine whatever this says;
    * ``tangent_mode``: "lagged" (the exact derivative of the staggered
      map) or "coupled" (the implicit-function tangent of the coupled
      (e, xi, h) system);
    * ``ift_tangents``: under forward-mode AD, attach the
      implicit-function tangent to the detached trust-region solutions
      and ``SplineG``'s hardness update by straight-through corrections
      (zero in value).  The reference reads it from the environment
      (``EXACONSTIT_IFT_TANGENTS=1``); here it is a field.

    The reference's Pallas switches (``use_pallas``,
    ``pallas_min_batch``) have no counterpart: the CUDA stage runs for
    every batch on the card."""

    slip: SlipGeom
    elast: Elasticity
    kinetics: object  # kinetics.VocePL, KMBalD or SplineG
    eos: EosConst
    solver_tol: float = 1e-10
    solver_max_iter: int = 200
    substep_cap: float = 0.1
    max_substeps: int = 8
    h_gd_blend: float = 1.0
    mixed_precision: bool = True
    fast_tol: float = 1e-6
    refine_iters: int = 3
    hardness_mode: str = "staggered"
    stagger_iters: int = 1
    h_per_substep: bool = True
    flow_theta: float = 1.0
    h_gd_source: str = "converged"
    rot_frame: str = "end"
    h_order: str = "after"
    engine: str = "cm"
    tangent_mode: str = "lagged"
    ift_tangents: bool = False

    def __post_init__(self):
        if self.h_gd_blend != 1.0 and (self.h_order == "before"
                                       or self.h_gd_source != "converged"):
            raise ValueError(
                "h_gd_blend only applies to the production hardness map "
                "(h_order='after', h_gd_source='converged'); with "
                f"h_order={self.h_order!r} h_gd_source="
                f"{self.h_gd_source!r} the blend would be silently "
                "ignored")

    @property
    def nslip(self):
        return self.slip.nslip

    @property
    def n_h(self):
        return self.kinetics.n_h

    @property
    def supports_cm(self):
        """True when the component-major engine covers these settings."""
        return (self.engine == "cm" and self.hardness_mode == "staggered"
                and self.flow_theta == 1.0
                and self.h_gd_source == "converged"
                and self.rot_frame == "end" and self.h_order == "after")


# ---------------------------------------------------------------------------
# kinematics with the exact rotation derivatives
# ---------------------------------------------------------------------------


def _expmap_jac_cm(xi):
    """d expmap_to_quat_cm / d xi, (4, 3, N), on the same two branches."""
    ang2 = xi[0] * xi[0] + xi[1] * xi[1] + xi[2] * xi[2]
    big = ang2 > 1e-24
    a2 = torch.where(big, ang2, 1.0)
    ang = torch.sqrt(a2)
    c = torch.cos(0.5 * ang)
    sinc = torch.where(big, torch.sin(0.5 * ang) / ang, 0.5 - ang2 / 48.0)
    dq0 = torch.where(big, -0.5 * sinc, -0.25)[None] * xi  # (3, N)
    coef = torch.where(big, (0.5 * c - sinc) / a2, -1.0 / 24.0)
    dqv = (sinc[None, None] * const(np.eye(3), xi)[:, :, None]
           + coef[None, None] * xi[:, None] * xi[None, :])  # (3, 3, N)
    return torch.cat([dq0[None], dqv], dim=0)


def _rmat_dir_cm(q, v):
    """Derivative of quat_to_rmat_cm at q (4, N) along v (4, ..., N)."""
    q0, q1, q2, q3 = (a[None] if v.ndim == 3 else a for a in q)
    v0, v1, v2, v3 = v
    dbar = 2.0 * (q0 * v0 - (q1 * v1 + q2 * v2 + q3 * v3))
    r = [[dbar + 4.0 * q1 * v1,
          2.0 * (q1 * v2 + v1 * q2 - q0 * v3 - v0 * q3),
          2.0 * (q1 * v3 + v1 * q3 + q0 * v2 + v0 * q2)],
         [2.0 * (q1 * v2 + v1 * q2 + q0 * v3 + v0 * q3),
          dbar + 4.0 * q2 * v2,
          2.0 * (q2 * v3 + v2 * q3 - q0 * v1 - v0 * q1)],
         [2.0 * (q1 * v3 + v1 * q3 - q0 * v2 - v0 * q2),
          2.0 * (q2 * v3 + v2 * q3 + q0 * v1 + v0 * q1),
          dbar + 4.0 * q3 * v3]]
    return torch.stack([torch.stack(row) for row in r])


def _rotation(q_n, xi):
    """(R (3, 3, N), dR/dxi (3, 3, 3, N)) of R(q_n exp(xi))."""
    q_end = cm.quat_multiply_cm(q_n, cm.expmap_to_quat_cm(xi))
    dq = cm.quat_multiply_cm(q_n[:, None], _expmap_jac_cm(xi))  # (4, 3, N)
    return cm.quat_to_rmat_cm(q_end), _rmat_dir_cm(q_end, dq)


def _kinematics(model, xi, d_vecd, w_vec, q_n, with_jac):
    """Lattice-frame rates (d_lat (5, N), w_lat (3, N)) in the frame
    ``model.rot_frame`` gives, and with ``with_jac`` their xi columns
    (5, 3, N), (3, 3, N) (zero in the begin frame)."""
    D = cm.vecd_to_mat_cm(d_vecd)
    if model.rot_frame == "begin":
        R, dR = cm.quat_to_rmat_cm(q_n), None
    elif with_jac:
        R, dR = _rotation(q_n, xi)
    else:
        R = cm.quat_to_rmat_cm(cm.quat_multiply_cm(
            q_n, cm.expmap_to_quat_cm(xi)))
        dR = None
    RT = R.transpose(0, 1)
    d_lat = cm.mat_to_vecd_cm(cm.mm_cm(RT, cm.mm_cm(D, R)))
    w_lat = cm.mv_cm(RT, w_vec)
    if not with_jac:
        return d_lat, w_lat
    if dR is None:
        return (d_lat, w_lat, d_lat.new_zeros(5, 3, d_lat.shape[1]),
                w_lat.new_zeros(3, 3, w_lat.shape[1]))
    DR = cm.mm_cm(D, R)
    dd, dw = [], []
    for k in range(3):
        A = cm.mm_cm(dR[:, :, k].transpose(0, 1), DR)  # dR^T D R
        dd.append(cm.mat_to_vecd_cm(A + A.transpose(0, 1)))
        dw.append(cm.mv_cm(dR[:, :, k].transpose(0, 1), w_vec))
    return d_lat, w_lat, torch.stack(dd, dim=1), torch.stack(dw, dim=1)


def _tables(model):
    P = np.asarray(model.slip.P)
    return P, np.asarray(model.slip.Q), P @ np.asarray(model.elast.C_dev)


# ---------------------------------------------------------------------------
# residual, Jacobian and slip rates
# ---------------------------------------------------------------------------


def _flow(model, gd, e_n, h, temp_k):
    """Slip rates weighted by flow_theta with the begin state's."""
    th = model.flow_theta
    if th == 1.0:
        return gd
    _, _, PC = _tables(model)
    gd_n = model.kinetics.gdots(cm.const_mm_cm(PC, e_n), h, temp_k)
    return th * gd + (1.0 - th) * gd_n


def _residual(model, x, h, dt, d_vecd, w_vec, e_n, q_n, temp_k):
    """The 8-dim backward-Euler residual (8, N)."""
    e_end, xi = x[:5], x[5:]
    d_lat, w_lat = _kinematics(model, xi, d_vecd, w_vec, q_n, False)
    P, Q, PC = _tables(model)
    gd = _flow(model, model.kinetics.gdots(cm.const_mm_cm(PC, e_end), h,
                                           temp_k), e_n, h, temp_k)
    dtb = cm._dt_rows(dt)
    return torch.cat([e_end - e_n + dtb * (cm.const_mm_cm(P.T, gd) - d_lat),
                      xi - dtb * (w_lat - cm.const_mm_cm(Q.T, gd))], dim=0)


def _residual_and_jac(model, x, h, dt, d_vecd, w_vec, e_n, q_n, temp_k):
    """Residual (8, N) and its 8x8 Jacobian (8, 8, N): the kinetics block
    from the closed-form slip-rate slope, the rotation columns exact."""
    e_end, xi = x[:5], x[5:]
    d_lat, w_lat, dd, dw = _kinematics(model, xi, d_vecd, w_vec, q_n, True)
    P, Q, PC = _tables(model)
    gd, slope = model.kinetics.gdots_slope(cm.const_mm_cm(PC, e_end), h,
                                           temp_k)
    gd = _flow(model, gd, e_n, h, temp_k)
    dtb = cm._dt_rows(dt)
    r = torch.cat([e_end - e_n + dtb * (cm.const_mm_cm(P.T, gd) - d_lat),
                   xi - dtb * (w_lat - cm.const_mm_cm(Q.T, gd))], dim=0)
    S = P.shape[0]
    kp = model.flow_theta * slope
    dt2 = dtb[None] if torch.is_tensor(dt) and dt.ndim == 1 else dt
    J_ee = const(np.eye(5), x)[:, :, None] + dt2 * cm.const_mm_cm(
        np.einsum("sk,sl->kls", P, PC).reshape(25, S), kp).reshape(5, 5, -1)
    J_xe = dt2 * cm.const_mm_cm(
        np.einsum("sk,sl->kls", Q, PC).reshape(15, S), kp).reshape(3, 5, -1)
    J = torch.cat([torch.cat([J_ee, -dt2 * dd], dim=1),
                   torch.cat([J_xe, const(np.eye(3), x)[:, :, None]
                              - dt2 * dw], dim=1)], dim=0)
    return r, J


def _gdots_of(model, x, h, temp_k):
    _, _, PC = _tables(model)
    return model.kinetics.gdots(cm.const_mm_cm(PC, x[:5]), h, temp_k)


def _coupled_resid_jac(model, z, h_n, dt, d_vecd, w_vec, e_n, q_n, temp_k):
    """Residual (8+nh, N) and Jacobian (8+nh, 8+nh, N) of the coupled
    (e, xi, h) system: the 8-dim residual at h, then the backward-Euler
    hardness residual at the slip rates of (x, h)."""
    x, h = z[:8], z[8:]
    r, J = _residual_and_jac(model, x, h, dt, d_vecd, w_vec, e_n, q_n,
                             temp_k)
    rh = model.kinetics.h_residual(h, h_n, _gdots_of(model, x, h, temp_k),
                                   dt, temp_k)
    J_xh, J_h = cm._h_blocks_cm(model, dt, x, h, h_n, e_n, temp_k)
    return (torch.cat([r, rh], dim=0),
            torch.cat([torch.cat([J, J_xh], dim=1), J_h], dim=0))


def _initial_guess(model, dt, d_vecd, e_n, q_n, h_n):
    """Yield-surface-aware predictor: the elastic trial strain scaled so
    that max_s |tau_s| / g sits at the kinetics' operating ratio."""
    R = cm.quat_to_rmat_cm(q_n)
    d_lat = cm.mat_to_vecd_cm(cm.rot_T_mat_rot_cm(
        R, cm.vecd_to_mat_cm(d_vecd)))
    e_trial = e_n + cm._dt_rows(dt) * d_lat
    _, _, PC = _tables(model)
    taus = cm.const_mm_cm(PC, e_trial)
    kin = model.kinetics
    g = kin.strength_floor(h_n) if hasattr(kin, "strength_floor") else h_n[0]
    ratio_trial = torch.amax(torch.abs(taus), dim=0) / g
    deff = tn.SQR2B3 * torch.sqrt(torch.sum(d_lat * d_lat, dim=0))
    scale = torch.clamp(kin.operating_ratio(deff)
                        / torch.clamp(ratio_trial, min=1e-30), max=1.0)
    return e_trial * scale[None]


def _pm(rj):
    """A component-major (r, J) function as dogleg_solve's point-major."""
    def f(x):
        r, J = rj(x.T)
        return r.T, J.permute(2, 0, 1)
    return f


# ---------------------------------------------------------------------------
# the point solves
# ---------------------------------------------------------------------------


def _solve_point_coupled(model, dt, d_vecd, w_vec, e_n, q_n, h_n, temp_k):
    """The fully implicit (e, xi, h) dogleg over the whole step (no
    substeps).  Returns (x, h_end, h_used, iters, converged)."""
    e0 = _initial_guess(model, dt, d_vecd, e_n, q_n, h_n)
    z0 = torch.cat([e0, torch.zeros_like(e0[:3]), h_n], dim=0)
    z, ok, iters, _ = dogleg_solve(
        _pm(lambda z: _coupled_resid_jac(model, z, h_n, dt, d_vecd, w_vec,
                                         e_n, q_n, temp_k)),
        z0.T, tol=model.solver_tol, max_iter=model.solver_max_iter)
    z = z.T
    return z[:8], z[8:], z[8:], iters, ok


def _solve_point_staggered(model, dt, d_vecd, w_vec, e_n, q_n, h_n, temp_k,
                           nsub):
    """The staggered (e, xi) | h solve with per-point substep counts
    ``nsub`` (N,), every knob of the reference's per-point engine.
    Returns (x, h_end, h_used, iters, converged)."""
    N = d_vecd.shape[1]
    dtype, dev = d_vecd.dtype, d_vecd.device
    f32 = torch.float32
    kin = model.kinetics
    max_sub = model.max_substeps if model.substep_cap > 0.0 else 1
    dt_sub = dt / nsub.to(dtype)
    use_mixed = model.mixed_precision and dtype == torch.float64
    ift = bool(model.ift_tangents)
    blend = float(model.h_gd_blend)

    def solve_exi(x0, h, e_c, q_c):
        if use_mixed:
            a32 = [a.to(f32) for a in (h, dt_sub, d_vecd, w_vec, e_c, q_c)]
            x32, ok, iters, _, J32 = dogleg_solve(
                _pm(lambda x: _residual_and_jac(model, x, *a32, temp_k)),
                x0.to(f32).T, tol=model.fast_tol,
                max_iter=model.solver_max_iter, return_jac=True)
            # quasi-Newton f64 polish reusing the stage's f32 Jacobian
            x = x32.T.to(dtype)
            for _ in range(model.refine_iters):
                r = _residual(model, x, h, dt_sub, d_vecd, w_vec, e_c, q_c,
                              temp_k)
                dx = cm.solve_dense_cm(J32.permute(1, 2, 0), r.to(f32))
                x = x - dx.to(dtype)
            return x, ok, iters
        x, ok, iters, _ = dogleg_solve(
            _pm(lambda x: _residual_and_jac(model, x, h, dt_sub, d_vecd,
                                            w_vec, e_c, q_c, temp_k)),
            x0.T, tol=model.solver_tol, max_iter=model.solver_max_iter)
        return x.T, ok, iters

    def h_update(h_c, gd):
        if model.h_gd_source == "h_forward":
            return kin.update_h_explicit(h_c, gd, dt_sub, temp_k)
        return kin.update_h(h_c, gd, dt_sub, temp_k, ift_tangents=ift)

    def one_substep(e_c, q_c, h_c):
        e0 = _initial_guess(model, dt_sub, d_vecd, e_c, q_c, h_c)
        zero3 = torch.zeros(3, N, dtype=dtype, device=dev)
        x0 = torch.cat([e0, zero3], dim=0)
        x_beg = torch.cat([e_c, zero3], dim=0)
        x, h, h_used = x0, h_c, h_c
        its = torch.zeros(N, dtype=torch.int32, device=dev)
        conv = torch.ones(N, dtype=torch.bool, device=dev)
        for _ in range(model.stagger_iters):
            if model.h_order == "before":
                # one-way predictor: advance h from the begin-of-substep
                # slip rates, then solve against it
                h = h_update(h_c, _gdots_of(model, x_beg, h, temp_k))
                h_used = h
                x, ok, iters = solve_exi(x0, h, e_c, q_c)
            else:
                h_used = h
                x, ok, iters = solve_exi(x0, h, e_c, q_c)
                if model.h_per_substep:
                    if model.h_gd_source == "gd_begin":
                        gd = _gdots_of(model, x_beg, h, temp_k)
                    else:
                        gd = _gdots_of(model, x, h, temp_k)
                        if blend != 1.0:
                            gd = (blend * gd + (1.0 - blend)
                                  * _gdots_of(model, x_beg, h, temp_k))
                    h = h_update(h_c, gd)
            its, conv = its + iters, conv & ok
        q_new = cm.quat_multiply_cm(q_c, cm.expmap_to_quat_cm(x[5:]))
        q_new = q_new / torch.sqrt(torch.sum(q_new * q_new, dim=0))[None]
        return x[:5], q_new, h, h_used, its, conv

    e, q, h, h_used = e_n, q_n, h_n, h_n
    its = torch.zeros(N, dtype=torch.int32, device=dev)
    conv = torch.ones(N, dtype=torch.bool, device=dev)
    for i in range(min(int(nsub.max()), max_sub)):
        # every lane is evaluated, a lane past its count keeps its state
        # (the reference's vmapped while_loop does the same)
        active = i < nsub
        e2, q2, h2, hu2, it2, c2 = one_substep(e, q, h)
        am = active[None]
        e = torch.where(am, e2, e)
        q = torch.where(am, q2, q)
        h = torch.where(am, h2, h)
        h_used = torch.where(am, hu2, h_used)
        its = its + torch.where(active, it2, 0)
        conv = torch.where(active, conv & c2, conv)
    x = torch.cat([e, cm.quat_to_expmap_cm(cm.quat_multiply_cm(
        cm.quat_conjugate_cm(q_n), q))], dim=0)
    if not model.h_per_substep:
        # one full-dt hardness update from the final slip rates
        h = kin.update_h(h_n, _gdots_of(model, x, h_n, temp_k), dt, temp_k,
                         ift_tangents=ift)
        h_used = h_n
    return x, h, h_used, its, conv


def _solve_point(model, dt, d_vecd, w_vec, e_n, q_n, h_n, temp_k, nsub):
    """(x, h_end, h_used, iters, converged); h_used is the hardness the
    (e, xi) system was solved against (h_end in the coupled mode)."""
    if model.hardness_mode == "coupled":
        return _solve_point_coupled(model, dt, d_vecd, w_vec, e_n, q_n, h_n,
                                    temp_k)
    return _solve_point_staggered(model, dt, d_vecd, w_vec, e_n, q_n, h_n,
                                  temp_k, nsub)


# ---------------------------------------------------------------------------
# outputs and tangents
# ---------------------------------------------------------------------------


def _outputs_from_solution(model, dt, d_vecd, w_vec, v0, v1, e_int_n, e_n,
                           q_n, h_n, temp_k, x, h_end, h_used, iters, ok,
                           compute_tangent):
    """Stress, state and diagnostics from the converged solution (those
    of ``evptn_cm.outputs_from_solution_cm``, which also guards the
    square roots of the effective rates where the reference's per-point
    outputs take plain ones: the same values, and a zero tangent where
    the rate is 0), with the tangent the settings call for."""
    out = cm.outputs_from_solution_cm(model, dt, d_vecd, w_vec, v0, v1,
                                      e_int_n, e_n, q_n, h_n, temp_k, x,
                                      h_end, h_used, iters, ok, False)
    if not compute_tangent:
        return out
    if model.tangent_mode == "lagged" and model.hardness_mode != "coupled":
        out["tangent"] = _frozen_h_tangent(model, x, h_used, dt, d_vecd,
                                           w_vec, e_n, q_n, v1, temp_k)
    else:
        out["tangent"] = _consistent_tangent(model, x, h_end, h_n, dt,
                                             d_vecd, w_vec, e_n, q_n, v1,
                                             temp_k)
    return out


def _tangent_from(model, J, x, dt, d_vecd, q_n, v1, nh):
    """The 6x6 tangent (6, 6, N) from the Jacobian J (8+nh, 8+nh, N) of
    the system at the solution x: the implicit-function theorem with
    d r / d d = [-dt Q5(R_frame^T); 0] and the exact stress
    sensitivity of sigma = Q5(R) (C e) / v1, R = R(q_n exp(xi))."""
    N = x.shape[1]
    C = np.asarray(model.elast.C_dev)
    if model.rot_frame == "begin":
        R_f = cm.quat_to_rmat_cm(q_n)
    else:
        R_f = cm.quat_to_rmat_cm(cm.quat_multiply_cm(
            q_n, cm.expmap_to_quat_cm(x[5:])))
    dR_dd = torch.cat([-dt * cm._vecd_rot5_cm(R_f.transpose(0, 1)),
                       x.new_zeros(3 + nh, 5, N)], dim=0)
    dx_dd = -cm.solve_dense_cm(J, dR_dd)  # (8 + nh, 5, N)

    R, dR = _rotation(q_n, x[5:])
    S = cm.vecd_to_mat_cm(cm.const_mm_cm(C, x[:5]))
    SRT = cm.mm_cm(S, R.transpose(0, 1))
    ds_dxi = []
    for k in range(3):
        A = cm.mm_cm(dR[:, :, k], SRT)  # dR S R^T
        ds_dxi.append(cm.mat_to_vecd_cm(A + A.transpose(0, 1)))
    ds_dz = torch.cat([cm.const_mm_r_cm(cm._vecd_rot5_cm(R), C),
                       torch.stack(ds_dxi, dim=1),
                       x.new_zeros(5, nh, N)], dim=1) / v1[None, None]
    ds_dd = cm.mm_cm(ds_dz, dx_dd)
    c_dev = cm.const_mm_cm(M_SVEC_FROM_VECD, cm.const_mm_r_cm(
        ds_dd / dt, M_VECD_FROM_SVEC_ENG))
    m6 = const(IDENT_VOL, x)
    k_eff = model.eos.dpressure_dvolstrain(v1)
    return c_dev + k_eff[None, None] * (m6[:, None, None] * m6[None, :, None])


def _frozen_h_tangent(model, x_sol, h, dt, d_vecd, w_vec, e_n, q_n, v1,
                      temp_k):
    """6x6 consistent tangent with the hardness frozen: exact for the
    staggered (lagged-h) update map."""
    _, J = _residual_and_jac(model, x_sol, h, dt, d_vecd, w_vec, e_n, q_n,
                             temp_k)
    return _tangent_from(model, J, x_sol, dt, d_vecd, q_n, v1, 0)


def _consistent_tangent(model, x_sol, h_sol, h_n, dt, d_vecd, w_vec, e_n,
                        q_n, v1, temp_k):
    """6x6 tangent by the implicit-function theorem on the coupled
    (e, xi, h) system at the converged solution."""
    _, J = _coupled_resid_jac(model, torch.cat([x_sol, h_sol], dim=0), h_n,
                              dt, d_vecd, w_vec, e_n, q_n, temp_k)
    return _tangent_from(model, J, x_sol, dt, d_vecd, q_n, v1,
                         h_sol.shape[0])


def point_update(model, dt, d_vecd, w_vec, v0, v1, e_int_n, e_n, q_n, h_n,
                 temp_k, compute_tangent=True, nsub=None):
    """The per-point engine's full update over a batch, component-major
    (c, N) inputs; returns the dict of ``_outputs_from_solution``."""
    if nsub is None:
        nsub = 1
    nsub = torch.as_tensor(nsub, dtype=torch.int32,
                           device=d_vecd.device).expand(d_vecd.shape[1])
    x, h_end, h_used, iters, ok = _solve_point(
        model, dt, d_vecd, w_vec, e_n, q_n, h_n, temp_k, nsub)
    return _outputs_from_solution(model, dt, d_vecd, w_vec, v0, v1, e_int_n,
                                  e_n, q_n, h_n, temp_k, x, h_end, h_used,
                                  iters, ok, compute_tangent)


def batched_update(model, dt, d_vecd_sm, w_vec_sm, v0, v1, e_int_n, e_n,
                   q_n, h_n, temp_k, compute_tangent=True, nsub=None,
                   x_warm=None, warm_ok=None):
    """The constitutive update of a flat batch of points, point-major
    (N, c) inputs and outputs, on the engine the settings call for.

    On the component-major engine (``model.supports_cm``) the solve is
    ``evptn_cm.solve_staggered_cm_core`` (with the warm start ``x_warm``
    (N, 8), compared per point unless ``warm_ok`` is False), the outputs
    those of the per-point engine and the tangent ``tangent_cm_core``,
    and the solution rides back as ``out["x_sol"]``.  Every other
    configuration runs on the per-point engine, which ignores the warm
    start."""
    T = [a.T for a in (d_vecd_sm, w_vec_sm, e_n, q_n, h_n)]
    if nsub is None:
        nsub = 1
    nsub = torch.as_tensor(nsub, dtype=torch.int32,
                           device=d_vecd_sm.device).expand(v1.shape[0])
    if model.supports_cm:
        x, h_end, h_used, iters, ok = cm.solve_staggered_cm_core(
            model, dt, *T, temp_k, nsub,
            x_warm=None if x_warm is None else x_warm.T,
            warm_ok=True if warm_ok is None else bool(warm_ok))
        out = _outputs_from_solution(model, dt, T[0], T[1], v0, v1, e_int_n,
                                     T[2], T[3], T[4], temp_k, x, h_end,
                                     h_used, iters, ok, False)
        if compute_tangent:
            out["tangent"] = cm.tangent_cm_core(
                model, dt, T[0], T[1], T[2], T[3], T[4], x, h_end, v1,
                temp_k, h_used_cm=h_used)
        out["x_sol"] = x
    else:
        out = point_update(model, dt, T[0], T[1], v0, v1, e_int_n, *T[2:],
                           temp_k, compute_tangent=compute_tangent,
                           nsub=nsub)
    return {k: v.permute(*range(v.ndim - 1, -1, -1)) if v.ndim < 3
            else v.permute(2, 0, 1) for k, v in out.items()}
