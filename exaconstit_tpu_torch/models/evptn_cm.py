"""Component-major batched crystal-plasticity point solve.

Port of the production path of ``exaconstit_tpu.models.evptn_cm``.  The
point batch is the LAST axis everywhere (``e (5, N)``, ``J (8, 8, N)``,
``taus (S, N)``), as in the reference, so the two packages compare like
with like.  Constant-matrix contractions are single matmuls against the
batch; per-point small products are broadcast multiply-and-sum.

The mixed-precision stage (f32 trust region to ``fast_tol``) goes
through ``solvers.dogleg_cuda.dogleg_stage``: the CUDA kernel for tensors
on the card, the plain version below (``dogleg_cm``) on the CPU.  The
f64 polish, the lagged tangent and the outputs are plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import tensors as tn
from ..utils.tensors import const
from .evptn import IDENT_VOL, M_SVEC_FROM_VECD, M_VECD_FROM_SVEC_ENG


def _safe_sqrt(s):
    """sqrt(s) for s > 0, else 0 (NaN included): a lane whose residual is
    not finite reads as converged at its start, which the reference keeps
    as the elastic-guess fallback (its round-5 note in evptn_cm.py)."""
    pos = s > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, 1.0)), 0.0)


def _tiny(dtype):
    return float(torch.finfo(dtype).tiny)


# ---------------------------------------------------------------------------
# component-major quaternion / rotation / small-matrix helpers, (C, N)
# ---------------------------------------------------------------------------


def quat_multiply_cm(a, b):
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    return torch.stack([
        a0 * b0 - a1 * b1 - a2 * b2 - a3 * b3,
        a0 * b1 + a1 * b0 + a2 * b3 - a3 * b2,
        a0 * b2 - a1 * b3 + a2 * b0 + a3 * b1,
        a0 * b3 + a1 * b2 - a2 * b1 + a3 * b0,
    ])


def expmap_to_quat_cm(xi):
    ang2 = xi[0] * xi[0] + xi[1] * xi[1] + xi[2] * xi[2]
    big = ang2 > 1e-24
    ang = torch.sqrt(torch.where(big, ang2, 1.0))
    q0 = torch.where(big, torch.cos(0.5 * ang), 1.0 - ang2 / 8.0)
    sinc = torch.where(big, torch.sin(0.5 * ang) / ang, 0.5 - ang2 / 48.0)
    return torch.stack([q0, xi[0] * sinc, xi[1] * sinc, xi[2] * sinc])


def quat_to_rmat_cm(q):
    """(3, 3, N) rotation matrix; same convention as tensors.quat_to_rmat."""
    q0, q1, q2, q3 = q
    qbar = q0 * q0 - (q1 * q1 + q2 * q2 + q3 * q3)
    r = [[qbar + 2.0 * q1 * q1, 2.0 * (q1 * q2 - q0 * q3),
          2.0 * (q1 * q3 + q0 * q2)],
         [2.0 * (q1 * q2 + q0 * q3), qbar + 2.0 * q2 * q2,
          2.0 * (q2 * q3 - q0 * q1)],
         [2.0 * (q1 * q3 - q0 * q2), 2.0 * (q2 * q3 + q0 * q1),
          qbar + 2.0 * q3 * q3]]
    return torch.stack([torch.stack(row) for row in r])


def vecd_to_mat_cm(t):
    """vecd (5, N) -> symmetric deviatoric (3, 3, N)."""
    return torch.einsum("kij,kn->ijn", const(tn.BASIS_DEV, t), t)


def mat_to_vecd_cm(a):
    """symmetric (3, 3, N) -> vecd (5, N)."""
    return torch.einsum("kij,ijn->kn", const(tn.BASIS_DEV, a),
                        a.reshape(3, 3, -1)).reshape(5, *a.shape[2:])


def mm_cm(A, B):
    """Per-point matmul (i, k, N) x (k, j, N) -> (i, j, N)."""
    return torch.sum(A[:, :, None] * B[None], dim=1)


def mv_cm(A, x):
    """Per-point matvec (i, k, N) x (k, N) -> (i, N)."""
    return torch.sum(A * x[None], dim=1)


def const_mm_cm(C, x):
    """Constant (i, k) table times batch (k, ..., N) -> (i, ..., N)."""
    C = np.asarray(C)
    out = const(C, x) @ x.reshape(C.shape[1], -1)
    return out.reshape(C.shape[0], *x.shape[1:])


def const_mm_r_cm(x, C):
    """Batch (..., k, N) times constant (k, j) -> (..., j, N)."""
    return torch.einsum("...kn,kj->...jn", x, const(C, x))


def rot_T_mat_rot_cm(R, A):
    """R^T A R for (3, 3, N) arrays."""
    return mm_cm(R.transpose(0, 1), mm_cm(A, R))


# ---------------------------------------------------------------------------
# batched small dense solve, component-major
# ---------------------------------------------------------------------------


def solve_dense_cm_eq(A, b):
    """Row-equilibrated solve: scales each row of [A | b] by 1/max|A row|
    before the pivoted Gauss-Jordan (the point Jacobians' conditioning is
    dominated by row scales dt * kinetics slope, up to ~1e6+)."""
    tiny = 1e-300 if A.dtype == torch.float64 else 1e-37
    rmax = torch.amax(torch.abs(A), dim=1, keepdim=True)  # (n, 1, N)
    rs = 1.0 / torch.clamp(rmax, min=tiny)
    bs = b * rs[:, 0, :] if b.ndim == 2 else b * rs
    return solve_dense_cm(A * rs, bs)


def solve_dense_cm(A, b):
    """Solve A x = b per lane: A (n, n, N), b (n, N) or (n, k, N).

    Gauss-Jordan with per-lane partial pivoting; the pivot is the first
    row of largest magnitude (``torch.argmax`` keeps the first maximum,
    as the reference's ``jnp.argmax`` does)."""
    n = A.shape[0]
    vec = b.ndim == 2
    M = torch.cat([A, b[:, None, :] if vec else b], dim=1)  # (n, m, N)
    m, N = M.shape[1], M.shape[2]
    rowidx = torch.arange(n, device=A.device)[:, None]
    for col in range(n):
        masked = torch.where(rowidx >= col, torch.abs(M[:, col, :]), -1.0)
        piv = torch.argmax(masked, dim=0)  # (N,)
        pivrow = torch.gather(M, 0, piv.expand(1, m, N))[0]  # (m, N)
        is_piv = (rowidx == piv[None, :])[:, None, :]  # (n, 1, N)
        M = torch.where(is_piv, M[col][None], M)
        prow = pivrow / pivrow[col][None, :]
        elim = M - M[:, col, None, :] * prow[None]
        is_col = (rowidx == col)[:, :, None]
        M = torch.where(is_col, prow[None], elim)
    X = M[:, n:, :]
    return X[:, 0, :] if vec else X


# ---------------------------------------------------------------------------
# residual + Jacobian, component-major
# ---------------------------------------------------------------------------

_EPS = np.zeros((3, 3, 3))
_EPS[0, 1, 2] = _EPS[1, 2, 0] = _EPS[2, 0, 1] = 1.0
_EPS[0, 2, 1] = _EPS[1, 0, 2] = _EPS[2, 1, 0] = -1.0


def _dt_rows(dt):
    """dt as a per-lane row: scalar, or (N,) -> (1, N)."""
    return dt[None] if torch.is_tensor(dt) and dt.ndim == 1 else dt


def _lattice_rates(x, Dsm, w_sm, q_n):
    """(R, D_lat (3, 3, N), d_lat (5, N), w_lat (3, N)) at q_n exp(xi)."""
    q_end = quat_multiply_cm(q_n, expmap_to_quat_cm(x[5:]))
    R = quat_to_rmat_cm(q_end)
    Dlat = rot_T_mat_rot_cm(R, Dsm)
    w_lat = mv_cm(R.transpose(0, 1), w_sm)  # R^T w
    return R, Dlat, mat_to_vecd_cm(Dlat), w_lat


def residual_cm(model, x, h, dt, Dsm, w_sm, e_n, q_n, temp_k):
    """Backward-Euler residual r (8, N) of x = [e (5); xi (3)].

    h (nh, N); Dsm (3, 3, N) sample-frame deformation rate; w_sm (3, N)
    spin axial vector; e_n (5, N); q_n (4, N); dt scalar or (N,); temp_k
    the temperature the kinetics read (Voce ignores it)."""
    e_end, xi = x[:5], x[5:]
    _, _, d_lat, w_lat = _lattice_rates(x, Dsm, w_sm, q_n)
    P = np.asarray(model.slip.P)
    PC = P @ np.asarray(model.elast.C_dev)
    gd = model.kinetics.gdots(const_mm_cm(PC, e_end), h, temp_k)
    dp = const_mm_cm(P.T, gd)
    wp = const_mm_cm(np.asarray(model.slip.Q).T, gd)
    dtb = _dt_rows(dt)
    r_e = e_end - e_n + dtb * (dp - d_lat)
    r_xi = xi - dtb * (w_lat - wp)
    return torch.cat([r_e, r_xi], dim=0)


def residual_and_jac_cm(model, x, h, dt, Dsm, w_sm, e_n, q_n, temp_k):
    """(r (8, N), J (8, 8, N)) with analytic kinetics and first-order
    right-increment kinematics derivatives."""
    e_end, xi = x[:5], x[5:]
    _, Dlat, d_lat, w_lat = _lattice_rates(x, Dsm, w_sm, q_n)
    P = np.asarray(model.slip.P)
    Q = np.asarray(model.slip.Q)
    PC = P @ np.asarray(model.elast.C_dev)  # (S, 5)
    gd, slope = model.kinetics.gdots_slope(const_mm_cm(PC, e_end), h,
                                           temp_k)
    dp = const_mm_cm(P.T, gd)
    wp = const_mm_cm(Q.T, gd)
    dtb = _dt_rows(dt)
    dtb2 = dtb[None] if torch.is_tensor(dt) and dt.ndim == 1 else dt
    r = torch.cat([e_end - e_n + dtb * (dp - d_lat),
                   xi - dtb * (w_lat - wp)], dim=0)

    # kinetics blocks: J_ee = I + dt P^T diag(slope) P C, J_xe likewise
    S = P.shape[0]
    W_P = np.einsum("sk,sl->kls", P, PC).reshape(25, S)
    W_Q = np.einsum("sk,sl->kls", Q, PC).reshape(15, S)
    J_ee = const(np.eye(5), x)[:, :, None] \
        + dtb2 * const_mm_cm(W_P, slope).reshape(5, 5, -1)
    J_xe = dtb2 * const_mm_cm(W_Q, slope).reshape(3, 5, -1)

    # kinematics: d(D_lat)/d xi_k ~ D_lat K_k - K_k D_lat, (K_k)_ij =
    # eps_ikj; d(w_lat)/d xi_k ~ eps_ijk w_lat_j
    ddlat = torch.stack([
        mat_to_vecd_cm(const_mm_r_cm(Dlat, _EPS[:, k, :])
                       - const_mm_cm(_EPS[:, k, :], Dlat))
        for k in range(3)], dim=1)  # (5, 3, N)
    dwlat = const_mm_cm(_EPS.transpose(0, 2, 1).reshape(9, 3),
                        w_lat).reshape(3, 3, -1)
    J_exi = -dtb2 * ddlat
    J_xxi = const(np.eye(3), x)[:, :, None] - dtb2 * dwlat
    J = torch.cat([torch.cat([J_ee, J_exi], dim=1),
                   torch.cat([J_xe, J_xxi], dim=1)], dim=0)
    return r, J


# ---------------------------------------------------------------------------
# masked batched dogleg (the plain version of the stage kernel)
# ---------------------------------------------------------------------------


def dogleg_cm(resjac_fn, x0, tol, max_iter, active0=None):
    """Trust-region dogleg on (n, N) unknowns with per-lane convergence.

    ``active0`` masks lanes that are not solved (their x stays x0).  One
    host read of the all-done test per iteration.  Returns (x, converged
    (N,), iters (N,), rnorm (N,), J_final)."""
    n, N = x0.shape
    tiny = _tiny(x0.dtype)

    def norm0(v):
        return _safe_sqrt(torch.sum(v * v, dim=0))

    x = x0
    r, J = resjac_fn(x0)
    if active0 is None:
        active0 = torch.ones(N, dtype=torch.bool, device=x0.device)
    done = (norm0(r) < tol) | ~active0
    delta = torch.ones(N, dtype=x0.dtype, device=x0.device)
    iters = torch.zeros(N, dtype=torch.int32, device=x0.device)
    it = 0
    while it < max_iter and not bool(done.all()):
        p_newton = -solve_dense_cm_eq(J, r)
        p_newton = torch.where(torch.isfinite(p_newton).all(dim=0)[None],
                               p_newton, 0.0)
        pn_norm = norm0(p_newton)

        g = mv_cm(J.transpose(0, 1), r)  # J^T r
        Jg = mv_cm(J, g)
        alpha = torch.sum(g * g, dim=0) / torch.clamp(
            torch.sum(Jg * Jg, dim=0), min=tiny)
        p_cauchy = -alpha[None] * g
        pc_norm = norm0(p_cauchy)

        d = p_newton - p_cauchy
        a = torch.sum(d * d, dim=0)
        b = 2.0 * torch.sum(p_cauchy * d, dim=0)
        c = torch.sum(p_cauchy * p_cauchy, dim=0) - delta * delta
        disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
        beta = (-b + _safe_sqrt(disc)) / torch.clamp(2.0 * a, min=tiny)
        beta = torch.clamp(beta, 0.0, 1.0)
        p_dog = p_cauchy + beta[None] * d
        p_desc = -(delta / torch.clamp(norm0(g), min=tiny))[None] * g
        p_tr = torch.where((pc_norm >= delta)[None], p_desc, p_dog)
        p = torch.where((pn_norm <= delta)[None], p_newton, p_tr)

        x_trial = x + p
        r_trial, J_trial = resjac_fn(x_trial)
        phi = 0.5 * torch.sum(r * r, dim=0)
        phi_trial = 0.5 * torch.sum(r_trial * r_trial, dim=0)
        lin = r + mv_cm(J, p)
        pred = phi - 0.5 * torch.sum(lin * lin, dim=0)
        rho = (phi - phi_trial) / torch.clamp(pred, min=tiny)
        finite = torch.isfinite(r_trial).all(dim=0)
        step = finite & (rho > 1e-4) & ~done

        x = torch.where(step[None], x_trial, x)
        r = torch.where(step[None], r_trial, r)
        J = torch.where(step[None, None], J_trial, J)

        p_norm = norm0(p)
        grow = (rho > 0.8) & (p_norm > 0.9 * delta)
        shrink = ~finite | (rho < 0.25)
        factor = torch.where(~finite | (rho < 0.0), 0.1, 0.25)
        delta_new = torch.where(grow, torch.clamp(2.0 * delta, max=1e4),
                                delta)
        delta_new = torch.where(
            shrink, torch.clamp(factor * p_norm, min=1e-12), delta_new)
        delta = torch.where(done, delta, delta_new)

        iters = iters + (~done).to(torch.int32)
        done = done | (norm0(r) < tol)
        it += 1
    return x, done, iters, norm0(r), J


# ---------------------------------------------------------------------------
# staggered sub-incremented solve
# ---------------------------------------------------------------------------


def _initial_guess_cm(model, dt_sub, Dsm, deff, e_c, q_c, h_c):
    """Elastic trial strain scaled back toward the flow surface."""
    R = quat_to_rmat_cm(q_c)
    e_trial = e_c + dt_sub[None] * mat_to_vecd_cm(rot_T_mat_rot_cm(R, Dsm))
    PC = np.asarray(model.slip.P) @ np.asarray(model.elast.C_dev)
    taus = const_mm_cm(PC, e_trial)
    kin = model.kinetics
    # the slip strength: the hardness itself for Voce, a function of the
    # dislocation density for the Kocks-Mecking kinetics
    g = kin.strength_floor(h_c) if hasattr(kin, "strength_floor") else h_c[0]
    ratio_trial = torch.amax(torch.abs(taus), dim=0) / g
    ratio_op = kin.operating_ratio(deff)
    scale = torch.clamp(ratio_op / torch.clamp(ratio_trial, min=1e-30),
                        max=1.0)
    return e_trial * scale[None]


def solve_staggered_cm_core(model, dt, d_cm, w_cm, e0, q0, h0, temp_k, nsub,
                            x_warm=None, warm_ok=False):
    """Batched staggered solve, component-major io (c, N) tensors.

    ``nsub`` (N,) int32 substep counts; ``x_warm`` (8, N) an optional
    warm-start candidate, compared per point against the default start
    when ``warm_ok`` (the smaller residual wins).  Returns (x (8, N),
    h_end (nh, N), h_used (nh, N), iters (N,), conv (N,))."""
    from ..solvers.dogleg_cuda import dogleg_stage

    N = d_cm.shape[1]
    dtype = d_cm.dtype
    f32 = torch.float32
    Dsm = vecd_to_mat_cm(d_cm)
    max_sub = model.max_substeps if model.substep_cap > 0.0 else 1
    nsub_f = nsub.to(dtype)
    dt_sub = dt / nsub_f
    deff = _safe_sqrt(2.0 / 3.0 * torch.sum(d_cm * d_cm, dim=0))
    use_mixed = model.mixed_precision and dtype == torch.float64
    kin = model.kinetics
    PC = np.asarray(model.slip.P) @ np.asarray(model.elast.C_dev)
    blend = float(model.h_gd_blend)

    def solve_exi(x0, h, e_c, q_c, active):
        if use_mixed:
            x32, ok, iters, _, J32 = dogleg_stage(
                model, x0.to(f32), h.to(f32), dt_sub.to(f32),
                d_cm.to(f32), w_cm.to(f32), e_c.to(f32), q_c.to(f32),
                active, model.fast_tol, model.solver_max_iter)
            # f64 polish: quasi-Newton from the stage's root with its
            # final f32 Jacobian
            x = x32.to(dtype)
            for _ in range(model.refine_iters):
                r = residual_cm(model, x, h, dt_sub, Dsm, w_cm, e_c, q_c,
                                temp_k)
                x = x - solve_dense_cm_eq(J32, r.to(f32)).to(dtype)
            return x, ok, iters

        def rj(x):
            return residual_and_jac_cm(model, x, h, dt_sub, Dsm, w_cm, e_c,
                                       q_c, temp_k)

        x, ok, iters, _, _ = dogleg_cm(rj, x0, model.solver_tol,
                                       model.solver_max_iter, active0=active)
        return x, ok, iters

    def one_substep(e_c, q_c, h_c, active):
        e_guess = _initial_guess_cm(model, dt_sub, Dsm, deff, e_c, q_c, h_c)
        x0 = torch.cat([e_guess, torch.zeros(3, N, dtype=dtype,
                                             device=d_cm.device)], dim=0)
        if x_warm is not None and warm_ok:
            # final elastic strain + the total rotation increment split
            # evenly over the substeps
            xw = torch.cat([x_warm[:5], x_warm[5:] / nsub_f[None]], dim=0)
            r_d = residual_cm(model, x0, h_c, dt_sub, Dsm, w_cm, e_c, q_c,
                              temp_k)
            r_w = residual_cm(model, xw, h_c, dt_sub, Dsm, w_cm, e_c, q_c,
                              temp_k)
            better = torch.sum(r_w * r_w, dim=0) < torch.sum(r_d * r_d,
                                                             dim=0)
            x0 = torch.where(better[None], xw, x0)  # NaN -> default start

        x, ok, iters = solve_exi(x0, h_c, e_c, q_c, active)
        # hardness from the slip rates at the solution, blended toward
        # the begin-of-substep rates
        gd = kin.gdots(const_mm_cm(PC, x[:5]), h_c, temp_k)
        if blend != 1.0:
            gd_b = kin.gdots(const_mm_cm(PC, e_c), h_c, temp_k)
            gd = blend * gd + (1.0 - blend) * gd_b
        h_new = kin.update_h(h_c, gd, dt_sub, temp_k)
        q_new = quat_multiply_cm(q_c, expmap_to_quat_cm(x[5:]))
        q_new = q_new / torch.sqrt(torch.sum(q_new * q_new, dim=0))[None]
        return x[:5], q_new, h_new, iters, ok

    e, q, h, h_used = e0, q0, h0, h0
    its = torch.zeros(N, dtype=torch.int32, device=d_cm.device)
    conv = torch.ones(N, dtype=torch.bool, device=d_cm.device)
    for i in range(min(int(nsub.max()), max_sub)):
        active = i < nsub
        e2, q2, h2, it2, c2 = one_substep(e, q, h, active)
        am = active[None]
        h_used = torch.where(am, h, h_used)
        e = torch.where(am, e2, e)
        q = torch.where(am, q2, q)
        h = torch.where(am, h2, h)
        its = its + torch.where(active, it2, 0)
        conv = torch.where(active, conv & c2, conv)

    # total rotation increment back in expmap form (log map, NaN-safe at
    # the identity)
    qc = q0 * const([1.0, -1.0, -1.0, -1.0], q0)[:, None]
    dq = quat_multiply_cm(qc, q)
    qv2 = dq[1] ** 2 + dq[2] ** 2 + dq[3] ** 2
    big = qv2 > 1e-28
    qvn = torch.sqrt(torch.where(big, qv2, 1.0))
    ang = 2.0 * torch.atan2(qvn, dq[0])
    fac = torch.where(big, ang / qvn,
                      2.0 / torch.clamp(dq[0], min=_tiny(dtype)))
    return torch.cat([e, dq[1:] * fac[None]], dim=0), h, h_used, its, conv


# ---------------------------------------------------------------------------
# lagged consistent tangent
# ---------------------------------------------------------------------------


def _vecd_rot5_cm(R):
    """(5, 5, N) rotation acting on vecd components: vecd(R A R^T)."""
    B = const(tn.BASIS_DEV, R)
    RB = torch.einsum("imn,kmj->kijn", R, B)  # R B_k
    RBRT = torch.einsum("kijn,ljn->kiln", RB, R)  # R B_k R^T
    return torch.einsum("pil,kiln->pkn", B, RBRT)


def tangent_cm_core(model, dt, d_cm, w_cm, e0, q0, x_cm, h_used_cm, v1,
                    temp_k):
    """6x6 consistent tangent d(sigma_svec)/d(eps_svec_eng), (6, 6, N).

    Lagged mode: the implicit-function theorem on the (e, xi) system at
    the frozen hardness ``h_used`` the final substep solved against,
    the exact derivative of the production staggered map.  Under
    ``model.mixed_precision`` it is computed in f32 (row-equilibrated
    solve plus one defect-correction pass) and cast back."""
    out_dtype = x_cm.dtype
    if model.mixed_precision and out_dtype == torch.float64:
        f32 = torch.float32
        return tangent_cm_core(
            model, dt, d_cm.to(f32), w_cm.to(f32), e0.to(f32), q0.to(f32),
            x_cm.to(f32), h_used_cm.to(f32), v1.to(f32),
            temp_k).to(out_dtype)

    N = x_cm.shape[1]
    C = np.asarray(model.elast.C_dev)
    Dsm = vecd_to_mat_cm(d_cm)
    _, Jz = residual_and_jac_cm(model, x_cm, h_used_cm, dt, Dsm, w_cm, e0,
                                q0, temp_k)  # (8, 8, N)
    e_end, xi = x_cm[:5], x_cm[5:]

    # right-hand side: only r_e depends on d, through d_lat = Q5(R^T) d
    R = quat_to_rmat_cm(quat_multiply_cm(q0, expmap_to_quat_cm(xi)))
    RT = R.transpose(0, 1)
    dR_dd = torch.cat([-dt * _vecd_rot5_cm(RT),
                       x_cm.new_zeros(3, 5, N)], dim=0)
    dz = solve_dense_cm_eq(Jz, dR_dd)
    dz = dz + solve_dense_cm_eq(Jz, dR_dd - mm_cm(Jz, dz))
    dz_dd = -dz  # (8, 5, N)

    # stress sensitivity: sigma_sm_vecd = Q5(R) (C e) / v1
    s_lat_mat = vecd_to_mat_cm(const_mm_cm(C, e_end))
    ds_de = const_mm_r_cm(_vecd_rot5_cm(R), C) / v1[None, None, :]
    ds_dxi = torch.stack([
        mat_to_vecd_cm(mm_cm(R, mm_cm(
            const_mm_cm(_EPS[:, k, :], s_lat_mat)
            - const_mm_r_cm(s_lat_mat, _EPS[:, k, :]), RT)))
        for k in range(3)], dim=1) / v1[None, None, :]
    ds_dd = mm_cm(torch.cat([ds_de, ds_dxi], dim=1), dz_dd)  # (5, 5, N)
    c_dev = const_mm_cm(M_SVEC_FROM_VECD,
                        const_mm_r_cm(ds_dd / dt, M_VECD_FROM_SVEC_ENG))
    m6 = const(IDENT_VOL, x_cm)
    k_eff = model.eos.dpressure_dvolstrain(v1)
    return c_dev + k_eff[None, None, :] * (m6[:, None, None]
                                           * m6[None, :, None])


# ---------------------------------------------------------------------------
# outputs
# ---------------------------------------------------------------------------

def vecd_to_svec_cm(t):
    """vecd (5, N) -> deviatoric svec (6, N) [a11,a22,a33,a23,a13,a12]."""
    t1 = tn.SQR2I * t[0]
    t2 = tn.SQR6I * t[1]
    return torch.stack([t1 - t2, -t1 - t2, tn.SQR2B3 * t[1],
                        tn.SQR2I * t[4], tn.SQR2I * t[3], tn.SQR2I * t[2]])


def outputs_from_solution_cm(model, dt, d_cm, w_cm, v0, v1, e_int_n, e0,
                             q0, temp_k, x, h_end, h_used, iters, ok,
                             compute_tangent):
    """Stress/state/tangent outputs, component-major (c, N) tensors."""
    e_end = x[:5]
    q_end = quat_multiply_cm(q0, expmap_to_quat_cm(x[5:]))
    q_end = q_end / torch.sqrt(torch.sum(q_end * q_end, dim=0))[None]
    P = np.asarray(model.slip.P)
    s_lat = const_mm_cm(np.asarray(model.elast.C_dev), e_end)  # (5, N)
    taus = const_mm_cm(P, s_lat)  # (S, N)
    gd = model.kinetics.gdots(taus, h_used, temp_k)
    dp_lat = const_mm_cm(P.T, gd)
    s_sm_vecd = mv_cm(_vecd_rot5_cm(quat_to_rmat_cm(q_end)), s_lat) \
        / v1[None]
    pressure = model.eos.pressure(v1, e_int_n)
    shrate_eff = tn.SQR2B3 * _safe_sqrt(torch.sum(dp_lat * dp_lat, dim=0))
    deff = tn.SQR2B3 * _safe_sqrt(torch.sum(d_cm * d_cm, dim=0))
    pl_work_rate = torch.sum(taus * gd, dim=0) / v1
    flow_str = pl_work_rate / torch.clamp(deff, min=1e-30)
    e_int = e_int_n + dt * pl_work_rate * v1 - pressure * (v1 - v0)
    out = dict(e_end=e_end, q_end=q_end, h_end=h_end, gdots=gd,
               s_vecd_sm=s_sm_vecd, pressure=pressure, e_int=e_int,
               shrate_eff=shrate_eff, flow_str=flow_str, iters=iters,
               converged=ok)
    if compute_tangent:
        out["tangent"] = tangent_cm_core(model, dt, d_cm, w_cm, e0, q0, x,
                                         h_used, v1, temp_k)
    return out
