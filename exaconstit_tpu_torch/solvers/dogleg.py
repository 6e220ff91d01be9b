"""Batched trust-region dogleg Newton solver for small dense systems.

Port of ``exaconstit_tpu.solvers.dogleg``: the reference solves one point
in a ``lax.while_loop`` and vmaps it, so every lane iterates until it
converges or reaches ``max_iter`` and then keeps its state while the
others go on.  ``torch.func.vmap`` cannot run a data-dependent loop per
lane, so this is the masked loop that the vmapped one amounts to: each
pass evaluates every lane and keeps the result of the lanes that are
still iterating, and the loop ends when none is (one host read of that
test per pass).  Same Newton/Cauchy/dogleg step, acceptance test and
radius rules as the reference.
"""

from __future__ import annotations

import torch

from .linalg_small import solve_dense


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def dogleg_solve(resid_jac_fn, x0, tol=1e-10, max_iter=100, delta_init=1.0,
                 delta_min=1e-12, delta_max=1e4, return_jac=False):
    """Solve R(x) = 0 at every point of a batch.

    resid_jac_fn: x (N, n) -> (r (N, n), J (N, n, n)).  Returns (x,
    converged (N,), iterations (N,), final norm (N,)[, J_final])."""
    N = x0.shape[0]
    dev, dtype = x0.device, x0.dtype
    tiny = float(torch.finfo(dtype).tiny)
    x = x0
    r, J = resid_jac_fn(x0)
    delta = torch.full((N,), delta_init, dtype=dtype, device=dev)
    it = torch.zeros(N, dtype=torch.int32, device=dev)
    done = _norm(r) < tol
    while True:
        run = (it < max_iter) & ~done
        if not bool(run.any()):
            break
        p_newton = -solve_dense(J, r)
        p_newton = torch.where(torch.isfinite(p_newton).all(dim=-1,
                                                            keepdim=True),
                               p_newton, 0.0)
        pn_norm = _norm(p_newton)

        g = torch.einsum("nji,nj->ni", J, r)  # J^T r
        Jg = torch.einsum("nij,nj->ni", J, g)
        alpha = torch.sum(g * g, dim=-1) / torch.clamp(
            torch.sum(Jg * Jg, dim=-1), min=tiny)
        p_cauchy = -alpha[:, None] * g
        pc_norm = _norm(p_cauchy)

        d = p_newton - p_cauchy
        a = torch.sum(d * d, dim=-1)
        b = 2.0 * torch.sum(p_cauchy * d, dim=-1)
        c = torch.sum(p_cauchy * p_cauchy, dim=-1) - delta * delta
        disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
        beta = torch.clamp((-b + torch.sqrt(disc))
                           / torch.clamp(2.0 * a, min=tiny), 0.0, 1.0)
        p_dog = p_cauchy + beta[:, None] * d
        p_desc = -(delta / torch.clamp(_norm(g), min=tiny))[:, None] * g
        p_tr = torch.where((pc_norm >= delta)[:, None], p_desc, p_dog)
        p = torch.where((pn_norm <= delta)[:, None], p_newton, p_tr)

        x_trial = x + p
        r_trial, J_trial = resid_jac_fn(x_trial)
        phi = 0.5 * torch.sum(r * r, dim=-1)
        phi_trial = 0.5 * torch.sum(r_trial * r_trial, dim=-1)
        lin = r + torch.einsum("nij,nj->ni", J, p)
        pred = phi - 0.5 * torch.sum(lin * lin, dim=-1)
        rho = (phi - phi_trial) / torch.clamp(pred, min=tiny)
        finite = torch.isfinite(r_trial).all(dim=-1)
        step = run & finite & (rho > 1e-4)

        x = torch.where(step[:, None], x_trial, x)
        r = torch.where(step[:, None], r_trial, r)
        J = torch.where(step[:, None, None], J_trial, J)

        p_norm = _norm(p)
        grow = (rho > 0.8) & (p_norm > 0.9 * delta)
        shrink = ~finite | (rho < 0.25)
        factor = torch.full_like(rho, 0.25).masked_fill(
            ~finite | (rho < 0.0), 0.1)
        delta_new = torch.where(grow, torch.clamp(2.0 * delta,
                                                  max=delta_max), delta)
        delta_new = torch.where(shrink, torch.clamp(factor * p_norm,
                                                    min=delta_min),
                                delta_new)
        delta = torch.where(run, delta_new, delta)
        it = it + run.to(torch.int32)
        done = torch.where(run, _norm(r) < tol, done)
    if return_jac:
        return x, done, it, _norm(r), J
    return x, done, it, _norm(r)
