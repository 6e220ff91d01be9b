"""Preconditioned conjugate gradients, plain and mixed-precision.

Port of ``exaconstit_tpu.solvers.krylov.pcg`` and ``pcg_refined`` with
MFEM's CG convergence semantics: stop when (z, r) <= max(rel_tol^2
(z0, r0), abs_tol^2).  The loops are eager Python loops with one host
read of the stop test per iteration.

Unlike the reference, ``pcg`` does not report a breakdown ((d, Ad) <= 0)
as convergence: it stops there with ``converged`` False.  Solutions and
iteration counts are the reference's.
"""

from __future__ import annotations

import torch


def pcg(matvec, precond, b, rel_tol, abs_tol, max_iter):
    """Solve A x = b.  Returns (x, iters, converged, rel_reduction) with
    rel_reduction = sqrt((z, r)/(z0, r0)) in the criterion's norm."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    d = z
    nom0 = torch.dot(z, r)
    nom = nom0
    r0 = torch.clamp(nom0 * rel_tol * rel_tol, min=abs_tol * abs_tol)
    converged = bool(nom <= r0)
    it = 0
    while it < max_iter and not converged:
        ad = matvec(d)
        den = torch.dot(d, ad)
        if not bool(den > 0.0):
            # breakdown: not positive definite at this iterate (in f32
            # also by underflow); counted as an iteration, as MFEM does
            it += 1
            break
        alpha = nom / den
        x = x + alpha * d
        r = r - alpha * ad
        z = precond(r)
        betanom = torch.dot(r, z)
        converged = bool(betanom <= r0)
        d = z + (betanom / nom) * d
        nom = betanom
        it += 1
    relred = float(torch.sqrt(torch.clamp(nom, min=0.0)
                              / (nom0 if float(nom0) > 0.0 else 1.0)))
    return x, it, converged, relred


def pcg_refined(matvec, precond, matvec_lo, precond_lo, b, rel_tol, abs_tol,
                max_iter, inner_rel=1e-4, max_rounds=6):
    """Mixed-precision PCG: f32 inner solves + f64 iterative refinement.

    Each round runs f32 PCG on the normalized current f64 residual
    (reducing it by ~inner_rel), then replays r = b - A x in f64.  The
    convergence test is ``pcg``'s, in f64.  matvec/precond act in f64,
    matvec_lo/precond_lo in f32.  Returns (x, total_inner_iters,
    converged, rel_reduction)."""
    z0 = precond(b)
    nom0 = torch.dot(z0, b)
    r0bar = torch.clamp(nom0 * rel_tol * rel_tol, min=abs_tol * abs_tol)
    x = torch.zeros_like(b)
    r = b
    nom = nom0
    done = bool(nom0 <= r0bar)
    it = rounds = 0
    while rounds < max_rounds and it < max_iter and not done:
        # normalized inner right-hand side: late rounds have |r| ~ 1e-8
        # |b|, whose square underflows the f32 recurrences
        rnorm = torch.sqrt(torch.dot(r, r))
        scale = torch.where(rnorm > 0.0, rnorm, 1.0)
        dx, in_it, _, _ = pcg(matvec_lo, precond_lo,
                              (r / scale).to(torch.float32), inner_rel, 0.0,
                              max_iter - it)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        x = x + scale * dx.to(b.dtype)
        r = b - matvec(x)
        nom = torch.dot(precond(r), r)
        it += in_it
        rounds += 1
        done = bool(nom <= r0bar)
    relred = float(torch.sqrt(torch.clamp(nom, min=0.0)
                              / (nom0 if float(nom0) > 0.0 else 1.0)))
    return x, it, done, relred
