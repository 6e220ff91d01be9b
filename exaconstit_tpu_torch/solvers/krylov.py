"""Krylov solvers: preconditioned conjugate gradients (plain and mixed
precision), MINRES and GMRES.

Port of ``exaconstit_tpu.solvers.krylov`` with MFEM's convergence
semantics: CG stops when (z, r) <= max(rel_tol^2 (z0, r0), abs_tol^2);
MINRES and GMRES when the preconditioned residual norm is at most
max(rel_tol * its initial value, abs_tol).  The loops are eager Python
loops with one host read of the stop test per iteration.  All return
(x, iters, converged, rel_reduction).  ``pcg`` and ``pcg_refined``
take the reference's ``dot=`` hook: every inner product and norm in them
goes through it (the slab system passes its owner-masked global dot);
the default is ``torch.dot``.  Each solver counts to the current
recorder (``utils.profiling.count``; nothing when none is current) each
blocking scalar read of the solve's stop tests and relative reduction
(``"host_reads"``) and the solve's inner iterations
(``"krylov.iterations"``; ``pcg_refined`` counts them in its inner
``pcg`` solves).

Unlike the reference, ``pcg`` does not report a breakdown ((d, Ad) <= 0)
as convergence: it stops there with ``converged`` False.  Solutions and
iteration counts are the reference's.
"""

from __future__ import annotations

import torch

from ..utils import profiling


def pcg(matvec, precond, b, rel_tol, abs_tol, max_iter, dot=torch.dot):
    """Solve A x = b.  Returns (x, iters, converged, rel_reduction) with
    rel_reduction = sqrt((z, r)/(z0, r0)) in the criterion's norm."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    d = z
    nom0 = dot(z, r)
    nom = nom0
    r0 = torch.clamp(nom0 * rel_tol * rel_tol, min=abs_tol * abs_tol)
    converged = bool(nom <= r0)
    profiling.count("host_reads")
    it = 0
    while it < max_iter and not converged:
        ad = matvec(d)
        den = dot(d, ad)
        if not bool(den > 0.0):
            # breakdown: not positive definite at this iterate (in f32
            # also by underflow); counted as an iteration, as MFEM does
            it += 1
            profiling.count("host_reads")
            break
        alpha = nom / den
        x = x + alpha * d
        r = r - alpha * ad
        z = precond(r)
        betanom = dot(r, z)
        converged = bool(betanom <= r0)
        profiling.count("host_reads", 2)
        d = z + (betanom / nom) * d
        nom = betanom
        it += 1
    relred = float(torch.sqrt(torch.clamp(nom, min=0.0)
                              / (nom0 if float(nom0) > 0.0 else 1.0)))
    profiling.count("host_reads", 2)
    profiling.count("krylov.iterations", it)
    return x, it, converged, relred


def minres(matvec, precond, b, rel_tol, abs_tol, max_iter):
    """Preconditioned MINRES (Paige-Saunders), stopping on the
    preconditioned residual norm phibar."""
    r1 = b  # x0 = 0
    y = precond(r1)
    beta1 = torch.sqrt(torch.dot(r1, y))
    goal = max(rel_tol * float(beta1), abs_tol)
    x = torch.zeros_like(b)
    r2, w, w2 = r1, torch.zeros_like(b), torch.zeros_like(b)
    oldb, beta = beta1.new_zeros(()), beta1
    dbar, epsln, phibar = beta1.new_zeros(()), beta1.new_zeros(()), beta1
    cs, sn = beta1.new_full((), -1.0), beta1.new_zeros(())
    done = bool(beta1 <= goal)
    profiling.count("host_reads", 2)
    it = 0
    while it < max_iter and not done:
        v = y / beta
        y = matvec(v)
        if it >= 1:
            y = y - (beta / torch.where(oldb == 0.0, 1.0, oldb)) * r1
        alfa = torch.dot(v, y)
        y = y - (alfa / beta) * r2
        r1, r2 = r2, y
        y = precond(r2)
        oldb, beta = beta, torch.sqrt(torch.dot(r2, y))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp(torch.sqrt(gbar * gbar + beta * beta),
                            min=1e-300)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        it += 1
        done = bool(phibar <= goal)
        profiling.count("host_reads")
    b1 = float(beta1)
    relred = float(phibar) / (b1 if b1 > 0.0 else 1.0)
    profiling.count("host_reads", 2)
    profiling.count("krylov.iterations", it)
    return x, it, done, relred


def gmres(matvec, precond, b, rel_tol, abs_tol, max_iter, restart=50):
    """Left-preconditioned restarted GMRES(m): modified Gram-Schmidt and
    Givens rotations in the reference's order.  A cycle stops at its
    m-th vector or as soon as the residual estimate |g[j+1]| meets the
    goal, so ``iters`` may exceed ``max_iter`` by less than m, as in the
    reference."""
    m = restart
    beta0 = float(torch.linalg.vector_norm(precond(b)))
    profiling.count("host_reads")
    goal = max(rel_tol * beta0, abs_tol)
    x = torch.zeros_like(b)
    it, done, res = 0, beta0 <= goal, beta0
    while it < max_iter and not done:
        r = precond(b - matvec(x))
        beta = torch.linalg.vector_norm(r)
        V = [r / torch.clamp(beta, min=1e-300)]
        H = b.new_zeros((m + 1, m))
        cs, sn = b.new_zeros(m), b.new_zeros(m)
        g = b.new_zeros(m + 1)
        g[0] = beta
        k = 0
        for j in range(m):
            w = precond(matvec(V[j]))
            hcol = b.new_zeros(m + 1)
            for i in range(j + 1):
                hcol[i] = torch.dot(V[i], w)
                w = w - hcol[i] * V[i]
            hj1 = torch.linalg.vector_norm(w)
            V.append(w / torch.clamp(hj1, min=1e-300))
            hcol[j + 1] = hj1
            for i in range(j):
                t0 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i] = t0
            denom = torch.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            cs[j] = hcol[j] / torch.clamp(denom, min=1e-300)
            sn[j] = hcol[j + 1] / torch.clamp(denom, min=1e-300)
            hcol[j], hcol[j + 1] = denom, 0.0
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            H[:, j] = hcol
            k = j + 1
            profiling.count("host_reads")
            if float(torch.abs(g[j + 1])) <= goal:
                done = True
                break
        # back substitution on the k x k upper-triangular system
        y = b.new_zeros(m)
        for j in range(k - 1, -1, -1):
            y[j] = (g[j] - torch.dot(H[j], y)) / H[j, j]
        x = x + torch.einsum("k,kn->n", y[:k], torch.stack(V[:k]))
        it += k
        res = float(torch.abs(g[k]))
        profiling.count("host_reads")
    relred = res / (beta0 if beta0 > 0.0 else 1.0)
    profiling.count("krylov.iterations", it)
    return x, it, done, relred


def pcg_refined(matvec, precond, matvec_lo, precond_lo, b, rel_tol, abs_tol,
                max_iter, inner_rel=1e-4, max_rounds=6, dot=torch.dot):
    """Mixed-precision PCG: f32 inner solves + f64 iterative refinement.

    Each round runs f32 PCG on the normalized current f64 residual
    (reducing it by ~inner_rel), then replays r = b - A x in f64.  The
    convergence test is ``pcg``'s, in f64.  matvec/precond act in f64,
    matvec_lo/precond_lo in f32.  Returns (x, total_inner_iters,
    converged, rel_reduction)."""
    z0 = precond(b)
    nom0 = dot(z0, b)
    r0bar = torch.clamp(nom0 * rel_tol * rel_tol, min=abs_tol * abs_tol)
    x = torch.zeros_like(b)
    r = b
    nom = nom0
    done = bool(nom0 <= r0bar)
    profiling.count("host_reads")
    it = rounds = 0
    while rounds < max_rounds and it < max_iter and not done:
        # normalized inner right-hand side: late rounds have |r| ~ 1e-8
        # |b|, whose square underflows the f32 recurrences
        rnorm = torch.sqrt(dot(r, r))
        scale = torch.where(rnorm > 0.0, rnorm, 1.0)
        dx, in_it, _, _ = pcg(matvec_lo, precond_lo,
                              (r / scale).to(torch.float32), inner_rel, 0.0,
                              max_iter - it, dot=dot)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        x = x + scale * dx.to(b.dtype)
        r = b - matvec(x)
        nom = dot(precond(r), r)
        it += in_it
        rounds += 1
        done = bool(nom <= r0bar)
        profiling.count("host_reads")
    relred = float(torch.sqrt(torch.clamp(nom, min=0.0)
                              / (nom0 if float(nom0) > 0.0 else 1.0)))
    profiling.count("host_reads", 2)
    return x, it, done, relred
