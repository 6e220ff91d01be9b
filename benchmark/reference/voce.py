"""Plain point update of the Voce FCC crystal: one implicit step.

The equations of ExaCMech's ``evptn`` model for copper FCC crystals
with power-law slip and linear Voce hardening, written point-major in
float64 from their definition, imports nothing of the program:

* the state is the elastic strain deviator e (5, in the orthonormal
  deviatoric basis ``BASIS``), the lattice quaternion q, the slip
  strength h, the relative volume v and the internal energy;
* one step of size dt under the velocity gradient L: d = sym L,
  w = the axial vector of skew L, v1 = v0 exp(tr d dt); the unknowns
  x = (e, xi), xi the lattice rotation increment (q1 = q0 exp(xi)),
  solve the backward-Euler equations
      e - e0 + dt (sum_s P_s gdot_s - vecd(R^T d R)) = 0
      xi - dt (R^T w - sum_s Q_s gdot_s) = 0
  with R = R(q1), tau_s = P_s . (C e), gdot_s = gdot0 |tau_s / h|^(1/m)
  sign(tau_s) at the step-begin strength h0 (the staggered scheme);
  then h1 = (h0 + a gs dGamma) / (1 + a dGamma), a = h_0 / (gs - g0),
  from dGamma = dt sum_s |gdot_s| of the slip rates blended toward the
  step-begin ones by ``H_GD_BLEND`` (the configuration's stated value);
* the Cauchy stress sigma = R (C e) R^T / v1 - p I, p = -K ln(v1) / v1
  (the props' Grueneisen factor is 0), and the energy update
  e_int1 = e_int0 + dt v1 sum_s tau_s gdot_s / v1 - p (v1 - v0).

Newton's method with the exact Jacobian (forward-mode derivatives, one
direction per unknown) solves the 8 equations of every point to
rounding.  The steps this runs are single solves (no substeps): the
substep count floor(dt gdot0 / 0.1) is 1 for dt < 0.2.

A material's reference module holds ``PointModel`` (``virgin`` and
``update``), ``SLOTS`` (where the program's history keeps each compared
quantity) and ``STATE`` (the quantities compared).
"""

from __future__ import annotations

import numpy as np
import torch

S2 = np.sqrt(2.0)
S6 = np.sqrt(6.0)
BASIS = np.zeros((5, 3, 3))
BASIS[0, 0, 0], BASIS[0, 1, 1] = 1 / S2, -1 / S2
BASIS[1, 0, 0], BASIS[1, 1, 1], BASIS[1, 2, 2] = -1 / S6, -1 / S6, 2 / S6
BASIS[2, 0, 1] = BASIS[2, 1, 0] = 1 / S2
BASIS[3, 0, 2] = BASIS[3, 2, 0] = 1 / S2
BASIS[4, 1, 2] = BASIS[4, 2, 1] = 1 / S2

# the blend of the hardness update's slip rates toward the step-begin
# ones, as the configuration states it
H_GD_BLEND = 0.99608

# the state slots the program's history layout gives the compared
# quantities: elastic strain, quaternion, slip strength
SLOTS = {"e": slice(4, 9), "q": slice(9, 13), "h": slice(13, 14)}
STATE = ("e", "q", "h")


def fcc_slip():
    """Symmetric (12, 5) and skew (12, 3) Schmid tensors of FCC
    {111}<110> slip."""
    P, Q = [], []
    for n in [(1, 1, 1), (-1, 1, 1), (1, -1, 1), (1, 1, -1)]:
        n = np.asarray(n, float) / np.sqrt(3.0)
        for d in [(0, 1, -1), (1, 0, -1), (1, -1, 0), (0, 1, 1), (1, 0, 1),
                  (1, 1, 0)]:
            m = np.asarray(d, float)
            if abs(m @ n) > 1e-12:
                continue
            m = m / np.linalg.norm(m)
            T = np.outer(m, n)
            sym, skw = 0.5 * (T + T.T), 0.5 * (T - T.T)
            P.append(np.einsum("kij,ij->k", BASIS, sym))
            Q.append([skw[2, 1], skw[0, 2], skw[1, 0]])
    return np.array(P), np.array(Q)


def quat_mul(a, b):
    a0, a1, a2, a3 = a.unbind(-1)
    b0, b1, b2, b3 = b.unbind(-1)
    return torch.stack([a0 * b0 - a1 * b1 - a2 * b2 - a3 * b3,
                        a0 * b1 + a1 * b0 + a2 * b3 - a3 * b2,
                        a0 * b2 - a1 * b3 + a2 * b0 + a3 * b1,
                        a0 * b3 + a1 * b2 - a2 * b1 + a3 * b0], dim=-1)


def quat_exp(xi):
    """Unit quaternion of the rotation vector xi (..., 3)."""
    ang2 = (xi * xi).sum(-1)
    small = ang2 < 1e-24
    ang = torch.sqrt(torch.where(small, 1.0, ang2))
    c = torch.where(small, 1.0 - ang2 / 8.0, torch.cos(0.5 * ang))
    s = torch.where(small, 0.5 - ang2 / 48.0, torch.sin(0.5 * ang) / ang)
    return torch.cat([c[..., None], xi * s[..., None]], dim=-1)


def rotation(q):
    """Rotation matrix (..., 3, 3) of the unit quaternion q."""
    q0, q1, q2, q3 = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (q2 * q2 + q3 * q3), 2 * (q1 * q2 - q0 * q3),
                     2 * (q1 * q3 + q0 * q2)], -1),
        torch.stack([2 * (q1 * q2 + q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3),
                     2 * (q2 * q3 - q0 * q1)], -1),
        torch.stack([2 * (q1 * q3 - q0 * q2), 2 * (q2 * q3 + q0 * q1),
                     1 - 2 * (q1 * q1 + q2 * q2)], -1)], -2)


class PointModel:
    """The Voce FCC point update, its material constants from the props
    file as tensors."""

    def __init__(self, props, device, dtype=torch.float64):
        p = np.asarray(props, float)
        c11, c12, c44 = p[3:6]
        self.xm, self.gdot0 = p[7], p[8]
        self.h0, self.g0, self.gs0 = p[9], p[10], p[11]
        if p[12] != 0.0 or p[15] != 0.0:
            raise ValueError("the reference covers xms = 0 and a zero "
                             "Grueneisen factor")
        self.bulk = (c11 + 2 * c12) / 3.0
        t = dict(dtype=dtype, device=device)
        self.C = torch.as_tensor(np.array([c11 - c12, c11 - c12, 2 * c44,
                                           2 * c44, 2 * c44]), **t)
        P, Q = fcc_slip()
        self.P = torch.as_tensor(P, **t)
        self.Q = torch.as_tensor(Q, **t)
        self.B = torch.as_tensor(BASIS, **t)
        self.log_cap = 80.0 if dtype == torch.float64 else 25.0

    def vecd(self, A):
        return torch.einsum("kij,...ij->...k", self.B, A)

    def mat(self, v):
        return torch.einsum("kij,...k->...ij", self.B, v)

    def gdots(self, e, h):
        """Slip rates (..., 12) at elastic strain e and strength h (...,)."""
        tau = (self.C * e) @ self.P.T
        ratio = tau.abs() / h[..., None]
        live = ratio > 1e-10
        lg = torch.log(torch.where(live, ratio, 1.0)) / self.xm
        # above exp(log_cap) the rate continues linearly in the log-rate
        rate = self.gdot0 * torch.exp(lg.clamp(max=self.log_cap)) \
            * (1.0 + (lg - self.log_cap).clamp(min=0.0))
        return torch.where(live, rate, 0.0) * torch.sign(tau), tau

    def residual(self, x, dt, D, w, e0, q0, h0):
        e, xi = x[..., :5], x[..., 5:]
        R = rotation(quat_mul(q0, quat_exp(xi)))
        Rt = R.transpose(-1, -2)
        d_lat = self.vecd(Rt @ D @ R)
        w_lat = (Rt @ w[..., None])[..., 0]
        gd, _ = self.gdots(e, h0)
        return torch.cat([e - e0 + dt * (gd @ self.P - d_lat),
                          xi - dt * (w_lat - gd @ self.Q)], dim=-1)

    def solve(self, dt, D, w, e0, q0, h0, iters=8):
        """The root x (..., 8) of ``residual`` by Newton, started at the
        elastic trial point; returns (x, max |r| at the root)."""
        R0 = rotation(q0)
        x = torch.cat([e0 + dt * self.vecd(R0.transpose(-1, -2) @ D @ R0),
                       dt * (R0.transpose(-1, -2) @ w[..., None])[..., 0]],
                      dim=-1)

        def f(z):
            return self.residual(z, dt, D, w, e0, q0, h0)

        eye = torch.eye(8, dtype=x.dtype, device=x.device)
        for _ in range(iters):
            cols = []
            for k in range(8):
                r, jk = torch.func.jvp(f, (x,), (eye[k].expand_as(x),))
                cols.append(jk)
            dx = torch.linalg.solve(torch.stack(cols, dim=-1),
                                    r[..., None])[..., 0]
            x = x - dx
            # converged to rounding at every point: the step is below a
            # few ulps of the point's largest unknown
            if float((dx.abs().amax(-1) - 4 * torch.finfo(x.dtype).eps
                      * x.abs().amax(-1)).amax()) <= 0.0:
                break
        return x, f(x).abs().amax()

    def update(self, L, dt, state):
        """One step at velocity gradients L (..., 3, 3) from ``state``, a
        dict of e (..., 5), q (..., 4), h, vol, e_int (...,).  Returns
        (stress (..., 6) [11, 22, 33, 23, 13, 12], the end state, max
        |r| of the point solves)."""
        d = 0.5 * (L + L.transpose(-1, -2))
        w = 0.5 * torch.stack([L[..., 2, 1] - L[..., 1, 2],
                               L[..., 0, 2] - L[..., 2, 0],
                               L[..., 1, 0] - L[..., 0, 1]], dim=-1)
        trd = d[..., 0, 0] + d[..., 1, 1] + d[..., 2, 2]
        D = d - trd[..., None, None] / 3.0 * torch.eye(3, dtype=L.dtype,
                                                     device=L.device)
        v0, v1 = state["vol"], state["vol"] * torch.exp(trd * dt)
        e0, q0, h0 = state["e"], state["q"], state["h"]
        x, res = self.solve(dt, D, w, e0, q0, h0)
        e1 = x[..., :5]
        q1 = quat_mul(q0, quat_exp(x[..., 5:]))
        q1 = q1 / q1.norm(dim=-1, keepdim=True)
        gd, tau = self.gdots(e1, h0)
        gd_b, _ = self.gdots(e0, h0)
        dgam = (H_GD_BLEND * gd + (1.0 - H_GD_BLEND) * gd_b).abs().sum(-1) \
            * dt
        a = self.h0 / (self.gs0 - self.g0)
        h1 = (h0 + a * self.gs0 * dgam) / (1.0 + a * dgam)
        R1 = rotation(q1)
        s = R1 @ self.mat(self.C * e1) @ R1.transpose(-1, -2) \
            / v1[..., None, None]
        p = -self.bulk * torch.log(v1) / v1
        sig = s - p[..., None, None] * torch.eye(3, dtype=L.dtype,
                                                 device=L.device)
        e_int = state["e_int"] + dt * (tau * gd).sum(-1) - p * (v1 - v0)
        stress = torch.stack([sig[..., 0, 0], sig[..., 1, 1], sig[..., 2, 2],
                              sig[..., 1, 2], sig[..., 0, 2], sig[..., 0, 1]],
                             dim=-1)
        return stress, dict(e=e1, q=q1, h=h1, vol=v1, e_int=e_int), res

    def virgin(self, quats):
        """The initial state at points with orientations quats (..., 4)."""
        q = quats / quats.norm(dim=-1, keepdim=True)
        z = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
        return dict(e=torch.zeros(*q.shape[:-1], 5, dtype=q.dtype,
                                  device=q.device), q=q, h=z + self.g0,
                    vol=z + 1.0, e_int=z)
