"""Slip kinetics and hardening laws, component-major.

Port of ``exaconstit_tpu.models.kinetics``:

* ``VocePL``: power-law slip with Voce hardening (ExaCMech's Kin_FCC_A,
  and Kin_FCC_AH with a nonlinear Voce exponent), in the sat_ratio
  evolution form with a backward-Euler update, which is the one the
  reference's production configuration uses;
* ``KMBalD``: Kocks-Mecking dislocation density with balanced thermally
  activated (MTS-like) slip and phonon drag, for FCC, BCC
  (``g_athermal``) and per-slip HCP parameter sets;
* ``SplineG``: the ``KMBalD`` slip law with a free-form hardening map on
  the slip strength itself (the calibrated copper FCC row of
  ``ecmech._MTSDD_CALIBRATION``).

The reference's functions take point-major ``(N, S)`` arrays; these take
the component-major arrays of the point solve directly: resolved shears
``taus (S, N)``, hardness ``h (nh, N)``, slip rates ``(S, N)``.  Every
rate function takes the temperature ``temp_k`` last; Voce ignores it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils.tensors import const

_TINY = 1e-280


def max_log_gdot(dtype):
    """Exponent cap: exp(80)^2 overflows f32, so f32 caps at 25."""
    return 80.0 if dtype == torch.float64 else 25.0


@dataclasses.dataclass(frozen=True)
class VocePL:
    mu: float
    xm: float
    gdot0: float
    h0: float
    g0: float
    gs0: float
    xms: float
    gam_s: float
    hdn_init: float
    voce_exponent: float = 1.0  # 1 -> linear Voce (Kin_FCC_A)

    n_h = 1

    @classmethod
    def from_props(cls, props, nonlinear: bool):
        # the kinetics block starts at index 6 (after rho0, cvav, tol,
        # c11, c12, c44); the NL variant inserts the exponent after gs0
        p = np.asarray(props, dtype=float)
        if nonlinear:
            (mu, xm, gdot0, h0, g0, gs0, expo, xms, gam_s, hdn) = \
                (float(v) for v in p[6:16])
        else:
            (mu, xm, gdot0, h0, g0, gs0, xms, gam_s, hdn) = \
                (float(v) for v in p[6:15])
            expo = 1.0
        return cls(mu=mu, xm=xm, gdot0=gdot0, h0=h0, g0=g0, gs0=gs0,
                   xms=xms, gam_s=gam_s, hdn_init=hdn, voce_exponent=expo)

    def init_hardness(self):
        return np.array([self.g0])

    def _log_rate(self, taus, h):
        tau_abs = torch.abs(taus)
        ratio = tau_abs / h[0:1]
        big = ratio > 1e-10
        ratio_safe = torch.where(big, ratio, 1.0)
        log_gdot = (1.0 / self.xm) * torch.log(ratio_safe)
        cap = max_log_gdot(taus.dtype)
        capped = torch.clamp(log_gdot, max=cap)
        over = torch.clamp(log_gdot - cap, min=0.0)
        return tau_abs, big, log_gdot, capped, over, cap

    def gdots(self, taus, h, temp_k=None):
        """Slip rates; above the exponent cap the rate continues
        linearly in the log-rate so the Jacobian never goes flat."""
        _, big, _, capped, over, _ = self._log_rate(taus, h)
        gd = torch.where(big, self.gdot0 * torch.exp(capped) * (1.0 + over),
                         0.0)
        return torch.sign(taus) * gd

    def gdots_slope(self, taus, h, temp_k=None):
        """(gdots, d|gdots|/d|tau|) with the slope in closed form."""
        tau_abs, big, log_gdot, capped, over, cap = self._log_rate(taus, h)
        xn = 1.0 / self.xm
        mag_cap = self.gdot0 * torch.exp(capped)
        mag = mag_cap * (1.0 + over)
        gd = torch.where(big, mag, 0.0)
        # below the cap d|gd|/d|tau| = xn*mag/tau; above it only the
        # linear continuation varies: mag_cap*xn/tau
        slope_mag = torch.where(log_gdot < cap, xn * mag, xn * mag_cap)
        slope = torch.where(big, slope_mag / torch.where(big, tau_abs, 1.0),
                            0.0)
        return torch.sign(taus) * gd, slope

    def operating_ratio(self, deff):
        """|tau|/g at fully developed flow at rate deff (initial guess)."""
        return torch.pow(torch.clamp(deff, min=1e-12) / self.gdot0, self.xm)

    def _gsat(self, shrate):
        if self.xms == 0.0:
            return torch.full_like(shrate, self.gs0)
        arg = torch.clamp(shrate, min=_TINY) / self.gam_s
        return self.gs0 * torch.pow(arg, self.xms)

    def update_h(self, h_n, gdots, dt, temp_k=None):
        """Backward-Euler hardness update from converged slip rates.

        h_n (1, N), gdots (S, N), dt scalar or (N,).  Closed form for
        the linear Voce law; 20 scalar Newton steps for the nonlinear
        exponent."""
        shrate = torch.sum(torch.abs(gdots), dim=0, keepdim=True)
        gs = self._gsat(shrate)
        dgam = shrate * dt
        n = self.voce_exponent
        if n == 1.0:
            a = self.h0 / (gs - self.g0)
            return (h_n + a * gs * dgam) / (1.0 + a * dgam)
        h = h_n
        for _ in range(20):
            x = (gs - h) / (gs - self.g0)
            xpos = torch.clamp(x, min=0.0)
            hdot = self.h0 * torch.pow(torch.clamp(xpos, min=_TINY), n)
            r = h - h_n - hdot * dgam
            x = torch.clamp(x, min=_TINY)
            drdh = 1.0 + dgam * self.h0 * n * torch.pow(x, n - 1.0) / (
                gs - self.g0)
            h = h - r / drdh
        return h


def _col(v, like):
    """A kinetics parameter ready to broadcast against (S, N): a float
    stays a float, a per-slip (S,) array becomes an (S, 1) tensor."""
    a = np.asarray(v, dtype=float)
    return float(a) if a.ndim == 0 else const(a.reshape(-1, 1), like)


def _safe_pow(x, expo):
    """(x^expo, d/dx x^expo), both exactly 0 for x <= 1e-12 (no NaN from
    the power at 0); the identity for expo == 1."""
    if expo == 1.0:
        return x, torch.ones_like(x)
    pos = x > 1e-12
    xs = torch.where(pos, x, 1.0)
    return (torch.where(pos, torch.pow(xs, expo), 0.0),
            torch.where(pos, expo * torch.pow(xs, expo - 1.0), 0.0))


@dataclasses.dataclass(frozen=True)
class KMBalD:
    """Kocks-Mecking dislocation-density kinetics with phonon drag.

    Parameter order: mu_ref, tK_ref, c_1 = g_0 b^3 / kB [K/stress], tau_a
    (Peierls), p, q, gam_wo, gam_ro, wrD (drag stress), go, s, k1, k2_0,
    ninv, gam_ro_dd, rho_dd_init.  ``c1``, ``go`` and ``s`` are floats,
    or (S,) arrays for the per-slip HCP layout.  The density evolves as
    drho/dGamma = k1 rho^a - k2 rho^b (a = ``prod_exponent``, b =
    ``recov_exponent``).  With ``g_athermal`` (BCC) the dislocation
    strength acts athermally (subtracted from tau) and the Peierls
    stress is the thermally activated obstacle; FCC and HCP are the
    reverse."""

    mu_ref: float
    tk_ref: float
    c1: object
    tau_a: float
    p: float
    q: float
    gam_wo: float
    gam_ro: float
    wr_d: float
    go: object
    s: object
    k1: float
    k2_0: float
    ninv: float
    gam_ro_dd: float
    rho_dd_init: float
    prod_exponent: float = 0.5
    recov_exponent: float = 1.0
    g_athermal: bool = False

    n_h = 1
    # Floor of the recovery-rate argument: k2 enters only multiplied by
    # shrate * dt, so its value below this shear rate does not matter.
    _SHRATE_FLOOR = 1e-10

    @classmethod
    def from_props(cls, props, n_elastic: int = 3, g_athermal: bool = False,
                   nslip: int = 12):
        """Parse the kinetics block: the scalar layout (16 values; FCC,
        BCC, scalar HCP) or the per-slip layout (13 + 3 * nslip values;
        HCP, with c_1, g_0 and s given for every slip system)."""
        p = np.asarray(props, dtype=float)
        k = 3 + n_elastic  # rho0, cvav, tol + elastic constants
        nkin = len(p) - k - 2  # gruneisen + e_ref trail
        if nkin == 13 + 3 * nslip and nslip > 1:
            S = nslip
            i = k
            mu, tk = p[i], p[i + 1]
            i += 2
            c1 = p[i:i + S].copy()
            i += S
            tau_a, pp, qq, gw, gr, wrd = p[i:i + 6]
            i += 6
            go = p[i:i + S].copy()
            i += S
            s = p[i:i + S].copy()
            i += S
            k1, k2_0, ninv, gro_dd, rho_init = p[i:i + 5]
            return cls(mu_ref=float(mu), tk_ref=float(tk), c1=c1,
                       tau_a=float(tau_a), p=float(pp), q=float(qq),
                       gam_wo=float(gw), gam_ro=float(gr), wr_d=float(wrd),
                       go=go, s=s, k1=float(k1), k2_0=float(k2_0),
                       ninv=float(ninv), gam_ro_dd=float(gro_dd),
                       rho_dd_init=float(rho_init), g_athermal=g_athermal)
        return cls(*[float(v) for v in p[k:k + 16]], g_athermal=g_athermal)

    def init_hardness(self):
        return np.array([self.rho_dd_init])

    def _strength(self, h):
        """Slip strength go + s sqrt(rho): (1, N) for scalar go and s,
        (S, N) for per-slip ones."""
        rho = torch.clamp(h[0:1], min=_TINY)
        return _col(self.go, h) + _col(self.s, h) * torch.sqrt(rho)

    def strength_floor(self, h):
        """(N,) lower bound of the slip strengths (initial guess)."""
        return torch.amin(self._strength(h), dim=0)

    def operating_ratio(self, deff):
        """|tau|/strength at flow rate deff (thermal branch, p = q ~ 1
        estimate); only the initial guess of the point solve uses it."""
        c_t = float(np.mean(np.asarray(self.c1))) * self.mu_ref / 300.0
        x = torch.clamp(
            1.0 + torch.log(torch.clamp(deff, min=1e-12) / self.gam_wo) / c_t,
            0.05, 1.0)
        if self.g_athermal:
            # flow at |tau| ~ g + x tau_a, relative to g(h_init)
            g0 = float(np.min(np.asarray(self.go) + np.asarray(self.s)
                              * np.sqrt(max(self.rho_dd_init, 1e-30))))
            return 1.0 + x * self.tau_a / g0
        return x

    def gdots(self, taus, h, temp_k):
        return self.gdots_slope(taus, h, temp_k)[0]

    def gdots_slope(self, taus, h, temp_k):
        """(gdots, d|gdots|/d|tau|) of the balanced rate gd = gw gr /
        (gw + gr), with gw = gam_wo exp(-(c1 mu / T) (1 - x^p)^q) the
        thermally activated branch and gr = gam_ro tau_eff / wrD the drag
        branch, in log space (gw spans hundreds of decades).  The slope
        goes through the balance as d log gd = d log gw (1 - p_w) +
        d log gr (1 - p_r), with p_* the softmax weights of the
        logaddexp."""
        g = self._strength(h)
        tau_abs = torch.abs(taus)
        if self.g_athermal:  # BCC: strength athermal, Peierls thermal
            tau_eff = torch.clamp(tau_abs - g, min=0.0)
            norm = self.tau_a
        else:  # FCC/HCP: Peierls athermal, strength thermal
            tau_eff = torch.clamp(tau_abs - self.tau_a, min=0.0)
            norm = g
        xr = tau_eff / norm
        x = torch.clamp(xr, 0.0, 1.0)
        c_t = _col(self.c1, taus) * self.mu_ref / temp_k
        xp, dxp_dx = _safe_pow(x, self.p)
        act = torch.clamp(1.0 - xp, min=0.0)
        actq, dactq_dact = _safe_pow(act, self.q)
        tiny = float(torch.finfo(taus.dtype).tiny)
        log_gw = math.log(self.gam_wo) - c_t * actq
        tau_eff_s = torch.clamp(tau_eff, min=tiny)
        log_gr = math.log(self.gam_ro / self.wr_d) + torch.log(tau_eff_s)
        lse = torch.logaddexp(log_gw, log_gr)
        log_gd = log_gw + log_gr - lse
        floor = -700.0 if taus.dtype == torch.float64 else -80.0
        active = tau_eff > 10 * tiny
        mag = torch.where(active,
                          torch.exp(torch.clamp(log_gd, min=floor)), 0.0)

        dtau_eff = torch.where(tau_eff > 0.0, 1.0, 0.0)
        in_window = (xr > 0.0) & (xr < 1.0)
        dx = torch.where(in_window, dtau_eff / norm, 0.0)
        dlgw = c_t * dactq_dact * dxp_dx * dx
        dlgr = dtau_eff / tau_eff_s
        p_w = torch.exp(log_gw - lse)
        p_r = torch.exp(log_gr - lse)
        dlog_gd = dlgw * (1.0 - p_w) + dlgr * (1.0 - p_r)
        slope = torch.where(active, mag * dlog_gd, 0.0)
        return torch.sign(taus) * mag, slope

    def _k2(self, shrate):
        return self.k2_0 * torch.pow(
            self.gam_ro_dd / torch.clamp(shrate, min=self._SHRATE_FLOOR),
            self.ninv)

    def _prod(self, rho):
        """Density production k1 rho^a and its derivative."""
        a = self.prod_exponent
        rs = torch.clamp(rho, min=_TINY)
        ra = torch.pow(rs, a)
        return self.k1 * ra, self.k1 * a * ra / rs

    def _recov(self, rho, k2):
        """Density recovery k2 rho^b and its derivative."""
        b = self.recov_exponent
        rs = torch.clamp(rho, min=_TINY)
        rb = torch.pow(rs, b)
        return k2 * rb, k2 * b * rb / rs

    def h_residual(self, h, h_n, gdots, dt, temp_k=None):
        """Backward-Euler density residual."""
        shrate = torch.sum(torch.abs(gdots), dim=0, keepdim=True)
        rho = torch.clamp(h, min=_TINY)
        prod, _ = self._prod(rho)
        recov, _ = self._recov(rho, self._k2(shrate))
        return h - h_n - (prod - recov) * (shrate * dt)

    def update_h(self, h_n, gdots, dt, temp_k=None):
        """Implicit density update: 20 Newton steps on the backward-Euler
        residual, k2 = k2_0 (gam_ro_dd / Gamma_dot)^ninv."""
        shrate = torch.sum(torch.abs(gdots), dim=0, keepdim=True)
        dgam = shrate * dt
        k2 = self._k2(shrate)
        rho = torch.clamp(h_n, min=_TINY)
        for _ in range(20):
            prod, dprod = self._prod(rho)
            recov, drecov = self._recov(rho, k2)
            r = rho - h_n - (prod - recov) * dgam
            drdrho = 1.0 - (dprod - drecov) * dgam
            rho = torch.clamp(rho - r / drdrho, min=_TINY)
        return rho


@dataclasses.dataclass(frozen=True)
class SplineG(KMBalD):
    """``KMBalD`` slip with a free-form hardening map.

    The hardness state is the slip strength g itself, and it evolves as
    dg/dGamma = exp(pwl(g; g_knots, log_f)) with flat extrapolation
    outside the knots."""

    g_knots: tuple = ()
    log_f: object = None

    def init_hardness(self):
        g0 = self.go + np.min(np.asarray(self.s)) * np.sqrt(self.rho_dd_init)
        return np.array([float(g0)])

    def _strength(self, h):
        return h[0:1]

    def _f(self, g):
        """(f, df/dg) of the log-piecewise-linear hardening map."""
        kn = const(np.asarray(self.g_knots), g)
        lf = const(np.asarray(self.log_f), g)
        i = torch.clamp(torch.searchsorted(kn, g.contiguous()) - 1, 0,
                        len(self.g_knots) - 2)
        x0, x1 = kn[i], kn[i + 1]
        y0, y1 = lf[i], lf[i + 1]
        t = torch.clamp((g - x0) / (x1 - x0), 0.0, 1.0)
        f = torch.exp(y0 + t * (y1 - y0))
        slope = torch.where((g > kn[0]) & (g < kn[-1]),
                            (y1 - y0) / (x1 - x0), 0.0)
        return f, f * slope

    def h_residual(self, h, h_n, gdots, dt, temp_k=None):
        shrate = torch.sum(torch.abs(gdots), dim=0, keepdim=True)
        f, _ = self._f(h[0:1])
        return h - h_n - f * shrate * dt

    def update_h(self, h_n, gdots, dt, temp_k=None):
        """30 Newton steps on g - h_n - f(g) dGamma = 0."""
        dgam = torch.sum(torch.abs(gdots), dim=0, keepdim=True) * dt
        g = h_n
        for _ in range(30):
            f, df = self._f(g)
            g = g - (g - h_n - f * dgam) / (1.0 - df * dgam)
        return g
