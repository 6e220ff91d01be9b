"""Slip kinetics and hardening laws, component-major.

Port of ``exaconstit_tpu.models.kinetics``:

* ``VocePL``: power-law slip with Voce hardening (ExaCMech's Kin_FCC_A,
  and Kin_FCC_AH with a nonlinear Voce exponent), in either evolution
  form and either update scheme of the reference (production: the
  sat_ratio form with a backward-Euler update);
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

A scalar parameter may be a 0-d tensor instead of a float (a dual tensor
of ``torch.autograd.forward_ad``, for parameter sensitivities: for
example ``dataclasses.replace(kin, h0=dual)``); the values are those of
the float.  ``gdots_dh`` and ``h_residual_partials`` give the hardness
partials of the coupled tangent in closed form (the reference takes them
by ``jax.jvp``; nested forward-mode AD is not available in torch).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils.tensors import const

_TINY = 1e-280


def _log(v):
    """log of a parameter: math.log of a float, torch.log of a tensor."""
    return torch.log(v) if torch.is_tensor(v) else math.log(v)


def _table(v, like):
    """A parameter table as a tensor of ``like``'s dtype and device: a
    tensor keeps its tangent, anything else is a cached constant."""
    if torch.is_tensor(v):
        return v.to(dtype=like.dtype, device=like.device)
    return const(np.asarray(v, dtype=float), like)


def primal(kin):
    """The kinetics with every tensor parameter replaced by its value (a
    float, or a numpy array for a per-slip table), without tangents."""
    vals = {}
    for f in dataclasses.fields(kin):
        v = getattr(kin, f.name)
        if torch.is_tensor(v):
            a = v.detach().cpu().numpy().astype(float)
            vals[f.name] = float(a) if a.ndim == 0 else a
    return dataclasses.replace(kin, **vals) if vals else kin


def _mean(v):
    return torch.mean(v) if torch.is_tensor(v) else float(np.mean(
        np.asarray(v)))


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
    # evolution form: "sat_ratio" h0 ((gs - h) / (gs - g0))^n Gamma_dot,
    # "one_minus" h0 (1 - h / gs)^n Gamma_dot
    form: str = "sat_ratio"
    # linear Voce update over the step: "backward_euler" (one implicit
    # Euler step, ExaCMech's) or "exponential" (the exact solution of
    # dh/dGamma = a (gs - h) with gs frozen)
    h_scheme: str = "backward_euler"

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

    def gdots_dh(self, taus, h, temp_k=None):
        """d gdots / d h (S, N): the rate is a function of |tau| / g."""
        _, big, log_gdot, capped, _, cap = self._log_rate(taus, h)
        mag_cap = self.gdot0 * torch.exp(capped)
        dmag = torch.where(log_gdot < cap,
                           mag_cap * (1.0 + torch.clamp(log_gdot - cap,
                                                        min=0.0)), mag_cap)
        d = -(1.0 / self.xm) / h[0:1] * dmag
        return torch.sign(taus) * torch.where(big, d, 0.0)

    def _gsat(self, shrate):
        """(gs, d gs / d shrate) of the saturation strength."""
        if self.xms == 0.0:
            if torch.is_tensor(self.gs0):
                return (torch.zeros_like(shrate) + self.gs0,
                        torch.zeros_like(shrate))
            return torch.full_like(shrate, self.gs0), torch.zeros_like(shrate)
        arg = torch.clamp(shrate, min=_TINY) / self.gam_s
        gs = self.gs0 * torch.pow(arg, self.xms)
        return gs, torch.where(shrate > _TINY,
                               gs * self.xms / torch.clamp(shrate,
                                                           min=_TINY), 0.0)

    def _x(self, h, gs):
        """(x, dx/dh, dx/dgs) of the evolution form."""
        if self.form == "sat_ratio":
            den = gs - self.g0
            return (gs - h) / den, -1.0 / den, (h - self.g0) / (den * den)
        return 1.0 - h / gs, -1.0 / gs, h / (gs * gs)

    def _hdot(self, h, gs):
        """(hdot, d hdot / d x) at x = self._x(h, gs)[0]."""
        x = torch.clamp(self._x(h, gs)[0], min=0.0)
        n = self.voce_exponent
        if n == 1.0:
            return self.h0 * x, self.h0 * (x > 0.0).to(x.dtype)
        xs = torch.clamp(x, min=_TINY)
        return (self.h0 * torch.pow(xs, n),
                torch.where(x > _TINY, self.h0 * n * torch.pow(xs, n - 1.0),
                            0.0))

    def h_residual(self, h, h_n, gdots, dt, temp_k=None):
        """Backward-Euler hardness residual (the coupled system's h row)."""
        shrate = torch.sum(torch.abs(gdots), dim=0, keepdim=True)
        return h - h_n - self._hdot(h, self._gsat(shrate)[0])[0] \
            * shrate * dt

    def h_residual_partials(self, h, h_n, gdots, dt, temp_k=None):
        """(d rh / d h, d rh / d shrate), each (1, N), of ``h_residual``,
        shrate = sum |gdots|."""
        shrate = torch.sum(torch.abs(gdots), dim=0, keepdim=True)
        gs, dgs = self._gsat(shrate)
        hdot, dhdot_dx = self._hdot(h, gs)
        _, dx_dh, dx_dgs = self._x(h, gs)
        dgam = shrate * dt
        return (1.0 - dhdot_dx * dx_dh * dgam,
                -(hdot * dt + dhdot_dx * dx_dgs * dgs * dgam))

    def update_h_explicit(self, h_n, gdots, dt, temp_k=None):
        """Forward-Euler hardness update (the h_forward scheme)."""
        shrate = torch.sum(torch.abs(gdots), dim=0, keepdim=True)
        return h_n + self._hdot(h_n, self._gsat(shrate)[0])[0] * shrate * dt

    def update_h(self, h_n, gdots, dt, temp_k=None, ift_tangents=False):
        """Implicit hardness update from converged slip rates.

        h_n (1, N), gdots (S, N), dt scalar or (N,).  Closed form for
        the linear Voce law; 20 scalar Newton steps for the nonlinear
        exponent.  ``ift_tangents`` is read by ``SplineG`` alone."""
        shrate = torch.sum(torch.abs(gdots), dim=0, keepdim=True)
        gs = self._gsat(shrate)[0]
        dgam = shrate * dt
        n = self.voce_exponent
        if n == 1.0:
            a = self.h0 / (gs - self.g0 if self.form == "sat_ratio" else gs)
            if self.h_scheme == "backward_euler":
                return (h_n + a * gs * dgam) / (1.0 + a * dgam)
            return gs + (h_n - gs) * torch.exp(-a * dgam)
        h = h_n
        den = gs - self.g0 if self.form == "sat_ratio" else gs
        for _ in range(20):
            r = h - h_n - self._hdot(h, gs)[0] * dgam
            x = torch.clamp(self._x(h, gs)[0], min=_TINY)
            drdh = 1.0 + dgam * self.h0 * n * torch.pow(x, n - 1.0) / den
            h = h - r / drdh
        return h


def _col(v, like):
    """A kinetics parameter ready to broadcast against (S, N): a float
    stays a float, a per-slip (S,) array becomes an (S, 1) tensor."""
    if torch.is_tensor(v):
        v = v.to(dtype=like.dtype, device=like.device)
        return v if v.ndim == 0 else v.reshape(-1, 1)
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

    def _strength_dh(self, h):
        """d strength / d h, shaped as ``_strength``."""
        rho = torch.clamp(h[0:1], min=_TINY)
        return torch.where(h[0:1] > _TINY,
                           _col(self.s, h) * 0.5 / torch.sqrt(rho), 0.0)

    def strength_floor(self, h):
        """(N,) lower bound of the slip strengths (initial guess)."""
        return torch.amin(self._strength(h), dim=0)

    def operating_ratio(self, deff):
        """|tau|/strength at flow rate deff (thermal branch, p = q ~ 1
        estimate); only the initial guess of the point solve uses it."""
        c_t = _mean(self.c1) * self.mu_ref / 300.0
        x = torch.clamp(
            1.0 + torch.log(torch.clamp(deff, min=1e-12) / self.gam_wo) / c_t,
            0.05, 1.0)
        if self.g_athermal:
            # flow at |tau| ~ g + x tau_a, relative to g(h_init)
            if any(torch.is_tensor(v) for v in (self.go, self.s,
                                                 self.rho_dd_init)):
                g0 = torch.min(torch.as_tensor(self.go) + torch.as_tensor(
                    self.s) * torch.sqrt(torch.clamp(torch.as_tensor(
                        self.rho_dd_init), min=1e-30)))
            else:
                g0 = float(np.min(np.asarray(self.go) + np.asarray(self.s)
                                  * np.sqrt(max(self.rho_dd_init, 1e-30))))
            return 1.0 + x * self.tau_a / g0
        return x

    def gdots(self, taus, h, temp_k):
        return self.gdots_slope(taus, h, temp_k)[0]

    def gdots_slope(self, taus, h, temp_k):
        return self._rates(taus, h, temp_k)[:2]

    def gdots_dh(self, taus, h, temp_k):
        """d gdots / d h (S, N), through the strength (the thermal
        window's normaliser for FCC/HCP, the athermal offset for BCC)."""
        return self._rates(taus, h, temp_k, with_dh=True)[2]

    def _rates(self, taus, h, temp_k, with_dh=False):
        """(gdots, d|gdots|/d|tau|[, d gdots / d h]) of the balanced rate
        gd = gw gr / (gw + gr), with gw = gam_wo exp(-(c1 mu / T)
        (1 - x^p)^q) the
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
        log_gw = _log(self.gam_wo) - c_t * actq
        tau_eff_s = torch.clamp(tau_eff, min=tiny)
        log_gr = _log(self.gam_ro / self.wr_d) + torch.log(tau_eff_s)
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
        if not with_dh:
            return torch.sign(taus) * mag, slope
        # d/dh through g: tau_eff moves by -dg for BCC, the normaliser by
        # dg for FCC/HCP
        dg = self._strength_dh(h)
        if self.g_athermal:
            dte = torch.where(tau_eff > 0.0, -dg, 0.0)
            dxr = dte / norm
        else:
            dte = torch.zeros_like(dg)
            dxr = -xr / norm * dg
        dlgw_h = c_t * dactq_dact * dxp_dx * torch.where(in_window, dxr, 0.0)
        dlgr_h = dte / tau_eff_s
        dmag = torch.where(active, mag * (dlgw_h * (1.0 - p_w)
                                          + dlgr_h * (1.0 - p_r)), 0.0)
        return torch.sign(taus) * mag, slope, torch.sign(taus) * dmag

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

    def h_residual_partials(self, h, h_n, gdots, dt, temp_k=None):
        """(d rh / d h, d rh / d shrate), each (1, N), of ``h_residual``."""
        shrate = torch.sum(torch.abs(gdots), dim=0, keepdim=True)
        rho = torch.clamp(h, min=_TINY)
        k2 = self._k2(shrate)
        prod, dprod = self._prod(rho)
        recov, drecov = self._recov(rho, k2)
        dgam = shrate * dt
        inside = shrate > self._SHRATE_FLOOR
        dk2 = torch.where(inside, -self.ninv * k2
                          / torch.clamp(shrate, min=self._SHRATE_FLOOR), 0.0)
        drh_dh = 1.0 - torch.where(h > _TINY, dprod - drecov, 0.0) * dgam
        rb = torch.pow(rho, self.recov_exponent)
        drh_ds = -(prod - recov) * dt + rb * dk2 * dgam
        return drh_dh, drh_ds

    def update_h(self, h_n, gdots, dt, temp_k=None, ift_tangents=False):
        """Implicit density update: 20 Newton steps on the backward-Euler
        residual, k2 = k2_0 (gam_ro_dd / Gamma_dot)^ninv (differentiated
        through, as the reference does)."""
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

    def _strength_dh(self, h):
        return torch.ones_like(h[0:1])

    def _f(self, g):
        """(f, df/dg) of the log-piecewise-linear hardening map."""
        kn = _table(self.g_knots, g)
        lf = _table(self.log_f, g)
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

    def h_residual_partials(self, h, h_n, gdots, dt, temp_k=None):
        shrate = torch.sum(torch.abs(gdots), dim=0, keepdim=True)
        f, df = self._f(h[0:1])
        return 1.0 - df * shrate * dt, -f * dt

    def update_h_explicit(self, h_n, gdots, dt, temp_k=None):
        """Forward-Euler update of the strength (the h_forward scheme)."""
        shrate = torch.sum(torch.abs(gdots), dim=0, keepdim=True)
        f, _ = self._f(h_n)
        return h_n + f * shrate * dt

    def update_h(self, h_n, gdots, dt, temp_k=None, ift_tangents=False):
        """30 Newton steps on g - h_n - f(g) dGamma = 0.

        Forward-mode tangents through the iteration are cut (its
        mid-iteration denominator crossings give inf/NaN tangents where
        the value is fine), as the reference's ``stop_gradient`` does.
        With ``ift_tangents`` a straight-through Newton correction (zero
        in value, the clamped denominator of the reference) carries the
        implicit-function-theorem tangent of r(g; h_n, dGamma) = 0."""
        dgam = torch.sum(torch.abs(gdots), dim=0, keepdim=True) * dt
        g = h_n
        for _ in range(30):
            f, df = self._f(g)
            g = g - (g - h_n - f * dgam) / (1.0 - df * dgam)
        g = g.detach()
        if not ift_tangents:
            return g
        f, df = self._f(g)
        den = 1.0 - df * dgam
        den = torch.where(torch.abs(den) > 1e-3, den,
                          torch.where(den >= 0.0, 1.0, -1.0).to(den.dtype)
                          * 1e-3)
        corr = (g - h_n - f * dgam) / den
        return g - (corr - corr.detach())
