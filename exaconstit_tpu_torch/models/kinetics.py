"""Power-law slip with Voce hardening (``VocePL``), component-major.

Port of ``exaconstit_tpu.models.kinetics.VocePL`` (ExaCMech's Kin_FCC_A,
and Kin_FCC_AH with a nonlinear Voce exponent).  The reference's
functions take point-major ``(N, S)`` arrays; these take the
component-major arrays of the point solve directly: resolved shears
``taus (S, N)``, hardness ``h (1, N)`` (the CRSS), slip rates
``(S, N)``.  The sat_ratio evolution form with a backward-Euler update
is the one the reference's production configuration uses.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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

    def gdots(self, taus, h):
        """Slip rates; above the exponent cap the rate continues
        linearly in the log-rate so the Jacobian never goes flat."""
        _, big, _, capped, over, _ = self._log_rate(taus, h)
        gd = torch.where(big, self.gdot0 * torch.exp(capped) * (1.0 + over),
                         0.0)
        return torch.sign(taus) * gd

    def gdots_slope(self, taus, h):
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

    def update_h(self, h_n, gdots, dt):
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
