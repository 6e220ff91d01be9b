"""Constant-bulk equation of state with a Grüneisen thermal term.

Port of ``exaconstit_tpu.models.eos``: p = -mean(sigma), p > 0 in
compression.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EosConst:
    bulk: float
    gruneisen: float = 0.0
    rho0: float = 1.0
    e0: float = 0.0  # reference internal energy (per unit reference volume)

    def pressure(self, v, e_int):
        """Cauchy pressure at relative volume v and internal energy e_int."""
        p_cold = -self.bulk * torch.log(v) / v
        p_therm = self.gruneisen * self.rho0 / v * (e_int - self.e0)
        return p_cold + p_therm

    def dpressure_dvolstrain(self, v):
        """-d(mean stress)/d(eps_vol), the bulk modulus at v ~ 1."""
        return self.bulk * (1.0 - torch.log(v)) / (v * v)
