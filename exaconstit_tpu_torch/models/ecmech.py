"""ExaCMech-equivalent material model: state layout, setup, factory.

Port of ``exaconstit_tpu.models.ecmech``: FCC, BCC and HCP crystals with
the power-law Voce kinetics (POWERVOCE / POWERVOCENL) or the
Kocks-Mecking dislocation-density kinetics (MTSDD).  The state layout per
point is the ExaCMech history ordering:

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
from . import evptn, evptn_cm
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
        """Uniform substep count floor(dt * rate_ref / cap) clipped to
        [1, max_substeps], or None when sub-incrementation is off.
        rate_ref is the kinetics' reference slip rate: gdot0 for the
        power-law Voce models, gam_wo for MTSDD."""
        cap = self.evptn.substep_cap
        if cap <= 0.0:
            return None
        kin = self.evptn.kinetics
        rate_ref = getattr(kin, "gdot0", None)
        if rate_ref is None:
            rate_ref = getattr(kin, "gam_wo", 1.0)
        n = math.floor(dt * rate_ref / cap)
        return int(min(max(n, 1), self.evptn.max_substeps))

    @property
    def supports_cm(self):
        """True when ``model_setup_cm`` covers this configuration (the
        component-major engine's settings)."""
        return self.evptn.supports_cm

    @property
    def point_major(self):
        """The driver takes the reference's point-major path (cold point
        solves, the f64 operator, no GMG) for what the component-major
        engine does not cover."""
        return not self.supports_cm

    def model_setup(self, dt, vgrad, state_beg, compute_tangent=True,
                    nsub=None, x_warm=None, warm_ok=None,
                    with_solution=False):
        """Constitutive update, point-major, through
        ``evptn.batched_update`` (either engine): vgrad (N, 3, 3),
        state_beg (N, num_state) -> (stress (N, 6), state_end (N,
        num_state), tangent (N, 6, 6) or None[, x (N, 8)]).
        ``with_solution`` needs the component-major engine (the per-point
        engine returns no solution vector), as in the reference."""
        d = 0.5 * (vgrad + vgrad.transpose(1, 2))
        tr_d = d[:, 0, 0] + d[:, 1, 1] + d[:, 2, 2]
        d_vecd = torch.einsum("kij,nij->nk", tn.const(tn.BASIS_DEV, d), d)
        w_vec = torch.stack([0.5 * (vgrad[:, 2, 1] - vgrad[:, 1, 2]),
                             0.5 * (vgrad[:, 0, 2] - vgrad[:, 2, 0]),
                             0.5 * (vgrad[:, 1, 0] - vgrad[:, 0, 1])],
                            dim=1)
        v0 = state_beg[:, self.ind_vols]
        v1 = v0 * torch.exp(tr_d * dt)
        e_int = state_beg[:, self.ind_int_eng]
        e_n = state_beg[:, self.IND_ESTRAIN:self.IND_ESTRAIN + 5]
        q_n = state_beg[:, self.IND_QUATS:self.IND_QUATS + 4]
        h_n = state_beg[:, self.IND_HARD:self.IND_HARD + self.n_h]
        if nsub is None:
            nsub = self.substep_counts(dt)
        out = evptn.batched_update(
            self.evptn, dt, d_vecd, w_vec, v0, v1, e_int, e_n, q_n, h_n,
            self.temp_k, compute_tangent=compute_tangent, nsub=nsub,
            x_warm=x_warm, warm_ok=warm_ok)
        stress = evptn_cm.vecd_to_svec_cm(out["s_vecd_sm"].T).T \
            - out["pressure"][:, None] * tn.const([1.0, 1, 1, 0, 0, 0], v1)
        deff = tn.vecd_deff(d_vecd)
        plw_inc = torch.where(deff > IDP_TINY_SQRT,
                              out["flow_str"] * deff * dt, 0.0)
        state_end = torch.cat([
            out["shrate_eff"][:, None],
            (state_beg[:, self.IND_SHREFF] + out["shrate_eff"] * dt)[:, None],
            (state_beg[:, self.IND_PLWORK] + plw_inc)[:, None],
            out["iters"].to(stress.dtype)[:, None],
            out["e_end"], out["q_end"], out["h_end"], out["gdots"],
            v1[:, None], out["e_int"][:, None],
        ], dim=1)
        tangent = out.get("tangent")
        if with_solution:
            if "x_sol" not in out:
                raise ValueError(
                    "with_solution requires the component-major engine "
                    "(the per-point engine does not expose the solution "
                    "vector)")
            return stress, state_end, tangent, out["x_sol"]
        return stress, state_end, tangent

    def model_setup_cm(self, dt, vgrad_cm, state_beg_cm,
                       compute_tangent=True, nsub=None, x_warm=None,
                       warm_ok=False, with_solution=False):
        """Constitutive update for a flat batch of points, component-major.

        vgrad_cm (3, 3, N) velocity gradient L_ij = dv_i/dx_j;
        state_beg_cm (num_state, N).  Returns (stress (6, N), state_end
        (num_state, N), tangent (6, 6, N) or None[, x (8, N)]).  Needs the
        component-major engine's settings (``supports_cm``)."""
        if not self.supports_cm:
            raise NotImplementedError(
                "model_setup_cm implements the component-major engine's "
                "staggered scheme only; these settings run through "
                "model_setup")
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
            ev, dt, d_vecd, w_vec, e_n, q_n, h_n, self.temp_k, nsub,
            x_warm=x_warm, warm_ok=warm_ok)
        out = evptn_cm.outputs_from_solution_cm(
            ev, dt, d_vecd, w_vec, v0, v1, e_int, e_n, q_n, h_n, self.temp_k,
            x, h_end, h_used, iters, ok, compute_tangent)

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

    def dp_mat_cm(self, state_cm):
        """Sample-frame plastic deformation-rate tensor (3, 3, N) from a
        component-major state (num_state, N): the slip rates' symmetric
        Schmid sum, rotated out of the lattice frame."""
        gd = state_cm[self.ind_gdot:self.ind_gdot + self.nslip]
        q = state_cm[self.IND_QUATS:self.IND_QUATS + 4]
        dp_lat = evptn_cm.const_mm_cm(np.asarray(self.evptn.slip.P).T, gd)
        R = evptn_cm.quat_to_rmat_cm(q)
        return evptn_cm.mm_cm(R, evptn_cm.mm_cm(
            evptn_cm.vecd_to_mat_cm(dp_lat), R.transpose(0, 1)))


# Effective Kocks-Mecking evolution constants for the MTSDD models, as
# the reference package identified them against the golden stress curves
# of its copper parameter set (its models/ecmech.py tells the story).
# Keyed on the file's (k1, k2_0) so only that parameter set is rewritten;
# any other set runs the published form drho/dGamma = k1 sqrt(rho) - k2 rho
# with its own constants.  Per crystal: (k1_eff, k2_eff, production
# exponent a, recovery exponent b[, s_scale, c1_scale[, p, q]]), or a
# free-form hardening map dg/dGamma = exp(pwl(g; knots, log_f)) on the
# slip strength with one scale on c_1.  The FCC map was identified on one
# loading path, rate and temperature; outside its strength window
# g in [0.0110, 0.0307] it extrapolates flat.
_MTSDD_CALIBRATION = {
    (3.0e-4, 5e-5): {
        XtalType.FCC: {
            "knots": [0.010989, 0.01278494, 0.01458087, 0.01637681,
                      0.01817275, 0.01996869, 0.02176462, 0.02356056,
                      0.0253565, 0.02715244, 0.02894837, 0.03074431],
            "log_f": [36.674222, 13.532857, 11.243521, 3.630117,
                      3.346182, 2.024460, 2.030811, 1.496569,
                      0.756925, 0.304698, -1.257315, -9.361863],
            "c1_scale": 1.0359223763912433,
        },
        XtalType.BCC: (64.331, 702.32, 0.0, 1.0),
    },
}


def _spline_kin(kin, knots, log_f, c1_scale=None):
    """Free-form-hardening SplineG kinetics from a KMBalD base."""
    vals = {f.name: getattr(kin, f.name)
            for f in dataclasses.fields(kinetics.KMBalD)}
    if c1_scale is not None:
        vals["c1"] = vals["c1"] * float(c1_scale)
    return kinetics.SplineG(**vals, g_knots=tuple(knots),
                            log_f=np.asarray(log_f, dtype=float))


def _calibrated_kin(kin, row):
    if isinstance(row, dict):
        return _spline_kin(kin, row["knots"], row["log_f"],
                           row.get("c1_scale"))
    k1e, k2e, pa, pb = row[:4]
    upd = dict(k1=k1e, k2_0=k2e, prod_exponent=pa, recov_exponent=pb)
    if len(row) > 4:
        upd["s"] = kin.s * row[4]
        upd["c1"] = kin.c1 * row[5]
    if len(row) > 6:
        upd["p"] = row[6]
        upd["q"] = row[7]
    return dataclasses.replace(kin, **upd)


def _apply_mtsdd_calibration(kin, xtal):
    for (k1, k2), table in _MTSDD_CALIBRATION.items():
        if (abs(kin.k1 - k1) < 1e-6 * abs(k1)
                and abs(kin.k2_0 - k2) < 1e-6 * abs(k2) and xtal in table):
            return _calibrated_kin(kin, table[xtal])
    return kin


def build_model(opt: ExaOptions, props: np.ndarray) -> ECMechModel:
    """Model factory from options + property vector: FCC, BCC or HCP with
    POWERVOCE, POWERVOCENL or MTSDD kinetics."""
    props = np.asarray(props, dtype=float)
    rho0, tol = props[0], props[2]
    if opt.xtal_type in (XtalType.FCC, XtalType.BCC):
        elast = elasticity.cubic(props[3], props[4], props[5])
        n_elast = 3
    elif opt.xtal_type == XtalType.HCP:
        elast = elasticity.hexagonal(*props[3:8])
        n_elast = 5
    else:
        raise ValueError(f"unsupported xtal type {opt.xtal_type}")

    # Mixed f32/f64 precision is safe for the power-law kinetics but not
    # for MTSDD: its thermal branch is near rate-independent, the point
    # Jacobian's condition number at the elastic-plastic transition
    # amplifies the f32 factorization error past O(1), and the f64 polish
    # stops contracting.  MTSDD solves its points fully in f64.
    extra = {}
    if opt.slip_type in (SlipType.POWERVOCE, SlipType.POWERVOCENL):
        kin = kinetics.VocePL.from_props(
            props, nonlinear=opt.slip_type == SlipType.POWERVOCENL)
        extra["h_gd_blend"] = VOCE_H_GD_BLEND
    elif opt.slip_type == SlipType.MTSDD:
        kin = kinetics.KMBalD.from_props(
            props, n_elastic=n_elast,
            g_athermal=opt.xtal_type == XtalType.BCC,
            nslip=24 if opt.xtal_type == XtalType.HCP else 12)
        kin = _apply_mtsdd_calibration(kin, opt.xtal_type)
    else:
        raise ValueError(f"unsupported slip type {opt.slip_type}")

    slip = slip_geom.get_slip_geom(opt.xtal_type.value)
    eos = EosConst(bulk=elast.bulk, gruneisen=props[-2], rho0=rho0,
                   e0=props[-1])
    evptn = EvptnModel(slip=slip, elast=elast, kinetics=kin, eos=eos,
                       solver_tol=max(float(tol), 1e-14),
                       mixed_precision=opt.slip_type != SlipType.MTSDD,
                       **extra)
    return ECMechModel(evptn=evptn, temp_k=opt.temp_k, nslip=slip.nslip,
                       n_h=kin.n_h)
