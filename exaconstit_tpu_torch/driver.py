"""System driver: time stepping, Newton-Krylov solves, BCs, outputs.

Port of ``exaconstit_tpu.driver`` for one device, every single-device
configuration of the reference but ``precision = "f32"``: the voxel
brick (``Mesh.type = "auto"``) or an MFEM mesh file, the strided or the
index gather/scatter-add, EA (and FULL), PA or B-bar assembly, ExaCMech
or UMAT materials, PCG (GMG V-cycle or Jacobi, inside mixed-precision
iterative refinement), MINRES or GMRES; one component-major layout for
all of them.  And the reference's host-side control flow: Newton with
the 3-point line-search fallback (NR) or always line-searching (NRLS),
the BC-change corrector (SolveInit), custom, fixed or automatic dt (the
subdivide retry for the first two), the volume-averaged stress file and
the additional averages, checkpoint/restart and visualization dumps.

Everything runs eagerly; each Newton iteration, PCG iteration and
dogleg iteration reads its stop test on the host.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from . import set_precision_policy
from .config.options import (Assembly, ExaOptions, IntegrationType,
                             KrylovSolver, MechType, MeshType, NLSolver,
                             OriType, parse_options)
from .fem import operators as ops
from .fem.geometry import (adjugate_3x3_cm, det_3x3_cm, grad_calc_cm,
                           jacobians_cm)
from .fem.space import FESpace, IndexMap, StructuredMap
from .io.checkpoint import load_checkpoint, save_checkpoint
from .io.postprocess import write_vis_step
from .mesh.mfem_io import read_mfem_mesh
from .mesh.voxel import HexMesh, make_cartesian_mesh
from .models.ecmech import build_model
from .models.umat import UmatLibrary, UmatModel
from .solvers import gmg
from .solvers.krylov import gmres, minres, pcg_refined

# ----------------------------------------------------------------------------
# Boundary conditions
# ----------------------------------------------------------------------------

_COMPONENTS = {
    0: (False, False, False), 1: (True, False, False),
    2: (False, True, False), 3: (False, False, True),
    4: (True, True, False), 5: (False, True, True),
    6: (True, False, True), 7: (True, True, True),
}


@dataclasses.dataclass
class StepBCs:
    """Resolved boundary conditions for one BC epoch (update step)."""

    ess_mask: np.ndarray  # (nnodes, 3) bool: all constrained dofs
    vel_nodes: np.ndarray  # node ids on active velocity-BC attributes
    vel_values: np.ndarray  # (len(vel_nodes), 3) scale*essVel
    vgrad_mask: np.ndarray  # (nnodes, 3) bool: velocity-gradient BC dofs
    vgrad: np.ndarray  # (3, 3)
    has_vel: bool
    has_vgrad: bool


def resolve_step_bcs(opt: ExaOptions, fes: FESpace, step: int) -> StepBCs:
    """BCManager::updateBCData semantics (reference driver.py:67-114)."""
    active = {}
    for i, c in zip(opt.map_ess_id["total"][step],
                    opt.map_ess_comp["total"][step]):
        if c != 0:
            cur = active.get(i, (False, False, False))
            active[i] = tuple(a or b for a, b in
                              zip(cur, _COMPONENTS[abs(c)]))
    ess_mask = fes.ess_mask(active)

    vals_v = opt.map_ess_vel.get(step, [])
    node_vals = {}
    for i, (attr, c) in enumerate(zip(opt.map_ess_id["ess_vel"][step],
                                      opt.map_ess_comp["ess_vel"][step])):
        if c == 0:
            continue
        scale = np.array(_COMPONENTS[c], dtype=float)
        vel = np.array(vals_v[3 * i:3 * i + 3], dtype=float)
        for n in fes.mesh.bdr_nodes.get(int(attr), []):
            node_vals[int(n)] = vel * scale
    if node_vals:
        vel_nodes = np.array(sorted(node_vals), dtype=np.int32)
        vel_values = np.stack([node_vals[int(n)] for n in vel_nodes])
    else:
        vel_nodes = np.zeros(0, dtype=np.int32)
        vel_values = np.zeros((0, 3))

    active_g = {}
    for attr, c in zip(opt.map_ess_id["ess_vgrad"][step],
                       opt.map_ess_comp["ess_vgrad"][step]):
        if c != 0:
            cur = active_g.get(attr, (False, False, False))
            active_g[attr] = tuple(a or b for a, b in
                                   zip(cur, _COMPONENTS[c]))
    flat = opt.map_ess_vgrad.get(step, [])
    vgrad = np.array(flat, dtype=float).reshape(3, 3) if len(flat) == 9 \
        else np.zeros((3, 3))
    return StepBCs(ess_mask=ess_mask, vel_nodes=vel_nodes,
                   vel_values=vel_values, vgrad_mask=fes.ess_mask(active_g),
                   vgrad=vgrad, has_vel=len(vel_nodes) > 0,
                   has_vgrad=bool(active_g))


# ----------------------------------------------------------------------------
# The mechanics system
# ----------------------------------------------------------------------------


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device with no card present raises
    rather than running on the CPU (pass ``device="cpu"`` for that)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch finds no CUDA device; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return device


class MechSystem:
    """FE space, material model and the per-iteration compute on one
    device, component-major: nodal vectors flat (3*nn,) component planes,
    quadrature-point fields (k, nq*ne) with point index q*ne + e.

    The element map is the strided ``StructuredMap`` on a voxel brick
    and the ``IndexMap`` on any other mesh.  The operator is EA (which
    also serves FULL), PA, or B-bar with EA blocks (B-bar forces EA, as
    the reference has no PA gradient for it).  PA, B-bar and a model
    without the component-major point solve (UMAT) are the reference's
    point-major half (``point_major``), whose numbers the port keeps:
    the point solve starts cold at every setup, and the operator is
    built in f64 even where the point solve is mixed precision.
    Elsewhere ``ea_asm_f32`` builds the 24x24 EA blocks in f32 (default:
    when the model solves its points in mixed precision, as the
    reference does for Voce); the Newton residual stays f64.

    The Krylov solver is ``opt.solver``: PCG in mixed precision (f32
    inner, f64 replay) with the preconditioner ``opt.krylov_precond``
    ("auto" takes GMG on a structured order-1 grid that coarsens, on
    the component-major EA path; else Jacobi), or MINRES or GMRES in
    f64 with Jacobi."""

    def __init__(self, opt: ExaOptions, mesh: HexMesh, model,
                 device="cuda", ea_asm_f32=None):
        self.device = resolve_device(device)
        self.opt = opt
        self.model = model
        self.fes = FESpace.create(mesh)
        self.bbar = opt.integ_type == IntegrationType.BBAR
        self.pa = opt.assembly == Assembly.PA and not self.bbar
        self.point_major = self.bbar or self.pa or model.point_major
        if mesh.structure is not None:
            self.emap = StructuredMap(mesh.structure, mesh.order)
        else:
            self.emap = IndexMap(self.fes.conn, self.fes.num_nodes,
                                 device=self.device)
        f64 = torch.float64
        self.dshape = torch.as_tensor(self.fes.ref.dshape, dtype=f64,
                                      device=self.device)
        self.qwts = torch.as_tensor(self.fes.ref.qwts, dtype=f64,
                                    device=self.device)
        self.nn = self.fes.num_nodes
        self.ne = self.fes.num_elems
        self.nq = self.fes.nqpts
        self.npts = self.ne * self.nq
        mixed = getattr(getattr(model, "evptn", None), "mixed_precision",
                        False)
        self.ea_asm_f32 = not self.point_major and (
            mixed if ea_asm_f32 is None else bool(ea_asm_f32))
        self.gmg_meta = None
        kind = opt.krylov_precond
        eligible = (mesh.structure is not None and self.fes.ref.nnodes == 8
                    and opt.solver == KrylovSolver.PCG
                    and not self.point_major)
        if kind in ("gmg", "auto") and eligible:
            meta = gmg.GMGMeta(mesh.structure)
            if meta.usable:
                self.gmg_meta = meta
            elif kind == "gmg":
                print("gmg preconditioner unavailable (grid does not "
                      "coarsen); using Jacobi")
        elif kind == "gmg":
            print("gmg preconditioner requires PCG on the component-major "
                  "EA path on a structured order-1 mesh; using Jacobi")
        self.precond_kind = "gmg" if self.gmg_meta is not None else "jacobi"
        self.last_newton_stats = {}

    # -- layout adapters (host point-major <-> device component-major) -----

    def to_node(self, arr):
        """Host (nn, 3) nodal field -> flat (3*nn,) f64 device vector."""
        return torch.as_tensor(np.asarray(arr).T.reshape(-1),
                               dtype=torch.float64, device=self.device)

    def from_node(self, dev):
        return dev.cpu().numpy().reshape(3, -1).T

    def to_ess(self, mask):
        return torch.as_tensor(np.asarray(mask).T.reshape(-1),
                               device=self.device)

    def to_state(self, pm):
        """Host (ne, nq, k) qpt field -> (k, nq*ne) device tensor."""
        a = np.asarray(pm)
        return torch.as_tensor(a.transpose(2, 1, 0).reshape(a.shape[2], -1),
                               dtype=torch.float64, device=self.device)

    def from_state(self, dev):
        a = dev.cpu().numpy()
        return a.reshape(a.shape[0], self.nq, self.ne).transpose(2, 1, 0)

    # stress shares the (k, npts) <-> (ne, nq, k) transform
    to_stress = to_state
    from_stress = from_state

    def _ess_flat(self, ess_mask):
        if torch.is_tensor(ess_mask) and ess_mask.ndim == 1:
            return ess_mask
        return self.to_ess(ess_mask)

    def compute_nsub(self, dt):
        """Uniform substep count, frozen for the whole time step."""
        return self.model.substep_counts(dt) or 1

    # -- per-iteration compute ---------------------------------------------

    def _vgrad(self, el_x, el_v):
        J = jacobians_cm(el_x, self.dshape)
        L = grad_calc_cm(el_v, self.dshape, adjugate_3x3_cm(J), det_3x3_cm(J))
        return L.reshape(3, 3, self.npts)

    def _point_update(self, v, x_end, state, dt, nsub, x_warm, warm_ok,
                      compute_tangent):
        """Geometry and the material update at every point; the
        point-major half starts each point solve cold."""
        el_x = self.emap.gather(x_end)
        el_v = self.emap.gather(v)
        if self.point_major:
            x_warm, warm_ok = None, False
        out = self.model.model_setup_cm(
            dt, self._vgrad(el_x, el_v), state,
            compute_tangent=compute_tangent, nsub=nsub, x_warm=x_warm,
            warm_ok=warm_ok, with_solution=True)
        return el_x, out

    def _force(self, el_x, stress):
        stress_q = stress.reshape(6, self.nq, self.ne)
        if self.bbar:
            return ops.residual_force_bbar_cm(el_x, self.dshape, self.qwts,
                                              stress_q)
        return ops.residual_force_cm(el_x, self.dshape, self.qwts, stress_q)

    def setup(self, v, x_beg, state, dt, ess, advance_coords, nsub, x_warm,
              warm_ok):
        """Residual, operator data (EA blocks or the PA tensor), diagonal,
        stress, end state and the point-solve solution (None on the
        point-major half: it carries no warm start) at velocity iterate
        v."""
        x_end = x_beg + dt * v if advance_coords else x_beg
        el_x, (stress, state_end, c6, x_sol) = self._point_update(
            v, x_end, state, dt, nsub, x_warm, warm_ok, True)
        c6_q = c6.reshape(6, 6, self.nq, self.ne)
        nen = self.fes.ref.nnodes
        args = (el_x, self.dshape, self.qwts, c6_q, dt)
        if self.pa:
            k_data = ops.assemble_pa_gradient_cm(*args)
            dloc = ops.pa_diagonal_cm(*args)
        elif self.bbar:
            k_data = ops.assemble_ea_gradient_bbar_cm(*args)
            dloc = ops.ea_diagonal_cm(k_data, nen)
        elif self.ea_asm_f32 and el_x.dtype == torch.float64:
            f32 = torch.float32
            k_data = ops.assemble_ea_gradient_cm(*(
                a.to(f32) for a in args[:4]), dt)
            dloc = ops.ea_diagonal_cm(k_data, nen).to(el_x.dtype)
        else:
            k_data = ops.assemble_ea_gradient_cm(*args)
            dloc = ops.ea_diagonal_cm(k_data, nen)
        force = self._force(el_x, stress)
        r = torch.where(ess, 0.0, self.emap.scatter_add(force))
        diag = torch.where(ess, 1.0, self.emap.scatter_add(dloc))
        return r, k_data, diag, stress, state_end, x_sol

    def residual_only(self, v, x_beg, state, dt, ess, nsub, x_warm,
                      warm_ok):
        el_x, (stress, _, _, _) = self._point_update(
            v, x_beg + dt * v, state, dt, nsub, x_warm, warm_ok, False)
        return torch.where(ess, 0.0,
                           self.emap.scatter_add(self._force(el_x, stress)))

    def apply_k(self, k_data, x):
        """K x with the operator data (promoted to x's dtype)."""
        el_u = self.emap.gather(x)
        if self.pa:
            el_y = ops.apply_pa_gradient_cm(k_data.to(x.dtype),
                                            self.dshape.to(x.dtype), el_u)
        else:
            el_y = ops.apply_ea_gradient_cm(k_data.to(x.dtype), el_u)
        return self.emap.scatter_add(el_y)

    def grad_matvec(self, k_data, x, ess):
        """y = K x with essential-dof identity rows and columns."""
        y = self.apply_k(k_data, torch.where(ess, 0.0, x))
        return torch.where(ess, x, y)

    def krylov_solve(self, k_data, diag, b, ess):
        """PCG in mixed precision (f32 inner, f64 replay) with the GMG
        V-cycle or Jacobi, or MINRES or GMRES in f64 with Jacobi.
        Returns (x, iters, converged, rel_red)."""
        opt = self.opt
        dinv = 1.0 / diag

        def matvec(x):
            return self.grad_matvec(k_data, x, ess)

        def precond(v):
            return dinv * v

        args = (b, opt.krylov_rel_tol, opt.krylov_abs_tol, opt.krylov_iter)
        if opt.solver == KrylovSolver.MINRES:
            return minres(matvec, precond, *args)
        if opt.solver == KrylovSolver.GMRES:
            return gmres(matvec, precond, *args)
        f32 = torch.float32
        k32 = k_data.to(f32)
        dinv32 = dinv.to(f32)

        def matvec32(x):
            return self.grad_matvec(k32, x, ess)

        def precond32(v):
            return dinv32 * v

        if self.gmg_meta is not None:
            levels = gmg.build_hierarchy(self.gmg_meta, k32, ess, matvec32,
                                         diag.to(f32))
            cd = self.gmg_meta.coarse_dense

            def precond32(v):
                return gmg.v_cycle(levels, v, coarse_dense=cd)

            def precond(v):
                return gmg.v_cycle(levels, v.to(f32),
                                   coarse_dense=cd).to(b.dtype)

        return pcg_refined(matvec, precond, matvec32, precond32, *args)

    def vol_avg(self, values_q, el_x, divide=True):
        """Volume-weighted average (or, without ``divide``, the volume
        integral) of a (k, nq, ne) field."""
        wts = ops.quad_point_volumes_cm(el_x, self.dshape, self.qwts)
        s = torch.einsum("qe,kqe->k", wts, values_q)
        return s / torch.sum(wts) if divide else s

    # -- Newton solve ---------------------------------------------------------

    def newton_solve(self, v, x_beg, state, dt, ess_mask, verbose=True):
        """Newton-Krylov with quadratic line-search safeguarding.

        NR takes the full step and falls back to the 3-point quadratic
        line search when the step fails to halve the residual; NRLS
        always line-searches.  The converged point-solve solution of the
        last setup warm-starts the next one."""
        opt = self.opt
        ess = self._ess_flat(ess_mask)
        nsub = self.compute_nsub(dt)
        xw = torch.zeros((8, self.npts), dtype=state.dtype,
                         device=self.device)
        ok = False

        def do_setup(v_it):
            return self.setup(v_it, x_beg, state, dt, ess, True, nsub, xw,
                              ok)

        def do_resid(v_it):
            return self.residual_only(v_it, x_beg, state, dt, ess, nsub, xw,
                                      ok)

        def norm(r):
            return float(torch.linalg.vector_norm(r))

        out = do_setup(v)
        r, k_data, diag, stress, state_end = out[:5]
        xw, ok = out[5], True
        norm0 = nrm = norm(r)
        norm_max = max(opt.newton_rel_tol * norm0, opt.newton_abs_tol)
        it = 0
        kiters, kconv, krelres = [], [], []
        converged = False
        always_ls = opt.nl_solver == NLSolver.NRLS
        while np.isfinite(nrm):
            if verbose:
                print(f"  Newton iteration {it:2d} : ||r|| = {nrm:.6e}" +
                      (f", ||r||/||r_0|| = {nrm / norm0:.6e}" if it else ""))
            if nrm <= norm_max:
                converged = True
                break
            if it >= opt.newton_iter:
                break
            c, kit, kdone, krel = self.krylov_solve(k_data, diag, r, ess)
            kiters.append(int(kit))
            kconv.append(bool(kdone))
            krelres.append(float(krel))
            q1 = nrm

            def quad_ls():
                q3 = norm(do_resid(v - c))
                q2 = norm(do_resid(v - 0.5 * c))
                denom = q1 - 2.0 * q2 + q3
                eps = (3.0 * q1 - 4.0 * q2 + q3) / (4.0 * denom) \
                    if denom != 0 else 1.0
                if denom > 0 and 0 < eps < 1:
                    return eps
                if q3 < q1:
                    return 1.0
                return 0.05

            # release this iteration's large arrays before the next setup
            r = k_data = diag = stress = state_end = out = None
            if always_ls:
                v_new = v - quad_ls() * c
                out = do_setup(v_new)
            else:
                v_new = v - c
                out = do_setup(v_new)
                q_full = norm(out[0])
                if not np.isfinite(q_full) or q_full > 0.5 * q1:
                    scale = quad_ls()
                    if scale != 1.0:
                        v_new = v - scale * c
                        out = do_setup(v_new)
            v = v_new
            r, k_data, diag, stress, state_end = out[:5]
            xw = out[5]
            nrm = norm(r)
            it += 1

        self.last_newton_stats = {
            "nr_iters": it, "krylov_iters": kiters,
            "krylov_converged": kconv, "krylov_relres": krelres,
            "norm0": norm0, "norm": nrm,
        }
        return v, stress, state_end, converged, it, nrm

    def solve_init(self, v_prev, v_new, x_beg, state, dt, ess_mask):
        """BC-change corrector (SystemDriver::SolveInit): one linear solve
        for the jump in the essential velocities, geometry not advanced."""
        ess = self._ess_flat(ess_mask)
        delta = torch.where(ess, v_new - v_prev, 0.0)
        xw = torch.zeros((8, self.npts), dtype=state.dtype,
                         device=self.device)
        r, k_data, diag = self.setup(v_prev, x_beg, state, dt, ess, False,
                                     self.compute_nsub(dt), xw, False)[:3]
        y = torch.where(ess, 0.0, self.apply_k(k_data, delta)) + r
        c = self.krylov_solve(k_data, diag, y, ess)[0]
        return v_prev - c


# ----------------------------------------------------------------------------
# Simulation driver (main time loop)
# ----------------------------------------------------------------------------


def _euler_to_quat(euler):
    """Bunge ZXZ Euler angles (radians) -> quaternions."""
    phi1, Phi, phi2 = euler[:, 0], euler[:, 1], euler[:, 2]
    s, c = np.sin(Phi / 2), np.cos(Phi / 2)
    sig, dlt = (phi1 + phi2) / 2, (phi1 - phi2) / 2
    q = np.stack([c * np.cos(sig), s * np.cos(dlt), s * np.sin(dlt),
                  c * np.sin(sig)], axis=1)
    q[q[:, 0] < 0] *= -1
    return q


class Simulation:
    def __init__(self, opt: ExaOptions, workdir: str | None = None,
                 device="cuda"):
        device = resolve_device(device)
        if opt.precision != "f64":
            raise NotImplementedError(
                "not ported yet: precision other than f64")
        self.opt = opt
        self.workdir = workdir or os.getcwd()
        levels = opt.ser_ref_levels + opt.par_ref_levels
        if opt.mesh_type == MeshType.AUTO:
            gpath = opt.abspath(opt.grain_map)
            gmap = np.loadtxt(gpath).reshape(-1) \
                if opt.cp and os.path.exists(gpath) else None
            self.mesh = make_cartesian_mesh(
                opt.nxyz, opt.mxyz, order=opt.order, grain_map=gmap,
                ref_levels=levels)
        else:  # "other" or "cubit": an MFEM mesh file
            self.mesh = read_mfem_mesh(opt.abspath(opt.mesh_file),
                                       ref_levels=levels, order=opt.order)
        props = np.loadtxt(opt.abspath(opt.props_file)).reshape(-1)
        if props.size != opt.nProps:
            raise ValueError(f"props file has {props.size} values, expected "
                             f"{opt.nProps}")
        self.props = props
        if opt.mech_type == MechType.UMAT:
            # crystal UMATs carry the per-grain orientation rows inside
            # the state variables (spliced in below)
            self._ori_stride = {OriType.QUAT: 4, OriType.EULER: 3}.get(
                opt.ori_type, opt.grain_custom_stride) if opt.cp else 0
            self.model = UmatModel(
                lib=UmatLibrary(opt.abspath(opt.umat_library)), props=props,
                num_user_state=opt.numStateVars + self._ori_stride,
                temp_k=opt.temp_k)
        else:
            self.model = build_model(opt, props)
        self.system = MechSystem(opt, self.mesh, self.model, device=device)
        sysm = self.system
        state0 = (self._umat_state() if opt.mech_type == MechType.UMAT
                  else self._ecmech_state())
        self.state = sysm.to_state(state0.reshape(sysm.ne, sysm.nq, -1))
        self.stress = torch.zeros((6, sysm.npts), dtype=torch.float64,
                                  device=sysm.device)

        self.x_ref = sysm.to_node(self.mesh.coords)
        self.x_beg = self.x_ref
        self.x_cur = self.x_ref
        self.v = torch.zeros_like(self.x_ref)

        if opt.dt_cust:
            dts = np.loadtxt(opt.abspath(opt.dt_file)).reshape(-1)
            if dts.size < opt.nsteps:
                raise ValueError(f"{opt.dt_file} has {dts.size} steps, "
                                 f"expected {opt.nsteps}")
            self.cust_dt = dts[:opt.nsteps]
            self.t_final = float(self.cust_dt.sum())
            self.nsteps = opt.nsteps
        else:
            self.cust_dt = None
            self.t_final = opt.t_final
            self.nsteps = int(np.ceil(opt.t_final / opt.dt_min))
        self.dt_auto_cur = opt.dt  # automatic stepping: the next dt

        self.bc_steps = {s: resolve_step_bcs(opt, sysm.fes, s)
                         for s in opt.updateStep}
        self.update_steps = set(opt.updateStep)
        self.cur_bcs = self.bc_steps[1]
        self.step_times = []
        self.step_stats = []
        self.vis_entries = []
        self.visualize = (opt.visit or opt.conduit or opt.paraview
                          or opt.adios2)

    def _ecmech_state(self):
        """Initial point-major state: the orientation file's quaternions
        per grain in the model's own initial history (ExaCMech
        overwrites every other slot of the state file)."""
        opt = self.opt
        ori = np.loadtxt(opt.abspath(opt.ori_file)).reshape(-1)
        if opt.ori_type == OriType.QUAT or (
                opt.ori_type == OriType.CUSTOM
                and opt.grain_custom_stride == 4
                and opt.grain_statevar_offset == self.model.IND_QUATS):
            quats = ori.reshape(opt.ngrains, 4)
            quats = quats / np.linalg.norm(quats, axis=1, keepdims=True)
        elif opt.ori_type == OriType.EULER:
            quats = _euler_to_quat(ori.reshape(opt.ngrains, 3))
        else:
            raise ValueError(
                "ExaCMech models require quaternion orientation data in the "
                f"history quaternion slot; got ori_type={opt.ori_type} "
                f"stride={opt.grain_custom_stride} "
                f"loc={opt.grain_statevar_offset}")
        grain_ids = self.mesh.elem_attr.astype(int) - 1
        return self.model.init_state(
            np.repeat(quats[grain_ids], self.system.nq, axis=0))

    def _umat_state(self):
        """Initial point-major UMAT state: F = I, zero stress, and the
        state file's values at every point, with a crystal UMAT's
        orientation rows spliced in at ``grain_statevar_offset`` (< 0:
        at the end)."""
        opt = self.opt
        nq, npts = self.system.nq, self.system.npts
        sv = np.loadtxt(opt.abspath(opt.state_file)).reshape(-1)
        if sv.size != opt.numStateVars:
            raise ValueError(f"state file has {sv.size} values, expected "
                             f"{opt.numStateVars}")
        if opt.cp:
            ori = np.loadtxt(opt.abspath(opt.ori_file)).reshape(
                opt.ngrains, self._ori_stride)
            loc = opt.grain_statevar_offset
            if loc < 0:
                loc = sv.size
            per_grain = np.concatenate(
                [np.tile(sv[:loc], (opt.ngrains, 1)), ori,
                 np.tile(sv[loc:], (opt.ngrains, 1))], axis=1)
            grain_ids = self.mesh.elem_attr.astype(int) - 1
            statev0 = np.repeat(per_grain[grain_ids], nq, axis=0)
        else:
            statev0 = np.tile(sv, (npts, 1))
        state0 = self.model.init_state(npts=npts)
        state0[:, 15:] = statev0
        return state0

    def update_velocity(self):
        """Essential velocities (and velocity-gradient BCs) into v."""
        bcs = self.cur_bcs
        sysm = self.system
        v = sysm.from_node(self.v).copy()
        if bcs.has_vel:
            v[bcs.vel_nodes] = bcs.vel_values
        if bcs.has_vgrad:
            x = sysm.from_node(self.x_cur)
            origin = (np.asarray(self.opt.vgrad_origin)
                      if self.opt.vgrad_origin_flag else x.min(axis=0))
            v_full = (x - origin) @ bcs.vgrad.T
            v[bcs.vgrad_mask] = v_full[bcs.vgrad_mask]
        self.v = sysm.to_node(v)

    def advance(self, ti, dt, verbose=True):
        """One time step of size dt; returns the dt it took (automatic
        time stepping may cut it)."""
        opt = self.opt
        sysm = self.system
        x_sub = None
        subdivided = 1
        if ti in self.update_steps:
            if verbose and ti != 1:
                print(f"Changing boundary conditions this step: {ti}")
            v_prev = self.v
            self.cur_bcs = self.bc_steps[ti]
            self.update_velocity()
            self.v = sysm.solve_init(v_prev, self.v, self.x_beg, self.state,
                                     dt, self.cur_bcs.ess_mask)
        self.update_velocity()

        if opt.dt_auto:
            # up to two retries at dt * dt_scale, then dt grows (or
            # shrinks) for the next step by newton_iter * dt_scale / nit
            v_save = self.v
            attempts = 0
            while True:
                v, stress, state_end, conv, nit, _ = sysm.newton_solve(
                    self.v, self.x_beg, self.state, dt,
                    self.cur_bcs.ess_mask, verbose)
                if conv or attempts >= 2:
                    break
                print("WARNING: Solution did not converge; decreasing dt")
                self.v = v_save
                dt = max(dt * opt.dt_scale, opt.dt_min)
                attempts += 1
            if conv:
                factor = opt.newton_iter * opt.dt_scale / max(nit, 1)
                self.dt_auto_cur = max(dt * factor, opt.dt_min)
                self._append_file(opt.dt_file, f"{dt:.12g}\n")
        else:
            v, stress, state_end, conv, nit, _ = sysm.newton_solve(
                self.v, self.x_beg, self.state, dt, self.cur_bcs.ess_mask,
                verbose)
        if not conv and not opt.dt_auto:
            # ExaConstit aborts here; as the JAX package does, subdivide
            # the step and compose the sub-solves instead (essential velocities are rates, so
            # x_end = x + sum_k (dt/n) v_k)
            for nsub in (2, 4, 8):
                if verbose:
                    print(f"WARNING: Newton failed at dt={dt:g}; "
                          f"retrying with {nsub} substeps")
                got = self._solve_subdivided(dt, nsub, verbose)
                if got is not None:
                    v, stress, state_end, x_sub = got
                    conv, subdivided = True, nsub
                    break
        if not conv:
            raise RuntimeError("Newton Solver did not converge.")

        # Newton and Krylov counts of the last solve, the first solve's
        # NR count, and the number of sub-solves the step took
        self.step_stats.append(dict(sysm.last_newton_stats, first_nr=nit,
                                    subdivided=subdivided))
        self.v = v
        self.x_cur = x_sub if x_sub is not None else self.x_beg + dt * v
        # state_prev is the state the step began from: the plastic
        # deformation rate output reads it, so that output lags one step,
        # as the reference's does
        self.state_prev = self.state
        self.stress = stress
        self.state = state_end
        self.x_beg = self.x_cur
        return dt

    def _solve_subdivided(self, dt, nsub, verbose):
        """One scheduled step as ``nsub`` composed sub-solves; commits
        nothing, returns (v, stress, state_end, x_end) or None."""
        sysm = self.system
        v, x, state = self.v, self.x_beg, self.state
        dts = dt / nsub
        for _ in range(nsub):
            v, stress, state_end, conv, _, _ = sysm.newton_solve(
                v, x, state, dts, self.cur_bcs.ess_mask, verbose)
            if not conv:
                return None
            x = x + dts * v
            state = state_end
        return v, stress, state, x

    def _append_file(self, name, text):
        with open(os.path.join(self.workdir, name), "a") as f:
            f.write(text)

    def write_averages(self):
        """Append this step's row to the average stress file and, with
        ``additional_avgs``, to the plastic work, deformation gradient and
        plastic deformation rate files."""
        opt = self.opt
        sysm = self.system

        def row(values):
            return " ".join(f"{v:.6g}" for v in values.cpu().numpy()) + "\n"

        el_x = sysm.emap.gather(self.x_cur)
        self._append_file(opt.avg_stress_fname, row(sysm.vol_avg(
            self.stress.reshape(6, sysm.nq, -1), el_x)))
        if not opt.additional_avgs:
            return
        ecmech = opt.mech_type == MechType.EXACMECH
        if ecmech:  # a UMAT reports no plastic work
            off, _ = self.model.qf_mapping["pl_work"]
            self._append_file(opt.avg_pl_work_fname, row(sysm.vol_avg(
                self.state[off:off + 1].reshape(1, sysm.nq, -1), el_x,
                divide=False)))
        # average deformation gradient F = d x_cur / d X over the
        # reference volume, as a column-major 9-vector
        el_X = sysm.emap.gather(self.x_ref)
        Jref = jacobians_cm(el_X, sysm.dshape)
        F = grad_calc_cm(el_x, sysm.dshape, adjugate_3x3_cm(Jref),
                         det_3x3_cm(Jref))  # (3, 3, nq, ne)
        self._append_file(opt.avg_def_grad_fname, row(sysm.vol_avg(
            F.transpose(0, 1).reshape(9, sysm.nq, -1), el_X)))
        if not ecmech:  # nor a plastic deformation rate
            return
        # plastic deformation rate from the state the step began from,
        # column-major (0, 4, 8, 5, 2, 1) -> svec
        dp = self.model.dp_mat_cm(getattr(self, "state_prev", self.state))
        dp9 = sysm.vol_avg(dp.transpose(0, 1).reshape(9, sysm.nq, -1), el_x)
        self._append_file(opt.avg_dp_tensor_fname,
                          row(dp9[[0, 4, 8, 5, 2, 1]]))

    def run(self, verbose=True):
        opt = self.opt
        t = 0.0
        ti = 1
        ckpt_path = os.path.join(self.workdir, opt.checkpoint_dir,
                                 "checkpoint.npz")
        if opt.restart and os.path.exists(ckpt_path):
            t, ti_done = load_checkpoint(ckpt_path, self)
            ti = ti_done + 1
            if verbose:
                print(f"restarted from checkpoint at step {ti_done}, "
                      f"t = {t:.6g}")
        while ti <= self.nsteps or (opt.dt_auto
                                    and t < self.t_final - 1e-14):
            if self.cust_dt is not None:
                dt = float(self.cust_dt[ti - 1])
            elif opt.dt_auto:
                dt = min(self.dt_auto_cur, self.t_final - t)
            else:
                dt = min(opt.dt, self.t_final - t)
            if verbose:
                print(f"step {ti}, dt = {dt:.6g}")
            t0 = time.perf_counter()
            dt = self.advance(ti, dt, verbose)
            if self.system.device.type == "cuda":
                torch.cuda.synchronize(self.system.device)
            self.step_times.append(time.perf_counter() - t0)
            t += dt
            last = abs(t - self.t_final) <= abs(1e-3 * dt)
            self.write_averages()
            if opt.checkpoint_steps > 0 and ti % opt.checkpoint_steps == 0:
                save_checkpoint(ckpt_path, self, t, ti)
            if self.visualize and (last or ti % opt.vis_steps == 0):
                write_vis_step(self, ti, t, self.vis_entries)
            if verbose:
                print(f"step {ti} done, t = {t:.6g} "
                      f"({self.step_times[-1]:.2f}s)")
            if last:
                break
            ti += 1
        return t


def run_simulation(toml_path: str, workdir: str | None = None,
                   verbose: bool = True, device="cuda"):
    """Parse the options file and run the whole simulation on ``device``
    (default: the card; ``device="cpu"`` runs on the CPU)."""
    set_precision_policy()
    opt = parse_options(toml_path)
    with torch.inference_mode():
        sim = Simulation(opt, workdir=workdir, device=device)
        sim.run(verbose=verbose)
    return sim
