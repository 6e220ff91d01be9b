"""System driver: time stepping, Newton-Krylov solves, BCs, outputs.

Port of ``exaconstit_tpu.driver`` for one device, every single-device
configuration of the reference, in f64 or (``precision = "f32"``) in
f32 throughout: the voxel
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
dogleg iteration reads its stop test on the host.  As in the reference,
``EXACONSTIT_TPU_REGIONS`` turns on the region timings
(``utils/profiling.py``: the reference's three regions, the port's spans
of the corrector, the averages, the Newton solve, the point update, the
operator build and apply and the GMG V-cycle, and its counters of host
reads and Krylov and point-solve iterations, timed by CUDA events; the
card is waited for once a Newton solve, when its stats take the
regions' delta) and
``EXACONSTIT_CHECK_NUMERICS`` the layer guards (``utils/guards.py``),
both read when a ``MechSystem`` is built.

Spread over shards (``Simulation(shards=...)``, the CLI's ``--shards``
or one shard per rank of a process group) a run takes, as the
reference's ``Simulation`` does on a device mesh, the slab domain
decomposition (``parallel/slab_system.SlabMechSystem``) or the
replicated-node element sharding (``MechSystem`` on a
``parallel/replicated.ReplicatedMap``); every host step here is the
same on every rank, and only rank 0 writes files.
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
from .fem import ea_apply_cuda, pa_apply_cuda
from .fem.geometry import (adjugate_3x3_cm, det_3x3_cm, grad_calc_cm,
                           jacobians_cm)
from .fem.space import FESpace, IndexMap, StructuredMap
from .io.checkpoint import load_checkpoint, save_checkpoint
from .io.postprocess import write_vis_step
from .mesh.mfem_io import read_mfem_mesh
from .mesh.voxel import HexMesh, make_cartesian_mesh
from .models.ecmech import build_model
from .models.umat import UmatLibrary, UmatModel
from .parallel import sharding
from .parallel.replicated import ReplicatedMap
from .solvers import gmg
from .solvers.krylov import gmres, minres, pcg, pcg_refined
from .utils import profiling
from .utils.guards import (FiniteTally, check_finite,
                           numerics_checks_enabled)
from .utils.profiling import Regions

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


def run_dtype(opt: ExaOptions) -> torch.dtype:
    """The run's floating type: f32 runs the whole stack in f32, as the
    reference does with x64 off; anything else in f64.
    ``EXACONSTIT_TPU_PRECISION``, when it is set, decides, as the
    reference's global x64 switch does: "f32" (any case) gives f32, any
    other value (the empty string included) f64.  Unset, the options
    file's ``precision`` decides."""
    precision = os.environ.get("EXACONSTIT_TPU_PRECISION")
    if precision is None:
        precision = opt.precision
    return torch.float32 if precision.lower() == "f32" else torch.float64


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device with no card present raises
    rather than running on the CPU (pass ``device="cpu"`` for that)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch finds no CUDA device; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return device


# one device's setup takes its elements in chunks of about this many
# points, and an f64 run above this many stores its EA blocks in f32
# (the reference's constants, exaconstit_tpu/driver.py:438,452)
SETUP_CHUNK_POINTS = 262_144
EA_F32_POINTS = 1_500_000


def setup_chunk_count(ne, nq, requested="auto", sharded=False) -> int:
    """The number of element chunks one setup takes, the reference's rule:
    "auto" takes ceil(ne * nq / SETUP_CHUNK_POINTS), an integer (or its
    string) itself; at most ``ne``, lowered until it divides ``ne``; a
    sharded map takes 1."""
    if sharded:
        return 1
    if requested == "auto":
        target = -(-ne * nq // SETUP_CHUNK_POINTS)
    else:
        target = int(requested)
    nc = min(max(1, target), ne)
    while ne % nc:
        nc -= 1
    return nc


def _switch(value, variable):
    """``value`` if given, else the environment's ``variable``: "auto"
    (also when unset), or True for "1" and False for anything else."""
    if value is not None:
        return value
    env = os.environ.get(variable, "auto")
    return env if env == "auto" else env == "1"


class MechSystem:
    """FE space, material model and the per-iteration compute on one
    device, component-major: nodal vectors flat (3*nn,) component planes,
    quadrature-point fields (k, nq*ne) with point index q*ne + e.

    The element map is the strided ``StructuredMap`` on a voxel brick
    and the ``IndexMap`` on any other mesh; on an order-1 ``IndexMap``
    the PA apply is ``fem/pa_apply_cuda.pa_apply`` (the hand-written
    kernel pair on the card, the plain version on the CPU), and every
    other map keeps the plain contraction and its own scatter.  The
    operator is EA (which also serves FULL), PA, or B-bar with EA blocks
    (B-bar forces EA, as the reference has no PA gradient for it).  PA,
    B-bar and a model without the component-major point solve (UMAT, and
    an ECMech model whose settings only the per-point engine covers,
    which runs through its point-major ``model_setup``) are the
    reference's point-major half (``point_major``), whose numbers the
    port keeps:
    the point solve starts cold at every setup, and the operator is
    built in f64 even where the point solve is mixed precision.
    Elsewhere ``ea_asm_f32`` builds the 24x24 EA blocks in f32 (default:
    when the model solves its points in mixed precision, as the
    reference does for Voce), and ``ea_f32`` builds them in f64 and
    stores them in f32, the diagonal taken before the cast (default:
    above ``EA_F32_POINTS`` points over all shards, pads included); the
    Newton residual stays f64.  There the setup and the line-search
    residual take the elements in ``setup_chunks`` contiguous chunks
    (``setup_chunk_count``: chunks of about ``SETUP_CHUNK_POINTS`` points
    by default on one device, one over shards), each output written in
    place into one array of full size, so that the point solve's
    temporaries are those of one chunk.

    The Krylov solver is ``opt.solver``: PCG in mixed precision (f32
    inner, f64 replay) with the preconditioner ``opt.krylov_precond``
    ("auto" takes GMG on a structured order-1 grid that coarsens, on
    the component-major EA path; else Jacobi), or MINRES or GMRES in
    f64 with Jacobi.

    On an f32 run (``dtype``, ``run_dtype(opt)``) coordinates, state,
    residual and operator are f32, the EA blocks are built in the run's
    f32, PCG is the plain f32 ``pcg`` (GMG built on the f32 blocks, or
    Jacobi) and the point solve is the plain f32 trust region: the
    kernel's mixed-precision stage needs an f64 run, as the reference's
    does.

    A caller's ``emap`` over shards of the mesh (``emap.layout``, this
    rank's ``emap.ne`` elements, pads included, with ``emap.real`` the
    real ones) stands for the reference's device mesh: the system never
    takes GMG, and the volume averages and the largest deformation rate
    leave out the pad elements and add up over all shards.  The element
    map's scatter-add skips the pads, which zeroes their force, operator
    and diagonal as the reference's element mask does.  The
    replicated-node ``parallel/replicated.ReplicatedMap`` keeps the
    point-major half, the f32 EA build and the warm starts of one
    device, as the reference does; the slab's ``SlabMap``
    (``warm_everywhere``) warm-starts every point solve, and its system
    asks for the f64 EA build.

    The switches the reference reads from the environment when it is
    built are read here when an argument is None: ``setup_chunks``
    (``EXACONSTIT_SETUP_CHUNKS``, "auto" or a count), ``ea_f32``
    (``EXACONSTIT_EA_F32``: "auto", "1", "0"), ``ea_asm_f32``
    (``EXACONSTIT_EA_ASM_F32``, the same), ``warm_start``
    (``EXACONSTIT_WARM_START=0`` starts every point solve cold), the
    preconditioner (``EXACONSTIT_PRECOND`` over ``opt.krylov_precond``;
    ``rebuild_krylov`` swaps it on a live system),
    ``EXACONSTIT_TPU_NO_CM=1``, which puts any model on the point-major
    half, and ``EXACONSTIT_TPU_NO_STRUCT=1``, which gives a voxel brick
    the ``IndexMap`` (GMG stays eligible: it reads the mesh's structure,
    not the map)."""

    def __init__(self, opt: ExaOptions, mesh: HexMesh, model,
                 device="cuda", ea_asm_f32=None, emap=None,
                 setup_chunks=None, ea_f32=None, warm_start=None):
        self.device = resolve_device(device)
        self.dtype = run_dtype(opt)
        self.opt = opt
        self.model = model
        self.fes = FESpace.create(mesh)
        self.bbar = opt.integ_type == IntegrationType.BBAR
        self.pa = opt.assembly == Assembly.PA and not self.bbar
        sharded = emap is not None
        self.layout = emap.layout if sharded else None
        no_cm = os.environ.get("EXACONSTIT_TPU_NO_CM") == "1"
        self.point_major = (self.bbar or self.pa or model.point_major
                            or no_cm) \
            and not getattr(emap, "warm_everywhere", False)
        if sharded:
            self.emap = emap
        elif mesh.structure is not None \
                and os.environ.get("EXACONSTIT_TPU_NO_STRUCT") != "1":
            self.emap = StructuredMap(mesh.structure, mesh.order)
        else:
            self.emap = IndexMap(self.fes.conn, self.fes.num_nodes,
                                 device=self.device)
        self.dshape = torch.as_tensor(self.fes.ref.dshape, dtype=self.dtype,
                                      device=self.device)
        self._dshapes = {self.dtype: self.dshape}
        # the PA apply's kernel pair: an order-1 mesh on one device's
        # index map (the strided and the sharded maps keep their scatter)
        self.pa_kernel = self.pa and isinstance(self.emap, IndexMap) \
            and self.fes.ref.dshape.shape == (pa_apply_cuda.NQ,
                                              pa_apply_cuda.NEN, 3)
        self.qwts = torch.as_tensor(self.fes.ref.qwts, dtype=self.dtype,
                                    device=self.device)
        self.nn = self.fes.num_nodes
        self.ne = emap.ne if sharded else self.fes.num_elems
        self.nq = self.fes.nqpts
        self.npts = self.ne * self.nq
        f64_cm = not self.point_major and self.dtype == torch.float64
        mixed = getattr(getattr(model, "evptn", None), "mixed_precision",
                        False)
        asm = _switch(ea_asm_f32, "EXACONSTIT_EA_ASM_F32")
        self.ea_asm_f32 = f64_cm and (mixed if asm == "auto" else asm)
        store = _switch(ea_f32, "EXACONSTIT_EA_F32")
        if store == "auto":  # the global point count, pads included
            store = self.nq * (emap.ne_pad if sharded else self.ne) \
                > EA_F32_POINTS
        self.ea_f32 = f64_cm and (self.ea_asm_f32 or store)
        self.ea_dtype = torch.float32 if self.ea_f32 else self.dtype
        chunks = os.environ.get("EXACONSTIT_SETUP_CHUNKS", "auto") \
            if setup_chunks is None else setup_chunks
        self.setup_chunks = 1 if self.point_major else setup_chunk_count(
            self.ne, self.nq, chunks, sharded)
        self.warm_start = (os.environ.get("EXACONSTIT_WARM_START", "1")
                           != "0") if warm_start is None else warm_start
        self._mesh = mesh
        self._sharded = sharded
        self.rebuild_krylov(os.environ.get("EXACONSTIT_PRECOND",
                                           opt.krylov_precond))
        self.last_newton_stats = {}
        # region and span times and the counters (opt-in), and the layer
        # guards
        self.regions = Regions() if os.environ.get(
            "EXACONSTIT_TPU_REGIONS") else None
        self.check_numerics = numerics_checks_enabled()

    # -- layout adapters (host point-major <-> device component-major) -----

    def to_node(self, arr):
        """Host (nn, 3) nodal field -> flat (3*nn,) device vector."""
        return torch.as_tensor(np.asarray(arr).T.reshape(-1),
                               dtype=self.dtype, device=self.device)

    def from_node(self, dev):
        return dev.cpu().numpy().reshape(3, -1).T

    def to_ess(self, mask):
        return torch.as_tensor(np.asarray(mask).T.reshape(-1),
                               device=self.device)

    def _gather_ranks(self, dev):
        """(world_size, *dev.shape) host array of every rank's ``dev``
        (collective over shards: every rank must reach it)."""
        if self.layout is None:
            return dev.cpu().numpy()[None]
        return self.layout.allgather_blocks(dev).cpu().numpy()

    def to_state(self, pm):
        """Host (ne, nq, k) qpt field -> (k, nq*ne) device tensor; its
        real elements' rows, whatever padding ``pm`` has.  Over shards
        this rank's elements of the list padded with element 0's rows."""
        a = np.asarray(pm)[:self.fes.num_elems]
        if self.layout is not None:
            emap = self.emap
            a = np.concatenate([a, np.repeat(a[:1], emap.ne_pad - len(a),
                                             axis=0)])
            first = self.layout.first * emap.ne_per
            a = a[first:first + self.ne]
        return torch.as_tensor(a.transpose(2, 1, 0).reshape(a.shape[2], -1),
                               dtype=self.dtype, device=self.device)

    def from_state(self, dev):
        """(k, nq*ne) -> host (ne, nq, k); over shards (ne_pad, nq, k),
        gathered over the ranks, as the reference's checkpoint holds it."""
        a = self._gather_ranks(dev)
        a = a.reshape(a.shape[0], a.shape[1], self.nq, self.ne)
        return a.transpose(0, 3, 2, 1).reshape(-1, self.nq, a.shape[1])

    # stress shares the (k, npts) <-> (ne, nq, k) transform
    to_stress = to_state
    from_stress = from_state

    def from_elem(self, dev):
        """(k, ne) per-element device field -> host (ne, k) over the real
        elements (gathered over the ranks)."""
        a = self._gather_ranks(dev).transpose(0, 2, 1)
        return a.reshape(-1, a.shape[2])[:self.fes.num_elems]

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
        return L.reshape(3, 3, -1)

    def _check(self, layer, **tensors):
        if self.check_numerics:
            check_finite(layer, **tensors)

    def _over_chunks(self, core, v, x_end, state, dt, nsub, x_warm,
                     warm_ok, point_fields):
        """``core``'s outputs at velocity ``v`` and coordinates ``x_end``
        over the setup's element chunks [e0, e0 + nec): each chunk's
        element vectors as views, its point fields (point index q*ne + e)
        as contiguous copies, and each output written in place into one
        array of full size (``point_fields`` flags the (k, nq*ne) point
        fields among them, the rest are (..., ne) element fields), so
        that a chunk's temporaries are gone before the next one starts.
        The layer guards read once, over every chunk."""
        el_x = self.emap.gather(x_end)
        el_v = self.emap.gather(v)
        if self.point_major:  # its point solves start cold
            x_warm, warm_ok = None, False
        tally = FiniteTally(self.check_numerics)
        nc = self.setup_chunks
        if nc == 1:
            outs = core(el_x, el_v, state, x_warm, dt, nsub, warm_ok, tally)
            tally.check()
            return outs
        nec, nq, ne = self.ne // nc, self.nq, self.ne

        def points(a, e):
            if a is None:
                return None
            return a.reshape(a.shape[0], nq, ne)[:, :, e].reshape(
                a.shape[0], -1)

        outs = None
        for c in range(nc):
            e = slice(c * nec, (c + 1) * nec)
            got = core(el_x[..., e], el_v[..., e], points(state, e),
                       points(x_warm, e), dt, nsub, warm_ok, tally)
            if outs is None:
                outs = [None if g is None else g.new_empty(
                    (g.shape[0], self.npts) if pt else (*g.shape[:-1], ne))
                    for g, pt in zip(got, point_fields)]
            for o, g, pt in zip(outs, got, point_fields):
                if g is None:
                    continue
                if pt:
                    o.view(o.shape[0], nq, ne)[:, :, e] = g.view(
                        g.shape[0], nq, nec)
                else:
                    o[..., e] = g
            del got
        tally.check()
        return outs

    def _point_update(self, el_x, el_v, state, dt, nsub, x_warm, warm_ok,
                      compute_tangent, tally):
        """The velocity gradient and the material update at the points of
        the elements of ``el_x`` and ``el_v`` (all of them or a chunk)."""
        vgrad = self._vgrad(el_x, el_v)
        tally.add("velocity gradient", vgrad=vgrad)
        if getattr(self.model, "supports_cm", True):
            out = self.model.model_setup_cm(
                dt, vgrad, state, compute_tangent=compute_tangent,
                nsub=nsub, x_warm=x_warm, warm_ok=warm_ok,
                with_solution=True)
        else:  # the per-point engine, point-major as the reference's
            stress, state_end, c6 = self.model.model_setup(
                dt, vgrad.permute(2, 0, 1), state.T,
                compute_tangent=compute_tangent, nsub=nsub)
            out = (stress.T, state_end.T,
                   None if c6 is None else c6.permute(1, 2, 0), None)
        tally.add("point solve", stress=out[0], state=out[1],
                  tangent=out[2])
        return out

    def _force(self, el_x, stress):
        stress_q = stress.reshape(6, self.nq, -1)
        if self.bbar:
            return ops.residual_force_bbar_cm(el_x, self.dshape, self.qwts,
                                              stress_q)
        return ops.residual_force_cm(el_x, self.dshape, self.qwts, stress_q)

    def _setup_core(self, el_x, el_v, state, x_warm, dt, nsub, warm_ok,
                    tally):
        """(force, operator data, its local diagonal, stress, end state,
        point solution) of the elements of ``el_x`` (all or a chunk)."""
        stress, state_end, c6, x_sol = self.span(
            "setup.point_update", self._point_update, el_x, el_v, state, dt,
            nsub, x_warm, warm_ok, True, tally)
        k_data, dloc = self.span("setup.operator_build", self._build_operator,
                                 el_x, c6.reshape(6, 6, self.nq, -1), dt)
        tally.add("operator", operator_data=k_data)
        return (self._force(el_x, stress), k_data, dloc, stress, state_end,
                x_sol)

    def _build_operator(self, el_x, c6_q, dt):
        """(operator data, its local diagonal): the PA tensor, or the EA
        or B-bar blocks, of the elements of ``el_x``."""
        nen = self.fes.ref.nnodes
        args = (el_x, self.dshape, self.qwts, c6_q, dt)
        if self.pa:
            k_data = ops.assemble_pa_gradient_cm(*args)
            dloc = ops.pa_diagonal_cm(*args)
        elif self.bbar:
            k_data = ops.assemble_ea_gradient_bbar_cm(*args)
            dloc = ops.ea_diagonal_cm(k_data, nen)
        elif self.ea_asm_f32:
            f32 = torch.float32
            k_data = ops.assemble_ea_gradient_cm(*(
                a.to(f32) for a in args[:4]), dt)
            dloc = ops.ea_diagonal_cm(k_data, nen).to(el_x.dtype)
        else:
            k_data = ops.assemble_ea_gradient_cm(*args)
            dloc = ops.ea_diagonal_cm(k_data, nen)
            if self.ea_dtype != k_data.dtype:
                # the diagonal at full precision, then f32 storage (a copy
                # of the diagonal, so the f64 blocks are not kept alive)
                dloc = dloc.clone()
                k_data = k_data.to(self.ea_dtype)
        return k_data, dloc

    def _resid_core(self, el_x, el_v, state, x_warm, dt, nsub, warm_ok,
                    tally):
        stress = self.span("setup.point_update", self._point_update, el_x,
                           el_v, state, dt, nsub, x_warm, warm_ok, False,
                           tally)[0]
        return (self._force(el_x, stress),)

    def setup(self, v, x_beg, state, dt, ess, advance_coords, nsub, x_warm,
              warm_ok):
        """Residual, operator data (EA blocks or the PA tensor), diagonal,
        stress, end state and the point-solve solution (None on the
        point-major half, which starts each point solve cold) at velocity
        iterate v, over ``setup_chunks`` element chunks."""
        x_end = x_beg + dt * v if advance_coords else x_beg
        force, k_data, dloc, stress, state_end, x_sol = self._over_chunks(
            self._setup_core, v, x_end, state, dt, nsub, x_warm, warm_ok,
            (False, False, False, True, True, True))
        r = torch.where(ess, 0.0, self.emap.scatter_add(force))
        diag = torch.where(ess, 1.0, self.emap.scatter_add(dloc))
        self._check("diagonal", diagonal=diag)
        self._check("residual", residual=r)
        return r, k_data, diag, stress, state_end, x_sol

    def residual_only(self, v, x_beg, state, dt, ess, nsub, x_warm,
                      warm_ok):
        """The residual alone at velocity iterate v (the line search's),
        over the setup's element chunks."""
        force, = self._over_chunks(self._resid_core, v, x_beg + dt * v,
                                   state, dt, nsub, x_warm, warm_ok,
                                   (False,))
        r = torch.where(ess, 0.0, self.emap.scatter_add(force))
        self._check("residual", residual=r)
        return r

    def dshape_as(self, dtype):
        """The reference shape gradients in ``dtype``, cast once."""
        if dtype not in self._dshapes:
            self._dshapes[dtype] = self.dshape.to(dtype)
        return self._dshapes[dtype]

    def apply_k(self, k_data, x):
        """K x with the operator data: the PA tensor promoted to x's
        dtype, on an order-1 index map through ``pa_apply_cuda.pa_apply``
        (the kernel pair on the card, the plain version on the CPU); the
        EA blocks as stored, through ``ops.apply_ea`` (on the card's
        strided map the kernel pair of ``ea_apply_cuda``, which promotes
        f32 blocks to an f64 x in registers; elsewhere the blocks cast to
        x's dtype)."""
        if self.pa:
            apply = pa_apply_cuda.pa_apply if self.pa_kernel \
                else pa_apply_cuda.pa_apply_reference
            return apply(k_data.to(x.dtype), self.dshape_as(x.dtype), x,
                         self.emap)
        return ops.apply_ea(k_data, self.emap, x)

    def grad_matvec(self, k_data, x, ess):
        """y = K x with essential-dof identity rows and columns, the apply
        recorded as span ``operator.apply``."""
        return ops.masked_apply(lambda v: self.span(
            "operator.apply", self.apply_k, k_data, v), x, ess)

    def dot(self, a, b):
        """Inner product of two nodal vectors: PCG's and the norms'."""
        return torch.dot(a, b)

    def norm(self, r):
        """Norm of a nodal vector (Newton's stop test), a 0-d tensor."""
        return torch.linalg.vector_norm(r)

    def rebuild_krylov(self, precond_kind="jacobi"):
        """Choose the Krylov solve's preconditioner on a live system (the
        reference's ``rebuild_krylov``; the setup is not rebuilt): "gmg"
        or "auto" take the GMG V-cycle where it applies (PCG on the
        single-device component-major EA path on a structured order-1
        grid that coarsens), else Jacobi, which "gmg" says; anything else
        takes Jacobi.  It also reads ``opt.mixed_krylov`` (default True:
        the f64 run's PCG in mixed precision), as the reference does."""
        opt = self.opt
        mesh = self._mesh
        self.mixed_krylov = getattr(opt, "mixed_krylov", True)
        self.gmg_meta = None
        self._cycle_graphs = None
        eligible = (mesh.structure is not None and self.fes.ref.nnodes == 8
                    and opt.solver == KrylovSolver.PCG
                    and not self.point_major and not self._sharded)
        if precond_kind in ("gmg", "auto") and eligible:
            meta = gmg.GMGMeta(mesh.structure)
            if meta.usable:
                self.gmg_meta = meta
            elif precond_kind == "gmg":
                print("gmg preconditioner unavailable (grid does not "
                      "coarsen); using Jacobi")
        elif precond_kind == "gmg":
            print("gmg preconditioner requires PCG on the single-device "
                  "component-major EA path on a structured order-1 mesh; "
                  "using Jacobi")
        self.precond_kind = "gmg" if self.gmg_meta is not None else "jacobi"

    def krylov_solve(self, k_data, diag, b, ess):
        """PCG in mixed precision (f32 inner, f64 replay; plain PCG in the
        run's dtype without ``mixed_krylov``) with the GMG V-cycle or
        Jacobi, or MINRES or GMRES in f64 with Jacobi; on an f32 run each
        solver in plain f32.  On the card the V-cycle is one CUDA graph,
        captured once a solve (``_gmg_levels``) and replayed by both legs
        of ``pcg_refined``.  The system's recorder is current inside it
        (the counters of ``solvers/krylov.py``, the V-cycle's spans and
        counters).  Returns (x, iters, converged, rel_red)."""
        with profiling.recording(self.regions):
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
            if b.dtype != torch.float64 or not self.mixed_krylov:
                if self.gmg_meta is not None:
                    levels = self._gmg_levels(k_data, ess, matvec, diag)

                    def precond(v):
                        return gmg.v_cycle(levels, v)

                return pcg(matvec, precond, *args, dot=self.dot)
            f32 = torch.float32
            k32 = k_data.to(f32)
            dinv32 = dinv.to(f32)

            def matvec32(x):
                return self.grad_matvec(k32, x, ess)

            def precond32(v):
                return dinv32 * v

            if self.gmg_meta is not None:
                levels = self._gmg_levels(k32, ess, matvec32, diag.to(f32))

                def precond32(v):
                    return gmg.v_cycle(levels, v)

                def precond(v):
                    return gmg.v_cycle(levels, v.to(f32)).to(b.dtype)

            return pcg_refined(matvec, precond, matvec32, precond32, *args,
                               dot=self.dot)

    def _gmg_levels(self, k_data, ess, matvec, diag):
        """The GMG hierarchy of one Krylov solve (``gmg.build_hierarchy``);
        on the card its V-cycle is captured as a CUDA graph into the
        system's pool, with grad_matvec's masked apply as the fine matvec,
        but with no span and past any wrapper put on ``apply_k``: nothing
        inside a capture may record a timing event (the recorder is paused
        there too).  On the strided map the captured fine apply must be
        the EA kernel pair (``ea_apply_cuda.engages``): the blocks are
        read in place, and the pool holds no copy of them."""
        graphs = None
        if diag.is_cuda:
            if isinstance(self.emap, StructuredMap) \
                    and not ea_apply_cuda.engages(k_data, self.emap, diag):
                raise RuntimeError(
                    "the V-cycle's graph would capture the plain EA apply: "
                    f"blocks {tuple(k_data.shape)}, contiguous "
                    f"{k_data.is_contiguous()}, on the strided map of order "
                    f"{self.emap.p}")
            if self._cycle_graphs is None:
                self._cycle_graphs = gmg.CycleGraphs(diag.device)
            graphs = self._cycle_graphs

        def plain(x):
            return ops.masked_apply(
                lambda v: MechSystem.apply_k(self, k_data, v), x, ess)

        return gmg.build_hierarchy(self.gmg_meta, k_data, ess, matvec, diag,
                                   graphs=graphs, graph_matvec=plain)

    def span(self, name, fn, *args, region=False):
        """fn(*args), with region timing on recorded as the port's span
        ``name`` or (``region``) as the reference's region ``name`` (the
        setups, the line-search residuals and the Krylov solves), inside
        which the system's recorder is current (``utils.profiling``)."""
        if self.regions is None:
            return fn(*args)
        timed = self.regions.region if region else self.regions.span
        with timed(name, self.device):
            return fn(*args)

    def vol_avg(self, values_q, el_x, divide=True):
        """Volume-weighted average (or, without ``divide``, the volume
        integral) of a (k, nq, ne) field.  Over shards, over the real
        elements of all of them: per-shard sums of the weighted values
        and of the weights, then their sums over the shards in shard
        order (the same whatever the ranks)."""
        wts = ops.quad_point_volumes_cm(el_x, self.dshape, self.qwts)
        lay = self.layout
        if lay is None:
            s = torch.einsum("qe,kqe->k", wts, values_q)
            return s / torch.sum(wts) if divide else s
        wts = torch.where(self.emap.real, wts, 0.0)
        terms = torch.cat([values_q * wts, wts[None]])  # (k + 1, nq, ne)
        sums = lay.sum_shards(terms.reshape(
            -1, self.nq, lay.s_local, self.ne // lay.s_local), axis=2,
            keep=1)
        return sums[:-1] / sums[-1] if divide else sums[:-1]

    def _deff(self, v, x_beg, dt):
        """(nq, ne) effective deformation rate at the end-of-step
        geometry."""
        el_x = self.emap.gather(x_beg + dt * v)
        L = self._vgrad(el_x, self.emap.gather(v))
        d = 0.5 * (L + L.transpose(0, 1))
        tr3 = (d[0, 0] + d[1, 1] + d[2, 2]) / 3.0
        dev2 = torch.sum(d * d, dim=(0, 1)) - 3.0 * tr3 * tr3
        deff = torch.sqrt(2.0 / 3.0 * torch.clamp(dev2, min=0.0))
        return deff.reshape(self.nq, self.ne)

    def max_deff(self, v, x_beg, dt):
        """The largest effective deformation rate over the points (over
        shards, the real elements' of all ranks), a 0-d tensor (the
        reference's ``_max_deff``)."""
        deff = self._deff(v, x_beg, dt)
        if self.layout is None:
            return deff.max()
        deff = torch.where(self.emap.real, deff, 0.0)
        return self.layout.allreduce_max(deff.max())

    # -- Newton solve ---------------------------------------------------------

    def newton_solve(self, v, x_beg, state, dt, ess_mask, verbose=True):
        """Newton-Krylov with quadratic line-search safeguarding.

        NR takes the full step and falls back to the 3-point quadratic
        line search when the step fails to halve the residual; NRLS
        always line-searches.  The converged point-solve solution of the
        last setup warm-starts the next one (with ``warm_start``).  With
        region timing on it is span ``newton.solve`` and counts its
        residual-norm reads (``host_reads``), and its stats
        (``last_newton_stats``) also hold ``spans`` and ``counters``,
        ``Regions.delta()`` taken after the span closes: what the regions
        recorded since the previous solve's stats were taken (this solve's
        own span, and the corrector and the rest of the time loop since
        the previous solve).  Taking it waits for the card once a solve."""
        out = self.span("newton.solve", self._newton_solve, v, x_beg, state,
                        dt, ess_mask, verbose)
        if self.regions is not None:
            spans, counters = self.regions.delta()
            self.last_newton_stats.update(spans=spans, counters=counters)
        return out

    def _newton_solve(self, v, x_beg, state, dt, ess_mask, verbose):
        opt = self.opt
        ess = self._ess_flat(ess_mask)
        nsub = self.compute_nsub(dt)
        xw = torch.zeros((8, self.npts), dtype=state.dtype,
                         device=self.device)
        ok = False

        def do_setup(v_it):
            return self.span("operator_setup", self.setup, v_it, x_beg,
                             state, dt, ess, True, nsub, xw, ok, region=True)

        def do_resid(v_it):
            return self.span("line_search", self.residual_only, v_it, x_beg,
                             state, dt, ess, nsub, xw, ok, region=True)

        def norm(r):
            n = float(self.norm(r))
            profiling.count("host_reads")
            return n

        out = do_setup(v)
        r, k_data, diag, stress, state_end = out[:5]
        if self.warm_start:
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
            c, kit, kdone, krel = self.span(
                "krylov_solve", self.krylov_solve, k_data, diag, r, ess,
                region=True)
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
            if self.warm_start:
                xw = out[5]
            nrm = norm(r)
            it += 1

        self.last_newton_stats = {
            "nr_iters": it, "krylov_iters": kiters,
            "krylov_converged": kconv, "krylov_relres": krelres,
            "norm0": norm0, "norm": nrm,
        }
        return v, stress, state_end, converged, it, nrm

    def make_step(self, newton_iters=2):
        """One time step of fixed work, the reference's ``make_jit_step``:
        ``step(v, x_beg, state, dt, ess)`` runs ``newton_iters`` setups
        each followed by a Krylov update (no line search, the point
        solution carried warm with ``warm_start``), then a final setup,
        and returns (v,
        x_cur, stress, state_end, norm) with the final residual's norm
        as a 0-d tensor.  It adds no host read to those of the solvers
        it calls."""

        def step(v, x_beg, state, dt, ess):
            ess = self._ess_flat(ess)
            nsub = self.compute_nsub(dt)
            xw = torch.zeros((8, self.npts), dtype=state.dtype,
                             device=self.device)
            ok = False
            for _ in range(newton_iters):
                r, k_data, diag, _, _, x_sol = self.setup(
                    v, x_beg, state, dt, ess, True, nsub, xw, ok)
                v = v - self.krylov_solve(k_data, diag, r, ess)[0]
                # release this iteration's operator before the next setup
                r = k_data = diag = None
                if self.warm_start:
                    xw, ok = x_sol, True
            r, _, _, stress, state_end, _ = self.setup(
                v, x_beg, state, dt, ess, True, nsub, xw, ok)
            return (v, x_beg + dt * v, stress, state_end, self.norm(r))

        return step

    def solve_init(self, v_prev, v_new, x_beg, state, dt, ess_mask):
        """BC-change corrector (SystemDriver::SolveInit): one linear solve
        for the jump in the essential velocities, geometry not advanced."""
        ess = self._ess_flat(ess_mask)
        delta = torch.where(ess, v_new - v_prev, 0.0)
        xw = torch.zeros((8, self.npts), dtype=state.dtype,
                         device=self.device)
        r, k_data, diag = self.setup(v_prev, x_beg, state, dt, ess, False,
                                     self.compute_nsub(dt), xw, False)[:3]
        y = torch.where(ess, 0.0, self.span("operator.apply", self.apply_k,
                                            k_data, delta)) + r
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
    """The time loop on one device or, with ``shards``, on the slab
    domain decomposition or the replicated-node element sharding (see
    ``_make_system``).

    ``model``, when given, runs instead of the material the options
    build (it must read the same properties and state layout): for
    example the options' ECMech model with a knob of the point update
    set, ``dataclasses.replace(m, evptn=dataclasses.replace(m.evptn,
    hardness_mode="coupled"))`` of ``models.ecmech.build_model(opt,
    props)``."""

    def __init__(self, opt: ExaOptions, workdir: str | None = None,
                 device="cuda", shards: int | None = None, model=None):
        device = resolve_device(device)
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
        if model is not None:
            self.model = model
        elif opt.mech_type == MechType.UMAT:
            self.model = UmatModel(
                lib=UmatLibrary(opt.abspath(opt.umat_library)), props=props,
                num_user_state=opt.numStateVars + self._ori_stride,
                temp_k=opt.temp_k)
        else:
            self.model = build_model(opt, props)
        self.system = self._make_system(device, shards)
        sysm = self.system
        state0 = (self._umat_state() if opt.mech_type == MechType.UMAT
                  else self._ecmech_state())
        self.state = sysm.to_state(state0.reshape(self.mesh.num_elems,
                                                  sysm.nq, -1))
        self.stress = torch.zeros((6, sysm.npts), dtype=sysm.dtype,
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

    def _make_system(self, device, shards):
        """The system the run takes, as the reference's ``Simulation``
        chooses it on a device mesh (``parallel_mode`` in
        ``self.parallel_mode``).

        ``shards`` None means one shard per rank when the process group
        has more than one rank (unless ``parallel_mode = "single"``), and
        one device otherwise.  Over shards, "auto" and "slab" take the
        slab with an ExaCMech material and PCG; "slab" with a UMAT or
        another solver, or a mesh it cannot partition, raises.  Every
        other choice takes the replicated-node element sharding
        (``parallel/replicated.py``): "replicated", "single" with shards,
        "auto" with a configuration the slab does not cover, and "auto"
        on a mesh it cannot partition (printing why)."""
        opt = self.opt
        mode = opt.parallel_mode
        world = sharding.world_size()
        if shards is None and world > 1 and mode != "single":
            shards = world
        if shards is None:
            self.parallel_mode = "single"
            return MechSystem(opt, self.mesh, self.model, device=device)
        if shards % world:
            raise ValueError(f"{shards} shards do not divide over {world} "
                             "ranks")
        covered = (opt.mech_type == MechType.EXACMECH
                   and opt.solver == KrylovSolver.PCG)
        if mode in ("auto", "slab") and covered:
            from .parallel.slab_system import SlabMechSystem
            try:
                system = SlabMechSystem(opt, self.mesh, self.model, shards,
                                        device=device)
                self.parallel_mode = "slab"
                return system
            except ValueError as e:
                if mode == "slab":
                    raise
                print(f"slab partition unavailable ({e}); using "
                      "replicated-node element sharding")
        elif mode == "slab":
            raise ValueError(
                "Solvers.parallel_mode = 'slab' requires an ExaCMech "
                "material and the PCG Krylov solver (got "
                f"mech_type={opt.mech_type.name}, "
                f"solver={opt.solver.name})")
        emap = ReplicatedMap(self.mesh.conn, self.mesh.num_nodes,
                             sharding.ShardLayout.create(shards, device))
        self.parallel_mode = "replicated"
        return MechSystem(opt, self.mesh, self.model, device=device,
                          emap=emap)

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
        nq = self.system.nq
        npts = self.mesh.num_elems * nq
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
        self._solves = []
        if ti in self.update_steps:
            if verbose and ti != 1:
                print(f"Changing boundary conditions this step: {ti}")
            v_prev = self.v
            self.cur_bcs = self.bc_steps[ti]
            self.update_velocity()
            self.v = sysm.span("time_loop.corrector", sysm.solve_init, v_prev,
                               self.v, self.x_beg, self.state, dt,
                               self.cur_bcs.ess_mask)
        self.update_velocity()

        if opt.dt_auto:
            # up to two retries at dt * dt_scale, then dt grows (or
            # shrinks) for the next step by newton_iter * dt_scale / nit
            v_save = self.v
            attempts = 0
            while True:
                v, stress, state_end, conv, nit, _ = self._newton(
                    self.v, self.x_beg, self.state, dt, verbose)
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
            v, stress, state_end, conv, nit, _ = self._newton(
                self.v, self.x_beg, self.state, dt, verbose)
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
        # NR count, the number of sub-solves the step took, and every
        # solve's counts (retries and sub-solves included)
        self.step_stats.append(dict(sysm.last_newton_stats, first_nr=nit,
                                    subdivided=subdivided,
                                    solves=self._solves))
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
        v, x, state = self.v, self.x_beg, self.state
        dts = dt / nsub
        for _ in range(nsub):
            v, stress, state_end, conv, _, _ = self._newton(
                v, x, state, dts, verbose)
            if not conv:
                return None
            x = x + dts * v
            state = state_end
        return v, stress, state, x

    def _newton(self, v, x, state, dt, verbose):
        """The system's Newton solve under the current BCs, its counts
        kept in the step's list of solves."""
        sysm = self.system
        out = sysm.newton_solve(v, x, state, dt, self.cur_bcs.ess_mask,
                                verbose)
        self._solves.append(dict(sysm.last_newton_stats))
        return out

    def _append_file(self, name, text):
        # every rank computes the averages (collectively); rank 0 writes
        if sharding.process_rank() != 0:
            return
        with open(os.path.join(self.workdir, name), "a") as f:
            f.write(text)

    def write_averages(self):
        """Append this step's row to the average stress file and, with
        ``additional_avgs``, to the plastic work, deformation gradient and
        plastic deformation rate files (span ``time_loop.averages``)."""
        self.system.span("time_loop.averages", self._write_averages)

    def _write_averages(self):
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
        if self.system.regions is not None:
            print(self.system.regions.report())
        return t


def run_simulation(toml_path: str, workdir: str | None = None,
                   verbose: bool = True, device="cuda",
                   shards: int | None = None):
    """Parse the options file and run the whole simulation on ``device``
    (default: the card; ``device="cpu"`` runs on the CPU), over
    ``shards`` shards if given (``Simulation``)."""
    set_precision_policy()
    opt = parse_options(toml_path)
    with torch.inference_mode():
        sim = Simulation(opt, workdir=workdir, device=device, shards=shards)
        if verbose and sim.parallel_mode != "single":
            print(f"{sim.parallel_mode} domain decomposition over "
                  f"{sim.system.layout.n_shards} shards on "
                  f"{sharding.world_size()} rank(s) "
                  f"(Solvers.parallel_mode = {opt.parallel_mode})")
        sim.run(verbose=verbose)
    return sim
