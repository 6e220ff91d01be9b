"""TOML options schema, bit-compatible with the reference's ExaOptions.

The TOML tables, keys, defaults, and validation rules mirror
src/option_parser.{hpp,cpp} and src/options.toml from the reference so
that the reference's test inputs (its test/data/*.toml) run unmodified.
A verbatim copy of exaconstit_tpu/config/options.py apart from this
sentence: it imports only numpy and tomllib.

Parsing uses Python's stdlib ``tomllib`` (replacing the reference's
vendored toml11 C++ library, src/TOML_Reader/).
"""

from __future__ import annotations

import dataclasses
import enum
import os
import tomllib
from typing import Optional

import numpy as np


class MechType(enum.Enum):
    UMAT = "umat"
    EXACMECH = "exacmech"
    NOTYPE = "notype"


class XtalType(enum.Enum):
    FCC = "fcc"
    BCC = "bcc"
    HCP = "hcp"
    NOTYPE = "notype"


class SlipType(enum.Enum):
    POWERVOCE = "powervoce"
    POWERVOCENL = "powervocenl"
    MTSDD = "mtsdd"
    NOTYPE = "notype"


class OriType(enum.Enum):
    EULER = "euler"
    QUAT = "quat"
    CUSTOM = "custom"
    NOTYPE = "notype"


class MeshType(enum.Enum):
    CUBIT = "cubit"
    AUTO = "auto"
    OTHER = "other"
    NOTYPE = "notype"


class KrylovSolver(enum.Enum):
    GMRES = "GMRES"
    PCG = "PCG"
    MINRES = "MINRES"
    NOTYPE = "notype"


class NLSolver(enum.Enum):
    NR = "NR"
    NRLS = "NRLS"


class Assembly(enum.Enum):
    FULL = "FULL"
    PA = "PA"
    EA = "EA"
    NOTYPE = "notype"


class IntegrationType(enum.Enum):
    FULL = "FULL"
    BBAR = "BBAR"
    NOTYPE = "notype"


class RTModel(enum.Enum):
    CPU = "CPU"
    OPENMP = "OPENMP"
    GPU = "GPU"
    # TPU-native addition; CPU/OPENMP/GPU are accepted for input
    # compatibility and all map onto the single XLA execution path.
    TPU = "TPU"
    NOTYPE = "notype"


# Model size constants (mirroring ExaCMech compile-time constants used by
# option_parser.cpp:396-485 for validation).
# num_hist = 4 (A-vars) + 5 (dev elastic strain) + 4 (quats) + nH + nslip
_MODEL_DB = {
    # (slip_type, xtal_type): (nparams, nslip, nH)
    (SlipType.POWERVOCE, XtalType.FCC): (17, 12, 1),
    (SlipType.POWERVOCE, XtalType.BCC): (17, 12, 1),
    (SlipType.POWERVOCENL, XtalType.FCC): (18, 12, 1),
    (SlipType.POWERVOCENL, XtalType.BCC): (18, 12, 1),
    (SlipType.MTSDD, XtalType.FCC): (24, 12, 1),
    (SlipType.MTSDD, XtalType.BCC): (24, 12, 1),
    # HCP: c_1, g_0 and s are per-slip-system (24 each) in the reference
    # parameter layout (scripts/ecmech_prop_file.py documents this), so
    # nParams = 3 + 5 elastic + (13 + 3*24) kinetics + 2 = 95.
    (SlipType.MTSDD, XtalType.HCP): (95, 24, 1),
}

# convenience extension (not in the reference): HCP MTSDD with scalar
# c_1/g_0/s, for parameter studies that do not resolve slip families
_HCP_SCALAR_NPROPS = 26

ECMECH_NE = 1  # number of internal-energy history slots (ecmech::ne)


def model_num_hist(slip_type: SlipType, xtal_type: XtalType) -> int:
    _, nslip, nh = _MODEL_DB[(slip_type, xtal_type)]
    return 4 + 5 + 4 + nh + nslip


def model_num_state_vars(slip_type: SlipType, xtal_type: XtalType) -> int:
    """State-var file length: numHist + ne + 1 - 4 (quats supplied separately).

    Mirrors option_parser.cpp:459-485.
    """
    return model_num_hist(slip_type, xtal_type) + ECMECH_NE + 1 - 4


class OptionError(RuntimeError):
    pass


def _abort(msg):
    raise OptionError(msg)


@dataclasses.dataclass
class ExaOptions:
    """Parsed simulation options (reference: option_parser.hpp:138-265)."""

    floc: str = ""
    basedir: str = "."
    version: str = "0.6.0"

    # --- Properties ---
    temp_k: float = 298.0
    props_file: str = "props.txt"
    nProps: int = 1
    state_file: str = "state.txt"
    numStateVars: int = 1
    # grain / orientation info
    cp: bool = False
    ori_type: OriType = OriType.EULER
    ngrains: int = 0
    grain_custom_stride: int = 0
    grain_statevar_offset: int = -1
    ori_file: str = "ori.txt"
    grain_map: str = "grain_map.txt"

    # --- BCs ---
    changing_bcs: bool = False
    updateStep: list = dataclasses.field(default_factory=list)
    # step -> list maps, keyed like the reference's map_of_imap
    map_ess_vel: dict = dataclasses.field(default_factory=dict)
    map_ess_vgrad: dict = dataclasses.field(default_factory=dict)
    map_ess_id: dict = dataclasses.field(default_factory=dict)
    map_ess_comp: dict = dataclasses.field(default_factory=dict)
    vgrad_origin: Optional[np.ndarray] = None

    # --- Model ---
    mech_type: MechType = MechType.NOTYPE
    xtal_type: XtalType = XtalType.NOTYPE
    slip_type: SlipType = SlipType.NOTYPE
    # UMAT user-material shared library (TPU-native extension: the
    # reference links the Fortran UMAT at build time instead)
    umat_library: str = ""

    # --- Time ---
    dt_cust: bool = False
    dt_auto: bool = False
    dt: float = 1.0
    dt_min: float = 1.0
    dt_scale: float = 0.25
    t_final: float = 1.0
    dt_file: str = "custom_dt.txt"
    nsteps: int = 1
    cust_dt: Optional[np.ndarray] = None

    # --- Visualization / outputs ---
    vis_steps: int = 1
    visit: bool = False
    conduit: bool = False
    paraview: bool = False
    adios2: bool = False
    light_up: bool = False
    basename: str = "results/exaconstit"
    avg_stress_fname: str = "avg_stress.txt"
    additional_avgs: bool = False
    avg_def_grad_fname: str = "avg_def_grad.txt"
    avg_pl_work_fname: str = "avg_pl_work.txt"
    avg_dp_tensor_fname: str = "avg_dp_tensor.txt"

    # --- Solvers ---
    assembly: Assembly = Assembly.FULL
    rtmodel: RTModel = RTModel.TPU
    integ_type: IntegrationType = IntegrationType.FULL
    newton_iter: int = 25
    newton_rel_tol: float = 1e-5
    newton_abs_tol: float = 1e-10
    nl_solver: NLSolver = NLSolver.NR
    krylov_iter: int = 200
    krylov_rel_tol: float = 1e-10
    krylov_abs_tol: float = 1e-30
    solver: KrylovSolver = KrylovSolver.GMRES
    # preconditioner: "auto" picks "gmg" (geometric multigrid on the
    # voxel hierarchy, the BoomerAMG role -- solvers/gmg.py) where it
    # applies (structured order-1 mesh, CM EA path, PCG, single device)
    # and falls back to "jacobi" (assembled-diagonal, the reference's
    # matrix-free default) elsewhere.  Measured at 48^3 (BENCH_r05):
    # GMG converges the linear solves in ~9 iterations where
    # Jacobi-PCG hits the 200 cap unconverged, at 1.07x better step
    # wall time -- hence the default.
    krylov_precond: str = "auto"

    # --- Mesh ---
    mesh_type: MeshType = MeshType.OTHER
    mesh_file: str = ""
    ser_ref_levels: int = 0
    par_ref_levels: int = 0
    order: int = 1
    mxyz: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 1.0, 1.0]))
    nxyz: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1, 1, 1], dtype=int))

    # --- TPU-native extensions (absent from the reference schema) ---
    # compute dtype for the hot paths; "f64" reproduces the reference
    precision: str = "f64"
    # checkpoint/resume (a gap in the reference, SURVEY.md section 5)
    checkpoint_steps: int = 0
    checkpoint_dir: str = "checkpoint"
    restart: bool = False
    # multi-device domain decomposition (the reference always
    # ParMesh-partitions, mechanics_driver.cpp:312-315):
    #   "auto"       slab halo-exchange partition when >1 device and the
    #                mesh/solver support it, else replicated-node sharding
    #   "slab"       require the slab partition (error if unsupported)
    #   "replicated" element-sharded state + replicated nodes
    #   "single"     ignore extra devices
    parallel_mode: str = "auto"

    # ------------------------------------------------------------------
    @property
    def vgrad_origin_flag(self) -> bool:
        return self.vgrad_origin is not None

    def abspath(self, p: str) -> str:
        if os.path.isabs(p):
            return p
        return os.path.join(self.basedir, p)


def parse_options(floc: str) -> ExaOptions:
    with open(floc, "rb") as f:
        data = tomllib.load(f)
    opt = ExaOptions(floc=floc, basedir=os.path.dirname(os.path.abspath(floc)))
    opt.version = data.get("Version", opt.version)
    # TPU-native extension: checkpoint/restart (a gap in the reference)
    ck = data.get("Checkpoint", {})
    opt.checkpoint_steps = int(ck.get("steps", 0))
    opt.checkpoint_dir = ck.get("dir", "checkpoint")
    opt.restart = bool(ck.get("restart", False))
    _parse_properties(opt, data)
    _parse_bcs(opt, data)
    _parse_model(opt, data)
    _parse_time(opt, data)
    _parse_visualizations(opt, data)
    _parse_solvers(opt, data)
    _parse_mesh(opt, data)
    _validate_model(opt)
    return opt


def _parse_properties(opt: ExaOptions, data: dict):
    table = data.get("Properties", {})
    opt.temp_k = float(table.get("temperature", 298))
    matl = table.get("Matl_Props", {})
    opt.props_file = matl.get("floc", "props.txt")
    opt.nProps = int(matl.get("num_props", 1))
    sv = table.get("State_Vars", {})
    opt.state_file = sv.get("floc", "state.txt")
    opt.numStateVars = int(sv.get("num_vars", 1))
    grain = table.get("Grain", None)
    if grain is not None:
        opt.cp = True
        opt.grain_statevar_offset = int(grain.get("ori_state_var_loc", -1))
        opt.grain_custom_stride = int(grain.get("ori_stride", 0))
        ori_type = str(grain.get("ori_type", "euler")).lower()
        # same aliases the reference accepts (option_parser.cpp:123-132)
        ori_type = {"quaternion": "quat", "quats": "quat"}.get(ori_type,
                                                               ori_type)
        try:
            opt.ori_type = OriType(ori_type)
        except ValueError:
            _abort("Properties.Grain.ori_type was not provided a valid type.")
        opt.ngrains = int(grain.get("num_grains", 0))
        opt.ori_file = grain.get("ori_floc", "ori.txt")
        opt.grain_map = grain.get("grain_floc", "grain_map.txt")


def _split_comps(ids, comps):
    """Split signed essential_comps into velocity / velocity-gradient sets.

    Negative components signify velocity-gradient BCs
    (option_parser.cpp:170-207, 282-296).
    """
    vel_id, vel_comp, vg_id, vg_comp = [], [], [], []
    for i, c in zip(ids, comps):
        if c >= 0:
            vel_id.append(i)
            vel_comp.append(c)
            vg_id.append(i)
            vg_comp.append(0)
        else:
            vel_id.append(i)
            vel_comp.append(0)
            vg_id.append(i)
            vg_comp.append(abs(c))
    return vel_id, vel_comp, vg_id, vg_comp


def _parse_bcs(opt: ExaOptions, data: dict):
    table = data.get("BCs", {})
    opt.changing_bcs = bool(table.get("changing_ess_bcs", False))
    vgrad_origin = table.get("vgrad_origin", [])
    if vgrad_origin:
        if len(vgrad_origin) != 3:
            _abort("BCs.vgrad_origin when provided must contain 3 components.")
        opt.vgrad_origin = np.asarray(vgrad_origin, dtype=float)

    opt.map_ess_id = {"total": {}, "ess_vel": {}, "ess_vgrad": {}}
    opt.map_ess_comp = {"total": {}, "ess_vel": {}, "ess_vgrad": {}}
    opt.map_ess_vel = {}
    opt.map_ess_vgrad = {}

    if not opt.changing_bcs:
        ids = table.get("essential_ids", [])
        if not ids:
            _abort("BCs.essential_ids was not provided any values.")
        comps = table.get("essential_comps", [])
        if not comps:
            _abort("BCs.essential_comps was not provided any values.")
        vel_id, vel_comp, vg_id, vg_comp = _split_comps(ids, comps)
        opt.map_ess_id["total"][1] = list(ids)
        opt.map_ess_comp["total"][1] = list(comps)
        opt.map_ess_id["ess_vel"][1] = vel_id
        opt.map_ess_comp["ess_vel"][1] = vel_comp
        opt.map_ess_id["ess_vgrad"][1] = vg_id
        opt.map_ess_comp["ess_vgrad"][1] = vg_comp
        vals = table.get("essential_vals", [])
        if not vals and any(c > 0 for c in vel_comp):
            _abort("BCs.essential_vals was not provided any values but a "
                   "boundary requires this.")
        opt.map_ess_vel[1] = list(map(float, vals))
        vgrad = table.get("essential_vel_grad", [])
        flat = [float(x) for row in vgrad for x in row]
        if not flat and any(c > 0 for c in vg_comp):
            _abort("BCs.essential_vel_grad was not provided any values but a "
                   "boundary requires this.")
        opt.map_ess_vgrad[1] = flat
        opt.updateStep = [1]
    else:
        steps = table.get("update_steps", [])
        if not steps:
            _abort("BCs.update_steps was not provided any values.")
        if 1 not in steps:
            _abort("BCs.update_steps must contain 1 in the array")
        opt.updateStep = list(steps)
        nested_ids = table.get("essential_ids", [])
        nested_comps = table.get("essential_comps", [])
        nested_vals = table.get("essential_vals", [])
        nested_vgrad = table.get("essential_vel_grad", [])
        if len(nested_ids) != len(steps):
            _abort("BCs.essential_ids did not contain the same number of "
                   "arrays as number of update steps")
        if len(nested_comps) != len(steps):
            _abort("BCs.essential_comps did not contain the same number of "
                   "arrays as number of update steps")
        for k, step in enumerate(steps):
            ids = nested_ids[k]
            comps = nested_comps[k]
            if not ids:
                _abort("BCs.essential_ids contains empty array.")
            if not comps:
                _abort("BCs.essential_comps contains empty array.")
            vel_id, vel_comp, vg_id, vg_comp = _split_comps(ids, comps)
            opt.map_ess_id["total"][step] = list(ids)
            opt.map_ess_comp["total"][step] = list(comps)
            opt.map_ess_id["ess_vel"][step] = vel_id
            opt.map_ess_comp["ess_vel"][step] = vel_comp
            opt.map_ess_id["ess_vgrad"][step] = vg_id
            opt.map_ess_comp["ess_vgrad"][step] = vg_comp
            if nested_vals:
                opt.map_ess_vel[step] = list(map(float, nested_vals[k]))
            else:
                opt.map_ess_vel[step] = []
            if nested_vgrad:
                rows = nested_vgrad[k]
                opt.map_ess_vgrad[step] = [float(x) for row in rows for x in row]
            else:
                opt.map_ess_vgrad[step] = []


def _parse_model(opt: ExaOptions, data: dict):
    table = data.get("Model", {})
    mech = str(table.get("mech_type", "")).lower()
    if mech == "umat":
        opt.mech_type = MechType.UMAT
    elif mech == "exacmech":
        opt.mech_type = MechType.EXACMECH
    else:
        _abort("Model.mech_type was not provided a valid type.")
    opt.cp = bool(table.get("cp", opt.cp))
    if opt.mech_type == MechType.UMAT:
        sub = table.get("UMAT", {})
        opt.umat_library = sub.get("library", "")
    if opt.mech_type == MechType.EXACMECH:
        sub = table.get("ExaCMech", None)
        if sub is None:
            _abort("The table Model.ExaCMech does not exist, but the model "
                   "being used is ExaCMech.")
        xt = str(sub.get("xtal_type", "")).lower()
        try:
            opt.xtal_type = XtalType(xt)
        except ValueError:
            _abort("Model.ExaCMech.xtal_type was not provided a valid type.")
        st = str(sub.get("slip_type", "")).lower()
        try:
            opt.slip_type = SlipType(st)
        except ValueError:
            _abort("Model.ExaCMech.slip_type was not provided a valid type.")


def _validate_model(opt: ExaOptions):
    if opt.mech_type != MechType.EXACMECH:
        return
    key = (opt.slip_type, opt.xtal_type)
    if key not in _MODEL_DB:
        _abort(f"Model combination {opt.slip_type.value} + "
               f"{opt.xtal_type.value} is not supported.")
    nparams, _, _ = _MODEL_DB[key]
    ok = opt.nProps == nparams or (key == (SlipType.MTSDD, XtalType.HCP)
                                   and opt.nProps == _HCP_SCALAR_NPROPS)
    if not ok:
        _abort(f"Properties.Matl_Props.num_props needs {nparams} values for "
               f"the {opt.slip_type.value} option and {opt.xtal_type.value} "
               "option")
    nsv = model_num_state_vars(opt.slip_type, opt.xtal_type)
    if opt.numStateVars != nsv:
        _abort(f"Properties.State_Vars.num_vars needs {nsv} values for a "
               f"{opt.xtal_type.value} material when using an ExaCMech model. "
               "Note: the number of values for a quaternion are not included "
               "in this count.")


def _parse_time(opt: ExaOptions, data: dict):
    table = data.get("Time", {})
    if "Fixed" in table:
        fixed = table["Fixed"]
        opt.dt_cust = False
        opt.dt_auto = False
        opt.dt = float(fixed.get("dt", 1.0))
        opt.dt_min = opt.dt
        opt.t_final = float(fixed.get("t_final", 1.0))
    if "Auto" in table:
        if opt.changing_bcs:
            _abort("Automatic time stepping is currently not compatible with "
                   "changing boundary conditions")
        auto = table["Auto"]
        opt.dt_cust = False
        opt.dt_auto = True
        opt.dt = float(auto.get("dt_start", 1.0))
        opt.dt_scale = float(auto.get("dt_scale", 0.25))
        if opt.dt_scale < 0.0 or opt.dt_scale > 1.0:
            _abort("dt_scale for auto time stepping needs to be between 0 "
                   "and 1.")
        opt.dt_min = float(auto.get("dt_min", 1.0))
        opt.t_final = float(auto.get("t_final", 1.0))
        opt.dt_file = auto.get("auto_dt_file", "auto_dt_out.txt")
    if "Custom" in table:
        cust = table["Custom"]
        opt.dt_cust = True
        opt.dt_auto = False
        opt.nsteps = int(cust.get("nsteps", 1))
        opt.dt_file = cust.get("floc", "custom_dt.txt")


def _parse_visualizations(opt: ExaOptions, data: dict):
    table = data.get("Visualizations", {})
    opt.vis_steps = int(table.get("steps", 1))
    opt.visit = bool(table.get("visit", False))
    opt.conduit = bool(table.get("conduit", False))
    opt.paraview = bool(table.get("paraview", False))
    opt.adios2 = bool(table.get("adios2", False))
    opt.light_up = bool(table.get("light_up", False))
    opt.basename = table.get("floc", "results/exaconstit")
    opt.avg_stress_fname = table.get("avg_stress_fname", "avg_stress.txt")
    opt.additional_avgs = bool(table.get("additional_avgs", False))
    opt.avg_def_grad_fname = table.get("avg_def_grad_fname",
                                       "avg_def_grad.txt")
    opt.avg_pl_work_fname = table.get("avg_pl_work_fname", "avg_pl_work.txt")
    opt.avg_dp_tensor_fname = table.get("avg_dp_tensor_fname",
                                        "avg_dp_tensor.txt")


def _parse_solvers(opt: ExaOptions, data: dict):
    table = data.get("Solvers", {})
    asm = str(table.get("assembly", "FULL")).upper()
    try:
        opt.assembly = Assembly(asm)
    except ValueError:
        _abort("Solvers.assembly was not provided a valid type.")
    rt = str(table.get("rtmodel", "CPU")).upper()
    if rt == "CUDA":  # pre-v0.7.0 alias
        rt = "GPU"
    try:
        opt.rtmodel = RTModel(rt)
    except ValueError:
        _abort("Solvers.rtmodel was not provided a valid type.")
    integ = str(table.get("integ_model", "FULL")).upper()
    try:
        opt.integ_type = IntegrationType(integ)
    except ValueError:
        _abort("Solvers.integ_model was not provided a valid type.")
    nr = table.get("NR", {})
    opt.newton_iter = int(nr.get("iter", 25))
    opt.newton_rel_tol = float(nr.get("rel_tol", 1e-5))
    opt.newton_abs_tol = float(nr.get("abs_tol", 1e-10))
    nls = str(nr.get("nl_solver", "NR")).upper()
    try:
        opt.nl_solver = NLSolver(nls)
    except ValueError:
        _abort("Solvers.NR.nl_solver was not provided a valid type.")
    kry = table.get("Krylov", {})
    opt.krylov_iter = int(kry.get("iter", 200))
    opt.krylov_rel_tol = float(kry.get("rel_tol", 1e-10))
    opt.krylov_abs_tol = float(kry.get("abs_tol", 1e-30))
    ks = str(kry.get("solver", "GMRES")).upper()
    try:
        opt.solver = KrylovSolver(ks)
    except ValueError:
        _abort("Solvers.Krylov.solver was not provided a valid type.")
    opt.krylov_precond = str(kry.get("precond", "auto")).lower()
    if opt.krylov_precond not in ("auto", "jacobi", "gmg"):
        _abort("Solvers.Krylov.precond must be auto|jacobi|gmg")
    # TPU-native extensions
    opt.precision = str(table.get("precision", "f64")).lower()
    opt.parallel_mode = str(table.get("parallel_mode", "auto")).lower()
    if opt.parallel_mode not in ("auto", "slab", "replicated", "single"):
        _abort("Solvers.parallel_mode must be auto|slab|replicated|single")


def _parse_mesh(opt: ExaOptions, data: dict):
    table = data.get("Mesh", {})
    opt.ser_ref_levels = int(table.get("ref_ser", 0))
    opt.par_ref_levels = int(table.get("ref_par", 0))
    opt.order = int(table.get("p_refinement", 1))
    opt.mesh_file = table.get("floc", "")
    mt = str(table.get("type", "other")).lower()
    try:
        opt.mesh_type = MeshType(mt)
    except ValueError:
        _abort("Mesh.type was not provided a valid type.")
    auto = table.get("Auto", {})
    if opt.mesh_type == MeshType.AUTO:
        opt.mxyz = np.asarray(auto.get("length", [1.0, 1.0, 1.0]), dtype=float)
        opt.nxyz = np.asarray(auto.get("ncuts", [1, 1, 1]), dtype=int)
        if np.any(opt.nxyz <= 0) or np.any(opt.mxyz <= 0):
            _abort("Must input mesh geometry/discretization for hex_mesh_gen")
