"""The benchmark's inputs, written from a seed: a frozen copy.

Copied from ``exaconstit_tpu_torch/cases.py`` (its ``TOLERANCES``,
``voronoi_grains``, the seeded quaternions, the options file and
``write_mfem_mesh``) so that a change to the program cannot change what
the benchmark feeds it.  Nothing here imports the program: the voxel
brick is built by ``brick`` below, with the numbering the program's
``make_cartesian_mesh`` uses (nodes and elements x fastest, local nodes
lexicographic), and the plain reference builds its mesh from the same
function or from the mesh file written here.

The case is an ExaCMech crystal under uniaxial tension along z at
1e-3/s with symmetry planes at x = 0, y = 0, z = 0.  Its material is
the one the configuration's ``case`` names under ``material``
(``DEFAULT_MATERIAL`` where it names none): ``inputs/<material>.py``
holds its props, initial state and model types, and
``reference/<material>.py`` its plain point model.
"""

from __future__ import annotations

import importlib
import os
from pathlib import Path

import numpy as np

# the material of a case that names none
DEFAULT_MATERIAL = "voce"
# what each of a material's two modules defines
MATERIAL_NAMES = {
    "inputs": ("PROPS", "INITIAL_STATE", "XTAL_TYPE", "SLIP_TYPE"),
    "reference": ("PointModel", "SLOTS", "STATE"),
}
_HARNESS = Path(__file__).resolve().parent.parent

# [Solvers.NR] rel_tol, abs_tol, [Solvers.Krylov] rel_tol and the point
# solve's tolerance (None keeps the props file's) by precision
TOLERANCES = {
    "f64": dict(nr_rel_tol=5e-5, nr_abs_tol=5e-10, krylov_rel_tol=1e-7,
                solver_tol=None),
    "f32": dict(nr_rel_tol=1e-3, nr_abs_tol=1e-8, krylov_rel_tol=1e-5,
                solver_tol=1e-7),
}

# the velocity boundary conditions: (boundary attribute, component
# code, velocity); attributes 1-6 are the faces z = 0, x = 0, y = 0,
# z = L, x = L, y = L; component code 1, 2, 3 is x, y, z
ESSENTIAL = ((1, 3, (0.0, 0.0, 0.0)), (2, 1, (0.0, 0.0, 0.0)),
             (3, 2, (0.0, 0.0, 0.0)), (4, 3, (0.0, 0.0, 0.001)))

# the options file; the quaternion sits at history slot 9, 4 wide, in
# every ExaCMech material
_TOML = """\
Version = "0.6.0"
[Properties]
    temperature = 298
    [Properties.Matl_Props]
        floc = "props_cp_{material}.txt"
        num_props = {num_props}
    [Properties.State_Vars]
        floc = "state_cp_{material}.txt"
        num_vars = {num_vars}
    [Properties.Grain]
        ori_state_var_loc = 9
        ori_stride = 4
        ori_type = "quat"
        num_grains = {ngrains}
        ori_floc = "quats.ori"
        grain_floc = "grains.txt"
[BCs]
    essential_ids = [{ess_ids}]
    essential_comps = [{ess_comps}]
    essential_vals = [{ess_vals}]
[Model]
    mech_type = "exacmech"
    cp = true
    [Model.ExaCMech]
        xtal_type = "{xtal_type}"
        slip_type = "{slip_type}"
[Time]
    [Time.Custom]
        nsteps = {nsteps}
        floc = "dt.txt"
[Visualizations]
    steps = 100000
    visit = false
    conduit = false
    paraview = false
    floc = "results/exaconstit"
    avg_stress_fname = "avg_stress.txt"
    additional_avgs = false
[Solvers]
    assembly = "{assembly}"
    integ_model = "FULL"
    parallel_mode = "single"
    precision = "{precision}"
    [Solvers.NR]
        iter = 25
        rel_tol = {nr_rel_tol}
        abs_tol = {nr_abs_tol}
    [Solvers.Krylov]
        iter = {krylov_iter}
        rel_tol = {krylov_rel_tol}
        abs_tol = 1e-27
        solver = "PCG"
        precond = "{precond}"
[Mesh]
    ref_ser = 0
    ref_par = 0
    p_refinement = 1
    type = "{mesh_type}"
{mesh_floc}    [Mesh.Auto]
        length = [1.0, 1.0, 1.0]
        ncuts = [{nx}, {ny}, {nz}]
"""


def material_of(case) -> str:
    """The name of the material a configuration's ``case`` names."""
    name = case.get("material", DEFAULT_MATERIAL)
    if not name.isidentifier():
        raise ValueError(f"material {name!r} is not a module name")
    return name


def material_module(kind, name):
    """The module ``<kind>/<name>.py`` of the material ``name``, where
    ``kind`` is ``inputs`` or ``reference``.  Raises ``FileNotFoundError``
    naming the paths it looked for where either of the material's two
    modules is missing, and ``ImportError`` where the module lacks a name
    of ``MATERIAL_NAMES[kind]`` (as the harness's own modules beside it
    do)."""
    paths = {k: _HARNESS / k / f"{name}.py" for k in MATERIAL_NAMES}
    missing = [str(p) for p in paths.values() if not p.is_file()]
    if missing:
        raise FileNotFoundError(
            f"material {name!r}: looked for {paths['inputs']} and "
            f"{paths['reference']}; missing {' and '.join(missing)}")
    mod = importlib.import_module(f"{_HARNESS.name}.{kind}.{name}")
    lacking = [a for a in MATERIAL_NAMES[kind] if not hasattr(mod, a)]
    if lacking:
        raise ImportError(f"{paths[kind]} lacks {', '.join(lacking)}")
    return mod


def voronoi_grains(ncuts, ngrains, seed) -> np.ndarray:
    """Grain ids 1..ngrains of the nearest of ``ngrains`` seeded points,
    per element center, x fastest."""
    nx, ny, nz = ncuts
    rng = np.random.default_rng(seed)
    seeds = rng.uniform(size=(ngrains, 3))
    k, j, i = np.meshgrid((np.arange(nz) + 0.5) / nz,
                          (np.arange(ny) + 0.5) / ny,
                          (np.arange(nx) + 0.5) / nx, indexing="ij")
    centers = np.stack([i.ravel(), j.ravel(), k.ravel()], axis=1)
    ids = np.empty(len(centers), dtype=np.int64)
    for c0 in range(0, len(centers), 4096):
        c = centers[c0:c0 + 4096]
        d2 = ((c[:, None, :] - seeds[None]) ** 2).sum(-1)
        ids[c0:c0 + 4096] = np.argmin(d2, axis=1)
    return ids + 1


def quaternions(ngrains, seed) -> np.ndarray:
    """Seeded random unit quaternions, one per grain."""
    q = np.random.default_rng(seed).normal(size=(ngrains, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def brick(ncuts):
    """The order-1 voxel brick on the unit cube: (coords (nn, 3), conn
    (ne, 8) with local nodes lexicographic, boundary node sets {attribute:
    node ids}), nodes and elements numbered x fastest."""
    nx, ny, nz = ncuts
    n = (nx + 1, ny + 1, nz + 1)
    k, j, i = np.meshgrid(np.arange(n[2]), np.arange(n[1]),
                          np.arange(n[0]), indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    coords = np.stack([i / nx, j / ny, k / nz], axis=1)
    ek, ej, ei = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    base = (ei + n[0] * (ej + n[1] * ek)).ravel()
    local = [dx + n[0] * (dy + n[1] * dz)
             for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    conn = base[:, None] + np.asarray(local)[None, :]
    ids = np.arange(coords.shape[0])
    bdr = {1: ids[k == 0], 2: ids[i == 0], 3: ids[j == 0],
           4: ids[k == nz], 5: ids[i == nx], 6: ids[j == ny]}
    return coords, conn, bdr


# the boundary quads of the brick, per attribute: the face's fixed axis
# and side, and its four corners in the two free axes (MFEM's outward
# orientation)
_FACES = {1: (2, 0, ((0, 0), (0, 1), (1, 1), (1, 0))),
          4: (2, 1, ((0, 0), (1, 0), (1, 1), (0, 1))),
          2: (0, 0, ((0, 0), (0, 1), (1, 1), (1, 0))),
          5: (0, 1, ((0, 0), (1, 0), (1, 1), (0, 1))),
          3: (1, 0, ((0, 0), (1, 0), (1, 1), (0, 1))),
          6: (1, 1, ((0, 0), (0, 1), (1, 1), (1, 0)))}
# lexicographic local vertex -> MFEM hex vertex order (its own inverse)
LEX_TO_MFEM = np.array([0, 1, 3, 2, 4, 5, 7, 6])


def write_mfem_mesh(path, ncuts, grains):
    """The brick as an ASCII MFEM v1.0 mesh: the grain ids as element
    attributes, the boundary quads tagged 1-6 as ExaConstit tags them."""
    coords, conn, _ = brick(ncuts)
    n = tuple(c + 1 for c in ncuts)
    quads = []
    for attr, (axis, side, corners) in _FACES.items():
        u, w = [a for a in range(3) if a != axis]
        iu, iw = np.meshgrid(np.arange(n[u] - 1), np.arange(n[w] - 1),
                             indexing="ij")
        ijk = [None] * 3
        verts = []
        for du, dw in corners:
            ijk[axis] = np.full(iu.size, side * (n[axis] - 1))
            ijk[u], ijk[w] = iu.ravel() + du, iw.ravel() + dw
            verts.append(ijk[0] + n[0] * (ijk[1] + n[1] * ijk[2]))
        quads.append(np.column_stack([np.full(iu.size, attr),
                                      np.full(iu.size, 3)] + verts))
    quads = np.concatenate(quads)
    elems = np.column_stack([grains, np.full(len(conn), 5),
                             conn[:, LEX_TO_MFEM]])
    with open(path, "w") as f:
        f.write("MFEM mesh v1.0\n\ndimension\n3\n\n")
        f.write(f"elements\n{len(elems)}\n")
        np.savetxt(f, elems, fmt="%d")
        f.write(f"\nboundary\n{len(quads)}\n")
        np.savetxt(f, quads, fmt="%d")
        f.write(f"\nvertices\n{len(coords)}\n3\n")
        np.savetxt(f, coords, fmt="%.17g")


def write_case(dirpath, case, dts, seed) -> dict:
    """Write the case ``case`` (a configuration's ``case`` block:
    ncuts, ngrains, mesh_file, assembly, precond, precision, krylov_iter,
    and optionally microstructure_seed and material) for the load steps
    ``dts`` into ``dirpath``, with the options file ``<material>.toml``.
    Returns the inputs both sides read: the options file's path, the
    grain map, the quaternions, the props and the material's name."""
    os.makedirs(dirpath, exist_ok=True)
    material = material_of(case)
    matl = material_module("inputs", material)
    ncuts = tuple(int(c) for c in case["ncuts"])
    ngrains = int(case["ngrains"])
    precision = case.get("precision", "f64")
    tols = TOLERANCES[precision]
    props = np.array(matl.PROPS, dtype=float)
    if tols["solver_tol"] is not None:
        props[2] = tols["solver_tol"]
    if "microstructure_seed" in case:
        # the configuration's one microstructure; the run's seed only
        # relabels its grains (ids and orientation rows permuted alike),
        # so that every seed gives the same work
        ms = int(case["microstructure_seed"])
        quats = quaternions(ngrains, ms)
        grains = voronoi_grains(ncuts, ngrains, ms + 1)
        label = np.random.default_rng(seed).permutation(ngrains)
        grains = label[grains - 1] + 1
        quats = quats[np.argsort(label)]
    else:
        quats = quaternions(ngrains, seed)
        grains = voronoi_grains(ncuts, ngrains, seed + 1)
    np.savetxt(os.path.join(dirpath, f"props_cp_{material}.txt"), props)
    np.savetxt(os.path.join(dirpath, f"state_cp_{material}.txt"),
               matl.INITIAL_STATE)
    np.savetxt(os.path.join(dirpath, "quats.ori"), quats)
    np.savetxt(os.path.join(dirpath, "grains.txt"), grains, fmt="%d")
    np.savetxt(os.path.join(dirpath, "dt.txt"), np.asarray(dts, float))
    mesh_floc = ""
    if case.get("mesh_file", False):
        write_mfem_mesh(os.path.join(dirpath, "mesh.mesh"), ncuts, grains)
        mesh_floc = '    floc = "mesh.mesh"\n'
    path = os.path.join(dirpath, f"{material}.toml")
    with open(path, "w") as f:
        f.write(_TOML.format(
            material=material, num_props=len(props),
            num_vars=len(matl.INITIAL_STATE), ngrains=ngrains,
            ess_ids=", ".join(str(a) for a, _, _ in ESSENTIAL),
            ess_comps=", ".join(str(c) for _, c, _ in ESSENTIAL),
            ess_vals=", ".join(repr(float(x)) for _, _, v in ESSENTIAL
                               for x in v),
            xtal_type=matl.XTAL_TYPE, slip_type=matl.SLIP_TYPE,
            nsteps=len(dts), assembly=case["assembly"],
            precision=precision, precond=case["precond"],
            krylov_iter=int(case.get("krylov_iter", 1000)),
            nr_rel_tol=tols["nr_rel_tol"], nr_abs_tol=tols["nr_abs_tol"],
            krylov_rel_tol=tols["krylov_rel_tol"],
            mesh_type="other" if case.get("mesh_file", False) else "auto",
            mesh_floc=mesh_floc, nx=ncuts[0], ny=ncuts[1], nz=ncuts[2]))
    return dict(options=path, dirpath=dirpath, ncuts=ncuts, grains=grains,
                quats=quats, props=props, material=material,
                mesh_file=os.path.join(dirpath, "mesh.mesh")
                if case.get("mesh_file", False) else None)
