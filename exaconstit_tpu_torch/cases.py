"""In-repo cases: options file and inputs, from a seed.

The two flagship families of the reference, written into a directory so
a run needs nothing outside the repository.  Both are polycrystals under
uniaxial tension along z with symmetry planes at x = 0, y = 0, z = 0:

* ``write_voce_case`` (``voce_full``): copper FCC crystals, power-law
  slip with Voce hardening;
* ``write_mtsdd_case`` (``mtsdd_full``): Kocks-Mecking dislocation-density
  kinetics, for FCC or BCC crystals with the copper parameter set (whose
  k1, k2_0 select the calibrated rows of ``ecmech._MTSDD_CALIBRATION``)
  or HCP crystals with a titanium-like per-slip set;
* ``write_umat_case``: an isotropic elastic UMAT (the repository's
  ``native/libumat_elastic.so``, E = 100, nu = 0.3) on one grain.

Every writer can put the voxel brick into an MFEM mesh file
(``mesh_file=True``, ``write_mfem_mesh``) and name the assembly, the
integration model and the Krylov solver.

Each writes:

* ``props_*.txt``: the material constants;
* ``state_*.txt``: the initial state values the schema expects (the
  model's own initial state takes precedence, as in ExaConstit);
* ``quats.ori``: seeded random unit quaternions, one per grain;
* ``grains.txt``: a seeded nearest-seed (Voronoi) grain map on the voxel
  grid, one grain id per element, x fastest;
* ``dt.txt``: the custom time-step schedule (unless ``auto_dt``);
* ``mesh.mesh``: the voxel brick as an MFEM mesh (with ``mesh_file``);
* ``voce.toml`` / ``mtsdd.toml`` / ``umat.toml``: the options file.
"""

from __future__ import annotations

import os

import numpy as np

VOCE_PROPS = np.array([
    8.920e-6, 0.003435984, 1.0e-10,      # rho0, cv, solver tol
    168.4, 121.4, 75.2,                  # c11, c12, c44 (GPa)
    44.0, 0.02, 1.0,                     # mu, m, gdot_0
    400.0e-3, 17.0e-3, 122.4e-3,         # h0, g0, gs0
    0.0, 5.0e9, 17.0e-3,                 # xms, gam_s, hdn_init
    0.0, -1.0307952,                     # gruneisen, ref energy
])


def _voigt_reuss_shear(c11, c12, c44):
    mu = (c11 - c12) / 2.0
    voigt = 0.2 * (2.0 * mu + 3.0 * c44)
    reuss = (mu * c44) / (c44 + 3.0 * (mu - c44) * 0.2)
    return 0.5 * (voigt + reuss)


# copper MTSDD set, in the order scripts/ecmech_prop_file.py documents
MTSDD_PROPS = np.array([
    8.920e-6, 385.2, 1e-8,               # rho0, cv, solver tol
    168.4, 121.4, 75.2,                  # c11, c12, c44 (GPa)
    _voigt_reuss_shear(168.4, 121.4, 75.2), 300.0,  # mu_ref, T_ref
    1944.106926, 4e-4, 1.0, 1.0,         # g0 b^3 / kB, tau_Peierls, p, q
    1.0, 1.0, 0.03,                      # gam_wo, gam_ro, drag stress
    0.008, 0.1,                          # go, s
    3e-4, 5e-5, 0.1, 0.01, 9e-4,         # k1, k2_0, ninv, gam_ro_dd, rho_dd
    0.0, -385.2 * 300.0,                 # gruneisen, ref energy
])


def hcp_mtsdd_props() -> np.ndarray:
    """A titanium-like HCP MTSDD set in the per-slip layout (95 values:
    c_1, g_0 and s for each of the 24 systems), with the basal and
    prismatic families soft and the pyramidal ones hard."""
    S = 24
    go = np.full(S, 12e-3)
    go[:6] = 4e-3
    s = np.full(S, 0.12)
    s[:6] = 0.06
    c1 = np.full(S, 1.9e3)
    return np.concatenate([
        [8.92e-6, 385.0, 1e-10],
        [162.4, 92.0, 69.0, 180.7, 46.7],  # c11 c12 c13 c33 c44
        [46.0, 300.0], c1,
        [4e-4, 1.0, 1.0, 1.0, 1.0, 3e-2],
        go, s,
        [3e-4, 5e-5, 0.1, 1e-2, 9e-4],
        [0.0, -1.1556e5],
    ])


_GRAIN = """\
    [Properties.Grain]
        ori_state_var_loc = 9
        ori_stride = 4
        ori_type = "quat"
        num_grains = {ngrains}
        ori_floc = "quats.ori"
        grain_floc = "grains.txt"
"""

_EXACMECH = """\
    mech_type = "exacmech"
    cp = true
    [Model.ExaCMech]
        xtal_type = "{xtal}"
        slip_type = "{slip}"
"""

_UMAT = """\
    mech_type = "umat"
    cp = false
    [Model.UMAT]
        library = "{library}"
"""

_TOML = """\
Version = "0.6.0"
{checkpoint}[Properties]
    temperature = 298
    [Properties.Matl_Props]
        floc = "{props_file}"
        num_props = {num_props}
    [Properties.State_Vars]
        floc = "{state_file}"
        num_vars = {num_vars}
{grain}[BCs]
    essential_ids = [1, 2, 3, 4]
    essential_comps = [3, 1, 2, 3]
    essential_vals = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.001]
[Model]
{model}[Time]
{time}
[Visualizations]
    steps = {vis_steps}
    visit = false
    conduit = false
    paraview = {paraview}
    floc = "results/exaconstit"
    avg_stress_fname = "avg_stress.txt"
    additional_avgs = {additional_avgs}
[Solvers]
    assembly = "{assembly}"
    integ_model = "{integ_model}"
    parallel_mode = "{parallel_mode}"
    precision = "{precision}"
    [Solvers.NR]
        iter = 25
        rel_tol = {nr_rel_tol}
        abs_tol = {nr_abs_tol}
    [Solvers.Krylov]
        iter = {krylov_iter}
        rel_tol = {krylov_rel_tol}
        abs_tol = 1e-27
        solver = "{krylov_solver}"
{precond}[Mesh]
    ref_ser = 0
    ref_par = 0
    p_refinement = 1
    type = "{mesh_type}"
{mesh_floc}    [Mesh.Auto]
        length = [1.0, 1.0, 1.0]
        ncuts = [{nx}, {ny}, {nz}]
"""

# Solver tolerances by precision: [Solvers.NR] rel_tol, abs_tol,
# [Solvers.Krylov] rel_tol, and the point solve's tolerance (the props
# file's third value; None keeps the props set's own).  f32 cannot reach
# the f64 values.  Newton's residual stalls where the point solve's
# tolerance leaves it, and Newton stops at rel 1e-3: with the point solve
# at the 1e-6 that the reference's note on f32 runs gives, the 32^3 Voce
# case in dt 0.01 steps stalls near that 1e-3 (13-16 iterations a step,
# a failed step by the sixth); at 1e-7 every step takes about two.  f32
# PCG's true residual stops falling near 1e-7 to 1e-5 of the right-hand
# side while its recurrence keeps falling, so Krylov stops at 1e-5.
TOLERANCES = {
    "f64": dict(nr_rel_tol=5e-5, nr_abs_tol=5e-10, krylov_rel_tol=1e-7,
                solver_tol=None),
    "f32": dict(nr_rel_tol=1e-3, nr_abs_tol=1e-8, krylov_rel_tol=1e-5,
                solver_tol=1e-7),
}


def voronoi_grains(ncuts, ngrains, seed=0) -> np.ndarray:
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


def _bool(v):
    return "true" if v else "false"


# the boundary quads of a voxel brick, per ExaConstit attribute: the
# face's fixed axis and side, and its four corners in the two free axes
# (MFEM's outward orientation)
_FACES = {1: (2, 0, ((0, 0), (0, 1), (1, 1), (1, 0))),
          4: (2, 1, ((0, 0), (1, 0), (1, 1), (0, 1))),
          2: (0, 0, ((0, 0), (0, 1), (1, 1), (1, 0))),
          5: (0, 1, ((0, 0), (1, 0), (1, 1), (0, 1))),
          3: (1, 0, ((0, 0), (1, 0), (1, 1), (0, 1))),
          6: (1, 1, ((0, 0), (0, 1), (1, 1), (1, 0)))}
# lexicographic local vertex -> MFEM hex vertex order (its own inverse)
_LEX_TO_MFEM = np.array([0, 1, 3, 2, 4, 5, 7, 6])


def write_mfem_mesh(path, mesh):
    """Write an order-1 voxel brick (``make_cartesian_mesh``) as an ASCII
    MFEM v1.0 mesh: the grain ids as element attributes and the
    boundary quads tagged 1-6 as ExaConstit tags them (z = 0, x = 0,
    y = 0, z = L, x = L, y = L).  ``read_mfem_mesh`` reads it back with
    the same nodes, elements, attributes and boundary node sets."""
    if mesh.structure is None or mesh.order != 1:
        raise ValueError("write_mfem_mesh writes an order-1 voxel brick")
    nx, ny, nz = mesh.structure
    n = (nx + 1, ny + 1, nz + 1)
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
    elems = np.column_stack([mesh.elem_attr, np.full(mesh.num_elems, 5),
                             np.asarray(mesh.conn)[:, _LEX_TO_MFEM]])
    with open(path, "w") as f:
        f.write("MFEM mesh v1.0\n\ndimension\n3\n\n")
        f.write(f"elements\n{len(elems)}\n")
        np.savetxt(f, elems, fmt="%d")
        f.write(f"\nboundary\n{len(quads)}\n")
        np.savetxt(f, quads, fmt="%d")
        f.write(f"\nvertices\n{mesh.num_nodes}\n3\n")
        np.savetxt(f, mesh.coords, fmt="%.17g")


UMAT_LIBRARY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "libumat_elastic.so")


def _write_case(dirpath, name, props, ncuts, dts, ngrains, seed,
                xtal=None, slip=None, library=None, additional_avgs=False,
                paraview=False, vis_steps=100, checkpoint_steps=0,
                restart=False, auto_dt=None, mesh_file=False, assembly="EA",
                integ_model="FULL", krylov_solver="PCG",
                krylov_iter=1000, precision="f64", parallel_mode="single",
                precond=None) -> str:
    """Write the input files and ``<name>.toml`` into ``dirpath``: an
    ExaCMech crystal case (``xtal``, ``slip``) or, with ``library``, a
    UMAT case on one grain with one zero state variable.

    ``auto_dt`` switches from the custom schedule ``dts`` to automatic
    time stepping: a dict with ``dt_start``, ``dt_min``, ``t_final`` and
    optionally ``dt_scale``.  ``checkpoint_steps`` > 0 writes a
    checkpoint every that many steps, ``restart`` resumes from it;
    ``paraview`` dumps VTU/PVD files every ``vis_steps`` steps and at the
    end; ``additional_avgs`` adds the plastic work, deformation gradient
    and plastic deformation rate files.  ``mesh_file`` writes the voxel
    brick (with the grain map as attributes) to ``mesh.mesh`` and reads
    it as ``Mesh.type = "other"``; ``assembly`` ("EA", "PA", "FULL"),
    ``integ_model`` ("FULL", "BBAR"), ``krylov_solver`` ("PCG",
    "MINRES", "GMRES"), ``krylov_iter``, ``precond`` ("jacobi", "gmg";
    None leaves the reference's "auto") and ``parallel_mode`` ("single",
    "auto", "slab", "replicated") go to ``[Solvers]``.
    ``precision`` ("f64" or "f32") goes there too, with the solver
    tolerances of ``TOLERANCES[precision]``; in f32 an ExaCMech props
    file carries the relaxed point-solve tolerance."""
    from .mesh.voxel import make_cartesian_mesh
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(ngrains, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    props_file, state_file = f"props_{name}.txt", f"state_{name}.txt"
    if library is None:
        nslip = 24 if xtal == "hcp" else 12
        num_vars = 4 + 5 + 1 + nslip + 2  # the history less the quaternion
        props_file, state_file = f"props_cp_{name}.txt", f"state_cp_{name}.txt"
        grain = _GRAIN.format(ngrains=ngrains)
        model = _EXACMECH.format(xtal=xtal, slip=slip)
    else:
        num_vars = 1
        grain = ""
        model = _UMAT.format(library=library)
    tols = TOLERANCES[precision]
    if library is None and tols["solver_tol"] is not None:
        props = np.array(props, dtype=float)
        props[2] = tols["solver_tol"]
    np.savetxt(os.path.join(dirpath, props_file), props)
    np.savetxt(os.path.join(dirpath, state_file), np.zeros(num_vars))
    np.savetxt(os.path.join(dirpath, "quats.ori"), q)
    grains = voronoi_grains(ncuts, ngrains, seed + 1)
    np.savetxt(os.path.join(dirpath, "grains.txt"), grains, fmt="%d")
    mesh_floc = ""
    if mesh_file:
        write_mfem_mesh(os.path.join(dirpath, "mesh.mesh"),
                        make_cartesian_mesh(ncuts, [1.0, 1.0, 1.0],
                                            grain_map=grains))
        mesh_floc = '    floc = "mesh.mesh"\n'
    if auto_dt is None:
        np.savetxt(os.path.join(dirpath, "dt.txt"), np.asarray(dts, float))
        time = (f"    [Time.Custom]\n        nsteps = {len(dts)}\n"
                '        floc = "dt.txt"')
    else:
        time = "    [Time.Auto]\n" + "\n".join(
            f"        {k} = {v}" for k, v in auto_dt.items())
    checkpoint = ""
    if checkpoint_steps > 0 or restart:
        checkpoint = (f"[Checkpoint]\n    steps = {checkpoint_steps}\n"
                      f"    restart = {_bool(restart)}\n")
    path = os.path.join(dirpath, f"{name}.toml")
    with open(path, "w") as f:
        f.write(_TOML.format(
            checkpoint=checkpoint, props_file=props_file,
            num_props=len(props), state_file=state_file, num_vars=num_vars,
            grain=grain, model=model, time=time,
            vis_steps=vis_steps, paraview=_bool(paraview),
            additional_avgs=_bool(additional_avgs), assembly=assembly,
            integ_model=integ_model, krylov_solver=krylov_solver,
            krylov_iter=krylov_iter, precision=precision,
            parallel_mode=parallel_mode,
            precond="" if precond is None else
            f'        precond = "{precond}"\n',
            nr_rel_tol=tols["nr_rel_tol"], nr_abs_tol=tols["nr_abs_tol"],
            krylov_rel_tol=tols["krylov_rel_tol"],
            mesh_type="other" if mesh_file else "auto", mesh_floc=mesh_floc,
            nx=ncuts[0], ny=ncuts[1], nz=ncuts[2]))
    return path


def write_voce_case(dirpath, ncuts, dts, ngrains=500, seed=0, **options) -> str:
    """Write the FCC Voce case into ``dirpath``; returns the options file
    path.  ``options`` as in ``_write_case``."""
    return _write_case(dirpath, "voce", VOCE_PROPS, ncuts, dts, ngrains,
                       seed, xtal="fcc", slip="powervoce", **options)


def write_mtsdd_case(dirpath, ncuts, dts, ngrains=500, xtal="fcc", seed=0,
                     **options) -> str:
    """Write the MTSDD case for ``xtal`` ("fcc", "bcc" or "hcp") into
    ``dirpath``; returns the options file path."""
    if xtal not in ("fcc", "bcc", "hcp"):
        raise ValueError(f"unknown xtal {xtal!r}")
    props = hcp_mtsdd_props() if xtal == "hcp" else MTSDD_PROPS
    return _write_case(dirpath, "mtsdd", props, ncuts, dts, ngrains, seed,
                       xtal=xtal, slip="mtsdd", **options)


def write_umat_case(dirpath, ncuts, dts, library=UMAT_LIBRARY,
                    E=100.0, nu=0.3, seed=0, **options) -> str:
    """Write the elastic UMAT case (props E, nu; one grain) into
    ``dirpath``; returns the options file path.  ``options`` as in
    ``_write_case``."""
    return _write_case(dirpath, "umat", np.array([E, nu]), ncuts, dts, 1,
                       seed, library=library, **options)
