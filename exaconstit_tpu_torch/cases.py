"""An in-repo FCC power-law Voce case: options file and inputs, from a seed.

The flagship configuration of the reference (``voce_full``: copper FCC
crystals, power-law slip with Voce hardening, uniaxial tension along z
with symmetry planes at x = 0, y = 0, z = 0) written into a directory,
so a run needs nothing outside the repository:

* ``props_cp_voce.txt``: the copper Voce constants (public values, the
  same as the reference's test/data/props_cp_voce.txt);
* ``state_cp_voce.txt``: the 24 initial state values the schema expects
  (the model's own initial state takes precedence, as in ExaConstit);
* ``quats.ori``: seeded random unit quaternions, one per grain;
* ``grains.txt``: a seeded nearest-seed (Voronoi) grain map on the voxel
  grid, one grain id per element, x fastest;
* ``dt.txt``: the custom time-step schedule;
* ``voce.toml``: the options file.
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

_TOML = """\
Version = "0.6.0"
[Properties]
    temperature = 298
    [Properties.Matl_Props]
        floc = "props_cp_voce.txt"
        num_props = 17
    [Properties.State_Vars]
        floc = "state_cp_voce.txt"
        num_vars = 24
    [Properties.Grain]
        ori_state_var_loc = 9
        ori_stride = 4
        ori_type = "quat"
        num_grains = {ngrains}
        ori_floc = "quats.ori"
        grain_floc = "grains.txt"
[BCs]
    essential_ids = [1, 2, 3, 4]
    essential_comps = [3, 1, 2, 3]
    essential_vals = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.001]
[Model]
    mech_type = "exacmech"
    cp = true
    [Model.ExaCMech]
        xtal_type = "fcc"
        slip_type = "powervoce"
[Time]
    [Time.Custom]
        nsteps = {nsteps}
        floc = "dt.txt"
[Visualizations]
    steps = 100
    visit = false
    conduit = false
    paraview = false
    avg_stress_fname = "avg_stress.txt"
[Solvers]
    assembly = "EA"
    parallel_mode = "single"
    [Solvers.NR]
        iter = 25
        rel_tol = 5e-5
        abs_tol = 5e-10
    [Solvers.Krylov]
        iter = 1000
        rel_tol = 1e-7
        abs_tol = 1e-27
        solver = "PCG"
[Mesh]
    ref_ser = 0
    ref_par = 0
    p_refinement = 1
    type = "auto"
    [Mesh.Auto]
        length = [1.0, 1.0, 1.0]
        ncuts = [{nx}, {ny}, {nz}]
"""


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


def write_voce_case(dirpath, ncuts, dts, ngrains=500, seed=0) -> str:
    """Write the case into ``dirpath``; returns the options file path."""
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(ngrains, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.savetxt(os.path.join(dirpath, "props_cp_voce.txt"), VOCE_PROPS)
    np.savetxt(os.path.join(dirpath, "state_cp_voce.txt"), np.zeros(24))
    np.savetxt(os.path.join(dirpath, "quats.ori"), q)
    np.savetxt(os.path.join(dirpath, "grains.txt"),
               voronoi_grains(ncuts, ngrains, seed + 1), fmt="%d")
    np.savetxt(os.path.join(dirpath, "dt.txt"), np.asarray(dts, float))
    path = os.path.join(dirpath, "voce.toml")
    with open(path, "w") as f:
        f.write(_TOML.format(ngrains=ngrains, nsteps=len(dts),
                             nx=ncuts[0], ny=ncuts[1], nz=ncuts[2]))
    return path
