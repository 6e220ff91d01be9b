"""The comparison that decides ``correct``.

The reference takes the inputs the benchmark wrote (mesh or mesh file,
grain map, quaternions, props, boundary conditions, the episode's dt)
and, of what the program produced in the window, the converged nodal
velocity of each solve of each step of one sampled episode (one solve
a step, or each of its sub-solves), its stress and state at
every quadrature point, and the rows it appended to the average stress
file.  From the virgin state and those velocities alone ``replay``
works out each step again: coordinates, velocity gradients, the point
update, the internal forces and the volume average.  ``judge`` reads
the program's stress, state and rows only to compare them.

Numbers, each a maximum over the episode's steps:

* ``stress``: max over points and components of |program - reference|
  over the step's largest |reference stress|;
* ``state``: the same for each quantity the material's ``STATE`` names,
  the largest;
* ``equilibrium``: the norm of the reference's nodal force residual at
  the free dofs at the program's velocity, over the tolerance the
  options file states for Newton's method: max(rel_tol times that norm
  at Newton's start, abs_tol), the largest over the step's solves.
  Newton's start is the last step's velocity with the boundary values
  set (``start_velocity``), as the program starts a step (step 1 too,
  from v = 0, where the program first takes a corrector solve, so step
  1's tolerance is the looser); where the program composed the step of
  sub-solves, each later sub-solve starts from the one before.  The
  limit is 1, the stated tolerance;
* ``avg_stress``: max over the window's rows of that step and their
  components of |row - reference average| over the largest |reference
  average| component;
* ``bc_velocity``: max over the constrained dofs of |program velocity
  - prescribed velocity| over the largest prescribed speed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..inputs.cases import ESSENTIAL, material_module
from .fem import Element, load_mesh

NUMBERS = ("stress", "state", "equilibrium", "avg_stress", "bc_velocity")


def prescribed(nn, bdr):
    """(constrained mask (nn, 3), prescribed velocities (nn, 3)) of
    ``ESSENTIAL``, later attributes overriding earlier ones."""
    mask = np.zeros((nn, 3), bool)
    vel = np.zeros((nn, 3))
    for attr, comp, v in ESSENTIAL:
        nodes = bdr[attr]
        mask[nodes, comp - 1] = True
        vel[nodes] = np.asarray(v) * np.eye(3)[comp - 1]
    return mask, vel


def _sym(stress):
    s = stress
    return torch.stack([torch.stack([s[..., 0], s[..., 5], s[..., 4]], -1),
                        torch.stack([s[..., 5], s[..., 1], s[..., 3]], -1),
                        torch.stack([s[..., 4], s[..., 3], s[..., 2]], -1)],
                       -2)


def start_velocity(v_prev, bdr):
    """Newton's starting velocity of a step: the last step's velocity with
    every node of a constrained boundary attribute set to its attribute's
    prescribed velocity, all three components (ExaConstit's BC update)."""
    v = np.array(v_prev, dtype=float, copy=True)
    for attr, comp, vel in ESSENTIAL:
        v[bdr[attr]] = np.asarray(vel) * np.eye(3)[comp - 1]
    return v


BLOCK_ELEMS = 32768  # elements a block of the replay takes at a time


def replay(inputs, dts, subs, device, dtype=torch.float64, mesh=None):
    """The episode worked out again from the virgin state and the nodal
    velocities of its solves: ``subs[k]`` lists step k's (dt, v) with v
    an (nn, 3) host array, one pair where the program solved the step
    whole, one per sub-solve where it composed the step of sub-solves
    (the sub-steps' dts sum to ``dts[k]``).  Yields one dict per step:
    ``stress`` (ne, nq, 6), ``state`` {e, q, h: (ne, nq, k)}, ``avg``
    (6,) host, ``residuals`` (one pair a solve: the norms of the nodal
    force residual at the free dofs at the solve's velocity and at its
    Newton start) and ``point_residual`` (the point solves' largest
    |r|), all in ``dtype``.  ``mesh`` is ``load_mesh(inputs)`` if already
    read."""
    torch.backends.cuda.matmul.allow_tf32 = False
    coords, conn, grains, bdr = mesh or load_mesh(inputs)
    nn, ne = len(coords), len(conn)
    mask, _ = prescribed(nn, bdr)
    matl = material_module("reference", inputs["material"])
    mat = matl.PointModel(inputs["props"], device, dtype)
    elem = Element(device, dtype)
    t = dict(dtype=dtype, device=device)
    quats = torch.as_tensor(inputs["quats"], **t)[
        torch.as_tensor(np.asarray(grains) - 1, device=device)]
    conn_t = torch.as_tensor(conn, device=device)
    free = torch.as_tensor(~mask, device=device)
    state = mat.virgin(quats[:, None, :].expand(ne, 8, 4))
    x = torch.as_tensor(coords, **t)
    v_prev = np.zeros((nn, 3))

    def step(v, dt, state):
        x_end = x + dt * v
        force = torch.zeros(nn, 3, **t)
        num = torch.zeros(6, **t)
        vol = torch.zeros((), **t)
        parts, stresses, res_max = {}, [], 0.0
        for e0 in range(0, ne, BLOCK_ELEMS):
            sl = slice(e0, min(ne, e0 + BLOCK_ELEMS))
            ci = conn_t[sl]
            dndx, wdet = elem.geometry(x_end[ci])
            L = elem.velocity_gradient(v[ci], dndx)
            stress, st1, res = mat.update(
                L, dt, {n: s[sl] for n, s in state.items()})
            res_max = max(res_max, float(res))
            for n, s in st1.items():
                parts.setdefault(n, []).append(s)
            stresses.append(stress)
            force.index_add_(0, ci.reshape(-1), elem.internal_force(
                dndx, wdet, _sym(stress)).reshape(-1, 3))
            num += torch.einsum("eq,eqc->c", wdet, stress)
            vol += wdet.sum()
        return (float(torch.linalg.vector_norm(force[free])), x_end,
                torch.cat(stresses),
                {n: torch.cat(s) for n, s in parts.items()},
                (num / vol).cpu().numpy().astype(np.float64), res_max)

    for dt, step_subs in zip(dts, subs):
        assert abs(sum(d for d, _ in step_subs) - dt) <= 1e-12 * dt
        # Newton starts the step (its first sub-solve) from the last
        # step's velocity with the boundary values set, and each later
        # sub-solve from the sub-solve before
        start = start_velocity(v_prev, bdr)
        residuals, res_max = [], 0.0
        for dt_k, v_host in step_subs:
            r0 = step(torch.as_tensor(start, **t), dt_k, state)[0]
            r, x_end, stress, state, avg, res_k = step(
                torch.as_tensor(v_host, **t), dt_k, state)
            residuals.append((r, r0))
            res_max = max(res_max, res_k)
            x, start = x_end, v_host
        v_prev = step_subs[-1][1]
        yield dict(stress=stress,
                   state={n: state[n] if state[n].dim() == 3
                          else state[n][..., None] for n in matl.STATE},
                   avg=avg, residuals=residuals, point_residual=res_max)


def judge(inputs, dts, steps, rows, device, nr_rel_tol, nr_abs_tol):
    """Numbers of the episode ``steps`` (one dict per step: ``v`` (nn, 3),
    ``stress`` (6, nq, ne), ``state`` {the material's ``STATE``: (k, nq,
    ne)}, host arrays) against the float64 reference; ``rows[k]`` lists the
    window's rows for step k; ``nr_rel_tol`` and ``nr_abs_tol`` are the
    Newton tolerances the options file states.  Returns ({number:
    value}, notes)."""
    mesh = load_mesh(inputs)
    mask, vel = prescribed(len(mesh[0]), mesh[3])
    out = {k: 0.0 for k in NUMBERS}
    notes = []
    ref = replay(inputs, dts, [s["subs"] for s in steps], device,
                 mesh=mesh)
    for k, (got, r) in enumerate(zip(steps, ref)):
        if r["point_residual"] > 1e-12:
            notes.append(f"step {k + 1}: the reference's point solve left "
                         f"|r| {r['point_residual']:.3e}")
        out["stress"] = max(out["stress"], _gap(got["stress"], r["stress"]))
        out["state"] = max(out["state"], *(
            _gap(got["state"][n], r["state"][n]) for n in r["state"]))
        out["equilibrium"] = max(out["equilibrium"], *(
            res / max(nr_rel_tol * res0, nr_abs_tol)
            for res, res0 in r["residuals"]))
        scale = np.abs(r["avg"]).max()
        for row in rows[k]:
            out["avg_stress"] = max(out["avg_stress"], float(
                np.abs(np.asarray(row, float) - r["avg"]).max() / scale))
        for _, v in got["subs"]:
            bc = np.abs(np.asarray(v, float)[mask] - vel[mask]).max() \
                / np.abs(vel).max()
            out["bc_velocity"] = max(out["bc_velocity"], float(bc))
    return out, notes


def _gap(prog, ref):
    """max |program - reference| over max |reference|; the program's
    point field is (k, nq, ne), the reference's (ne, nq, k)."""
    p = torch.as_tensor(np.asarray(prog), dtype=ref.dtype,
                        device=ref.device).permute(2, 1, 0)
    return float((p - ref).abs().max() / ref.abs().max())


def control_steps(inputs, dts, subs, device):
    """The reference put in the program's place in float32: its stress,
    state and average row from the program's velocities (``subs`` as
    ``replay`` takes them), laid out as the program's outputs are (the
    benchmark's control)."""
    steps, rows = [], []
    for s, r in zip(subs, replay(inputs, dts, subs, device, torch.float32)):
        steps.append(dict(
            v=s[-1][1], subs=s,
            stress=r["stress"].permute(2, 1, 0).double().cpu().numpy(),
            state={n: r["state"][n].permute(2, 1, 0).double().cpu().numpy()
                   for n in r["state"]}))
        rows.append([r["avg"]])
    return steps, rows
