"""Checkpoint / restart.

Port of ``exaconstit_tpu.io.checkpoint`` with the same archive: one
compressed ``.npz`` holding ``x_beg`` and ``v`` (nn, 3), ``state`` and
``state_prev`` (ne, nq, num_state), ``stress`` (ne, nq, 6), ``t``, ``ti``,
``dt_auto_cur`` and ``bc_epoch``, all in the host's point-major shapes
(the device layout is a ``MechSystem`` detail), whatever the mesh (voxel
brick or mesh file) and the model (an ExaCMech history or a UMAT's F,
stress and user state).  A checkpoint written by either package resumes
in the other.  All simulation state is explicit,
so a resumed run repeats the uninterrupted one exactly.
"""

from __future__ import annotations

import os

import numpy as np


def save_checkpoint(path: str, sim, t: float, ti: int):
    # active BC epoch: the last update step <= ti (cur_bcs stays fixed
    # between update steps)
    bc_epoch = max(s for s in sim.update_steps if s <= ti)
    sysm = sim.system
    arrays = dict(
        x_beg=sysm.from_node(sim.x_beg),
        v=sysm.from_node(sim.v),
        state=sysm.from_state(sim.state),
        stress=sysm.from_stress(sim.stress),
        t=t,
        ti=ti,
        dt_auto_cur=sim.dt_auto_cur,
        bc_epoch=bc_epoch,
    )
    if hasattr(sim, "state_prev"):
        arrays["state_prev"] = sysm.from_state(sim.state_prev)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, sim):
    """Restore ``sim`` from the archive; returns (t, last finished step)."""
    with np.load(path) as data:
        sysm = sim.system
        sim.x_beg = sysm.to_node(data["x_beg"])
        sim.x_cur = sim.x_beg
        sim.v = sysm.to_node(data["v"])
        sim.state = sysm.to_state(data["state"])
        sim.stress = sysm.to_stress(data["stress"])
        if "state_prev" in data:
            sim.state_prev = sysm.to_state(data["state_prev"])
        sim.dt_auto_cur = float(data["dt_auto_cur"])
        # restore the active BC epoch: without this a restart after a BC
        # change resumes with the step-1 BCs until the next update step
        if "bc_epoch" in data:
            sim.cur_bcs = sim.bc_steps[int(data["bc_epoch"])]
        return float(data["t"]), int(data["ti"])
