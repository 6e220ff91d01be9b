"""Faults planted under a built cell, to see the comparison fail.

Each takes the built ``core.Cell`` and breaks the timed path
underneath it: ``state_unchanged`` (a step that returns its state
unchanged), ``half_batch`` (the volume average taken over half of the
elements), ``answer_altered`` (a stress altered where Newton's solve
produces it) and ``velocity_altered`` (a free velocity altered there).
``control.py --fault <name>`` plants one at a cell's own size on the
card; the harness's tests plant each at 4^3 on the CPU.
"""

from __future__ import annotations


def state_unchanged(cell):
    sim = cell.sim
    advance = sim.advance

    def stale(ti, dt, verbose=True):
        state = sim.state
        out = advance(ti, dt, verbose)
        sim.state = state
        return out

    sim.advance = stale


def half_batch(cell):
    sysm = cell.sim.system
    vol_avg = sysm.vol_avg

    def half(values_q, el_x, divide=True):
        ne = values_q.shape[-1] // 2
        return vol_avg(values_q[..., :ne], el_x[..., :ne], divide)

    sysm.vol_avg = half


def answer_altered(cell):
    sysm = cell.sim.system
    newton = sysm.newton_solve

    def altered(*a, **k):
        v, stress, *rest = newton(*a, **k)
        stress = stress.clone()
        stress[2, 5] += 1e-3 * float(stress.abs().max())
        return (v, stress, *rest)

    sysm.newton_solve = altered


def velocity_altered(cell):
    sysm = cell.sim.system
    newton = sysm.newton_solve

    def altered(*a, **k):
        v, *rest = newton(*a, **k)
        v = v.clone()
        v[7] += 1e-3 * float(v.abs().max())  # a free x dof
        return (v, *rest)

    sysm.newton_solve = altered


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                  answer_altered, velocity_altered)}
