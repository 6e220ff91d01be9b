"""One run of one cell: set-up, the measured window, the traced
reading, the comparison with the reference, the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell's configuration and traffic; the configuration is
``configs/<config>.json`` (the case handed to the frozen input writer,
and the limits of the comparison), its case's material (``material``,
``cases.DEFAULT_MATERIAL`` where it names none) ``inputs/<material>.py``
(what the input writer writes for it) and ``reference/<material>.py``
(its plain point model and the state compared), the traffic
``traffic/<mix>.json`` (the episode's dt schedule) and each per-layer
metric ``metrics/<metric>.py`` (a reader of the traced run).

The window drives the program's own entry, ``Simulation.advance`` and
``Simulation.write_averages``, one load step at a time, in episodes
that start from the saved start state (restored through the program's
``io/checkpoint.py`` with the clock stopped).
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .inputs.cases import MATERIAL_NAMES, TOLERANCES, material_module, \
    material_of, write_case
from .reference.judge import NUMBERS, control_steps, judge
from . import tracing

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "exaconstit_tpu")
GIB = float(1 << 30)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def resolve(workload):
    """(workload entry, configuration file, traffic file, metrics of the
    cell) of ``workload`` in ``BENCHMARK.json``.  Raises, as
    ``cases.material_module`` does, where the configuration's material
    lacks its input or reference module."""
    bench = load_json(REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(REPO / configs[cell["config"]]["file"])
    for kind in MATERIAL_NAMES:
        material_module(kind, material_of(config["case"]))
    traffic = load_json(ROOT / "traffic" / f"{cell['traffic']}.json")

    def mine(m):
        return workload in m.get("workloads", [workload])

    return (cell, config, traffic,
            [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole."""
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


class Cell:
    """The program built for one configuration and traffic mix."""

    def __init__(self, config, traffic, seed, device, workdir, trace,
                 overrides=None):
        import torch
        from exaconstit_tpu_torch import set_precision_policy
        from exaconstit_tpu_torch.config.options import parse_options
        from exaconstit_tpu_torch.driver import Simulation
        from exaconstit_tpu_torch.io.checkpoint import save_checkpoint

        self.torch = torch
        self.device = torch.device(device)
        self.dts = [float(d) for d in traffic["dts"]]
        case = dict(config["case"], **(overrides or {}))
        self.inputs = write_case(workdir, case, self.dts, seed)
        for k in [k for k in os.environ if k.startswith("EXACONSTIT")]:
            del os.environ[k]
        if trace:
            os.environ["EXACONSTIT_TPU_REGIONS"] = "1"
        set_precision_policy()
        torch.set_grad_enabled(False)
        self.opt = parse_options(self.inputs["options"])
        self.sim = Simulation(self.opt, workdir=workdir, device=self.device)
        self.ckpt = os.path.join(workdir, "start.npz")
        # the saved start: the virgin state, v = 0 and the first BC epoch
        save_checkpoint(self.ckpt, self.sim, 0.0, 1)
        self.rows_file = os.path.join(workdir, self.opt.avg_stress_fname)

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def restore(self):
        from exaconstit_tpu_torch.io.checkpoint import load_checkpoint
        load_checkpoint(self.ckpt, self.sim)
        self.sync()

    def record_solves(self):
        """Keep (dt, velocity, converged) of every Newton solve of the
        step under way, so that a step the program took in sub-solves
        can be followed sub-solve by sub-solve."""
        sysm = self.sim.system
        newton = sysm.newton_solve
        self.solves = []

        def newton_solve(v, x, state, dt, *a, **k):
            out = newton(v, x, state, dt, *a, **k)
            self.solves.append((float(dt), out[0], bool(out[3])))
            return out

        sysm.newton_solve = newton_solve

    def step(self, ti, dt):
        """One load step as the program's time loop takes it."""
        self.solves = []
        self.sim.advance(ti, dt, verbose=False)
        self.sim.write_averages()
        self.sync()

    def finite(self):
        t = self.torch
        return bool(t.isfinite(self.sim.stress).all()) and bool(
            t.isfinite(self.sim.v).all())

    def snapshot(self):
        """The step's outputs the reference judges, as host arrays:
        the velocity of each of its solves (``subs``, one (dt, v) per
        sub-solve; the last is the program's velocity), its stress and
        state."""
        sim, sysm = self.sim, self.sim.system
        nq, ne = sysm.nq, sysm.ne

        def pts(a):
            return a.double().cpu().numpy().reshape(a.shape[0], nq, ne)

        def host(v):
            return v.double().cpu().numpy().reshape(3, -1).T

        nsub = sim.step_stats[-1].get("subdivided", 1)
        subs = [(dt, host(v)) for dt, v, conv in self.solves[-nsub:]]
        if nsub > 1:
            assert all(conv for _, _, conv in self.solves[-nsub:])
        subs[-1] = (subs[-1][0], host(sim.v))
        matl = material_module("reference", self.inputs["material"])
        return dict(v=subs[-1][1], subs=subs,
                    stress=pts(sim.stress),
                    state={n: pts(sim.state[matl.SLOTS[n]])
                           for n in matl.STATE})

    def rows(self):
        return np.loadtxt(self.rows_file, ndmin=2)


def run(workload, seed, seconds, trace, device="cuda", t_start=None,
        overrides=None, fault=None, control=None, log=None):
    """One run; returns the result line's dict.  ``overrides`` replace
    keys of the configuration's case (a test's smaller mesh, the
    program's float32 path), ``fault`` is called with the built
    ``Cell`` (a test's broken path); ``control`` "reference32" also
    judges the float32 reference in the program's place on the same
    episode, under the result's keys ``control`` (its numbers) and
    ``control_correct`` (``verdict`` of them, as for the program)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr))
    import torch
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _, config, traffic, e2e, per_layer = resolve(workload)
    rng = np.random.default_rng(seed)
    workdir = tempfile.mkdtemp(prefix=f"{workload}_",
                               dir=os.environ.get("TMPDIR"))
    try:
        return _run(workload, seed, seconds, trace, device, t_start,
                    overrides, fault, control, log, cuda, config, traffic,
                    e2e, per_layer, rng, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(workload, seed, seconds, trace, device, t_start, overrides, fault,
         control, log, cuda, config, traffic, e2e, per_layer, rng, workdir):
    import torch
    cell = Cell(config, traffic, seed, device, workdir, trace, overrides)
    log(f"built in {time.perf_counter() - t_start:.2f} s")
    if fault is not None:
        fault(cell)
    cell.record_solves()
    rec = tracing.Recorder(cell) if trace else None
    nsteps = len(cell.dts)

    # warm-up: one whole episode runs every shape the window runs
    for ti, dt in enumerate(cell.dts, 1):
        cell.step(ti, dt)
    cell.restore()
    rows_before = len(cell.rows())

    log(f"warm episode done at {time.perf_counter() - t_start:.2f} s")
    attempted = failed = 0
    clock = restore_s = 0.0
    episode_s = []
    episodes = 0
    sample, sample_steps = None, None
    window_rows = []  # (step index in the episode) per row appended
    if rec:
        rec.start_window()
    setup_s = time.perf_counter() - t_start
    while clock < seconds:
        if episodes:
            t0 = time.perf_counter()
            cell.restore()
            restore_s += time.perf_counter() - t0
        episodes += 1
        # reservoir sampling of the episode the reference checks
        keep = rng.random() < 1.0 / episodes
        steps = []
        for k, dt in enumerate(cell.dts):
            attempted += 1
            t0 = time.perf_counter()
            try:
                cell.step(k + 1, dt)
            except RuntimeError as e:
                clock += time.perf_counter() - t0
                failed += 1
                log(f"step {k + 1} of episode {episodes} failed: {e}")
                break
            clock += time.perf_counter() - t0
            window_rows.append(k)
            if not cell.finite():
                failed += 1
                log(f"step {k + 1} of episode {episodes}: non-finite "
                    "stress or velocity")
                break
            if keep:
                steps.append(cell.snapshot())
        if keep:
            sample, sample_steps = episodes, steps
        episode_s.append(clock - sum(episode_s))
    completed = attempted - failed
    stats = cell.sim.step_stats[-attempted:]
    log(f"window: {episodes} episodes, {clock:.3f} s of steps, "
        f"{restore_s:.2f} s of restores; Newton iterations "
        f"{[s['first_nr'] for s in stats[:nsteps]]}, sub-solves "
        f"{sorted({s['subdivided'] for s in stats})}, Krylov iterations a "
        f"step {sum(sum(s['krylov_iters']) for s in stats) / max(attempted, 1):.2f}"
        f"; episodes (s) {[round(e, 4) for e in episode_s]}")
    if rec:
        rec.stop_window(clock, completed)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    layer = extras = breakdown = None
    if rec:
        cell.restore()
        rec.profiled_episode(workdir)
        layer, extras, breakdown = rec.metrics(per_layer, ROOT / "metrics")
        for line in rec.summary():
            log(line)

    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")

    rows = cell.rows()[rows_before:rows_before + len(window_rows)]
    inputs = cell.inputs
    dts = cell.dts
    del cell, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the comparison with the reference, after the window
    t_check = time.perf_counter()
    limits = config["limits"]
    by_step = [[] for _ in range(nsteps)]
    for k, row in zip(window_rows, rows):
        by_step[k].append(row)
    notes, control_numbers = [], None
    if sample_steps is None or len(sample_steps) < nsteps:
        numbers = {k: None for k in NUMBERS}
        notes.append("no whole episode in the window to check")
    else:
        tols = TOLERANCES[config["case"].get("precision", "f64")]
        tols = (tols["nr_rel_tol"], tols["nr_abs_tol"])
        numbers, notes = judge(inputs, dts, sample_steps, by_step, device,
                               *tols)
        if control == "reference32":
            # the same episode with the float32 reference in the
            # program's place
            steps32, rows32 = control_steps(
                inputs, dts, [s["subs"] for s in sample_steps], device)
            control_numbers = judge(inputs, dts, steps32, rows32, device,
                                    *tols)[0]
    correct = verdict(numbers, limits, failed)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    for note in notes:
        log(note)
    log(f"reference and comparison {time.perf_counter() - t_check:.2f} s")
    log(f"checked episode {sample} of {episodes}, {len(rows)} rows")
    for k in NUMBERS:
        log(f"check {k}: {numbers[k]!r} (limit {limits[k]!r})")

    if trace:
        metrics = layer
    else:
        values = {"step_s": clock / max(completed, 1),
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in e2e}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info(device, peak)}
    if trace:
        result["device"].update(extras)
        result["breakdown"] = breakdown
    if control_numbers is not None:
        result["control"] = control_numbers
        result["control_correct"] = verdict(control_numbers, limits, 0)
    # the numbers compared, each beside its limit, last in the line
    result["checks"] = checks
    return result


def verdict(numbers, limits, failed):
    """``correct``: no step failed and every number is within its limit."""
    return failed == 0 and all(
        numbers[k] is not None and numbers[k] <= limits[k] for k in NUMBERS)


def device_info(device, peak):
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}
