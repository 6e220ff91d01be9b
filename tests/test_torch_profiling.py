"""Region timings, the profiler hook and the numerics guards
(``exaconstit_tpu_torch/utils/profiling.py`` and ``utils/guards.py``)
against the JAX package's ``utils/profiling.py`` and ``utils/guards.py``.

* ``EXACONSTIT_TPU_REGIONS``: both packages record the same regions
  (``operator_setup``, ``line_search``, ``krylov_solve``) with the same
  counts on one 2^3 run at tight Newton tolerances, and ``Simulation.run``
  prints the report; the port's own spans and counters on a 2^3 run in
  two setup chunks each count exactly what the run did, and unset they
  record nothing and change no average;
* ``EXACONSTIT_TPU_PROFILE_DIR``: the CLI writes a ``torch.profiler``
  Chrome trace on the CPU that holds the region names;
* ``EXACONSTIT_CHECK_NUMERICS``: the four cases of ``tests/test_guards.py``
  on the port's guard, a layer that returns a NaN stops the run and is
  named, and a clean run passes with unchanged averages.
"""

import glob
import json
from collections import Counter

import numpy as np
import pytest
import torch

from exaconstit_tpu.config import options as J_OPT
from exaconstit_tpu.driver import Simulation as JSimulation
from exaconstit_tpu_torch import cases, cli
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.driver import Simulation, run_simulation
from exaconstit_tpu_torch import driver
from exaconstit_tpu_torch.models import kinetics
from exaconstit_tpu_torch.solvers import dogleg_cuda, krylov
from exaconstit_tpu_torch.utils import profiling
from exaconstit_tpu_torch.utils.guards import (NonFiniteError, check_finite,
                                               numerics_checks_enabled)

REGIONS = {"operator_setup", "line_search", "krylov_solve"}


def _case(tmp_path, ncuts=(2, 2, 2), dts=(0.1, 0.2)):
    """The Voce case with the NRLS Newton solver, which line-searches at
    every iteration (so every region is entered)."""
    toml = cases.write_voce_case(tmp_path / "case", ncuts, dts, ngrains=4)
    with open(toml) as f:
        text = f.read()
    with open(toml, "w") as f:
        f.write(text.replace("[Solvers.NR]\n",
                             '[Solvers.NR]\n        nl_solver = "NRLS"\n'))
    return toml


def test_region_counts_match_reference(tmp_path, monkeypatch, capsys):
    """Both packages' ``MechSystem`` read EXACONSTIT_TPU_REGIONS when built;
    on the same 2^3 run (dt 0.1, 0.2, NRLS, Newton to rel 1e-10) they
    record the same regions the same number of times."""
    monkeypatch.setenv("EXACONSTIT_TPU_REGIONS", "1")
    toml = _case(tmp_path)
    counts = {}
    for tag, opts, sim_cls, kw in (("jax", J_OPT, JSimulation, {}),
                                   ("torch", T_OPT, Simulation,
                                    {"device": "cpu"})):
        opt = opts.parse_options(toml)
        opt.newton_rel_tol, opt.newton_abs_tol = 1e-10, 1e-16
        wd = tmp_path / tag
        wd.mkdir()
        with torch.inference_mode():
            sim = sim_cls(opt, workdir=str(wd), **kw)
            sim.run(verbose=False)
        regions = sim.system.regions
        counts[tag] = dict(regions.counts)
        assert set(regions.totals) == set(counts[tag])
        assert all(v > 0 for v in regions.totals.values())
    assert set(counts["torch"]) == REGIONS, counts
    assert counts["torch"] == counts["jax"]
    report = capsys.readouterr().out
    assert report.count("region timings:") == 2
    for name in REGIONS:
        assert f"x{counts['torch'][name]}" in report


def _counted_run(tmp_path, monkeypatch):
    """The 2^3 NRLS case in two setup chunks with region timing on, Newton
    to rel 1e-10, with each Krylov solve, each inner PCG solve and each
    point-solve stage recorded from outside, apart by whether the
    BC-change corrector is under way."""
    monkeypatch.setenv("EXACONSTIT_TPU_REGIONS", "1")
    monkeypatch.setenv("EXACONSTIT_SETUP_CHUNKS", "2")
    opt = T_OPT.parse_options(_case(tmp_path))
    opt.newton_rel_tol, opt.newton_abs_tol = 1e-10, 1e-16
    seen = dict(corrector=False, outer=[], inner=[], stages=[])
    sim = Simulation(opt, workdir=str(tmp_path), device="cpu")
    sysm = sim.system
    solve_init, refined, inner = (sysm.solve_init, driver.pcg_refined,
                                  krylov.pcg)
    stage = dogleg_cuda.dogleg_stage

    def corrector(*a):
        seen["corrector"] = True
        try:
            return solve_init(*a)
        finally:
            seen["corrector"] = False

    def outer(*a, **k):
        out = refined(*a, **k)
        seen["outer"].append((seen["corrector"], out[1]))
        return out

    def pcg(*a, **k):
        out = inner(*a, **k)
        seen["inner"].append((seen["corrector"], out[1]))
        return out

    def counted_stage(*a):
        out = stage(*a)
        seen["stages"].append((out[2].numel(), int(out[2].sum())))
        return out

    sysm.solve_init = corrector
    monkeypatch.setattr(driver, "pcg_refined", outer)
    monkeypatch.setattr(krylov, "pcg", pcg)
    monkeypatch.setattr(dogleg_cuda, "dogleg_stage", counted_stage)
    with torch.inference_mode():
        sim.run(verbose=False)
    return sim, seen


def test_spans_and_counters_count_the_run(tmp_path, monkeypatch):
    """Each span's calls and each counter, worked out from the regions'
    counts, the steps' solves and the solves recorded from outside: the
    corrector once a BC change, a point update and an operator build per
    setup chunk, every Krylov iteration and every host read of the
    Newton and Krylov stop tests under the innermost region or span."""
    sim, seen = _counted_run(tmp_path, monkeypatch)
    regions = sim.system.regions
    assert set(regions.totals) == set(regions.counts) == REGIONS
    spans, counters = regions.spans, regions.counters
    calls = {n: s["calls"] for n, s in spans.items()}
    chunks = sim.system.setup_chunks
    assert chunks == 2
    nsteps = len(sim.step_stats)
    bc_changes = len(sim.update_steps & set(range(1, nsteps + 1)))
    setups = regions.counts["operator_setup"] + bc_changes
    solves = [s for st in sim.step_stats for s in st["solves"]]
    assert bc_changes == 1 and nsteps == 2 and len(solves) == 2
    for st in sim.step_stats:
        assert st["solves"][-1]["nr_iters"] == st["nr_iters"]
    assert calls["time_loop.corrector"] == bc_changes
    assert calls["time_loop.averages"] == nsteps
    assert calls["newton.solve"] == len(solves)
    assert calls["setup.operator_build"] == chunks * setups
    assert calls["setup.point_update"] == chunks * (
        setups + regions.counts["line_search"])
    # every inner iteration's apply, one a refinement round, and the
    # corrector's apply of the velocity jump
    assert calls["operator.apply"] == sum(k for _, k in seen["inner"]) \
        + len(seen["inner"]) + bc_changes
    for s in spans.values():
        assert -1e-9 <= s["self_seconds"] <= s["seconds"] + 1e-9

    newton_krylov = sum(k for s in solves for k in s["krylov_iters"])
    corr_krylov = sum(k for c, k in seen["outer"] if c)
    assert counters["krylov.iterations"] == {
        "krylov_solve": newton_krylov, "time_loop.corrector": corr_krylov}

    def krylov_reads(corr):
        # pcg_refined: its first stop test and relative reduction (3);
        # each round's inner pcg (its first stop test, two a Krylov
        # iteration, its relative reduction) and its own stop test
        return (3 * sum(c == corr for c, _ in seen["outer"])
                + sum(4 + 2 * k for c, k in seen["inner"] if c == corr))

    # NRLS: the first residual norm, then per iteration the line search's
    # two and the new setup's
    assert counters["host_reads"] == {
        "krylov_solve": krylov_reads(False),
        "time_loop.corrector": krylov_reads(True),
        "newton.solve": sum(1 + 3 * s["nr_iters"] for s in solves)}
    assert counters["dogleg.points"] == {
        "setup.point_update": sum(n for n, _ in seen["stages"])}
    assert counters["dogleg.iterations"] == {
        "setup.point_update": sum(i for _, i in seen["stages"])}
    assert len(seen["stages"]) >= calls["setup.point_update"]
    # each solve's stats hold what the regions gained since the previous
    # solve's: every count, and every span but the last step's averages,
    # which come after the last solve
    summed = {}
    for s in solves:
        for name, by in s["counters"].items():
            for where, n in by.items():
                summed.setdefault(name, Counter())[where] += n
    assert summed == counters
    assert sum((Counter({n: r["calls"] for n, r in s["spans"].items()})
                for s in solves), Counter()) == Counter(calls) - Counter(
        {"time_loop.averages": 1})
    for s in solves:
        assert s["spans"]["newton.solve"]["calls"] == 1
    report = regions.report()
    for name in spans:
        assert f"x{calls[name]}" in report
    line = next(x for x in report.splitlines()
                if x.split()[0] == "host_reads")
    assert int(line.split()[1]) == sum(counters["host_reads"].values())


def test_regions_unset_record_nothing(tmp_path, monkeypatch):
    """With EXACONSTIT_TPU_REGIONS unset no region, span or counter is
    made or counted, and the averages are bitwise the counted run's."""
    sim, _ = _counted_run(tmp_path / "on", monkeypatch)
    assert profiling._CURRENT.get() is None
    monkeypatch.delenv("EXACONSTIT_TPU_REGIONS")

    def refused(*a, **k):
        raise AssertionError("region timing is off")

    monkeypatch.setattr(driver, "Regions", refused)
    for name in ("span", "region", "count", "count_on_device"):
        monkeypatch.setattr(profiling.Regions, name, refused)
    opt = T_OPT.parse_options(_case(tmp_path / "off"))
    opt.newton_rel_tol, opt.newton_abs_tol = 1e-10, 1e-16
    off = Simulation(opt, workdir=str(tmp_path / "off"), device="cpu")
    with torch.inference_mode():
        off.run(verbose=False)
    assert off.system.regions is None

    def counts(stats):
        return [{k: v for k, v in s.items() if k not in ("spans", "counters")}
                for st in stats for s in st["solves"]]

    assert all("spans" not in s and "counters" not in s
               for st in off.step_stats for s in st["solves"])
    assert counts(off.step_stats) == counts(sim.step_stats)
    on_rows = (tmp_path / "on" / "avg_stress.txt").read_bytes()
    assert (tmp_path / "off" / "avg_stress.txt").read_bytes() == on_rows
    assert len(on_rows.splitlines()) == 2


def test_regions_off_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("EXACONSTIT_TPU_REGIONS", raising=False)
    opt = T_OPT.parse_options(_case(tmp_path))
    assert Simulation(opt, workdir=str(tmp_path),
                      device="cpu").system.regions is None


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    """The CLI under EXACONSTIT_TPU_PROFILE_DIR writes one Chrome trace
    (CPU activity) holding the region names of the run."""
    prof = tmp_path / "prof"
    monkeypatch.setenv("EXACONSTIT_TPU_PROFILE_DIR", str(prof))
    monkeypatch.setenv("EXACONSTIT_TPU_REGIONS", "1")
    toml = _case(tmp_path, dts=(0.1,))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-opt", toml, "-q", "--device", "cpu"]) == 0
    traces = glob.glob(str(prof / "trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert REGIONS <= names
    assert np.loadtxt(tmp_path / "avg_stress.txt").shape == (6,)


# -- the numerics guards: the four cases of tests/test_guards.py ------------


def test_guard_off_is_a_no_op(tmp_path, monkeypatch):
    """Off, a NaN flows through the setup silently, as through jax.jit."""
    monkeypatch.delenv("EXACONSTIT_CHECK_NUMERICS", raising=False)
    assert not numerics_checks_enabled()
    sim, args = _first_setup(tmp_path)
    assert not sim.system.check_numerics
    r = sim.system.setup(*args)[0]
    assert torch.isnan(r).any()


def test_guard_raises_on_nan(monkeypatch):
    monkeypatch.setenv("EXACONSTIT_CHECK_NUMERICS", "1")
    assert numerics_checks_enabled()

    def solve_like(a, b):
        return torch.sqrt(a / torch.clamp(b, min=1e-30))  # NaN for a < 0

    out = solve_like(torch.tensor(4.0), torch.tensor(1.0))
    check_finite("solve", y=out)
    assert float(out) == 2.0
    with pytest.raises(NonFiniteError, match="nan.*solve layer: y"):
        check_finite("solve", y=solve_like(torch.tensor(-4.0),
                                           torch.tensor(1.0)))


def test_guard_passes_non_float_and_missing_outputs(monkeypatch):
    """What a layer may also return (no tangent, integer counts, flags)
    passes; an infinity is caught like a NaN."""
    monkeypatch.setenv("EXACONSTIT_CHECK_NUMERICS", "1")
    check_finite("point solve", stress=torch.ones(6, 3), tangent=None,
                 iters=torch.arange(3, dtype=torch.int32),
                 ok=torch.ones(3, dtype=torch.bool))
    with pytest.raises(NonFiniteError, match="2 of 3"):
        check_finite("diagonal", d=torch.tensor([1.0, float("inf"),
                                                 -float("inf")]))


def test_guard_passes_nan_safe_kinetics(monkeypatch):
    """The production kinetics' double-where guards keep zero resolved
    shear (the masked-log case) finite."""
    monkeypatch.setenv("EXACONSTIT_CHECK_NUMERICS", "1")
    kin = kinetics.VocePL(mu=45.0, xm=0.1, gdot0=1.0, h0=0.0, g0=0.01,
                          gs0=0.02, xms=0.0, gam_s=1.0, hdn_init=0.01)
    taus = torch.tensor([[0.0, 1e-3, -1e-3, 5e-3]], dtype=torch.float64)
    h = torch.full((1, 4), 0.01, dtype=torch.float64)
    gd, slope = kin.gdots_slope(taus, h)
    check_finite("kinetics", gdots=gd, slope=slope)
    assert float(gd[0, 0]) == 0.0


# -- the guards in the driver -------------------------------------------------


def _first_setup(tmp_path):
    """A 2^3 Simulation and the arguments of its first setup, with the
    state of one point made NaN."""
    opt = T_OPT.parse_options(_case(tmp_path))
    sim = Simulation(opt, workdir=str(tmp_path), device="cpu")
    sysm = sim.system
    sim.cur_bcs = sim.bc_steps[1]
    sim.update_velocity()
    state = sim.state.clone()
    state[:, 3] = float("nan")
    xw = torch.zeros((8, sysm.npts), dtype=sysm.dtype)
    return sim, (sim.v, sim.x_beg, state, 0.1, sysm.to_ess(
        sim.cur_bcs.ess_mask), True, sysm.compute_nsub(0.1), xw, False)


def test_guard_names_the_layer(tmp_path, monkeypatch):
    """On, the first layer whose output is not finite stops the setup and
    the line-search residual, and is named: a NaN state passes the
    velocity gradient and stops at the point solve."""
    monkeypatch.setenv("EXACONSTIT_CHECK_NUMERICS", "1")
    sim, args = _first_setup(tmp_path)
    with pytest.raises(NonFiniteError, match="point solve layer: stress"):
        sim.system.setup(*args)
    with pytest.raises(NonFiniteError, match="point solve layer: stress"):
        sim.system.residual_only(*args[:5], *args[6:])
    x_bad = args[1].clone()
    x_bad[0] = float("inf")
    with pytest.raises(NonFiniteError, match="velocity gradient layer"):
        sim.system.setup(args[0], x_bad, *args[2:])


def test_guard_clean_run_unchanged(tmp_path, monkeypatch):
    """A clean 2^3 run passes the guard and writes the same averages,
    bit for bit, as the run without it."""
    toml = _case(tmp_path)
    rows = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("EXACONSTIT_CHECK_NUMERICS", flag)
        wd = tmp_path / f"run{flag}"
        wd.mkdir()
        sim = run_simulation(toml, workdir=str(wd), verbose=False,
                             device="cpu")
        assert sim.system.check_numerics == (flag == "1")
        rows[flag] = (wd / "avg_stress.txt").read_text()
    assert rows["0"] == rows["1"] and len(rows["0"].splitlines()) == 2
