"""The GMG preconditioner's spans and counter (``solvers/gmg.py``, recorded
in ``utils/profiling.Regions`` when ``EXACONSTIT_TPU_REGIONS`` is on), on
the CPU at 10^3, the smallest brick on which GMG builds two levels:

* ``gmg.build`` once a Krylov solve, ``gmg.v_cycle`` once a
  preconditioner call, ``gmg.coarse_solve`` once a V-cycle;
* ``gmg.coarse_factor_failures`` counts a coarsest matrix that is not
  positive definite, and reads 0 on a sound one;
* with region timing off nothing is recorded, and the step's velocity is
  bitwise the one with it on;
* the CPU takes the eager cycle: no CUDA graph, no graph counter.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.driver import Simulation
from exaconstit_tpu_torch import driver
from exaconstit_tpu_torch.fem import operators as ops
from exaconstit_tpu_torch.fem.space import StructuredMap
from exaconstit_tpu_torch.solvers import gmg
from exaconstit_tpu_torch.utils import profiling

GRID = (10, 10, 10)
DT = 0.005  # the benchmark ramp's first step


def _step(tmp_path, regions_on):
    """One load step of the 10^3 Voce case (EA, ``precond = "auto"``) with
    the Krylov solves and V-cycles counted from outside."""
    mp = pytest.MonkeyPatch()
    seen = Counter()
    try:
        if regions_on:
            mp.setenv("EXACONSTIT_TPU_REGIONS", "1")
        else:
            mp.delenv("EXACONSTIT_TPU_REGIONS", raising=False)

            def refused(*a, **k):
                raise AssertionError("region timing is off")

            mp.setattr(driver, "Regions", refused)
            mp.setattr(profiling.Regions, "span", refused)
            mp.setattr(profiling.Regions, "count_on_device", refused)
        v_cycle, build = gmg.v_cycle, gmg.build_hierarchy

        def counted_cycle(*a, **k):
            seen["v_cycle"] += 1
            return v_cycle(*a, **k)

        def counted_build(*a, **k):
            seen["build"] += 1
            return build(*a, **k)

        mp.setattr(gmg, "v_cycle", counted_cycle)
        mp.setattr(gmg, "build_hierarchy", counted_build)
        toml = cases.write_voce_case(tmp_path / "case", GRID, (DT,),
                                     ngrains=8, assembly="EA", precond="auto")
        sim = Simulation(T_OPT.parse_options(toml), workdir=str(tmp_path),
                         device="cpu")
        sysm = sim.system
        solve = sysm.krylov_solve

        def counted_solve(*a, **k):
            seen["krylov"] += 1
            return solve(*a, **k)

        sysm.krylov_solve = counted_solve
        with torch.inference_mode():
            sim.advance(1, DT, verbose=False)
        return sim, seen
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    on = _step(tmp_path_factory.mktemp("on"), True)
    off = _step(tmp_path_factory.mktemp("off"), False)
    return on, off


def test_spans_count_builds_cycles_and_coarse_solves(runs):
    (sim, seen), _ = runs
    regions = sim.system.regions
    assert sim.system.precond_kind == "gmg"
    assert seen["krylov"] >= 2 and seen["v_cycle"] > seen["krylov"]
    spans = regions.spans
    assert spans["gmg.build"]["calls"] == seen["build"] == seen["krylov"]
    assert spans["gmg.v_cycle"]["calls"] == seen["v_cycle"]
    assert spans["gmg.coarse_solve"]["calls"] == seen["v_cycle"]
    # the fine-level applies inside a V-cycle keep their own span, so the
    # V-cycle's self time leaves them out
    cycle = spans["gmg.v_cycle"]
    assert 0.0 < cycle["self_seconds"] < cycle["seconds"]
    assert regions.counters["gmg.coarse_factor_failures"] == {
        "gmg.build": 0}


def test_regions_off_record_nothing_and_change_nothing(runs):
    (on, seen_on), (off, seen_off) = runs
    assert off.system.regions is None
    assert all("spans" not in s and "counters" not in s
               for st in off.step_stats for s in st["solves"])
    assert seen_off == seen_on
    assert torch.equal(off.v, on.v)


def test_cpu_step_takes_the_eager_cycle(runs):
    (sim, _), _ = runs
    assert sim.system._cycle_graphs is None
    assert not any(name.startswith("gmg.graph")
                   for name in sim.system.regions.counters)


def _blocks(seed, sign):
    """Seeded symmetric positive definite 24 x 24 element blocks on
    ``GRID`` (times ``sign``), the z = 0 face held, and the fine level's
    masked apply and assembled diagonal."""
    ne = int(np.prod(GRID))
    g = torch.Generator().manual_seed(seed)
    b = torch.randn(ne, 24, 24, dtype=torch.float64, generator=g)
    k = (b.transpose(1, 2) @ b + 24 * torch.eye(24, dtype=torch.float64))
    k = sign * k.permute(1, 2, 0).contiguous()
    smap = StructuredMap(GRID)
    nodes = smap.nodes
    ess = torch.zeros((3, *nodes), dtype=torch.bool)
    ess[:, 0] = True
    ess = ess.reshape(-1)
    dloc = torch.diagonal(k, dim1=0, dim2=1).T.reshape(8, 3, -1)
    diag = torch.where(ess, 1.0, smap.scatter_add(dloc.transpose(0, 1)))

    def matvec(x):
        return ops.masked_apply(lambda v: ops.apply_ea(k, smap, v), x, ess,
                                identity=False)

    return k, ess, matvec, diag


@pytest.mark.parametrize("sign,failures", [(1.0, 0), (-1.0, 1)])
def test_coarse_factor_failures_count_indefinite(sign, failures):
    """Negated blocks give a coarsest matrix that is not positive definite:
    one failure counted under ``gmg.build``; sound blocks count 0."""
    regions = profiling.Regions()
    meta = gmg.GMGMeta(GRID)
    assert meta.nlevels == 2 and meta.coarse_dense
    k, ess, matvec, diag = _blocks(3, sign)
    with profiling.recording(regions):
        levels = gmg.build_hierarchy(meta, k, ess, matvec, diag)
    assert regions.counters == {
        "gmg.coarse_factor_failures": {"gmg.build": failures}}
    assert regions.spans["gmg.build"]["calls"] == 1
    with profiling.recording(regions):
        z = gmg.v_cycle(levels, torch.ones_like(diag))
    assert bool(torch.isfinite(z).all()) is (failures == 0)
    assert regions.spans["gmg.coarse_solve"]["calls"] == 1
