"""The GMG V-cycle as one CUDA graph a hierarchy (``solvers/gmg.py``).

On the CPU (these count everywhere): ``v_cycle`` runs the eager cycle,
bitwise ``_cycle``, records ``gmg.coarse_solve`` once a cycle and no
graph counter, and ``build_hierarchy`` attaches no graph; a coarse
level's matvec is bitwise the masked EA matvec written out; the fine
matvec the system hands the capture is bitwise its ``grad_matvec``,
identity rows included.

Marked ``cuda`` (they skip here): the replayed cycle is bitwise the
eager ``_cycle`` on a seeded 32^3 hierarchy of 3 levels, in f32, on the
f64 leg and in f64; over hierarchies built in turn (the pool's blocks
reused) and over repeated replays (a returned z is not overwritten);
``MechSystem.krylov_solve`` gives the eager cycle's iterations and x
bitwise; the counters count the builds and the V-cycles; nothing is
timed inside a capture, also with an apply wrapped in timing events;
once the solve returns the graph is gone without the cycle collector and
the device memory is back where it was; a hierarchy whose applies go
through ``fem/operators.apply_ea`` captures the EA kernel pair for each
fine and coarse apply of a V-cycle.  Imports nothing of the JAX
package, so that the card's tests run with

    python -m pytest tests/test_torch_gmg_graph.py -q -m cuda   # on the card
"""

import gc
import weakref
from collections import Counter

import numpy as np
import pytest
import torch

from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch.config.options import parse_options
from exaconstit_tpu_torch.driver import Simulation
from exaconstit_tpu_torch.fem import ea_apply_cuda
from exaconstit_tpu_torch.fem import operators as ops
from exaconstit_tpu_torch.fem.space import StructuredMap
from exaconstit_tpu_torch.solvers import gmg
from exaconstit_tpu_torch.utils import profiling

SMALL = (10, 10, 10)  # the smallest brick on which GMG builds two levels
LARGE = (32, 32, 32)  # the benchmark's brick: 32^3 -> 16^3 -> 8^3
DT = 0.005  # the benchmark ramp's first step
f32, f64 = torch.float32, torch.float64


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")


def _problem(grid, seed, dtype, device):
    """Seeded symmetric positive definite (24, 24, ne) blocks on ``grid``
    with the z = 0 face held, the fine matvec with ``grad_matvec``'s
    arithmetic (identity rows take the input) and the assembled
    diagonal."""
    ne = int(np.prod(grid))
    g = torch.Generator().manual_seed(seed)
    b = torch.randn(ne, 24, 24, dtype=f64, generator=g)
    k = (b.transpose(1, 2) @ b + 24 * torch.eye(24, dtype=f64))
    k = k.permute(1, 2, 0).contiguous().to(dtype=dtype, device=device)
    smap = StructuredMap(grid)
    ess = torch.zeros((3, *smap.nodes), dtype=torch.bool)
    ess[:, 0] = True
    ess = ess.reshape(-1).to(device)
    dloc = torch.diagonal(k, dim1=0, dim2=1).T.reshape(8, 3, -1)
    diag = torch.where(ess, 1.0, smap.scatter_add(dloc.transpose(0, 1)))

    def matvec(x):
        return ops.masked_apply(lambda v: ops.apply_ea(k, smap, v), x, ess)

    return k, ess, matvec, diag


def _vector(n, seed, dtype, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, dtype=f64, generator=g).to(dtype=dtype,
                                                     device=device)


# -- on the CPU --------------------------------------------------------------


def test_cpu_v_cycle_is_the_eager_cycle():
    regions = profiling.Regions()
    meta = gmg.GMGMeta(SMALL)
    k, ess, matvec, diag = _problem(SMALL, 3, f64, "cpu")
    with profiling.recording(regions):
        levels = gmg.build_hierarchy(meta, k, ess, matvec, diag)
        assert levels.graph is None
        r = _vector(diag.numel(), 5, f64, "cpu")
        z = gmg.v_cycle(levels, r)
    assert torch.equal(z, gmg._cycle(levels, 0, r))
    assert regions.spans["gmg.coarse_solve"]["calls"] == 1
    assert not any(n.startswith("gmg.graph") for n in regions.counters)


@pytest.mark.parametrize("dtype", [f32, f64])
def test_cpu_coarse_matvec_is_the_masked_ea_apply(dtype):
    """A coarse level's matvec (``fem/operators``' masked EA apply, zero
    rows at the essential dofs) is bitwise the masked EA matvec written
    out, on x of the blocks' dtype and on f64 x over f32 blocks."""
    meta = gmg.GMGMeta(SMALL)
    k, ess, matvec, diag = _problem(SMALL, 3, dtype, "cpu")
    levels = gmg.build_hierarchy(meta, k, ess, matvec, diag)
    el_ess = meta.maps[0].gather(ess.to(dtype)).transpose(0, 1)
    k1 = gmg._rap(gmg._mask_blocks(k, el_ess.reshape(24, -1) > 0.5),
                  SMALL, meta.wd)
    smap, ess1 = meta.maps[1], levels[1]["ess"]
    for x_dtype in {dtype, f64}:
        x = _vector(ess1.numel(), 7, x_dtype, "cpu")
        xm = torch.where(ess1, 0.0, x)
        u = smap.gather(xm).transpose(0, 1).reshape(24, -1)
        y = torch.einsum("abe,be->ae", k1.to(u.dtype), u).reshape(8, 3, -1)
        want = torch.where(ess1, xm, smap.scatter_add(y.transpose(0, 1)))
        got = levels[1]["matvec"](x)
        assert got.dtype == x_dtype and torch.equal(got, want)
        assert bool((got[ess1] == 0).all()) and bool(ess1.any())


@pytest.fixture(scope="module")
def cpu_system(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cpu")
    toml = cases.write_voce_case(tmp / "case", SMALL, (DT,), ngrains=8,
                                 assembly="EA", precond="auto")
    sim = Simulation(parse_options(toml), workdir=str(tmp), device="cpu")
    assert sim.system.precond_kind == "gmg"
    return sim.system


@pytest.mark.parametrize("dtype", [f32, f64])
def test_capture_matvec_is_grad_matvec(cpu_system, dtype, monkeypatch):
    """The fine matvec the system gives the capture (no span, past any
    wrapper of apply_k) is bitwise its grad_matvec, whose identity rows
    take the input x (the coarse levels' rows there are zero)."""
    sysm = cpu_system
    got = {}

    def grab(*a, **kw):
        got["kw"] = kw
        return gmg.Levels([], True)

    monkeypatch.setattr(gmg, "build_hierarchy", grab)
    n, ne = 3 * sysm.nn, sysm.ne
    g = torch.Generator().manual_seed(11)
    b = torch.randn(ne, 24, 24, dtype=f64, generator=g)
    k = (b.transpose(1, 2) @ b).permute(1, 2, 0).contiguous().to(dtype)
    ess = torch.rand(n, generator=g) < 0.2
    x = _vector(n, 13, dtype, "cpu")

    def wrapped(*a):
        raise AssertionError("the capture's matvec went through apply_k")

    sysm._gmg_levels(k, ess, None, torch.ones(n, dtype=dtype))
    plain = got["kw"]["graph_matvec"]
    sysm.apply_k = wrapped
    try:
        y = plain(x)
    finally:
        del sysm.apply_k
    assert torch.equal(y, sysm.grad_matvec(k, x, ess))
    assert torch.equal(y[ess], x[ess])


# -- on the card --------------------------------------------------------------


def _levels(grid, seed, dtype, graphs):
    k, ess, matvec, diag = _problem(grid, seed, dtype, "cuda")
    return gmg.build_hierarchy(gmg.GMGMeta(grid), k, ess, matvec, diag,
                               graphs=graphs, graph_matvec=matvec)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [f32, f64])
def test_replay_is_bitwise_the_eager_cycle(dtype):
    _needs_card()
    graphs = gmg.CycleGraphs("cuda")
    levels = _levels(LARGE, 3, dtype, graphs)
    assert len(levels) == 3 and levels.graph is not None
    r = _vector(levels[0]["dinv"].numel(), 5, dtype, "cuda")
    z = gmg.v_cycle(levels, r)
    assert bool(torch.isfinite(z).all())
    assert torch.equal(z, gmg._cycle(levels, 0, r))
    if dtype == f32:  # pcg_refined's f64 leg takes the f32 graph
        r64 = _vector(r.numel(), 7, f64, "cuda")
        z64 = gmg.v_cycle(levels, r64.to(f32)).to(f64)
        assert torch.equal(z64, gmg._cycle(levels, 0, r64.to(f32)).to(f64))


MiB = 1 << 20
# the capture stream's cuBLAS workspace on an H100, made in the pool
CUBLAS_WORKSPACE = 32 * MiB
# the most the caching allocator rounds a request up to a segment, and
# the segment of its pool of small blocks
SEGMENT_ROUNDING = 20 * MiB
SMALL_SEGMENT = 2 * MiB


def _pool_bytes(pool):
    """Bytes the caching allocator reserves in the private pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


@pytest.mark.cuda
def test_hierarchies_in_turn_reuse_the_pool():
    """Each hierarchy's graph takes the pool's blocks again, and nothing
    accumulates once its levels are gone.  The card's memory is held
    against the eager cycle's: the graph path reserves what the eager
    cycle on the same hierarchy reserves plus the pool (and at most one
    small-block segment), and the pool holds at most the eager cycle's
    working set, the capture stream's cuBLAS workspace and one segment's
    rounding.  Allocated memory outside the pool grows only by torch's
    random-number state for graphs (held while a graph lives: the pool's
    ``_hold``), under 1 MiB."""
    _needs_card()
    a = torch.ones((1, 2, 2), device="cuda")
    torch.bmm(a, a)  # the current stream's cuBLAS workspace
    del a
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated = [torch.cuda.memory_allocated()]
    # the eager cycle on the first hierarchy, with no graph made
    k, ess, matvec, diag = _problem(LARGE, 3, f32, "cuda")
    levels = gmg._build(gmg.GMGMeta(LARGE), k, ess, matvec, diag)
    r = _vector(diag.numel(), 3, f32, "cuda")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    z = gmg._cycle(levels, 0, r)
    torch.cuda.synchronize()
    working_set = torch.cuda.max_memory_allocated() - held
    eager_reserved = torch.cuda.memory_reserved()
    del k, ess, matvec, diag, levels, r, z
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == allocated[0]

    graphs = gmg.CycleGraphs("cuda")
    reserved, pool = [], []
    for seed in (3, 4, 5):
        levels = _levels(LARGE, seed, f32, graphs)
        r = _vector(levels[0]["dinv"].numel(), seed, f32, "cuda")
        assert torch.equal(gmg.v_cycle(levels, r), gmg._cycle(levels, 0, r))
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
        pool.append(_pool_bytes(graphs.pool))
        del levels, r
        torch.cuda.synchronize()
        allocated.append(torch.cuda.memory_allocated())
    print(f"eager cycle: working set {working_set} B, reserved "
          f"{eager_reserved} B; graph path: reserved {reserved} B, pool "
          f"{pool} B")
    assert pool[0] == pool[1] == pool[2] > 0
    assert reserved[2] <= reserved[1] <= reserved[0]
    assert reserved[0] <= eager_reserved + pool[0] + SMALL_SEGMENT
    assert pool[0] <= working_set + CUBLAS_WORKSPACE + SEGMENT_ROUNDING
    assert allocated[1] == allocated[2] == allocated[3]
    assert 0 <= allocated[1] - allocated[0] < MiB


@pytest.mark.cuda
def test_capture_takes_the_ea_kernel():
    """``_problem``'s hierarchy, whose applies go through
    ``fem/operators.apply_ea`` as the system's do: the capture launches
    the EA kernel pair once for each apply of a V-cycle on the two levels
    above the dense one (9 a level), the replay launches them from the
    graph alone, and it is bitwise the eager cycle.  Prints the pool's
    reserved bytes."""
    _needs_card()
    k, ess, matvec, diag = _problem(LARGE, 3, f32, "cuda")
    meta = gmg.GMGMeta(LARGE)
    levels = gmg._build(meta, k, ess, matvec, diag)
    graphs = gmg.CycleGraphs("cuda")
    before = ea_apply_cuda.KERNEL.launches
    levels.graph = graphs.capture(levels, matvec, diag)
    captured = ea_apply_cuda.KERNEL.launches - before
    assert meta.nlevels == 3 and meta.coarse_dense
    assert captured == (meta.nlevels - 1) * (2 * gmg.DEGREE + 3) == 18
    r = _vector(diag.numel(), 5, f32, "cuda")
    z = gmg.v_cycle(levels, r)
    assert ea_apply_cuda.KERNEL.launches == before + captured
    assert torch.equal(z, gmg._cycle(levels, 0, r))
    torch.cuda.synchronize()
    print(f"EA kernel in the graph: {captured} applies captured, pool "
          f"{_pool_bytes(graphs.pool)} B reserved")


@pytest.mark.cuda
def test_returned_z_is_not_overwritten():
    _needs_card()
    levels = _levels(LARGE, 3, f32, gmg.CycleGraphs("cuda"))
    n = levels[0]["dinv"].numel()
    r1, r2 = _vector(n, 1, f32, "cuda"), _vector(n, 2, f32, "cuda")
    z1 = gmg.v_cycle(levels, r1)
    kept = z1.clone()
    z2 = gmg.v_cycle(levels, r2)
    z3 = gmg.v_cycle(levels, r1)
    assert torch.equal(z1, kept) and not torch.equal(z1, z2)
    assert torch.equal(z3, z1)
    assert torch.equal(z2, gmg._cycle(levels, 0, r2))


@pytest.mark.cuda
def test_card_requires_the_pool():
    _needs_card()
    k, ess, matvec, diag = _problem(SMALL, 3, f32, "cuda")
    with pytest.raises(ValueError, match="CUDA graph"):
        gmg.build_hierarchy(gmg.GMGMeta(SMALL), k, ess, matvec, diag)
    with pytest.raises(ValueError, match="graph_matvec"):
        gmg.build_hierarchy(gmg.GMGMeta(SMALL), k, ess, matvec, diag,
                            graphs=gmg.CycleGraphs("cuda"))


@pytest.fixture(scope="module")
def card_step(tmp_path_factory):
    """One load step of the 10^3 Voce case on the card with region timing
    on, the builds and V-cycles counted from outside, every timing event
    checked to be recorded outside a capture, the operator apply wrapped
    in timing events as the benchmark's traced run wraps it, and the
    first Krylov solve's arguments kept."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA graph has no CPU mode)")
    mp = pytest.MonkeyPatch()
    seen = Counter()
    try:
        mp.setenv("EXACONSTIT_TPU_REGIONS", "1")
        stamp = profiling.Regions._stamp

        def stamp_outside(self, stream):
            if torch.cuda.is_current_stream_capturing():
                seen["stamped in a capture"] += 1
            return stamp(self, stream)

        mp.setattr(profiling.Regions, "_stamp", stamp_outside)
        v_cycle, build = gmg.v_cycle, gmg.build_hierarchy

        def counted_cycle(*a, **k):
            seen["v_cycle"] += 1
            return v_cycle(*a, **k)

        def counted_build(*a, **k):
            seen["build"] += 1
            return build(*a, **k)

        mp.setattr(gmg, "v_cycle", counted_cycle)
        mp.setattr(gmg, "build_hierarchy", counted_build)
        tmp = tmp_path_factory.mktemp("card")
        toml = cases.write_voce_case(tmp / "case", SMALL, (DT,), ngrains=8,
                                     assembly="EA", precond="auto")
        sim = Simulation(parse_options(toml), workdir=str(tmp),
                         device="cuda")
        sysm = sim.system
        solve, apply_k = sysm.krylov_solve, sysm.apply_k
        args = []

        def kept_solve(*a):
            if not args:
                args.extend(t.clone() for t in a)
            return solve(*a)

        def timed_apply(k_data, x):
            if torch.cuda.is_current_stream_capturing():
                seen["applied in a capture"] += 1
            t0 = torch.cuda.Event(enable_timing=True)
            t0.record()
            y = apply_k(k_data, x)
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            seen["timed applies"] += 1
            return y

        sysm.krylov_solve = kept_solve
        sysm.apply_k = timed_apply
        with torch.inference_mode():
            sim.advance(1, DT, verbose=False)
        torch.cuda.synchronize()
        del sysm.krylov_solve, sysm.apply_k
        yield sim, seen, args
    finally:
        mp.undo()


@pytest.mark.cuda
def test_counters_count_builds_and_cycles(card_step):
    sim, seen, _ = card_step
    regions = sim.system.regions
    counters = regions.counters
    assert seen["build"] >= 2 and seen["v_cycle"] > seen["build"]
    assert sum(counters["gmg.graph_captures"].values()) == seen["build"]
    assert sum(counters["gmg.graph_replays"].values()) == seen["v_cycle"]
    assert counters["gmg.graph_replays"] == {"gmg.v_cycle": seen["v_cycle"]}


@pytest.mark.cuda
def test_nothing_timed_inside_a_capture(card_step):
    sim, seen, _ = card_step
    assert seen["stamped in a capture"] == 0
    assert seen["applied in a capture"] == 0 and seen["timed applies"] > 0
    spans = sim.system.regions.spans  # every event pair resolves
    assert "gmg.coarse_solve" not in spans
    assert spans["gmg.v_cycle"]["calls"] == seen["v_cycle"]
    assert spans["gmg.build"]["calls"] == seen["build"]


@pytest.mark.cuda
def test_system_capture_takes_only_the_ea_kernel(card_step, monkeypatch):
    """The system's V-cycle graph on the card's strided map captures the
    EA kernel pair for each apply of the level above the dense one (9 at
    10^3) and never the plain apply, and ``_gmg_levels`` refuses blocks
    that would put the plain apply inside the capture."""
    sim, _, args = card_step
    sysm = sim.system
    k32 = args[0].to(f32)
    diag, ess = args[1].to(f32), args[3]
    captured = Counter()
    launch, plain = ea_apply_cuda.KERNEL.launch, ops.apply_ea_plain

    def counted_launch(*a):
        captured["kernel"] += torch.cuda.is_current_stream_capturing()
        return launch(*a)

    def counted_plain(*a):
        captured["plain"] += torch.cuda.is_current_stream_capturing()
        return plain(*a)

    monkeypatch.setattr(ea_apply_cuda.KERNEL, "launch", counted_launch)
    monkeypatch.setattr(ops, "apply_ea_plain", counted_plain)

    def matvec(x):
        return sysm.grad_matvec(k32, x, ess)

    with torch.inference_mode():
        levels = sysm._gmg_levels(k32, ess, matvec, diag)
        torch.cuda.synchronize()
        assert levels.graph is not None
        assert captured["kernel"] == 2 * gmg.DEGREE + 3
        assert captured["plain"] == 0
        strided = k32.permute(0, 2, 1).contiguous().permute(0, 2, 1)
        with pytest.raises(RuntimeError, match="plain EA apply"):
            sysm._gmg_levels(strided, ess, matvec, diag)


@pytest.mark.cuda
def test_krylov_solve_matches_the_eager_cycle(card_step, monkeypatch):
    sim, _, args = card_step
    sysm = sim.system
    with torch.inference_mode():
        x, iters, conv, _ = sysm.krylov_solve(*args)

        def eager(levels, r):
            return gmg._cycle(levels, 0, r)

        monkeypatch.setattr(gmg, "v_cycle", eager)
        x_e, iters_e, conv_e, _ = sysm.krylov_solve(*args)
    assert conv and conv_e and iters == iters_e
    assert torch.equal(x, x_e)


@pytest.mark.cuda
def test_graph_dies_with_the_solve(card_step, monkeypatch):
    sim, _, args = card_step
    sysm = sim.system
    refs = []
    build = gmg.build_hierarchy

    def kept(*a, **k):
        levels = build(*a, **k)
        refs.extend(weakref.ref(o) for o in (levels, levels.graph,
                                             levels.graph._graph))
        return levels

    monkeypatch.setattr(gmg, "build_hierarchy", kept)
    was = gc.isenabled()
    gc.disable()
    try:
        with torch.inference_mode():
            sysm.regions.counters  # the held device sums read
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            out = sysm.krylov_solve(*args)
            del out
            sysm.regions.counters
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
    finally:
        if was:
            gc.enable()
    assert len(refs) == 3 and all(r() is None for r in refs)
    assert after == before
