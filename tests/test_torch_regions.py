"""``utils/profiling.Regions`` on its own: the tables of regions, spans and
counters, the current recorder that the layers report to, and (marked
``cuda``) timing on the card without waiting for it.  Imports nothing of
the JAX package, so that the card's tests run here:

    python -m pytest tests/test_torch_regions.py -q -m cuda   # on the card
"""

import time

import pytest
import torch

from exaconstit_tpu_torch.solvers import krylov
from exaconstit_tpu_torch.utils import profiling
from exaconstit_tpu_torch.utils.profiling import Regions


def test_tables_nest_and_count():
    """A region's seconds go to ``totals`` and ``counts`` alone, a span's
    to ``spans`` with its self seconds less every nested region and span,
    and each count to the innermost region or span open."""
    r = Regions()
    r.count("host_reads")
    with r.span("newton.solve", "cpu"):
        r.count("host_reads", 2)
        with r.region("krylov_solve", "cpu"):
            r.count("host_reads", 3)
            for _ in range(2):
                with r.span("operator.apply", "cpu"):
                    time.sleep(0.01)
            r.count_on_device("dogleg.iterations", torch.tensor([1, 2, 3]))
            r.count_on_device("dogleg.iterations", torch.tensor([4]))
        time.sleep(0.01)
    assert dict(r.counts) == {"krylov_solve": 1}
    assert set(r.totals) == {"krylov_solve"}
    spans = r.spans
    assert {n: s["calls"] for n, s in spans.items()} == {
        "newton.solve": 1, "operator.apply": 2}
    apply, newton = spans["operator.apply"], spans["newton.solve"]
    assert apply["self_seconds"] == apply["seconds"] >= 0.02
    assert newton["self_seconds"] == pytest.approx(
        newton["seconds"] - r.totals["krylov_solve"], abs=1e-12)
    assert 0.01 <= newton["self_seconds"] < newton["seconds"]
    assert r.counters == {
        "host_reads": {"-": 1, "newton.solve": 2, "krylov_solve": 3},
        "dogleg.iterations": {"krylov_solve": 10}}
    # the device sums are read once; later counts add to them
    r.count_on_device("dogleg.iterations", torch.tensor([5]))
    assert r.counters["dogleg.iterations"] == {"-": 5, "krylov_solve": 10}
    report = r.report()
    assert "krylov_solve" in report and "x2" in report


def test_a_raising_body_is_not_timed():
    r = Regions()
    with pytest.raises(ValueError):
        with r.span("operator.apply", "cpu"):
            raise ValueError
    with r.region("line_search", "cpu"):
        pass
    assert r.spans == {} and dict(r.counts) == {"line_search": 1}
    assert r.counters == {}


@pytest.mark.parametrize("solver", ["pcg", "pcg_refined", "minres",
                                    "gmres"])
def test_krylov_counts_every_host_read(solver):
    """Each solver counts to the current recorder every blocking scalar
    read the profiler sees it make (``aten::_local_scalar_dense``) and
    its iterations."""
    g = torch.Generator().manual_seed(5)
    m = torch.rand(40, 40, dtype=torch.float64, generator=g)
    a = m @ m.T + 40 * torch.eye(40, dtype=torch.float64)
    b = torch.rand(40, dtype=torch.float64, generator=g)
    dinv = 1.0 / torch.diagonal(a)
    args = (lambda x: a @ x, lambda r: dinv * r)
    lo = (lambda x: a.float() @ x, lambda r: dinv.float() * r)
    r = Regions()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            profiling.recording(r):
        if solver == "pcg_refined":
            out = krylov.pcg_refined(*args, *lo, b, 1e-12, 0.0, 200)
        else:
            out = getattr(krylov, solver)(*args, b, 1e-12, 0.0, 200)
    reads = sum(e.count for e in prof.key_averages()
                if e.key == "aten::_local_scalar_dense")
    assert out[2] and out[1] > 3
    assert r.counters == {"host_reads": {"-": reads},
                          "krylov.iterations": {"-": out[1]}}


def test_helpers_report_to_the_current_recorder():
    """A ``Regions``' open span makes it current, ``recording`` makes one
    current around a body and ``paused`` none: the helpers report to the
    current one, under its innermost open span, and outside every one do
    nothing."""
    a, b = Regions(), Regions()
    iters = torch.tensor([2, 3], dtype=torch.int32)
    profiling.count("host_reads")
    with profiling.span("operator.apply", "cpu"):
        profiling.count_on_device("dogleg.iterations", iters)
    with profiling.recording(a):
        profiling.count("host_reads")
        with profiling.span("gmg.v_cycle", "cpu"):
            profiling.count("host_reads", 2)
            with profiling.paused():
                profiling.count("host_reads")
                with profiling.span("gmg.coarse_solve", "cpu"):
                    pass
                with b.span("newton.solve", "cpu"):
                    profiling.count("host_reads")
                    profiling.count_on_device("dogleg.iterations", iters)
                profiling.count("host_reads")
            profiling.count("krylov.iterations")
    profiling.count("host_reads")
    assert profiling._CURRENT.get() is None
    assert a.counters == {
        "host_reads": {"-": 1, "gmg.v_cycle": 2},
        "krylov.iterations": {"gmg.v_cycle": 1}}
    assert {n: s["calls"] for n, s in a.spans.items()} == {"gmg.v_cycle": 1}
    assert b.counters == {"host_reads": {"newton.solve": 1},
                          "dogleg.iterations": {"newton.solve": 5}}
    assert {n: s["calls"] for n, s in b.spans.items()} == {"newton.solve": 1}


@pytest.mark.cuda
def test_regions_on_the_card_do_not_block():
    """Around a long run of matrix products the host leaves the region
    and span before the card has done their work: the device time the
    events read when the totals are read is longer than the host's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    a = torch.randn(4096, 4096, device="cuda")
    iters = torch.ones(7, dtype=torch.int32, device="cuda")
    r = Regions()
    with r.region("krylov_solve", "cuda"), r.span("operator.apply", "cuda"):
        # the first use of each piece (and the caching allocator's first
        # blocks, whose cudaMalloc waits for the card) out of the timing
        b = a @ a
        r.count_on_device("dogleg.iterations", iters)
    torch.cuda.synchronize()
    r = Regions()
    t0 = time.perf_counter()
    with r.region("krylov_solve", "cuda"):
        with r.span("operator.apply", "cuda"):
            for _ in range(100):
                b = a @ a
        r.count_on_device("dogleg.iterations", iters)
    host = time.perf_counter() - t0
    device = r.totals["krylov_solve"]
    assert host < 0.5 * device, (host, device)
    apply = r.spans["operator.apply"]
    assert 0.9 * device <= apply["seconds"] <= device
    assert r.counters["dogleg.iterations"] == {"krylov_solve": 7}
    assert torch.isfinite(b).all()
