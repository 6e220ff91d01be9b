"""Tests of the main-path cell's readers (``voce_fcc_ea_32.ramp``): each
gives the hand-computed value on a synthetic ``data`` dict, nothing on a
window without its spans or applies, and the cell's EA apply is counted
from the configuration's shapes.

    python -m pytest benchmark/test_ea_gmg_cell.py -q
"""

from __future__ import annotations

from pathlib import Path

import pytest

from benchmark import core, roofline, tracing
from benchmark.test_span_report import SPAN_READERS

ROOT = Path(__file__).resolve().parent
CELL = "voce_fcc_ea_32.ramp"
NEW = ("gmg.v_cycle_ms_per_call", "gmg.build_ms_per_call",
       "ea_apply_roofline")


def reader(name):
    return tracing.load_reader(ROOT / "metrics", name)


def test_cell_reads_the_new_metrics():
    entry, config, _, e2e, per_layer = core.resolve(CELL)
    assert entry["chips"] == 1 and entry["traffic"] == "ramp"
    assert config["case"]["assembly"] == "EA"
    assert config["case"]["mesh_file"] is False
    # the span and counter readers every cell reads, then the cell's own
    assert [m["name"] for m in per_layer] == list(SPAN_READERS) + list(NEW)
    assert {m["name"] for m in e2e} == {"step_s", "peak_mem_gib", "setup_s"}


def _solve(spans):
    return dict(nr_iters=1, krylov_iters=[10], spans=spans, counters={})


@pytest.mark.parametrize("name,span", [("gmg.v_cycle_ms_per_call",
                                        "gmg.v_cycle"),
                                       ("gmg.build_ms_per_call",
                                        "gmg.build")])
def test_span_readers(name, span):
    """Seconds over calls of every solve's span, in ms: (0.02 + 0.01) s
    over 10 + 5 calls is 2 ms; a solve without the span adds nothing."""
    data = dict(newton=[
        _solve({span: dict(seconds=0.02, calls=10, self_seconds=0.005)}),
        _solve({"operator.apply": dict(seconds=1.0, calls=3,
                                       self_seconds=1.0)}),
        _solve({span: dict(seconds=0.01, calls=5, self_seconds=0.001)})])
    assert reader(name)(data) == pytest.approx(2.0, rel=1e-12)
    # a program without the span (the parent of these spans) reads nothing
    parent = dict(newton=[_solve({"operator.apply": dict(
        seconds=1.0, calls=3, self_seconds=1.0)})])
    assert reader(name)(parent) is None
    assert reader(name)(dict(newton=[])) is None


def test_ea_apply_counts_of_the_cell():
    """The cell's f32 apply: 32,768 elements' 24 x 24 f32 blocks, the
    3 x 33^3 f32 vectors read and written, no index tables (the strided
    map holds none, as the Recorder reads it)."""
    from exaconstit_tpu_torch.fem.space import StructuredMap
    emap = StructuredMap((32, 32, 32))
    assert getattr(emap, "conn_t", None) is None
    assert getattr(emap, "table", None) is None
    ncuts = core.resolve(CELL)[1]["case"]["ncuts"]
    ne = ncuts[0] * ncuts[1] * ncuts[2]
    nn = (ncuts[0] + 1) * (ncuts[1] + 1) * (ncuts[2] + 1)
    ops, nbytes = roofline.operator_apply("ea", 576 * ne, 4, 3 * nn, 4, 0)
    assert (ops, nbytes) == roofline.operator_apply(
        "ea", 576 * 32768, 4, 3 * 33**3, 4, 0)
    assert ops == 32768 * 1176 == 38_535_168
    assert nbytes == 75_497_472 + 862_488 == 76_359_960
    # bytes bound: 76,359,960 B at 3.35 TB/s is 22.794 us
    t, by = roofline.bound_seconds(ops, nbytes, 4)
    assert by == "bytes" and t == pytest.approx(2.2794017910447762e-05)
    # ea_apply_roofline over two such applies of 100 us each, and one
    # PA apply it leaves out: 22.794 %
    call = dict(kind="ea", seconds=1e-4, ops=ops, bytes=nbytes,
                dtype_bytes=4)
    pa = dict(kind="pa", seconds=1.0, ops=1, bytes=1, dtype_bytes=4)
    share = reader("ea_apply_roofline")(dict(apply=[call, call, pa]))
    assert share == pytest.approx(22.794017910447762)
    assert reader("ea_apply_roofline")(dict(apply=[pa])) is None
