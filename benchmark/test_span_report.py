"""Tests of ``span_report.py`` and of the readers of the program's spans
and counters, on the CPU:

    python -m pytest benchmark/test_span_report.py -q
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import span_report, tracing
from benchmark.test_bench_harness import BENCH, CELLS, ROOT, SMALL

SPAN_READERS = ("time_loop.corrector_ms_per_step",
                "setup.point_update_ms_per_call",
                "setup.operator_build_ms_per_call",
                "operator.apply_ms_per_call", "krylov.host_reads_per_iter",
                "kernel.dogleg_iters_per_point")


def _event(name, ts, dur, cat="user_annotation", tid=1):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=7, tid=tid)


def test_idle_by_span_splits_gaps_at_span_edges():
    """A load step over 0-100 us, span A over 10-90 holding B over 30-60
    (and a span of another thread, left out), three device activities at
    0-20, 40-50 and 70-80, and scalar reads at 35, 55, 85 and 95: the idle
    20-40, 50-70 and 80-100 split where the spans open and close."""
    events = [_event("load_step", 0, 100), _event("A", 10, 80),
              _event("B", 30, 30), _event("A", 0, 100, tid=2),
              _event("k1", 0, 20, "kernel"), _event("k2", 40, 10, "kernel"),
              _event("k3", 70, 10, "gpu_memcpy")]
    events += [_event(span_report.READ_OP, t, 1, "cpu_op")
               for t in (35, 55, 85, 95)]
    got = span_report.idle_by_span(events)
    us = 1e-6
    assert got["idle_s"] == pytest.approx(60 * us, rel=1e-12)
    assert got["outside_s"] == pytest.approx(10 * us, rel=1e-12)
    assert set(got["spans"]) == {"A", "B"}
    a, b = got["spans"]["A"], got["spans"]["B"]
    assert a["seconds"] == pytest.approx(80 * us, rel=1e-12)
    assert a["idle_s"] == pytest.approx(50 * us, rel=1e-12)
    assert a["self_idle_s"] == pytest.approx(30 * us, rel=1e-12)
    assert b["seconds"] == pytest.approx(30 * us, rel=1e-12)
    assert b["idle_s"] == pytest.approx(20 * us, rel=1e-12)
    assert b["self_idle_s"] == pytest.approx(20 * us, rel=1e-12)
    assert 100 * a["idle_s"] / a["seconds"] == pytest.approx(62.5)
    assert 100 * b["idle_s"] / b["seconds"] == pytest.approx(200 / 3)
    assert (a["reads"], b["reads"]) == (3, 2)
    assert span_report.reads_in(events, "A") == 3
    no_card = [e for e in events if e["cat"] not in tracing.DEVICE_CATS]
    assert span_report.idle_by_span(no_card) is None


def test_span_readers_listed():
    listed = {m["name"]: m for m in BENCH["per_layer"]}
    for name in SPAN_READERS:
        assert listed[name]["workloads"] == CELLS
        assert callable(tracing.load_reader(ROOT / "metrics", name))


def test_span_readers_and_cross_checks_on_a_cpu_run(tmp_path, monkeypatch):
    """Traced at 4^3 on the CPU, the readers of the program's spans and
    counters give finite numbers; the apply span holds each call the
    Recorder wraps (the wrapper runs inside the span), and the Krylov host-read counter equals the trace's
    scalar reads inside ``krylov_solve``.  No card: no idle by span."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    out = span_report.report(CELLS[0], 2**33 + 9, 0.01, device="cpu",
                             overrides=SMALL, log=lambda *a: None)
    json.dumps(out)
    r = out["result"]
    assert r["correct"], r["checks"]
    for name in SPAN_READERS:
        assert np.isfinite(r["metrics"][name]["value"]), name
    assert r["metrics"]["krylov.host_reads_per_iter"]["value"] > 2.0
    assert out["idle_by_span"] is None
    checks = out["cross_checks"]
    apply = checks["apply_ms"]
    assert apply["span_calls"] == apply["wrapped_calls"] > 0
    assert apply["wrapped"] <= apply["span"]
    reads = checks["krylov_reads_per_iter"]
    assert reads["counter"] == reads["trace"] > 2.0
    # the plain stage on the CPU: counted, but no kernel launched
    assert checks["dogleg_iters_per_point"]["wrapped"] is None
    assert np.isfinite(checks["dogleg_iters_per_point"]["counters"])
