"""The device's idle time by program span, and the cross-checks of the
program's spans and counters, from one traced run of a cell.

    python3 benchmark/span_report.py --workload <cell> --seed <n> \
        --seconds <s>

It makes the run that ``run.py --trace 1`` makes (``core.run``), keeps
what ``tracing.Recorder`` read and the profiled episode's trace, and
prints one JSON line: ``result`` (the run's result line), ``idle_by_span``
(``idle_by_span`` of the profiled episode), ``episode_counters`` (the
program's counters over that episode) and ``cross_checks``:

* ``apply_ms``: ms a call of the program's span ``operator.apply`` over
  the window, against the Recorder's CUDA events around the same calls,
  which the program calls inside the span;
* ``dogleg_iters_per_point``: the program's counters over the profiled
  episode, against the Recorder's wrapped kernel launches there;
* ``krylov_reads_per_iter``: the program's counter ``host_reads`` under
  ``krylov_solve`` over the profiled episode's Krylov iterations there,
  against the trace's blocking scalar reads (``aten::_local_scalar_dense``)
  inside the ``krylov_solve`` annotations over the same iterations.

It reads the program's ``Regions.counters`` and the solves' ``spans``;
against a program without them those entries are None.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
from collections import defaultdict

# as run.py: few host threads, out of the way of the launching thread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import core, tracing  # noqa: E402

READ_OP = "aten::_local_scalar_dense"


def _annotations(events):
    """(load steps, program spans, scalar read starts) of a trace: the
    host's annotations on the thread of the ``load_step`` annotations."""
    steps, spans, reads = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s, d = float(ev["ts"]), float(ev["dur"])
        where = (ev.get("pid"), ev.get("tid"))
        if ev.get("cat") == "user_annotation":
            (steps if ev["name"] == "load_step" else spans).append(
                (s, s + d, ev["name"], where))
        elif ev.get("cat") == "cpu_op" and ev["name"] == READ_OP:
            reads.append(s)
    threads = {w for *_, w in steps}
    return steps, [x for x in spans if x[3] in threads], sorted(reads)


def reads_in(events, name):
    """The blocking scalar reads that start inside annotations ``name``."""
    _, spans, reads = _annotations(events)
    return sum(bisect.bisect_left(reads, e) - bisect.bisect_left(reads, s)
               for s, e, n, _ in spans if n == name)


def idle_by_span(events):
    """The device's idle time inside each program span of a traced
    episode, or None where the card ran nothing.

    Program spans are the host's annotations (``record_function``: the
    program's regions and spans) on the thread of the episode's
    ``load_step`` annotations, other than ``load_step``.  Idle is the
    complement, within the load steps, of the union of the device's
    kernels, copies and memsets; a gap is split where spans open or
    close, and each part counts for every span open over it (``idle_s``)
    and for the innermost alone (``self_idle_s``).  Per span name:
    ``seconds`` (within the load steps), ``idle_s``, ``self_idle_s`` and
    ``reads``, the blocking scalar reads that start inside it;
    ``outside_s`` is the idle time inside no program span."""
    dev = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
           for ev in events if ev.get("ph") == "X" and "dur" in ev
           and ev.get("cat") in tracing.DEVICE_CATS]
    steps, spans, reads = _annotations(events)
    if not dev or not steps:
        return None
    lo = min(s for s, *_ in steps)
    hi = max(e for _, e, *_ in steps)
    merged = [(max(s, lo), min(e, hi)) for s, e in tracing._union(dev)
              if e > lo and s < hi]
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
    starts = [s for s, _ in gaps]
    before = [0.0]
    for s, e in gaps:
        before.append(before[-1] + e - s)

    def idle_to(t):
        k = bisect.bisect_right(starts, t)
        if k == 0:
            return 0.0
        s, e = gaps[k - 1]
        return before[k - 1] + min(t, e) - s

    def idle(s, e):
        return (idle_to(e) - idle_to(s)) / 1e6 if e > s else 0.0

    out = defaultdict(lambda: dict(seconds=0.0, idle_s=0.0, self_idle_s=0.0,
                                   reads=0))
    top = 0.0
    stack = []  # (end, name) of the open spans, innermost last
    for s, e, name, _ in sorted(spans, key=lambda x: (x[0], -x[1])):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        while stack and stack[-1][0] <= s:
            stack.pop()
        own = idle(s, e)
        row = out[name]
        row["seconds"] += (e - s) / 1e6
        row["idle_s"] += own
        row["self_idle_s"] += own
        row["reads"] += (bisect.bisect_left(reads, e)
                         - bisect.bisect_left(reads, s))
        if stack:
            end, parent = stack[-1]
            out[parent]["self_idle_s"] -= idle(s, min(e, end))
        else:
            top += own
        stack.append((e, name))
    total = before[-1] / 1e6
    return dict(idle_s=total, outside_s=total - top, spans=dict(out))


def _counters(regions):
    return getattr(regions, "counters", None)


def _total(counters, name, where=None):
    by = (counters or {}).get(name, {})
    return by.get(where, 0) if where else sum(by.values())


def report(workload, seed, seconds, device="cuda", **kw):
    """The traced run of ``workload`` and what this module reads of it."""
    got = {}
    reduce_trace = tracing.reduce_trace
    episode, metrics = (tracing.Recorder.profiled_episode,
                        tracing.Recorder.metrics)

    def keep_events(events):
        got["events"] = events
        return reduce_trace(events)

    def counted_episode(self, workdir):
        c0 = _counters(self.sysm.regions)
        episode(self, workdir)
        c1 = _counters(self.sysm.regions)
        got["episode"] = None if c1 is None else {
            n: {w: v - c0.get(n, {}).get(w, 0) for w, v in by.items()}
            for n, by in c1.items()}

    def kept_metrics(self, *a):
        got["data"] = self.data
        return metrics(self, *a)

    tracing.reduce_trace = keep_events
    tracing.Recorder.profiled_episode = counted_episode
    tracing.Recorder.metrics = kept_metrics
    try:
        result = core.run(workload, seed, seconds, True, device=device, **kw)
    finally:
        tracing.reduce_trace = reduce_trace
        tracing.Recorder.profiled_episode = episode
        tracing.Recorder.metrics = metrics
    data, ep, events = got["data"], got["episode"], got["events"]
    checks = {}
    rows = [s["spans"]["operator.apply"] for s in data["newton"]
            if "operator.apply" in s.get("spans", {})]
    calls = sum(r["calls"] for r in rows)
    if calls and data.get("apply"):
        checks["apply_ms"] = dict(
            span=1e3 * sum(r["seconds"] for r in rows) / calls,
            span_calls=calls,
            wrapped=1e3 * sum(a["seconds"] for a in data["apply"])
            / len(data["apply"]), wrapped_calls=len(data["apply"]))
    points = _total(ep, "dogleg.points")
    if points:
        d = data.get("dogleg") or {}
        checks["dogleg_iters_per_point"] = dict(
            counters=_total(ep, "dogleg.iterations") / points,
            wrapped=d["iters"] / d["points"] if d.get("points") else None)
    iters = _total(ep, "krylov.iterations", "krylov_solve")
    if iters:
        checks["krylov_reads_per_iter"] = dict(
            counter=_total(ep, "host_reads", "krylov_solve") / iters,
            trace=reads_in(events, "krylov_solve") / iters, iterations=iters)
    return dict(result=result, idle_by_span=idle_by_span(events),
                episode_counters=ep, cross_checks=checks)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = report(args.workload, args.seed, args.seconds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
