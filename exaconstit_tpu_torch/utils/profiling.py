"""Region timings, program spans and counters, and the profiler hook.

Port of ``exaconstit_tpu.utils.profiling``:

* ``Regions`` times named regions of the run and prints them as a table at
  the end of it.  ``totals`` and ``counts`` hold the reference's regions
  (the analog of its Caliper marks): ``operator_setup``, ``line_search``
  and ``krylov_solve``, the same regions the same number of times as the
  JAX package.  ``spans`` holds the port's own spans (seconds, calls and
  self seconds, the time no nested region or span covers):
  ``time_loop.corrector``, ``time_loop.averages``, ``newton.solve``,
  ``setup.point_update`` (one a setup chunk), ``setup.operator_build``,
  ``operator.apply``, and the GMG preconditioner's (``solvers/gmg.py``)
  ``gmg.build`` (one a hierarchy, one a Krylov solve), ``gmg.v_cycle``
  (one a preconditioner call; on the CPU the fine applies inside it keep
  their ``operator.apply``) and ``gmg.coarse_solve`` (the dense
  triangular solves on the coarsest level, one a V-cycle, on the CPU:
  on the card the cycle is one CUDA graph, inside which nothing is
  timed).  ``counters`` holds
  counts, each kept under the innermost region or span open when it was
  counted ("-" outside every one): ``host_reads`` (the blocking scalar
  reads of the Newton and Krylov stop tests), ``krylov.iterations``,
  ``dogleg.points`` and ``dogleg.iterations`` (the point-solve stage's
  lanes and the iterations they report), ``operator.pa_kernel_applies``
  (the PA applies that ran the kernel pair of ``fem/pa_apply_cuda.py``),
  ``gmg.coarse_factor_failures`` (a device sum: GMG hierarchies whose
  coarsest matrix was not positive definite), and on the card
  ``gmg.graph_captures`` and ``gmg.graph_replays`` (V-cycles captured as
  a CUDA graph, one a hierarchy, and replayed, one a V-cycle).
  ``delta()`` gives
  what the spans and counters gained since its last call
  (``MechSystem.newton_solve`` puts it in each solve's stats).
  On a CUDA device a region or span records a CUDA timing event on the
  current stream at each end and does not wait for the card; the pairs
  are resolved (one synchronize, then ``elapsed_time``) when ``totals``,
  ``spans`` or ``delta()`` is read, which ``newton_solve`` does once a
  solve, and in batches, as they complete, while the run goes on.  On the CPU they take ``time.perf_counter``.  On the card each
  region and span is an NVTX range of its name, and while a profiler
  records (``torch.profiler``) each is also a ``record_function`` of its
  name, so the profiler's trace holds it on the kernels' clock, nested in
  its parent (outside a profiler the ``record_function`` is left out: it
  would cost the host a quarter of a span's time and record nothing);
* every layer reports to the current ``Regions`` through ``span``,
  ``count`` and ``count_on_device``, which do nothing (one lookup, no
  allocation) when none is current.  A ``Regions``' open region or span
  makes it current, ``recording(regions)`` makes it current around a
  body (the system's Krylov solve), and ``paused()`` none (a CUDA
  graph's capture, inside which nothing may record a timing event);
* ``maybe_profile`` wraps a run in ``torch.profiler`` when
  ``EXACONSTIT_TPU_PROFILE_DIR`` is set and writes a Chrome trace there.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from collections import defaultdict, deque

import torch

# pending event pairs at which those the card has passed are resolved
BATCH = 1024

# the current recorder, a Regions or None
_CURRENT = contextvars.ContextVar("exaconstit_recorder", default=None)
_NOTHING = contextlib.nullcontext()


class Regions:
    def __init__(self):
        self._totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._spans = defaultdict(lambda: [0.0, 0, 0.0])
        self._counters = defaultdict(lambda: defaultdict(int))
        self._device_sums = {}  # (counter, span) -> a running device sum
        self._open = []  # (name, is_span) of the open regions and spans
        self._pending = deque()  # (name, is_span, parent, start, end)
        self._free = []  # timing events to record again
        self._device = None
        self._streams = {}  # device -> the stream its events go on, or None
        self._marked = ({}, {})  # spans and counters at the last delta()

    @property
    def totals(self):
        """Seconds per region (every pending pair resolved)."""
        self._resolve(wait=True)
        return self._totals

    @property
    def spans(self):
        """{span: {"seconds", "calls", "self_seconds"}} (every pending pair
        resolved)."""
        self._resolve(wait=True)
        return {n: dict(seconds=s, calls=c, self_seconds=own)
                for n, (s, c, own) in self._spans.items()}

    @property
    def counters(self):
        """{counter: {innermost open region or span: count}} (the device
        sums read)."""
        for (name, where), total in self._device_sums.items():
            self._counters[name][where] += int(total.item())
        self._device_sums.clear()
        return {n: dict(by) for n, by in self._counters.items()}

    def delta(self):
        """(spans, counters) as ``spans`` and ``counters`` give them, less
        what they held at the previous call (at the start for the first),
        with the rows that did not change left out."""
        spans, counters = self.spans, self.counters
        s0, c0 = self._marked
        self._marked = (spans, counters)
        ds = {}
        for name, row in spans.items():
            d = {k: v - s0.get(name, {}).get(k, 0) for k, v in row.items()}
            if any(d.values()):
                ds[name] = d
        dc = {}
        for name, by in counters.items():
            d = {w: v - c0.get(name, {}).get(w, 0) for w, v in by.items()}
            d = {w: v for w, v in d.items() if v}
            if d:
                dc[name] = d
        return ds, dc

    def region(self, name, device=None):
        """A context that times its body as the reference's region
        ``name`` on ``device`` (None: the host's clock)."""
        return _Timed(self, name, device, False)

    def span(self, name, device=None):
        """A context that times its body as the port's span ``name``."""
        return _Timed(self, name, device, True)

    def _where(self):
        return self._open[-1][0] if self._open else "-"

    def count(self, name, n=1):
        """Add ``n`` to counter ``name`` under the innermost open region or
        span."""
        self._counters[name][self._where()] += n

    def count_on_device(self, name, values):
        """Add the sum of the device tensor ``values`` to counter ``name``
        under the innermost open region or span; the sum stays on the
        device until ``counters`` is read."""
        key = (name, self._where())
        total = values.sum()
        held = self._device_sums.get(key)
        self._device_sums[key] = total if held is None else held + total

    def _stream(self, device):
        """The stream current on ``device`` when it was first timed (the
        program keeps its work on one stream), None off the card."""
        try:
            return self._streams[device]
        except KeyError:
            stream = None
            if device is not None and torch.device(device).type == "cuda":
                stream = torch.cuda.current_stream(device)
                self._device = stream.device
            self._streams[device] = stream
            return stream

    def _done(self, name, is_span, parent, start, end):
        if is_span:
            self._spans[name][1] += 1
        else:
            self.counts[name] += 1
        self._pending.append((name, is_span, parent, start, end))
        if len(self._pending) >= BATCH:
            self._resolve(wait=False)

    def _stamp(self, stream):
        if stream is None:
            return time.perf_counter()
        ev = self._free.pop() if self._free else torch.cuda.Event(
            enable_timing=True)
        ev.record(stream)
        return ev

    def _resolve(self, wait):
        """Add the pending pairs' seconds to their tables: every pair after
        one synchronize (``wait``), else those the card has passed."""
        pending = self._pending
        if wait and self._device is not None and pending:
            torch.cuda.synchronize(self._device)
        while pending:
            name, is_span, parent, start, end = pending[0]
            if isinstance(end, float):
                seconds = end - start
            elif wait or end.query():
                seconds = start.elapsed_time(end) / 1e3
                self._free += (start, end)
            else:
                break
            pending.popleft()
            if is_span:
                row = self._spans[name]
                row[0] += seconds
                row[2] += seconds
            else:
                self._totals[name] += seconds
            if parent is not None and parent[1]:
                self._spans[parent[0]][2] -= seconds

    def report(self):
        lines = ["region timings:"]
        totals = self.totals
        for name in sorted(totals, key=totals.get, reverse=True):
            lines.append(f"  {name:28s} {totals[name]:10.3f}s "
                         f"x{self.counts[name]}")
        spans = self.spans
        if spans:
            lines.append("spans (seconds, self seconds, calls):")
            for name in sorted(spans, key=lambda n: -spans[n]["seconds"]):
                s = spans[name]
                lines.append(f"  {name:28s} {s['seconds']:10.3f}s "
                             f"{s['self_seconds']:10.3f}s x{s['calls']}")
        counters = self.counters
        if counters:
            lines.append("counters (total; by innermost region or span):")
            for name in sorted(counters):
                by = counters[name]
                where = ", ".join(f"{k} {v}" for k, v in sorted(
                    by.items(), key=lambda kv: -kv[1]))
                lines.append(f"  {name:28s} {sum(by.values()):12d}  "
                             f"({where})")
        return "\n".join(lines)


class _Timed:
    """One timed region or span of a ``Regions``."""

    __slots__ = ("regions", "name", "device", "is_span", "stream", "parent",
                 "start", "record", "token")

    def __init__(self, regions, name, device, is_span):
        self.regions = regions
        self.name = name
        self.device = device
        self.is_span = is_span

    def __enter__(self):
        r = self.regions
        self.stream = r._stream(self.device)
        if self.stream is not None:
            torch.cuda.nvtx.range_push(self.name)
        self.record = None
        if torch.autograd._profiler_enabled():
            self.record = torch.profiler.record_function(self.name)
            self.record.__enter__()
        self.parent = r._open[-1] if r._open else None
        r._open.append((self.name, self.is_span))
        self.token = _CURRENT.set(r)
        self.start = r._stamp(self.stream)
        return self

    def __exit__(self, kind, value, tb):
        r = self.regions
        end = r._stamp(self.stream) if kind is None else None
        _CURRENT.reset(self.token)
        r._open.pop()
        if self.record is not None:
            self.record.__exit__(kind, value, tb)
        if self.stream is not None:
            torch.cuda.nvtx.range_pop()
        if end is not None:
            r._done(self.name, self.is_span, self.parent, self.start, end)
        return False


@contextlib.contextmanager
def recording(regions):
    """A context in which ``regions`` (or None: no recorder) is current."""
    token = _CURRENT.set(regions)
    try:
        yield regions
    finally:
        _CURRENT.reset(token)


def paused():
    """A context in which no recorder is current (a CUDA graph's capture)."""
    return recording(None)


def span(name, device=None):
    """The current recorder's span ``name`` on ``device``, or nothing."""
    r = _CURRENT.get()
    return _NOTHING if r is None else r.span(name, device)


def count(name, n=1):
    """``Regions.count`` of the current recorder, or nothing."""
    r = _CURRENT.get()
    if r is not None:
        r.count(name, n)


def count_on_device(name, values):
    """``Regions.count_on_device`` of the current recorder, or nothing."""
    r = _CURRENT.get()
    if r is not None:
        r.count_on_device(name, values)


@contextlib.contextmanager
def maybe_profile(device="cpu"):
    """A ``torch.profiler`` trace of the body when
    EXACONSTIT_TPU_PROFILE_DIR is set: CPU activity, plus the card's
    kernels and copies when ``device`` is a CUDA device, written as a
    Chrome trace (``trace_<pid>_<time>.json``) into that directory.  The
    regions and spans appear in it as events when region timing is on
    too."""
    d = os.environ.get("EXACONSTIT_TPU_PROFILE_DIR")
    if not d:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(d, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        d, f"trace_{os.getpid()}_{time.time_ns()}.json"))
