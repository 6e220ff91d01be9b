"""The traced run's readings, taken from the benchmark's own files.

``Recorder`` wraps calls of one built program (the Newton solve, the
operator apply, the point-solve kernel's launch) and reads the
program's region timings (``EXACONSTIT_TPU_REGIONS=1``: operator_setup,
line_search, krylov_solve, each synchronised at both ends) over the
measured window.  After the window it holds one more episode under
``torch.profiler`` and reduces its trace: the device's busy time, the
kernels that took most of it, the idle gaps by what the host was doing,
and the kernel's device time.  Each per-layer metric's reader
(``metrics/<name>.py``) takes its number from the dict ``data`` that
``Recorder.metrics`` builds; a reader that finds nothing returns None.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import time
from collections import defaultdict

from . import roofline

TOP = 10


class Recorder:
    def __init__(self, cell):
        import torch
        from exaconstit_tpu_torch.solvers import dogleg_cuda

        self.torch = torch
        self.cell = cell
        self.sysm = sysm = cell.sim.system
        self.cuda = cell.device.type == "cuda"
        self.in_window = self.profiling = False
        self.newton, self.applies, self.launches = [], [], []
        self.data = {}
        if sysm.regions is None:
            raise RuntimeError("the traced run needs EXACONSTIT_TPU_REGIONS")

        newton = sysm.newton_solve

        def newton_solve(*a, **k):
            out = newton(*a, **k)
            if self.in_window:
                self.newton.append(dict(sysm.last_newton_stats))
            return out

        apply_k = sysm.apply_k
        kind = "pa" if sysm.pa else "ea"
        emap = sysm.emap
        index_bytes = sum(t.numel() * t.element_size() for t in (
            getattr(emap, "conn_t", None), getattr(emap, "table", None))
            if t is not None)

        def timed_apply(k_data, x):
            if not self.in_window:
                return apply_k(k_data, x)
            t0 = self._mark()
            y = apply_k(k_data, x)
            self.applies.append((t0, self._mark(), kind, k_data.numel(),
                                 k_data.element_size(), x.numel(),
                                 x.element_size(), index_bytes))
            return y

        kernel = dogleg_cuda.KERNEL
        launch = kernel.launch

        def counted_launch(params, *args):
            x, ok, iters, J = launch(params, *args)
            if self.profiling:
                self.launches.append((iters.numel(), iters.sum()))
            return x, ok, iters, J

        sysm.newton_solve = newton_solve
        sysm.apply_k = timed_apply
        kernel.launch = counted_launch
        self._unwrap = lambda: (vars(sysm).pop("newton_solve"),
                                vars(sysm).pop("apply_k"),
                                vars(kernel).pop("launch"))

    def _mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _regions(self):
        r = self.sysm.regions
        return {k: (r.totals[k], r.counts[k]) for k in r.totals}

    def start_window(self):
        self._r0 = self._regions()
        self.in_window = True

    def stop_window(self, step_seconds, steps):
        self.in_window = False
        r1 = self._regions()
        zero = (0.0, 0)
        self.data.update(
            steps=steps, step_s=step_seconds,
            regions={k: (v[0] - self._r0.get(k, zero)[0],
                         v[1] - self._r0.get(k, zero)[1])
                     for k, v in r1.items()},
            newton=self.newton)
        self.cell.sync()
        applies = []
        for t0, t1, kind, kn, ks, xn, xs, ib in self.applies:
            sec = t0.elapsed_time(t1) / 1e3 if self.cuda else t1 - t0
            ops, nbytes = roofline.operator_apply(kind, kn, ks, xn, xs, ib)
            applies.append(dict(kind=kind, seconds=sec, ops=ops,
                                bytes=nbytes, dtype_bytes=xs))
        self.data["apply"] = applies
        self.applies = []

    def profiled_episode(self, workdir):
        """One more episode under torch.profiler, after the window."""
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiling = True
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for ti, dt in enumerate(self.cell.dts, 1):
                with torch.profiler.record_function("load_step"):
                    self.cell.step(ti, dt)
            window_s = time.perf_counter() - t0
        self.profiling = False
        path = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.unlink(path)
        trace = reduce_trace(events)
        trace["window_s"] = window_s
        points = sum(n for n, _ in self.launches)
        iters = sum(int(s) for _, s in self.launches)
        self.data["trace"] = trace
        self.data["dogleg"] = dict(launches=len(self.launches), points=points,
                                   iters=iters,
                                   kernel_s=trace["kernels"].get("dogleg"))
        self._unwrap()

    def metrics(self, per_layer, metrics_dir):
        """({metric: {value, unit}} of the readers that found something,
        the device's busy and window seconds, the breakdown)."""
        out = {}
        for m in per_layer:
            value = load_reader(metrics_dir, m["name"])(self.data)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        tr = self.data["trace"]
        return (out, {"busy_s": tr["busy_s"], "window_s": tr["window_s"]},
                {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]})


    def summary(self):
        """Lines with the counts behind the roofline shares."""
        d = self.data["dogleg"]
        ops, nbytes = roofline.stage_work(d["points"], d["iters"])
        yield (f"dogleg_voce: {d['launches']} launches, {d['points']} points, "
               f"{d['iters']} iterations, {ops} operations, {nbytes} bytes, "
               f"kernel {d['kernel_s']} s")
        for kind in ("ea", "pa"):
            calls = [a for a in self.data["apply"] if a["kind"] == kind]
            for size in sorted({a["dtype_bytes"] for a in calls}):
                cs = [a for a in calls if a["dtype_bytes"] == size]
                yield (f"{kind} apply in {8 * size}-bit: {len(cs)} calls, "
                       f"{sum(a['ops'] for a in cs)} operations, "
                       f"{sum(a['bytes'] for a in cs)} bytes, "
                       f"{sum(a['seconds'] for a in cs)} s")
        tr = self.data["trace"]
        yield (f"traced episode: busy {tr['busy_s']} s of {tr['window_s']} s")


def load_reader(metrics_dir, name):
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(metrics_dir, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(events):
    """Busy seconds (the union of device activity), the ten device
    operations that took most time, the ten host activities the longest
    idle gaps fell in, and the kernel seconds by family."""
    dev, host, steps = [], [], []
    per_op = defaultdict(float)
    kernels = defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        s, d = float(ev["ts"]), float(ev["dur"])
        if cat in DEVICE_CATS:
            dev.append((s, s + d))
            per_op[ev["name"][:120]] += d
            if cat == "kernel" and "dogleg_voce" in ev["name"]:
                kernels["dogleg"] += d / 1e6
        elif cat in ("cpu_op", "user_annotation"):
            if ev["name"] == "load_step":
                steps.append((s, s + d))
            else:
                host.append((s, s + d, ev["name"]))
    lo = min((s for s, _ in steps), default=0.0)
    hi = max((e for _, e in steps), default=0.0)
    merged = [[max(s, lo), min(e, hi)] for s, e in _union(dev)
              if e > lo and s < hi]
    busy = sum(e - s for s, e in merged) / 1e6
    gaps = []
    if hi > lo:
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        for s, e in zip(edges[::2], edges[1::2]):
            s, e = max(s, lo), min(e, hi)
            if e > s:
                gaps.append((s, e))
    host.sort()
    idle = defaultdict(float)
    starts = [h[0] for h in host]
    for s, e in gaps:
        # the innermost host event open at the gap's start
        i = bisect.bisect_right(starts, s)
        name = "-"
        for j in range(i - 1, max(-1, i - 200), -1):
            if host[j][1] >= s:
                name = host[j][2]
                break
        idle[name[:120]] += (e - s) / 1e6
    return dict(
        busy_s=busy,
        device_ops=[[n, v / 1e6] for n, v in sorted(
            per_op.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[n, v] for n, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:TOP]],
        kernels=dict(kernels))
