"""Tests of the benchmark harness on the CPU (and, marked ``cuda``, one
run on the card).

    python -m pytest benchmark/test_bench_harness.py -q
    python -m pytest benchmark/test_bench_harness.py -q -m cuda   # card

The CPU runs are rehearsals of each configuration's episode at 4^3
through ``core.run(device="cpu")``, the test-only entry that skips the
harness's look for a card.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import core, roofline, tracing
from benchmark.faults import FAULTS
from benchmark.reference.judge import NUMBERS

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = dict(ncuts=[4, 4, 4], ngrains=8)


def small_run(workload, tmp_path, monkeypatch, **kw):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return core.run(workload, 2**33 + 5, 0.01, False, device="cpu",
                    overrides=SMALL, log=lambda *a: None, **kw)


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert len(n) <= 64 and all(ch.isalnum() or ch in "_.-" for ch in n)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] == "step_s"
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    entry, config, traffic, e2e, per_layer = core.resolve(cell)
    assert entry["config"] == config["name"]
    assert set(config["limits"]) == set(NUMBERS)
    assert set(config["reduced"]) == set(
        next(c for c in BENCH["configs"]
             if c["name"] == entry["config"])["reduced"])
    assert traffic["dts"] and all(d > 0 for d in traffic["dts"])
    assert {m["name"] for m in e2e} == {"step_s", "peak_mem_gib",
                                        "setup_s"}
    for m in per_layer:
        assert callable(tracing.load_reader(ROOT / "metrics", m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_readers_return_nothing_on_nothing(cell):
    empty = dict(steps=0, step_s=0.0, regions={}, newton=[], apply=[],
                 dogleg={}, trace={})
    for m in core.resolve(cell)[4]:
        assert tracing.load_reader(ROOT / "metrics", m["name"])(empty) \
            is None


def test_rehearsal_loads_no_jax(tmp_path):
    """Each configuration's episode at 4^3 on the CPU, traced, with the
    harness, the readers and the reference imported: no loaded module's
    top-level name is jax, jaxlib, flax or exaconstit_tpu."""
    code = (
        "import json, sys\n"
        "from benchmark import core\n"
        f"for w in {CELLS!r}:\n"
        "    r = core.run(w, 3, 0.01, True, device='cpu',\n"
        f"                 overrides={SMALL!r}, log=lambda *a: None)\n"
        "    assert r['correct'], r\n"
        "print(json.dumps(core.forbidden_modules()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TMPDIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "exaconstit_tpu_torch_x", sys)
    assert "exaconstit_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "exaconstit_tpu.driver", sys)
    assert core.forbidden_modules() == ["exaconstit_tpu"]


def test_reference_imports_nothing_of_the_program():
    for d in ("reference", "inputs", "roofline"):
        for f in (ROOT / d).glob("*.py"):
            tree = ast.parse(f.read_text())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                for m in mods:
                    assert m.split(".")[0] not in (
                        "exaconstit_tpu_torch", "exaconstit_tpu", "jax"), \
                        (f, m)
    code = ("import sys\nimport benchmark.reference.judge\n"
            "print(sorted(m for m in sys.modules if m.startswith('exa')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


def test_roofline_equals_stage_work():
    from exaconstit_tpu_torch.solvers import dogleg_cuda
    assert roofline.OPS_START == dogleg_cuda.OPS_START
    assert roofline.OPS_ITER == dogleg_cuda.OPS_ITER
    assert roofline.BYTES_PER_POINT == dogleg_cuda.BYTES_PER_POINT
    for n, it in ((262144, 1_000_000), (2_097_152, 3), (1, 0)):
        assert roofline.stage_work(n, it) == dogleg_cuda.stage_work(n, it)


def test_operator_apply_counts():
    # 64^3 EA blocks stored in f32, an f32 apply: 604 MB of blocks
    ops, nbytes = roofline.operator_apply("ea", 262144 * 576, 4,
                                          3 * 65**3, 4, 0)
    assert ops == 262144 * (2 * 576 + 24)
    assert nbytes == 262144 * 576 * 4 + 2 * 3 * 65**3 * 4
    t, by = roofline.bound_seconds(ops, nbytes, 4)
    assert by == "bytes" and abs(t - nbytes / 3.35e12) < 1e-15
    ops, _ = roofline.operator_apply("pa", 81 * 8 * 32768, 4, 3 * 33**3,
                                     4, 0)
    assert ops == 8 * 32768 * 450 + 32768 * 24


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_correct_and_control_not(cell, tmp_path, monkeypatch):
    """The program at 4^3 passes every limit; the float32 reference in
    its place on the same episode (the control) fails one."""
    r = small_run(cell, tmp_path, monkeypatch, control="reference32")
    assert r["correct"], r["checks"]
    limits = core.resolve(cell)[1]["limits"]
    assert any(r["control"][k] > limits[k] for k in NUMBERS), r["control"]
    assert r["control_correct"] is False
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(cell, fault, tmp_path, monkeypatch):
    r = small_run(cell, tmp_path, monkeypatch, fault=FAULTS[fault])
    assert not r["correct"], r["checks"]


def test_no_card_no_result(tmp_path):
    """Without a card the command prints no result and fails."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files the command prints no result and fails."""
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_run_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          cell, "--seed", str(2**34 + 1), "--seconds", "5"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0, r
    assert r["device"]["platform"] == "gpu"
    assert np.isfinite(r["metrics"]["step_s"]["value"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell):
    """The float32 reference in the program's place at the cell's own
    size reads not correct, by the benchmark's own verdict."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "benchmark/control.py",
                          "--workload", cell, "--seeds", str(2**34 + 3),
                          "--seconds", "5"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["reference32_correct"] is False, line


def _last_step_in_sub_solves(cell):
    """The program's whole solve of each episode's last step reads as not
    converged, so that the program composes the step of sub-solves."""
    sysm = cell.sim.system
    newton = sysm.newton_solve
    last = cell.dts[-1]

    def not_converged(v, x, state, dt, *a, **k):
        out = newton(v, x, state, dt, *a, **k)
        return (*out[:3], False, *out[4:]) if dt == last else out

    sysm.newton_solve = not_converged


@pytest.mark.parametrize("broken", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sub_solves_are_followed(cell, broken, tmp_path, monkeypatch):
    """A step the program composed of sub-solves is judged sub-solve by
    sub-solve: correct as it stands, not correct with a free velocity
    altered."""
    def planted(c):
        _last_step_in_sub_solves(c)
        if broken:
            FAULTS["velocity_altered"](c)

    lines = []
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    r = core.run(cell, 2**33 + 7, 0.01, False, device="cpu",
                 overrides=SMALL, fault=planted,
                 log=lambda *a: lines.append(" ".join(map(str, a))))
    assert any("sub-solves [1, 2]" in s for s in lines), lines
    assert r["correct"] is not broken, r["checks"]
