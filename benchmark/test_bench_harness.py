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
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import core, roofline, tracing
from benchmark.inputs import cases
from benchmark.faults import FAULTS
from benchmark.reference.judge import NUMBERS

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = dict(ncuts=[4, 4, 4], ngrains=8)

# SHA-256 of every file ``write_case`` writes, taken from the harness's
# tree before a configuration named its material; at 4^3 (``SMALL``) and
# at the configuration's own 32^3, at two seeds
_EVERY_CASE = {
    "dt.txt":
        "258774349b3a6775a247d7b486598f2ad76c415e7b979560c0bc1f9b67f18378",
    "props_cp_voce.txt":
        "204064e118c27952ce7149156a0d8def9bd72faff39e42390018bbc60df41bd0",
    "state_cp_voce.txt":
        "d57967108bc5adf4f6fa30849e6827b8562326a032a0440502bbaa6f293e87f4",
}
PINNED = {
    ("voce_fcc_pa_mesh_32", 4, 2**33 + 5): {
        **_EVERY_CASE,
        "grains.txt":
            "bb92ff4d37926e731816ca80d72cb0adc4b018d4902ddee7567bb7b9becf535e",
        "mesh.mesh":
            "8cc743b20edd2b7b9ad7859a72d1bbf0f6775ec77491cff362076367ac627420",
        "quats.ori":
            "862380e036334ddfa03eab526835b7a18bb59bbf25e6fd61fb74d0913c15aeaa",
        "voce.toml":
            "3abbcbe6ac96f5c85728f75330c7ae7883db7f77c1639e5dc5a45901b160ec4d",
    },
    ("voce_fcc_pa_mesh_32", 4, 3000000301): {
        **_EVERY_CASE,
        "grains.txt":
            "3c4512913d341311d7809cc827eb5611dd00475815c0d805e517c390bc499aac",
        "mesh.mesh":
            "78f53f6307cd7a5353ec0378c204674905eae2d6763fbb9530b819c27dd3cc91",
        "quats.ori":
            "b79024fb27d342514932d8a81203f4e5af7f3d4aabe9640b3820fc9b6dc0cbca",
        "voce.toml":
            "3abbcbe6ac96f5c85728f75330c7ae7883db7f77c1639e5dc5a45901b160ec4d",
    },
    ("voce_fcc_pa_mesh_32", 32, 2**33 + 5): {
        **_EVERY_CASE,
        "grains.txt":
            "f626c0c1a10a5c8dfaea0728f346111fd6af7dca02a38853e9093d3a44a77250",
        "mesh.mesh":
            "9f4bdd507cc4cd99c64fb858e8cfbfac11ba21f5a947abd25938885253dd51cf",
        "quats.ori":
            "5195dcf8bfd82130e9d3ec16bbb94025514f18d8f82e6a64b967a4b07e75318d",
        "voce.toml":
            "2c2c2bd573b9105f4b6683874d2aff061ed0f7c9b008d7b9a1d14a09efe9f916",
    },
    ("voce_fcc_pa_mesh_32", 32, 3000000301): {
        **_EVERY_CASE,
        "grains.txt":
            "7fa4cd9ff91b2055672f637a09aa55d661b07eefa828c8366ad35a9c4050a78d",
        "mesh.mesh":
            "0fadc358b209c4293d393b02f46fdf15087cf7a2853bde6c5b0e4ad60bac317d",
        "quats.ori":
            "244fb708fcdc14edda1e7c271f23d5d84c334061633850bf9ef1b71bfe1bf6c0",
        "voce.toml":
            "2c2c2bd573b9105f4b6683874d2aff061ed0f7c9b008d7b9a1d14a09efe9f916",
    },
    ("voce_fcc_ea_32", 4, 2**33 + 5): {
        **_EVERY_CASE,
        "grains.txt":
            "bb92ff4d37926e731816ca80d72cb0adc4b018d4902ddee7567bb7b9becf535e",
        "quats.ori":
            "862380e036334ddfa03eab526835b7a18bb59bbf25e6fd61fb74d0913c15aeaa",
        "voce.toml":
            "f2780a0b4062e50396436b1d9fb02273fbeceab2e3b32063d89ec11961f4da95",
    },
    ("voce_fcc_ea_32", 4, 3000000301): {
        **_EVERY_CASE,
        "grains.txt":
            "3c4512913d341311d7809cc827eb5611dd00475815c0d805e517c390bc499aac",
        "quats.ori":
            "b79024fb27d342514932d8a81203f4e5af7f3d4aabe9640b3820fc9b6dc0cbca",
        "voce.toml":
            "f2780a0b4062e50396436b1d9fb02273fbeceab2e3b32063d89ec11961f4da95",
    },
    ("voce_fcc_ea_32", 32, 2**33 + 5): {
        **_EVERY_CASE,
        "grains.txt":
            "f626c0c1a10a5c8dfaea0728f346111fd6af7dca02a38853e9093d3a44a77250",
        "quats.ori":
            "5195dcf8bfd82130e9d3ec16bbb94025514f18d8f82e6a64b967a4b07e75318d",
        "voce.toml":
            "6feab216542b5400542a71e40d31c14db60805b88d2fb0a24a5600af2c724b0f",
    },
    ("voce_fcc_ea_32", 32, 3000000301): {
        **_EVERY_CASE,
        "grains.txt":
            "7fa4cd9ff91b2055672f637a09aa55d661b07eefa828c8366ad35a9c4050a78d",
        "quats.ori":
            "244fb708fcdc14edda1e7c271f23d5d84c334061633850bf9ef1b71bfe1bf6c0",
        "voce.toml":
            "6feab216542b5400542a71e40d31c14db60805b88d2fb0a24a5600af2c724b0f",
    },
}


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
    """No module of the reference, the inputs (every material's too) or
    the roofline imports the program, by its source or once imported."""
    modules = []
    for d in ("reference", "inputs", "roofline"):
        for f in (ROOT / d).glob("*.py"):
            modules.append(".".join(["benchmark", d] + (
                [] if f.stem == "__init__" else [f.stem])))
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
    assert "benchmark.reference.voce" in modules
    assert "benchmark.inputs.voce" in modules
    code = (f"import importlib, sys\nfor m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.startswith('exa')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


def _written(dirpath):
    """{file name: SHA-256} of every file in ``dirpath``."""
    return {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(Path(dirpath).iterdir())}


def _case(config, size):
    case = dict(core.load_json(REPO / next(
        c["file"] for c in BENCH["configs"] if c["name"] == config))["case"])
    if size == 4:
        case.update(SMALL)
    assert case["ncuts"] == [size] * 3
    return case


DTS = core.load_json(ROOT / "traffic" / "ramp.json")["dts"]


@pytest.mark.parametrize("config,size,seed", sorted(PINNED))
def test_inputs_pinned(config, size, seed, tmp_path):
    """What the input writer writes for each configuration is byte for
    byte what it wrote before the material was named."""
    cases.write_case(tmp_path, _case(config, size), DTS, seed)
    assert _written(tmp_path) == PINNED[config, size, seed]


@pytest.mark.parametrize("cell", CELLS)
def test_material_named_as_the_default(cell, tmp_path, monkeypatch):
    """A case that names the default material is the case that names
    none: the same files, the same inputs, the same checks."""
    config = core.resolve(cell)[1]
    case = dict(config["case"], **SMALL)
    assert "material" not in case
    named = dict(case, material=cases.DEFAULT_MATERIAL)
    a = cases.write_case(tmp_path / "a", case, DTS, 2**33 + 5)
    b = cases.write_case(tmp_path / "b", named, DTS, 2**33 + 5)
    assert _written(tmp_path / "a") == _written(tmp_path / "b")
    assert set(a) == set(b) and a["material"] == b["material"]
    for k in ("ncuts", "grains", "quats", "props"):
        assert np.array_equal(a[k], b[k]), k
    for k in ("options", "mesh_file"):
        assert (a[k] and Path(a[k]).name) == (b[k] and Path(b[k]).name)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    checks = [core.run(cell, 2**33 + 5, 0.01, False, device="cpu",
                       overrides=o, log=lambda *a: None)["checks"]
              for o in (SMALL, dict(SMALL, material=cases.DEFAULT_MATERIAL))]
    assert checks[0] == checks[1]


@pytest.mark.parametrize("name,error", [
    ("nonesuch", FileNotFoundError), ("cases", FileNotFoundError),
    ("__init__", ImportError)])
def test_unknown_material_fails_in_resolve(name, error, monkeypatch):
    """A configuration whose material has no modules, or names one of the
    harness's own modules, fails before anything is built, naming the
    paths it looked for."""
    load = core.load_json

    def unknown(path):
        d = load(path)
        if "case" in d:
            d["case"]["material"] = name
        return d

    monkeypatch.setattr(core, "load_json", unknown)
    with pytest.raises(error) as e:
        core.resolve(CELLS[0])
    looked = [str(ROOT / d / f"{name}.py") for d in ("inputs", "reference")]
    assert any(p in str(e.value) for p in looked)
    if error is FileNotFoundError:
        assert all(p in str(e.value) for p in looked)


# a second material brought as two new modules: the default material's
# inputs and point model, with the elastic strain and the quaternion
# compared
_INPUTS_MODULE = """\
from .voce import INITIAL_STATE, PROPS, SLIP_TYPE, XTAL_TYPE  # noqa: F401
"""
_REFERENCE_MODULE = """\
from .voce import SLOTS, PointModel  # noqa: F401

STATE = ("e", "q")
"""


def test_new_material_needs_no_edit(tmp_path):
    """In a copy of the benchmark, a material added as two new modules,
    with a configuration and a cell that name it, runs through
    ``core.run`` at 4^3, loads both modules and reads correct."""
    tree = tmp_path / "tree"
    shutil.copytree(ROOT, tree / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tree / "benchmark/inputs/twin.py").write_text(_INPUTS_MODULE)
    (tree / "benchmark/reference/twin.py").write_text(_REFERENCE_MODULE)
    entry = next(c for c in BENCH["configs"]
                 if c["name"] == "voce_fcc_ea_32")
    config = core.load_json(REPO / entry["file"])
    config["name"] = "twin_fcc_ea_32"
    config["case"]["material"] = "twin"
    (tree / "benchmark/configs/twin_fcc_ea_32.json").write_text(
        json.dumps(config))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(entry, name="twin_fcc_ea_32",
                                 file="benchmark/configs/twin_fcc_ea_32.json"))
    cell = next(w for w in BENCH["workloads"]
                if w["config"] == "voce_fcc_ea_32")
    bench["workloads"].append(dict(cell, name="twin_fcc_ea_32.ramp",
                                   config="twin_fcc_ea_32"))
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys\n"
        "from benchmark import core\n"
        "r = core.run('twin_fcc_ea_32.ramp', 2**33 + 5, 0.01, False,\n"
        f"             device='cpu', overrides={SMALL!r},\n"
        "             log=lambda *a: None)\n"
        "r['loaded'] = sorted(m for m in sys.modules if 'twin' in m)\n"
        "print(json.dumps(dict(r, harness=core.__file__)))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert Path(r["harness"]).parent == tree / "benchmark"
    assert r["loaded"] == ["benchmark.inputs.twin", "benchmark.reference.twin"]
    assert r["correct"] and r["failed"] == 0, r["checks"]


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
