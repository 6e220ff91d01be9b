"""The PyTorch port's command line against the JAX package's, and the
port's independence from JAX.

Both CLIs run the same in-repo FCC Voce case (``exaconstit_tpu_torch.
cases``: a 4^3 voxel mesh, Voronoi grains, uniaxial tension, 2 custom
steps) written into ``tmp_path``, with the production defaults on both
sides; their average-stress files agree at the Newton tolerance.  So
do the case's variants: a mesh file with EA or PA, B-bar, GMRES and
MINRES."""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from exaconstit_tpu import cli as J_CLI
from exaconstit_tpu_torch import cli as T_CLI
from exaconstit_tpu_torch.cases import write_voce_case

PKG = Path(T_CLI.__file__).resolve().parent


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_cli(main, argv, rundir, monkeypatch):
    rundir.mkdir()
    monkeypatch.chdir(rundir)
    assert main(argv) == 0
    assert (rundir / "timing" / "time_solve.0.txt").exists()
    return np.loadtxt(rundir / "avg_stress.txt", ndmin=2)


def test_cli_matches_reference_cli(tmp_path, monkeypatch):
    """Production defaults on both sides (f32 stage + f64 polish, f32 EA
    build, PCG with mixed-precision refinement; the 4^3 grid does not
    coarsen, so Jacobi): rel 1e-6, the Newton tolerance level."""
    toml = write_voce_case(str(tmp_path / "case"), (4, 4, 4), (0.1, 0.2),
                           ngrains=20, seed=0)
    s_t = _run_cli(T_CLI.main, ["-opt", toml, "-q", "--device", "cpu"],
                   tmp_path / "torch", monkeypatch)
    s_j = _run_cli(J_CLI.main, ["-opt", toml, "-q"], tmp_path / "jax",
                   monkeypatch)
    assert s_t.shape == s_j.shape == (2, 6)
    assert np.isfinite(s_t).all()
    rel = np.max(np.abs(s_t - s_j)) / np.max(np.abs(s_j))
    assert rel < 1e-6


def _with_time_table(toml, table):
    """A copy of the case's options file with another [Time] table."""
    text = Path(toml).read_text()
    start = text.index("[Time]")
    end = text.index("[Visualizations]")
    path = Path(toml).with_name("other_time.toml")
    path.write_text(text[:start] + table + text[end:])
    return str(path)


def test_fixed_dt_matches_custom_schedule(tmp_path):
    """[Time.Fixed] dt = 0.1 to t_final = 0.2 takes the same two steps
    as the custom schedule (0.1, 0.1): the same stress, bit for bit.
    Automatic time stepping from dt_start = 0.1 takes that first step
    too, and then its own."""
    from exaconstit_tpu_torch.driver import run_simulation
    toml = write_voce_case(str(tmp_path / "case"), (2, 2, 2), (0.1, 0.1),
                           ngrains=8, seed=1)
    fixed = _with_time_table(
        toml, "[Time]\n    [Time.Fixed]\n        dt = 0.1\n"
        "        t_final = 0.2\n")
    stress = []
    for i, path in enumerate((toml, fixed)):
        rundir = tmp_path / f"run{i}"
        rundir.mkdir()
        sim = run_simulation(path, workdir=str(rundir), verbose=False,
                             device="cpu")
        assert len(sim.step_times) == 2
        stress.append(np.loadtxt(rundir / "avg_stress.txt"))
    np.testing.assert_array_equal(stress[0], stress[1])
    auto = _with_time_table(
        toml, "[Time]\n    [Time.Auto]\n        dt_start = 0.1\n"
        "        dt_min = 0.01\n        t_final = 0.2\n")
    rundir = tmp_path / "auto"
    rundir.mkdir()
    sim = run_simulation(auto, workdir=str(rundir), verbose=False,
                         device="cpu")
    dts = np.loadtxt(rundir / "auto_dt_out.txt").ravel()
    assert dts[0] == 0.1 and abs(dts.sum() - 0.2) < 1e-12
    assert len(sim.step_times) == len(dts)
    np.testing.assert_array_equal(
        np.loadtxt(rundir / "avg_stress.txt", ndmin=2)[0], stress[0][0])


def _entry_point(name, toml, rundir):
    """A call of one of the port's entry points on the 2^3 case; the
    keyword arguments are passed through to choose the device."""
    from exaconstit_tpu_torch import driver
    from exaconstit_tpu_torch.config.options import parse_options

    def call(**device):
        if name == "run_simulation":
            return driver.run_simulation(toml, workdir=str(rundir),
                                         verbose=False, **device)
        if name == "cli":
            argv = ["-opt", toml, "-q"]
            if device:
                argv += ["--device", device["device"]]
            return T_CLI.main(argv)
        opt = parse_options(toml)
        if name == "Simulation":
            return driver.Simulation(opt, workdir=str(rundir), **device)
        sim = driver.Simulation(opt, workdir=str(rundir), device="cpu")
        return driver.MechSystem(opt, sim.mesh, sim.model, **device)

    return call


@pytest.mark.parametrize("name", ["run_simulation", "Simulation",
                                  "MechSystem", "cli"])
def test_entry_points_default_to_the_card(name, tmp_path, monkeypatch):
    """With no card, each entry point called without a device raises
    instead of running on the CPU; with device "cpu" it runs there."""
    toml = write_voce_case(str(tmp_path / "case"), (2, 2, 2), (0.1,),
                           ngrains=4, seed=2)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_point(name, toml, tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
    out = call(device="cpu")
    if name == "cli":
        assert out == 0
    elif name == "MechSystem":
        assert out.device == torch.device("cpu")
    else:
        sysm = out.system
        assert sysm.device == torch.device("cpu")
        assert sysm.dshape.device.type == "cpu"
    if name in ("run_simulation", "cli"):
        stress = np.loadtxt(tmp_path / "avg_stress.txt", ndmin=2)
        assert stress.shape == (1, 6) and np.isfinite(stress).all()


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("banned", ["jax", "exaconstit_tpu"])
def test_port_imports_no_jax(banned):
    """The port and its chip smoke script import neither JAX nor the JAX
    package, at any depth of any module."""
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    assert len(files) > 25
    names = {str(f.relative_to(PKG)) for f in files[:-1]}
    assert {"io/checkpoint.py", "io/postprocess.py", "io/vtk.py",
            "io/hdf5_dc.py", "models/kinetics.py", "models/umat.py",
            "mesh/mfem_io.py", "cases.py"} <= names
    bad = [f"{f.relative_to(PKG.parent)}: {mod}" for f in files
           for mod in _imported_modules(f)
           if mod == banned or mod.startswith(banned + ".")]
    assert not bad, bad
    for f in files:
        text = f.read_text()
        assert "__import__(" not in text and "importlib" not in text, f


def test_cases_voronoi_grain_map(tmp_path):
    """The in-repo case: one grain id per element, every id in range, and
    the same files from the same seed."""
    a = write_voce_case(str(tmp_path / "a"), (6, 5, 4), (0.1,), ngrains=7,
                        seed=3)
    b = write_voce_case(str(tmp_path / "b"), (6, 5, 4), (0.1,), ngrains=7,
                        seed=3)
    ga = np.loadtxt(os.path.join(os.path.dirname(a), "grains.txt"))
    gb = np.loadtxt(os.path.join(os.path.dirname(b), "grains.txt"))
    assert ga.shape == (120,) and ga.min() >= 1 and ga.max() <= 7
    np.testing.assert_array_equal(ga, gb)
    q = np.loadtxt(os.path.join(os.path.dirname(a), "quats.ori"))
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, rtol=1e-12)


VARIANTS = {"mesh_file_EA": dict(mesh_file=True),
            "mesh_file_PA": dict(mesh_file=True, assembly="PA"),
            "BBar": dict(integ_model="BBAR"),
            "GMRES": dict(krylov_solver="GMRES"),
            "MINRES": dict(krylov_solver="MINRES")}


@pytest.mark.parametrize("name", VARIANTS)
def test_cli_variants_match_reference_cli(name, tmp_path, monkeypatch):
    """The configurations beyond the voxel EA path through both CLIs at
    the case defaults (Newton rel 5e-5, Krylov rel 1e-7): a mesh file
    with EA or PA, B-bar, GMRES, MINRES; rel 1e-6, the Newton tolerance
    level."""
    toml = write_voce_case(str(tmp_path / "case"), (4, 4, 4), (0.1, 0.2),
                           ngrains=20, seed=0, **VARIANTS[name])
    s_t = _run_cli(T_CLI.main, ["-opt", toml, "-q", "--device", "cpu"],
                   tmp_path / "torch", monkeypatch)
    s_j = _run_cli(J_CLI.main, ["-opt", toml, "-q"], tmp_path / "jax",
                   monkeypatch)
    assert s_t.shape == s_j.shape == (2, 6)
    rel = np.max(np.abs(s_t - s_j)) / np.max(np.abs(s_j))
    assert rel < 1e-6
