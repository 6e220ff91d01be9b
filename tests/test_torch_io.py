"""PyTorch port against the JAX package: checkpoint/restart and the
visualization output.

One copper MTSDD case at 2^3 (pure f64 on both sides, so the two packages
agree to 1e-8 a step) with a boundary-condition change at step 2, four
steps of 0.1.  The reference runs it once, checkpointing after step 2 and
after step 4; the port runs it once uninterrupted and once for two steps
with a checkpoint.  From those:

* the port, resumed from its own checkpoint, repeats its uninterrupted
  run bit for bit (stress rows, state, coordinates, velocity), BC epoch
  and the lagging ``state_prev`` included;
* both archives hold the same keys with the same shapes, the port resumes
  the reference's checkpoint and the reference the port's, each to 1e-8
  of the reference's uninterrupted run;
* from the same final state both packages write the same visualization
  fields (names, shapes, values to 1e-10) into VTU/PVD files and, where
  h5py is installed, the HDF5 collection.
"""

import filecmp
import shutil
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import pytest
import torch

from exaconstit_tpu.config import options as J_OPT
from exaconstit_tpu.driver import Simulation as JSimulation
from exaconstit_tpu.io import checkpoint as J_CK
from exaconstit_tpu.io import postprocess as J_PP
from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.driver import Simulation as TSimulation
from exaconstit_tpu_torch.driver import run_simulation
from exaconstit_tpu_torch.io import checkpoint as T_CK
from exaconstit_tpu_torch.io import postprocess as T_PP

DTS = (0.1, 0.1, 0.1, 0.1)
BCS = """[BCs]
    changing_ess_bcs = true
    update_steps = [1, 2]
    essential_ids = [[1, 2, 3, 4], [1, 2, 3, 4]]
    essential_comps = [[3, 1, 2, 3], [3, 1, 2, 3]]
    essential_vals = [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.001],
                      [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.002]]
"""


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_case(dirpath, nsteps, **options):
    """The 2^3 MTSDD case with the BC change at step 2."""
    toml = Path(cases.write_mtsdd_case(dirpath, (2, 2, 2), DTS[:nsteps],
                                       ngrains=8, seed=5, **options))
    text = toml.read_text()
    start, end = text.index("[BCs]"), text.index("[Model]")
    toml.write_text(text[:start] + BCS + text[end:])
    return str(toml)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def port_run(toml, workdir):
    workdir.mkdir()
    sim = run_simulation(toml, workdir=str(workdir), verbose=False,
                         device="cpu")
    return sim, np.loadtxt(workdir / "avg_stress.txt", ndmin=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("io")
    full = write_case(tmp / "full", 4, additional_avgs=True)
    half = write_case(tmp / "half", 2, additional_avgs=True,
                      checkpoint_steps=2)
    resume = write_case(tmp / "resume", 4, additional_avgs=True,
                        restart=True)

    # the reference: one run, checkpoints after steps 2 and 4
    jdir = tmp / "jax"
    jdir.mkdir()
    jsim = JSimulation(J_OPT.parse_options(full), workdir=str(jdir))
    t = 0.0
    for ti, dt in enumerate(DTS, start=1):
        t += jsim.advance(ti, dt, verbose=False)
        jsim.write_averages()
        if ti % 2 == 0:
            J_CK.save_checkpoint(str(jdir / f"ck{ti}" / "checkpoint.npz"),
                                 jsim, t, ti)
    j_stress = np.loadtxt(jdir / "avg_stress.txt", ndmin=2)

    t_full, s_full = port_run(full, tmp / "t_full")
    t_half, s_half = port_run(half, tmp / "t_half")
    return dict(tmp=tmp, full=full, resume=resume, jsim=jsim, jdir=jdir,
                j_stress=j_stress, t_full=t_full, s_full=s_full,
                t_half=t_half, s_half=s_half)


def resume_port(runs, ckpt_dir, name):
    """The port's 4-step run restarted from the checkpoint in ckpt_dir."""
    wd = runs["tmp"] / name
    wd.mkdir()
    shutil.copytree(ckpt_dir, wd / "checkpoint")
    sim = run_simulation(runs["resume"], workdir=str(wd), verbose=False,
                         device="cpu")
    return sim, np.loadtxt(wd / "avg_stress.txt", ndmin=2)


def test_checkpoint_resume_is_bitwise(runs):
    t_full, t_half = runs["t_full"], runs["t_half"]
    np.testing.assert_array_equal(runs["s_half"], runs["s_full"][:2])
    sim, rows = resume_port(runs, runs["tmp"] / "t_half" / "checkpoint",
                            "t_resumed")
    assert len(sim.step_times) == 2
    np.testing.assert_array_equal(rows, runs["s_full"][2:])
    for name in ("state", "state_prev", "stress", "x_beg", "x_cur", "v"):
        assert torch.equal(getattr(sim, name), getattr(t_full, name)), name
    # the BC epoch of step 2 is the one in force after the restart
    assert sim.cur_bcs is sim.bc_steps[2]
    np.testing.assert_array_equal(sim.cur_bcs.vel_values,
                                  t_full.cur_bcs.vel_values)
    # the additional averages carry on as well, Dp with its one-step lag
    for fname in ("avg_pl_work.txt", "avg_def_grad.txt",
                  "avg_dp_tensor.txt"):
        got = np.loadtxt(runs["tmp"] / "t_resumed" / fname, ndmin=2)
        want = np.loadtxt(runs["tmp"] / "t_full" / fname, ndmin=2)
        np.testing.assert_array_equal(got.reshape(2, -1),
                                      want.reshape(4, -1)[2:])


def test_checkpoint_archives_have_one_layout(runs):
    with np.load(runs["jdir"] / "ck2" / "checkpoint.npz") as j, \
            np.load(runs["tmp"] / "t_half" / "checkpoint"
                    / "checkpoint.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        assert "state_prev" in t.files and "bc_epoch" in t.files
        for k in j.files:
            assert j[k].shape == t[k].shape, k
            assert j[k].dtype == t[k].dtype, k
        assert int(t["ti"]) == 2 and int(t["bc_epoch"]) == 2
        assert _rel(t["state"], j["state"]) < 1e-8
        assert _rel(t["x_beg"], j["x_beg"]) < 1e-8


def test_port_resumes_reference_checkpoint(runs):
    sim, rows = resume_port(runs, runs["jdir"] / "ck2", "t_from_jax")
    assert rows.shape == (2, 6)
    assert _rel(rows, runs["j_stress"][2:]) < 1e-8
    jsim = runs["jsim"]
    assert _rel(sim.system.from_state(sim.state),
                jsim.system.from_state(jsim.state)) < 1e-8


def test_reference_resumes_port_checkpoint(runs):
    opt = J_OPT.parse_options(runs["full"])
    wd = runs["tmp"] / "jax_from_t"
    wd.mkdir()
    jsim = JSimulation(opt, workdir=str(wd))
    t, ti = J_CK.load_checkpoint(
        str(runs["tmp"] / "t_half" / "checkpoint" / "checkpoint.npz"), jsim)
    assert (t, ti) == (pytest.approx(0.2), 2)
    assert jsim.cur_bcs is jsim.bc_steps[2]
    for k in (3, 4):
        jsim.advance(k, DTS[k - 1], verbose=False)
        jsim.write_averages()
    rows = np.loadtxt(wd / "avg_stress.txt", ndmin=2)
    assert _rel(rows, runs["j_stress"][2:]) < 1e-8


# ---------------------------------------------------------------------------
# visualization
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vis_pair(runs):
    """The reference simulation at its final state and a port simulation
    holding that same state (through the step-4 checkpoint)."""
    tsim = TSimulation(T_OPT.parse_options(runs["full"]),
                       workdir=str(runs["tmp"] / "t_vis"), device="cpu")
    T_CK.load_checkpoint(str(runs["jdir"] / "ck4" / "checkpoint.npz"), tsim)
    return runs["jsim"], tsim


@pytest.mark.parametrize("light_up", [False, True])
def test_element_fields_match(vis_pair, light_up):
    jsim, tsim = vis_pair
    with torch.inference_mode():
        got = T_PP.compute_element_fields(tsim, light_up=light_up)
    want = J_PP.compute_element_fields(jsim, light_up=light_up)
    assert list(got) == list(want)
    assert ("XtalElasticStrain" in got) == light_up
    for name in want:
        assert got[name].shape == np.asarray(want[name]).shape, name
        assert _rel(got[name], want[name]) < 1e-10, name


def _vtu_arrays(path):
    root = ET.parse(path).getroot()
    return {(sec.tag, a.get("Name")): (
        int(a.get("NumberOfComponents", "1")),
        np.array(a.text.split(), dtype=float))
        for sec in root.iter() if sec.tag in ("CellData", "PointData")
        for a in sec.findall("DataArray")}


def _dump(sim, pp, workdir, **flags):
    workdir.mkdir(parents=True)
    for k, v in flags.items():
        setattr(sim.opt, k, v)
    old, sim.workdir = sim.workdir, str(workdir)
    entries = []
    try:
        with torch.inference_mode():
            pp.write_vis_step(sim, 4, 0.4, entries)
    finally:
        sim.workdir = old
        for k in flags:
            setattr(sim.opt, k, False)
    return entries


def test_vtu_and_pvd_files_match(vis_pair, runs):
    jsim, tsim = vis_pair
    jd, td = runs["tmp"] / "vis_j", runs["tmp"] / "vis_t"
    ej = _dump(jsim, J_PP, jd, paraview=True, light_up=True)
    et = _dump(tsim, T_PP, td, paraview=True, light_up=True)
    assert ej == et == [(0.4, "results/exaconstit/step_000004.vtu")]
    assert filecmp.cmp(jd / "results" / "exaconstit.pvd",
                       td / "results" / "exaconstit.pvd", shallow=False)
    aj = _vtu_arrays(jd / ej[0][1])
    at = _vtu_arrays(td / et[0][1])
    assert list(aj) == list(at)
    assert ("CellData", "Stress") in at and ("PointData", "Velocity") in at
    for key, (ncomp, vals) in aj.items():
        assert at[key][0] == ncomp, key
        assert at[key][1].shape == vals.shape, key
        # the files print 10 significant digits
        assert _rel(at[key][1], vals) < 1e-9, key


def test_hdf5_collection_matches(vis_pair, runs):
    h5py = pytest.importorskip("h5py")
    jsim, tsim = vis_pair
    jd, td = runs["tmp"] / "h5_j", runs["tmp"] / "h5_t"
    _dump(jsim, J_PP, jd, conduit=True)
    _dump(tsim, T_PP, td, conduit=True)
    with h5py.File(jd / "results" / "exaconstit.h5") as fj, \
            h5py.File(td / "results" / "exaconstit.h5") as ft:
        names = []
        fj.visit(names.append)
        tnames = []
        ft.visit(tnames.append)
        assert names == tnames
        for n in names:
            if isinstance(fj[n], h5py.Dataset):
                assert fj[n].shape == ft[n].shape, n
                assert _rel(ft[n][...], fj[n][...]) < 1e-10, n


def test_run_writes_the_dump_and_the_checkpoint(tmp_path):
    """Through ``run_simulation``: ``paraview`` dumps at every ``vis_steps``
    steps and at the last, ``checkpoint_steps`` writes the archive."""
    toml = cases.write_voce_case(tmp_path / "case", (2, 2, 2),
                                 (0.1, 0.1, 0.1), ngrains=4, paraview=True,
                                 vis_steps=2, checkpoint_steps=3)
    sim = run_simulation(toml, workdir=str(tmp_path), verbose=False,
                         device="cpu")
    files = sorted(p.name for p in
                   (tmp_path / "results" / "exaconstit").iterdir())
    assert files == ["step_000002.vtu", "step_000003.vtu"]
    assert [e[0] for e in sim.vis_entries] == pytest.approx([0.2, 0.3])
    pvd = (tmp_path / "results" / "exaconstit.pvd").read_text()
    assert pvd.count("<DataSet") == 2
    with np.load(tmp_path / "checkpoint" / "checkpoint.npz") as ck:
        assert int(ck["ti"]) == 3 and ck["state"].shape == (8, 8, 28)


@pytest.mark.parametrize("name", ["vtk.py", "hdf5_dc.py"])
def test_host_only_writers_are_copies(name):
    """The numpy-only writers are the reference's files, unchanged."""
    ref = Path(J_PP.__file__).with_name(name)
    port = Path(T_PP.__file__).with_name(name)
    assert filecmp.cmp(ref, port, shallow=False)
