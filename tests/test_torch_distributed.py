"""The port's slab domain decomposition end to end: the CLI as two gloo
ranks against one process, and ``Simulation`` over 8 shards against the
JAX package's on 8 virtual devices.

* The counterpart of ``tests/test_distributed.py::
  test_two_process_slab_matches_single``: the in-repo Voce case at
  2x2x8 (``cases.write_voce_case``, 2 custom steps, ``parallel_mode =
  "slab"``, a checkpoint and a paraview dump every step) through the
  port's CLI as 2 gloo ranks x 4 shards (``EXACONSTIT_TPU_DIST=1`` with
  the torchrun variables, ``--shards 8``) out of one shared working
  directory, against 1 process x 8 shards: the same partition, and
  every sum over shards is added in shard order whatever the ranks, so
  the average stress, the checkpoint's state and velocity agree to rtol
  1e-8 / atol 1e-14 (they are bitwise equal on the CPU); the stress file
  is written once (shape (2, 6)), the PVD lists both dumps once
  (rank-0 gating), and each rank writes its own step times.
* The counterpart of ``tests/test_slab_production.py::
  test_voce_full_through_slab_matches_single`` without the reference's
  data: the in-repo Voce case at 4x4x8 (Jacobi, two steps) through the
  JAX ``Simulation`` on ``make_device_mesh(8)`` and the port's
  ``Simulation(shards=8)`` on the CPU: average stress to rel 1e-6 of its
  largest entry (the Newton tolerance level; both take the slab).
* The replicated-node element sharding the same way: the elastic UMAT at
  3x3x3 with ``parallel_mode = "replicated"`` as 2 gloo ranks x 4 shards
  against 1 process x 8 shards, every checkpoint array bitwise equal.
* The start and its refusals: ``init_distributed`` with no launch, a
  missing variable, two ranks on one card and no card; a CUDA layout
  over a gloo group.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from exaconstit_tpu.driver import Simulation as JSimulation
from exaconstit_tpu.config.options import parse_options as j_parse
from exaconstit_tpu.parallel.sharding import make_device_mesh
from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch.config.options import parse_options
from exaconstit_tpu_torch.driver import Simulation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank=None, world=None, port=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    if rank is not None:
        env.update(EXACONSTIT_TPU_DIST="1", RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return env


def _launch(workdir, toml, env, quiet=True):
    return subprocess.Popen(
        [sys.executable, "-m", "exaconstit_tpu_torch.cli", "-opt", toml,
         *(["-q"] if quiet else []), "--device", "cpu", "--shards", "8"],
        cwd=workdir, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _finish(procs, what):
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{what} {i} failed:\n{out[-4000:]}"
    return outs


def test_two_gloo_ranks_match_one_process(tmp_path):
    toml = cases.write_voce_case(
        str(tmp_path / "case"), (2, 2, 8), (0.1, 0.2), ngrains=4, seed=0,
        parallel_mode="slab", checkpoint_steps=1, paraview=True,
        vis_steps=1)
    shared, single = tmp_path / "two", tmp_path / "one"
    shared.mkdir()
    single.mkdir()
    port = _free_port()
    procs = [_launch(shared, toml, _env(rank, 2, port)) for rank in range(2)]
    procs.append(_launch(single, toml, _env()))
    _finish(procs, "process")

    a2 = np.loadtxt(shared / "avg_stress.txt", ndmin=2)
    a1 = np.loadtxt(single / "avg_stress.txt", ndmin=2)
    assert a2.shape == a1.shape == (2, 6)
    assert np.isfinite(a2).all()
    np.testing.assert_allclose(a2, a1, rtol=1e-8, atol=1e-14)
    with np.load(shared / "checkpoint" / "checkpoint.npz") as ck2, \
            np.load(single / "checkpoint" / "checkpoint.npz") as ck1:
        assert int(ck2["ti"]) == 2
        assert ck2["state"].shape == ck1["state"].shape
        assert ck2["state"].shape[:2] == (32, 8)
        np.testing.assert_allclose(ck2["state"], ck1["state"], rtol=1e-8,
                                   atol=1e-14)
        np.testing.assert_allclose(ck2["v"], ck1["v"], rtol=1e-8,
                                   atol=1e-14)
    pvd = (shared / "results" / "exaconstit.pvd").read_text()
    assert pvd.count("<DataSet") == 2
    assert sorted(os.listdir(shared / "timing")) == [
        "time_solve.0.txt", "time_solve.1.txt"]
    assert os.listdir(single / "timing") == ["time_solve.0.txt"]


def test_two_gloo_ranks_replicated_umat_match_one_process(tmp_path):
    """The elastic UMAT at 3x3x3 (27 elements: 5 pad elements over 8
    shards, a rank's last shard all pads) with ``parallel_mode =
    "replicated"`` through the CLI as 2 gloo ranks x 4 shards against 1
    process x 8 shards: every array of the final checkpoint bitwise
    equal (each shard's partial sums are added in shard order whatever
    the ranks), the averages written once by rank 0 only, the archive
    holding the 32 padded rows."""
    toml = cases.write_umat_case(
        str(tmp_path / "case"), (3, 3, 3), (0.5, 0.5),
        parallel_mode="replicated", checkpoint_steps=2, paraview=True,
        vis_steps=1)
    shared, single = tmp_path / "two", tmp_path / "one"
    shared.mkdir()
    single.mkdir()
    port = _free_port()
    procs = [_launch(shared, toml, _env(rank, 2, port), quiet=False)
             for rank in range(2)]
    procs.append(_launch(single, toml, _env(), quiet=False))
    outs = _finish(procs, "process")
    for out in outs:
        assert "replicated domain decomposition over 8 shards" in out
    a2 = np.loadtxt(shared / "avg_stress.txt", ndmin=2)
    a1 = np.loadtxt(single / "avg_stress.txt", ndmin=2)
    assert a2.shape == (2, 6) and np.isfinite(a2).all()
    np.testing.assert_array_equal(a2, a1)
    with np.load(shared / "checkpoint" / "checkpoint.npz") as ck2, \
            np.load(single / "checkpoint" / "checkpoint.npz") as ck1:
        assert sorted(ck2.files) == sorted(ck1.files)
        assert ck2["state"].shape[:2] == (32, 8)
        for k in ck1.files:
            np.testing.assert_array_equal(ck2[k], ck1[k], err_msg=k)
    pvd = (shared / "results" / "exaconstit.pvd").read_text()
    assert pvd.count("<DataSet") == 2
    assert sorted(os.listdir(shared / "timing")) == [
        "time_solve.0.txt", "time_solve.1.txt"]


@pytest.fixture
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_slab_simulation_matches_reference(tmp_path, _one_thread):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    toml = cases.write_voce_case(
        str(tmp_path / "case"), (4, 4, 8), (0.1, 0.2), ngrains=8, seed=1,
        parallel_mode="slab", precond="jacobi")
    runs = {}
    for name in ("jax", "torch"):
        wd = tmp_path / name
        wd.mkdir()
        if name == "jax":
            sim = JSimulation(j_parse(toml), workdir=str(wd),
                              device_mesh=make_device_mesh(8))
            sim.run(verbose=False)
        else:
            with torch.inference_mode():
                sim = Simulation(parse_options(toml), workdir=str(wd),
                                 device="cpu", shards=8)
                sim.run(verbose=False)
        assert sim.parallel_mode == "slab"
        runs[name] = np.loadtxt(wd / "avg_stress.txt", ndmin=2)
    assert runs["torch"].shape == runs["jax"].shape == (2, 6)
    rel = np.abs(runs["torch"] - runs["jax"]).max() / np.abs(runs["jax"]).max()
    assert rel < 1e-6


_LAUNCH = dict(EXACONSTIT_TPU_DIST="1", RANK="1", LOCAL_RANK="1",
               WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT="1")


@pytest.mark.parametrize("case", ["no launch", "missing variable",
                                  "two ranks on one card", "no card"])
def test_init_distributed_stops_rather_than_switching(case, monkeypatch):
    """The process-group start: without a launch the device comes back
    as given and no group starts; a launch missing a variable, a second
    rank on a one-card machine and a CUDA launch with no card stop
    before any group is made (NCCL runs one rank per card)."""
    from exaconstit_tpu_torch.parallel import sharding
    for k in ("TORCHELASTIC_RUN_ID", *_LAUNCH):
        monkeypatch.delenv(k, raising=False)
    if case == "no launch":
        assert sharding.init_distributed("cpu") == torch.device("cpu")
        assert not sharding.process_group_active()
        return
    env = dict(_LAUNCH)
    if case == "missing variable":
        del env["MASTER_PORT"]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if case == "two ranks on one card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    match = {"missing variable": "MASTER_PORT",
             "two ranks on one card": "one rank per card",
             "no card": "no CUDA device"}[case]
    with pytest.raises(RuntimeError, match=match):
        sharding.init_distributed("cuda")
    assert not sharding.process_group_active()


def test_layout_refuses_a_cuda_run_on_gloo():
    """A CUDA run over a gloo group is an error, not a quiet switch; so
    are shards that do not divide over the ranks."""
    import torch.distributed as dist
    from exaconstit_tpu_torch.parallel.sharding import ShardLayout
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="needs the nccl backend"):
            ShardLayout.create(4, "cuda")
        layout = ShardLayout.create(4, "cpu")
        assert layout.distributed and layout.s_local == 4
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="do not divide"):
        ShardLayout.create(0, "cpu")
