"""PyTorch port against the JAX package: the UMAT interface.

* the point evaluation (the same ctypes calls of the repository's
  elastic UMAT, ``native/libumat_elastic.so``) on seeded velocity
  gradients and states: 1e-12 of each output's scale; the
  component-major adapter the driver calls returns the same numbers;
  a JAX UMAT model carried across by ``models/convert.py`` too;
* a 2^3 uniaxial run through both packages' ``Simulation``: stresses to
  1e-10, sigma_zz = E eps; and the port's outputs for a UMAT state
  (deformation-gradient average, VTU fields, a checkpoint that resumes
  bitwise).
"""

import os
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from exaconstit_tpu.config import options as J_OPT
from exaconstit_tpu.driver import Simulation as JSimulation
from exaconstit_tpu.models import umat as J_UMAT
from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.driver import Simulation
from exaconstit_tpu_torch.models import umat as T_UMAT
from exaconstit_tpu_torch.models.convert import (arrays_from_model,
                                                 umat_from_reference)

E, NU = 100.0, 0.3


@pytest.fixture(scope="module")
def lib():
    path = cases.UMAT_LIBRARY
    if not os.path.exists(path):
        subprocess.run(["make", "libumat_elastic.so", "CC=gcc"],
                       cwd=os.path.dirname(path), check=True)
    return path


def _inputs(model, n=16, seed=0):
    """Seeded velocity gradients and a state away from the initial one:
    F near I, a stress, a state variable."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, 3, 3)) * 1e-3
    state = model.init_state(npts=n)
    F = np.eye(3) + rng.normal(size=(n, 3, 3)) * 1e-2
    state[:, :9] = F.transpose(0, 2, 1).reshape(n, 9)
    state[:, 9:15] = rng.normal(size=(n, 6)) * 1e-2
    state[:, 15:] = rng.normal(size=(n, model.num_user_state))
    return L, state


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def test_point_evaluation(lib):
    jm = J_UMAT.UmatModel(lib=J_UMAT.UmatLibrary(lib),
                          props=np.array([E, NU]), num_user_state=1)
    tm = umat_from_reference(arrays_from_model(jm))
    assert isinstance(tm, T_UMAT.UmatModel) and tm.num_state == 16
    L, state = _inputs(tm)
    want = jm.model_setup(0.37, jnp.asarray(L), jnp.asarray(state))
    got = tm.model_setup(0.37, L, state)
    for a, b in zip(got, want):
        _close(a, b)
    # the component-major adapter: one transfer each way, same numbers
    s, st, c6, x = tm.model_setup_cm(
        0.37, torch.tensor(L.transpose(1, 2, 0).copy()),
        torch.tensor(state.T.copy()), with_solution=True)
    assert x is None
    np.testing.assert_array_equal(s.numpy(), got[0].T)
    np.testing.assert_array_equal(st.numpy(), got[1].T)
    np.testing.assert_array_equal(c6.numpy(), got[2].transpose(1, 2, 0))
    # a uniaxial increment: sigma_zz = (lambda + 2 mu) eps
    lam, mu = E * NU / ((1 + NU) * (1 - 2 * NU)), E / (2 * (1 + NU))
    L1 = np.tile(np.diag([0.0, 0.0, 1e-3]), (2, 1, 1))
    s1, _, dd = tm.model_setup(0.01, L1, tm.init_state(npts=2))
    np.testing.assert_allclose(s1[0, 2], (lam + 2 * mu) * 1e-5, rtol=1e-4)
    np.testing.assert_allclose(dd[0, 2, 2], lam + 2 * mu, rtol=1e-12)


DTS = (0.5, 0.5, 0.5, 0.5)


def test_uniaxial_run_both_packages(lib, tmp_path):
    toml = cases.write_umat_case(tmp_path / "case", (2, 2, 2), DTS,
                                 library=lib)
    out = {}
    for name, opts, sim_cls, kw in (("jax", J_OPT, JSimulation, {}),
                                    ("torch", T_OPT, Simulation,
                                     {"device": "cpu"})):
        wd = tmp_path / name
        wd.mkdir()
        with torch.inference_mode():
            sim = sim_cls(opts.parse_options(toml), workdir=str(wd), **kw)
            sim.run(verbose=False)
        out[name] = (sim.system.from_stress(sim.stress),
                     sim.system.from_state(sim.state),
                     np.loadtxt(wd / "avg_stress.txt", ndmin=2))
    for a, b in zip(out["torch"], out["jax"]):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()
    s = out["torch"][2]
    eps = 1e-3 * np.cumsum(DTS)
    np.testing.assert_allclose(s[:, 2], E * eps, rtol=2e-3)
    assert np.abs(s[:, :2]).max() < 1e-6


def test_umat_outputs_and_restart(lib, tmp_path):
    """The deformation-gradient average (no plastic work or Dp files for a
    UMAT), the VTU fields of a UMAT state, and a checkpoint after step 2
    that resumes to the uninterrupted run's numbers bitwise."""
    opts = dict(library=lib, additional_avgs=True, paraview=True,
                vis_steps=2)
    full = cases.write_umat_case(tmp_path / "full", (2, 2, 2), DTS, **opts)
    with torch.inference_mode():
        sim = Simulation(T_OPT.parse_options(full),
                         workdir=str(tmp_path / "full"), device="cpu")
        sim.run(verbose=False)
    wd = tmp_path / "full"
    F = np.loadtxt(wd / "avg_def_grad.txt", ndmin=2)
    np.testing.assert_allclose(F[:, 8], 1 + 1e-3 * np.cumsum(DTS), rtol=1e-5)
    assert not (wd / "avg_pl_work.txt").exists()
    assert not (wd / "avg_dp_tensor.txt").exists()
    vtu = (wd / "results" / "exaconstit" / "step_000004.vtu").read_text()
    for field in ("DeformationGradient", "StateVariables", "Stress",
                  "VonMisesStress"):
        assert f'Name="{field}"' in vtu, field
    assert 'Name="Hardness"' not in vtu
    # a checkpoint at step 2, then a restart to the end
    part = tmp_path / "part"
    toml = cases.write_umat_case(part, (2, 2, 2), DTS, library=lib,
                                 checkpoint_steps=2)
    opt = T_OPT.parse_options(toml)
    opt.nsteps, opt.restart = 2, False
    with torch.inference_mode():
        Simulation(opt, workdir=str(part), device="cpu").run(verbose=False)
        opt = T_OPT.parse_options(toml)
        opt.restart = True
        resumed = Simulation(opt, workdir=str(part), device="cpu")
        resumed.run(verbose=False)
    assert torch.equal(resumed.stress, sim.stress)
    assert torch.equal(resumed.state, sim.state)


@pytest.mark.parametrize("loc", [-1, 0])
def test_crystal_umat_state_splice(lib, tmp_path, loc):
    """A crystal UMAT (cp = true): the orientation rows are spliced into
    the user state at ``ori_state_var_loc`` (< 0: at the end), as the
    reference does; both packages build the same initial state."""
    toml = cases.write_umat_case(tmp_path / "case", (2, 2, 2), (0.5,),
                                 library=lib)
    text = open(toml).read().replace("cp = false", "cp = true").replace(
        "[BCs]", f"""    [Properties.Grain]
        ori_state_var_loc = {loc}
        ori_stride = 4
        ori_type = "quat"
        num_grains = 1
        ori_floc = "quats.ori"
        grain_floc = "grains.txt"
[BCs]""")
    open(toml, "w").write(text)
    states = []
    for opts, sim_cls, kw in ((J_OPT, JSimulation, {}),
                              (T_OPT, Simulation, {"device": "cpu"})):
        sim = sim_cls(opts.parse_options(toml), workdir=str(tmp_path), **kw)
        states.append(np.asarray(sim.system.from_state(sim.state)))
    np.testing.assert_array_equal(states[1], states[0])
    q = np.loadtxt(tmp_path / "case" / "quats.ori")
    at = 15 + (1 if loc < 0 else loc)
    np.testing.assert_array_equal(states[1][0, 0, at:at + 4], q)
