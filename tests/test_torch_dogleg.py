"""The f32 trust-region stage of the point solve.

The plain version (``dogleg_stage_reference``) against the JAX package's
TPU kernel run in interpret mode (``dogleg_pallas(..., interpret=True)``)
and against its XLA ``evptn_cm.dogleg_cm``, on the inputs
tests/test_dogleg_pallas.py uses; the wrapper's routing on CPU tensors;
the CUDA source and its build command; and, where a card is present, the
CUDA kernel against the plain version."""

import ctypes
import dataclasses
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from exaconstit_tpu.config import options as J_OPT
from exaconstit_tpu.models import ecmech as J_EC
from exaconstit_tpu.models import evptn_cm as J_CM
from exaconstit_tpu.solvers.dogleg_pallas import dogleg_pallas
from exaconstit_tpu_torch.config import options as T_OPT
from exaconstit_tpu_torch.models import ecmech as T_EC
from exaconstit_tpu_torch.models import evptn_cm as T_CM
from exaconstit_tpu_torch.solvers import dogleg_cuda

VOCE_PROPS = np.array([
    8.920e-6, 0.003435984, 1.0e-10, 168.4, 121.4, 75.2, 44.0, 0.02, 1.0,
    400.0e-3, 17.0e-3, 122.4e-3, 0.0, 5.0e9, 17.0e-3, 0.0, -1.0307952])
TOL, MAX_ITER = 1e-6, 200


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(xtal="FCC"):
    out = []
    for mod, ec in ((J_OPT, J_EC), (T_OPT, T_EC)):
        opt = mod.ExaOptions()
        opt.mech_type = mod.MechType.EXACMECH
        opt.xtal_type = mod.XtalType[xtal]
        opt.slip_type = mod.SlipType.POWERVOCE
        out.append(ec.build_model(opt, VOCE_PROPS).evptn)
    return out


def stage_inputs(n, dt, seed=3):
    """f32 inputs as tests/test_dogleg_pallas.py makes them; returns
    numpy arrays (d_vecd, w, e, q, h, dts, x0, active)."""
    jm, _ = _models()
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3, 3)) * 1e-3
    d = 0.5 * (d + np.swapaxes(d, 1, 2))
    d -= np.trace(d, axis1=1, axis2=2)[:, None, None] / 3.0 * np.eye(3)
    d_vecd = np.einsum("kij,nij->kn", T_CM.tn.BASIS_DEV, d)
    w = (rng.normal(size=(n, 3)) * 1e-3 * 0.3).T
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e = (rng.normal(size=(n, 5)) * 2e-4).T
    h = (np.full((n, 1), 0.017) + rng.uniform(0, 0.01, size=(n, 1))).T
    f32 = np.float32
    d_vecd, w, e, q, h = (a.astype(f32) for a in (d_vecd, w, e, q.T, h))
    dts = np.full(n, dt, f32)
    Dsm = J_CM.vecd_to_mat_cm(jnp.asarray(d_vecd))
    deff = jnp.sqrt(2.0 / 3.0 * jnp.sum(jnp.asarray(d_vecd) ** 2, axis=0))
    e_guess = J_CM._initial_guess_cm(jm, jnp.asarray(dts), Dsm, deff,
                                     jnp.asarray(e), jnp.asarray(q),
                                     jnp.asarray(h))
    x0 = np.concatenate([np.asarray(e_guess), np.zeros((3, n), f32)])
    active = np.ones(n, bool)
    active[5] = False
    return d_vecd, w, e, q, h, dts, x0, active


def run_reference(tm, inputs):
    d, w, e, q, h, dts, x0, active = (torch.tensor(a) for a in inputs)
    return dogleg_cuda.dogleg_stage_reference(tm, x0, h, dts, d, w, e, q,
                                              active, TOL, MAX_ITER)


@pytest.mark.parametrize("against", ["pallas_interpret", "dogleg_cm"])
def test_stage_reference_matches_jax(against):
    """Both converge to the same root at tol 1e-6: states agree to f32
    roundoff of the Newton basin (atol 2e-5, the reference's own bar);
    every active lane converges, the residual at the port's x is below
    tol, and the inactive lane keeps its start bit for bit."""
    jm, tm = _models()
    n = 48
    inputs = stage_inputs(n, 0.04)
    d, w, e, q, h, dts, x0, active = (jnp.asarray(a) for a in inputs)
    if against == "pallas_interpret":
        x_j, ok_j, _, _, _ = dogleg_pallas(jm, x0, h, dts, d, w, e, q, active,
                                           TOL, MAX_ITER, tile=64,
                                           interpret=True)
    else:
        Dsm = J_CM.vecd_to_mat_cm(d)
        x_j, ok_j, _, _, _ = J_CM.dogleg_cm(
            lambda x: J_CM.residual_and_jac_cm(jm, x, h, dts, Dsm, w, e, q,
                                               300.0),
            x0, TOL, MAX_ITER, active0=active)
    x_t, ok_t, it_t, rn, J_t = run_reference(tm, inputs)
    assert rn is None
    assert np.asarray(ok_j).all() and ok_t.all()
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=2e-5)
    r = T_CM.residual_cm(tm, x_t, torch.tensor(inputs[4]),
                         torch.tensor(inputs[5]),
                         T_CM.vecd_to_mat_cm(torch.tensor(inputs[0])),
                         torch.tensor(inputs[1]), torch.tensor(inputs[2]),
                         torch.tensor(inputs[3]), 300.0)
    rn = torch.sqrt(torch.sum(r * r, dim=0))
    assert float(rn[torch.tensor(inputs[7])].max()) < TOL
    np.testing.assert_array_equal(x_t.numpy()[:, 5], inputs[6][:, 5])
    assert int(it_t[5]) == 0
    assert x_t.dtype == J_t.dtype == torch.float32
    assert J_t.shape == (8, 8, n)


def test_stage_reference_on_bcc_tables():
    """A BCC Voce model feeds the stage the ``bcc12`` slip tables: the
    plain version against the JAX package's ``dogleg_cm`` on the same
    inputs (atol 2e-5), and the kernel's parameter block takes the BCC
    tables where it took the FCC ones."""
    jm, tm = _models("BCC")
    _, fcc = _models()
    assert tm.slip.name == "bcc12" and not np.allclose(tm.slip.P, fcc.slip.P)
    inputs = stage_inputs(32, 0.04)
    d, w, e, q, h, dts, x0, active = (jnp.asarray(a) for a in inputs)
    Dsm = J_CM.vecd_to_mat_cm(d)
    x_j, ok_j, _, _, _ = J_CM.dogleg_cm(
        lambda x: J_CM.residual_and_jac_cm(jm, x, h, dts, Dsm, w, e, q,
                                           300.0),
        x0, TOL, MAX_ITER, active0=active)
    x_t, ok_t, it_t, _, _ = run_reference(tm, inputs)
    assert np.asarray(ok_j).all() and ok_t.all() and int(it_t.max()) > 1
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0,
                               atol=2e-5)
    buf = dogleg_cuda.kernel_params(tm, TOL, MAX_ITER)
    PC = tm.slip.P @ tm.elast.C_dev
    np.testing.assert_array_equal(buf[:60], PC.ravel().astype(np.float32))
    np.testing.assert_array_equal(buf[60:120],
                                  tm.slip.P.T.ravel().astype(np.float32))
    assert not np.array_equal(buf[:156],
                              dogleg_cuda.kernel_params(fcc, TOL,
                                                        MAX_ITER)[:156])


def test_wrapper_routes_cpu_tensors_to_plain_version():
    _, tm = _models()
    inputs = stage_inputs(16, 0.08)
    before = dogleg_cuda.KERNEL.launches
    d, w, e, q, h, dts, x0, active = (torch.tensor(a) for a in inputs)
    got = dogleg_cuda.dogleg_stage(tm, x0, h, dts, d, w, e, q, active, TOL,
                                   MAX_ITER)
    ref = run_reference(tm, inputs)
    assert dogleg_cuda.KERNEL.launches == before
    for a, b in zip(got, ref):
        if a is None:
            assert b is None
        else:
            assert torch.equal(a, b)


def test_wrapper_rejects_non_voce_kinetics():
    _, tm = _models()

    @dataclasses.dataclass(frozen=True)
    class OtherKinetics:
        n_h: int = 1

    other = dataclasses.replace(tm, kinetics=OtherKinetics())
    x = torch.zeros(8, 4)
    with pytest.raises(NotImplementedError):
        dogleg_cuda.dogleg_stage(other, x, x[:1], x[0], x[:5], x[:3], x[:5],
                                 x[:4], x[0] > -1, TOL, MAX_ITER)


def test_cuda_source_and_build_command():
    src = dogleg_cuda.SOURCE.read_text()
    assert 'extern "C" int dogleg_voce_f32(' in src
    assert "__global__" in src
    # the source note names the TPU kernel it replaces
    assert "dogleg_pallas.py::" in src and "_dogleg_kernel" in src
    assert "use_fast_math" not in " ".join(dogleg_cuda.NVCC_FLAGS)
    cmd = dogleg_cuda.nvcc_command("dogleg_voce.so") if _has_nvcc() else \
        ["nvcc", *dogleg_cuda.NVCC_FLAGS]
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "-shared" in joined and "-O3" in joined
    assert dogleg_cuda.BUILD_DIR.name == "build"
    assert re.match(r"dogleg_voce_[0-9a-f]{16}\.so",
                    dogleg_cuda.KERNEL.library_path().name)
    # the ctypes argument list matches the C signature, the point counter
    # included
    sig = re.search(r'extern "C" int dogleg_voce_f32\(([^)]*)\)', src)
    params = [p.strip() for p in sig.group(1).split(",")]
    assert len(params) == len(dogleg_cuda.ARGTYPES) == 16
    assert params[12] == "int* next" and params[13] == "int N"
    for p, t in zip(params, dogleg_cuda.ARGTYPES):
        assert ("*" in p) == (t is ctypes.c_void_p), p


def _has_nvcc():
    import shutil
    return shutil.which("nvcc") is not None


def test_kernel_params_layout():
    """The by-value DoglegParams struct: P C, the rows of [P^T; Q^T],
    1/m, gdot0, tol, max_iter, in the kernel's order."""
    _, tm = _models()
    buf = dogleg_cuda.kernel_params(tm, TOL, MAX_ITER)
    P, Q = tm.slip.P, tm.slip.Q
    PC = P @ tm.elast.C_dev
    assert buf.dtype == np.float32 and buf.size == 160
    np.testing.assert_array_equal(buf[:60], PC.ravel().astype(np.float32))
    np.testing.assert_array_equal(buf[60:120], P.T.ravel().astype(np.float32))
    np.testing.assert_array_equal(buf[120:156],
                                  Q.T.ravel().astype(np.float32))
    np.testing.assert_allclose(buf[156:159], [50.0, 1.0, TOL], rtol=1e-7)
    assert int(buf[159:].view(np.int32)[0]) == MAX_ITER
    # the struct as the source declares it: 60 + 96 floats, 3 scalars
    src = dogleg_cuda.SOURCE.read_text()
    assert "float PC[NSLIP * 5];" in src and "float PQ[8 * NSLIP];" in src


def test_stage_work_counts():
    """The operation and byte counts the bound is computed from: one
    evaluation and one iteration per point as the serial algorithm
    needs them, and each input and output moved once."""
    ops, nbytes = dogleg_cuda.stage_work(10, 44)
    assert dogleg_cuda.OPS_START == sum(dogleg_cuda.OPS_RESJAC.values()) + 17
    assert ops == 10 * dogleg_cuda.OPS_START + 44 * dogleg_cuda.OPS_ITER
    assert 1800 < sum(dogleg_cuda.OPS_RESJAC.values()) < 2000
    assert 3000 < dogleg_cuda.OPS_ITER < 3600
    assert nbytes == 10 * (27 * 4 + 1 + 72 * 4 + 1 + 4)


FAR_LANES = (3, 40, 777, 2048, 4000)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["seeded", "heavy_tail", "bcc12"])
def test_cuda_kernel_matches_plain_version(case):
    """The kernel against the plain version on the card.  heavy_tail
    starts a few lanes 30 to 1e4 times farther from the root: they run
    to max_iter while the groups around them take new points; bcc12
    gives the kernel a BCC Voce model's slip tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _, tm = _models("BCC" if case == "bcc12" else "FCC")
    inputs = stage_inputs(4096, 0.08)
    if case == "heavy_tail":
        for lane, scale in zip(FAR_LANES, (30.0, -50.0, 100.0, 1e3, 1e4)):
            inputs[6][:5, lane] *= scale
    cpu = [torch.tensor(a) for a in inputs]
    dev = [a.cuda() for a in cpu]
    d, w, e, q, h, dts, x0, active = dev
    before = dogleg_cuda.KERNEL.launches
    x_k, ok_k, it_k, _, J_k = dogleg_cuda.dogleg_stage(
        tm, x0, h, dts, d, w, e, q, active, TOL, MAX_ITER)
    torch.cuda.synchronize()
    assert dogleg_cuda.KERNEL.launches == before + 1
    x_r, ok_r, it_r, _, _ = dogleg_cuda.dogleg_stage_reference(
        tm, x0, h, dts, d, w, e, q, active, TOL, MAX_ITER)
    both = ok_k & ok_r
    assert float((~(ok_k == ok_r)).float().mean()) <= 1e-4
    assert float((x_k - x_r)[:, both].abs().max()) < 2e-5
    assert torch.equal(x_k[:, 5], x0[:, 5])
    assert int(it_k[5]) == 0 and bool(ok_k[5])
    if case == "heavy_tail":
        far = list(FAR_LANES)
        assert (it_r[far] == MAX_ITER).all() and not ok_r[far].any()
        assert (it_k[far] == MAX_ITER).all() and not ok_k[far].any()
    # every lane was written: converged, or out of iterations
    assert bool((ok_k | (it_k == MAX_ITER)).all())
