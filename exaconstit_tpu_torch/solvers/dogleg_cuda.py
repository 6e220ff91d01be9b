"""The f32 trust-region stage of the point solve: CUDA kernel + plain version.

``dogleg_stage`` is the port of ``exaconstit_tpu.solvers.dogleg_pallas.
dogleg_pallas`` with the same ``(x, converged, iters, None, J_final)``
contract.  For tensors on the card it launches the hand-written kernel
``csrc/dogleg_voce.cu`` (built with nvcc on first use into
``exaconstit_tpu_torch/build/``, keyed by a hash of the source and the
flags, and loaded with ctypes); it has no batch threshold and no switch.
For tensors on the CPU it runs ``dogleg_stage_reference``, plain batched
torch ops (``evptn_cm.dogleg_cm`` with the Voce residual and Jacobian),
which the CPU tests hold against the JAX package and ``chip_smoke.py``
holds the kernel against.

Both are detached from automatic differentiation, as the reference's
``stop_gradient`` detaches its stage: they run inside
``DetachedStage``, an ``autograd.Function`` whose forward sees the
primal inputs and a model whose kinetics parameters are plain floats,
and whose outputs carry no tangent and no gradient.  The value path is
the same with and without dual inputs.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import dataclasses

import numpy as np
import torch

from ..models import evptn_cm as cm
from ..models.kinetics import VocePL, primal
from ..utils import nvcc, profiling

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "dogleg_voce.cu"
BUILD_DIR = nvcc.BUILD_DIR
NVCC_FLAGS = nvcc.FLAGS
NSLIP = 12
_PARAM_FLOATS = NSLIP * 5 + 8 * NSLIP
# dogleg_voce_f32's C arguments: 12 tensors (7 f32 inputs, the active
# mask, 4 outputs), the point counter, N, the params struct, the stream
ARGTYPES = ([ctypes.c_void_p] * 13
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

# The f32 operations the stage needs per point (FMA = 2; each division,
# square root, logf, expf, sinf or cosf = 1), counted from the serial
# algorithm in csrc/dogleg_voce.cu: the kernel's thread groups repeat
# some of them on every lane, which this count leaves out.
OPS_RESJAC = {
    "expmap and quaternion product": 41,
    "rotation matrix": 40,
    "lattice rates R^T D R, R^T w, vecd": 117,
    "12 slip rates and slopes": 12 * 24,
    "residual": 5 * 12 * 2 + 3 * 12 * 2 + 5 * 4 + 3 * 3,
    "kinetics Jacobian blocks (40 entries x 12 slips)": 40 * 12 * 2 + 40 * 2,
    "kinematics Jacobian blocks": 3 * (18 + 12 + 5) + 6,
}
OPS_STEP = {
    "row equilibration": 8 * (8 + 1 + 9),
    "Gauss-Jordan elimination": sum((8 - c) + (9 - c) + 14 * (9 - c)
                                    for c in range(8)),
    "Newton step check and norm": 33,
    "Cauchy point (J^T r, J g, alpha)": 128 + 128 + 32 + 1 + 8,
    "dogleg blend": 104,
    "model decrease and radius": 211,
}
OPS_START = sum(OPS_RESJAC.values()) + 17  # one evaluation and |r|
OPS_ITER = sum(OPS_STEP.values()) + sum(OPS_RESJAC.values())
# device memory per point: 27 f32 inputs and the active byte read; x (8)
# and J (64) f32, ok (1 byte) and iters (int32) written
BYTES_PER_POINT = 27 * 4 + 1 + 72 * 4 + 1 + 4


def stage_work(n_points, iters_sum):
    """(f32 operations, bytes) the stage needs for n_points whose
    iteration counts sum to iters_sum."""
    ops = n_points * OPS_START + iters_sum * OPS_ITER
    return ops, n_points * BYTES_PER_POINT


def nvcc_command(out_path) -> list:
    """The nvcc command line that builds the kernel library."""
    return nvcc.nvcc_command(SOURCE, out_path, NVCC_FLAGS)


class DoglegKernel:
    """The built kernel library and its launch count.

    ``launches`` grows by one per kernel launch (in ``run``) and
    nowhere else, so a run can show that its stage went through the
    kernel.  Every stage, the kernel's and the plain version's, also
    adds its lanes to the current recorder's counter ``dogleg.points``
    (``utils.profiling``) and the sum of their iterations, kept on the
    device, to ``dogleg.iterations``."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def tally(self, iters):
        """Count one stage's lanes and iterations to the current recorder."""
        profiling.count("dogleg.points", iters.numel())
        profiling.count_on_device("dogleg.iterations", iters)

    def library_path(self) -> Path:
        return nvcc.library_path(SOURCE, NVCC_FLAGS)

    def build(self) -> Path:
        """Compile the kernel unless this source is already built."""
        path, log = nvcc.build(SOURCE, NVCC_FLAGS)
        self.build_log = log or self.build_log
        return path

    def lib(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            lib.dogleg_voce_f32.argtypes = ARGTYPES
            lib.dogleg_voce_f32.restype = ctypes.c_int
            lib.dogleg_voce_params_size.restype = ctypes.c_int
            lib.dogleg_voce_build_info.argtypes = [ctypes.c_void_p] * 4
            lib.dogleg_voce_build_info.restype = ctypes.c_int
            if lib.dogleg_voce_params_size() != 4 * (_PARAM_FLOATS + 4):
                raise RuntimeError("DoglegParams layout mismatch")
            self._lib = lib
        return self._lib

    def build_info(self) -> dict:
        """Registers and local (stack and spill) bytes per thread,
        resident blocks per SM and threads per block, as the CUDA runtime
        reports them for the current device."""
        vals = [ctypes.c_int(0) for _ in range(4)]
        err = self.lib().dogleg_voce_build_info(
            *(ctypes.byref(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"dogleg_voce_build_info: CUDA error {err}")
        return dict(zip(("registers", "local_bytes", "blocks_per_sm",
                         "threads"), (v.value for v in vals)))

    def launch(self, params, d_vecd, w_sm, e_n, q_n, g, dts, x0, active):
        N = x0.shape[1]
        dev = x0.device
        x = torch.empty((8, N), dtype=torch.float32, device=dev)
        J = torch.empty((8, 8, N), dtype=torch.float32, device=dev)
        ok = torch.empty(N, dtype=torch.uint8, device=dev)
        iters = torch.empty(N, dtype=torch.int32, device=dev)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        self.run(params, (d_vecd, w_sm, e_n, q_n, g, dts, x0, active),
                 (x, J, ok, iters), counter)
        return x, ok.bool(), iters, J

    def run(self, params, inputs, outputs, counter):
        """The kernel on the current stream, writing ``outputs`` (x, J,
        ok, iters); ``counter`` is one zeroed int32 on the device."""
        dev = outputs[0].device
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (*inputs, *outputs, counter)]
        err = self.lib().dogleg_voce_f32(*ptrs, outputs[0].shape[1],
                                         params.ctypes.data, stream)
        if err != 0:
            raise RuntimeError(f"dogleg_voce_f32 launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        self.tally(outputs[3])


KERNEL = DoglegKernel()


def kernel_params(model, tol, max_iter) -> np.ndarray:
    """The kernel's DoglegParams struct as a flat 4-byte buffer."""
    P = np.asarray(model.slip.P, dtype=np.float64)
    Q = np.asarray(model.slip.Q, dtype=np.float64)
    if P.shape[0] != NSLIP:
        raise NotImplementedError("the kernel is built for 12 slip systems")
    PC = P @ np.asarray(model.elast.C_dev, dtype=np.float64)
    kin = model.kinetics
    buf = np.zeros(_PARAM_FLOATS + 4, dtype=np.float32)
    buf[:_PARAM_FLOATS] = np.concatenate(
        [PC.ravel(), P.T.ravel(), Q.T.ravel()])
    buf[_PARAM_FLOATS:_PARAM_FLOATS + 3] = [1.0 / float(kin.xm),
                                            float(kin.gdot0), tol]
    buf[_PARAM_FLOATS + 3:].view(np.int32)[0] = int(max_iter)
    return buf


class DetachedStage(torch.autograd.Function):
    """``solve(*inputs)`` with its outputs cut from automatic
    differentiation: the forward runs on the primal inputs, and the
    outputs have zero tangents (forward mode) and no gradient."""

    @staticmethod
    def forward(ctx, solve, *inputs):
        outs = solve(*inputs)
        ctx.n_outputs = len(outs)
        ctx.mark_non_differentiable(*outs)
        return outs

    @staticmethod
    def jvp(ctx, *tangents):
        return (None,) * ctx.n_outputs

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * len(ctx.needs_input_grad)


def _detached(solve, model, x0, h, dts, d_vecd, w_sm, e_n, q_n, active,
              tol, max_iter):
    """``solve`` (the kernel's launch or the plain version) on detached
    inputs with a primal model; returns (x, converged, iters, None, J)."""
    model = dataclasses.replace(model, kinetics=primal(model.kinetics))
    x, ok, iters, J = DetachedStage.apply(
        lambda *a: solve(model, *a, tol, max_iter), x0, h, dts, d_vecd,
        w_sm, e_n, q_n, active)
    return x, ok, iters, None, J


def _plain_stage(model, x0, h, dts, d_vecd, w_sm, e_n, q_n, active, tol,
                 max_iter):
    Dsm = cm.vecd_to_mat_cm(d_vecd)

    def rj(x):
        # the stage is Voce only, and Voce kinetics read no temperature
        return cm.residual_and_jac_cm(model, x, h, dts, Dsm, w_sm, e_n, q_n,
                                      None)

    x, ok, iters, _, J = cm.dogleg_cm(rj, x0, tol, max_iter, active0=active)
    KERNEL.tally(iters)
    return x, ok, iters, J


def dogleg_stage_reference(model, x0, h, dts, d_vecd, w_sm, e_n, q_n,
                           active, tol, max_iter):
    """Plain-torch version of the stage (same contract as dogleg_stage)."""
    return _detached(_plain_stage, model, x0, h, dts, d_vecd, w_sm, e_n,
                     q_n, active, tol, max_iter)


def _kernel_stage(model, x0, h, dts, d_vecd, w_sm, e_n, q_n, active, tol,
                  max_iter):
    args = [a.contiguous() for a in (d_vecd, w_sm, e_n, q_n, h[0], dts, x0)]
    return KERNEL.launch(kernel_params(model, tol, max_iter), *args,
                         active.to(torch.uint8).contiguous())


def dogleg_stage(model, x0, h, dts, d_vecd, w_sm, e_n, q_n, active, tol,
                 max_iter):
    """f32 trust-region stage of the point solve.

    x0 (8, N) start; h (1, N) CRSS; dts (N,) per-point substep dt;
    d_vecd (5, N) sample-frame deviatoric rate; w_sm (3, N) spin; e_n
    (5, N), q_n (4, N) begin-of-substep state; active (N,) lane mask (an
    inactive lane keeps x0 and reads as converged).  All f32.  Returns
    (x, converged, iters, None, J_final)."""
    if not isinstance(model.kinetics, VocePL):
        raise NotImplementedError(
            "the dogleg stage implements the power-law Voce kinetics")
    if x0.device.type == "cpu":
        return dogleg_stage_reference(model, x0, h, dts, d_vecd, w_sm, e_n,
                                      q_n, active, tol, max_iter)
    if x0.device.type != "cuda":
        raise ValueError(f"dogleg_stage: unsupported device {x0.device}")
    N = x0.shape[1]
    args = [d_vecd, w_sm, e_n, q_n, h[0], dts, x0]
    for a, rows in zip(args, (5, 3, 5, 4, None, None, 8)):
        if a.dtype != torch.float32 or a.device != x0.device:
            raise ValueError("dogleg_stage: every input must be f32 on the "
                             "same device")
        if a.shape != ((rows, N) if rows else (N,)):
            raise ValueError(f"dogleg_stage: bad input shape {a.shape}")
    if active.shape != (N,) or active.device != x0.device:
        raise ValueError("dogleg_stage: active must be (N,) on the device")
    return _detached(_kernel_stage, model, x0, h, dts, d_vecd, w_sm, e_n,
                     q_n, active, tol, max_iter)
