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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..models import evptn_cm as cm
from ..models.kinetics import VocePL

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "dogleg_voce.cu"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
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
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is None:
            raise RuntimeError("nvcc not found: the CUDA toolkit is needed "
                               "to build the dogleg kernel")
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    return [nvcc, *NVCC_FLAGS, "-o", str(out_path), str(SOURCE)]


class DoglegKernel:
    """The built kernel library and its launch count.

    ``launches`` grows by one per kernel launch (in ``run``) and
    nowhere else, so a run can show that its stage went through the
    kernel."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def library_path(self) -> Path:
        flags = " ".join(NVCC_FLAGS)
        key = hashlib.sha256(SOURCE.read_bytes() + flags.encode()).hexdigest()
        return BUILD_DIR / f"dogleg_voce_{key[:16]}.so"

    def build(self) -> Path:
        """Compile the kernel unless this source is already built."""
        path = self.library_path()
        if path.exists():
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(nvcc_command(tmp),
                                  capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {SOURCE.name}:\n{self.build_log}")
            os.replace(tmp, path)
            path.with_suffix(".log").write_text(self.build_log)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
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
    buf[_PARAM_FLOATS:_PARAM_FLOATS + 3] = [1.0 / kin.xm, kin.gdot0, tol]
    buf[_PARAM_FLOATS + 3:].view(np.int32)[0] = int(max_iter)
    return buf


def dogleg_stage_reference(model, x0, h, dts, d_vecd, w_sm, e_n, q_n,
                           active, tol, max_iter):
    """Plain-torch version of the stage (same contract as dogleg_stage)."""
    Dsm = cm.vecd_to_mat_cm(d_vecd)

    def rj(x):
        # the stage is Voce only, and Voce kinetics read no temperature
        return cm.residual_and_jac_cm(model, x, h, dts, Dsm, w_sm, e_n, q_n,
                                      None)

    x, ok, iters, _, J = cm.dogleg_cm(rj, x0, tol, max_iter, active0=active)
    return x, ok, iters, None, J


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
    args = [a.contiguous() for a in args]
    x, ok, iters, J = KERNEL.launch(kernel_params(model, tol, max_iter),
                                    *args, active.to(torch.uint8)
                                    .contiguous())
    return x, ok, iters, None, J
