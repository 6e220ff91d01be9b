"""Tensor-notation conventions, and small constant tables as tensors.

Same conventions as ``exaconstit_tpu.utils.tensors``:

* ``svec`` (6): ``[a11, a22, a33, a23, a13, a12]``;
* ``vecd`` (5): orthonormal deviatoric basis ``BASIS_DEV``,
  ``t0=(a11-a22)/sqrt(2), t1=sqrt(3/2)*a33, t2=sqrt(2)*a12,
  t3=sqrt(2)*a13, t4=sqrt(2)*a23``;
* ``wvec`` (3): axial vector ``[W32, W13, W21]``;
* ``quat`` (4): unit quaternion ``[q0(scalar), q1, q2, q3]``.
"""

import functools

import numpy as np
import torch

SQRT2 = float(np.sqrt(2.0))
SQRT6 = float(np.sqrt(6.0))
SQR2I = 1.0 / SQRT2
SQR6I = 1.0 / SQRT6
SQR2B3 = float(np.sqrt(2.0 / 3.0))

# vecd_k(A) = BASIS_DEV[k] : A
_B = np.zeros((5, 3, 3))
_B[0, 0, 0] = SQR2I
_B[0, 1, 1] = -SQR2I
_B[1, 0, 0] = -SQR6I
_B[1, 1, 1] = -SQR6I
_B[1, 2, 2] = 2.0 * SQR6I
_B[2, 0, 1] = _B[2, 1, 0] = SQR2I
_B[3, 0, 2] = _B[3, 2, 0] = SQR2I
_B[4, 1, 2] = _B[4, 2, 1] = SQR2I
BASIS_DEV = _B  # (5, 3, 3), numpy


@functools.lru_cache(maxsize=512)
def _const_cached(data: bytes, shape: tuple, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    arr = np.frombuffer(data, dtype=np.float64).reshape(shape)
    return torch.tensor(arr, dtype=dtype, device=device)


def const(arr, like: torch.Tensor) -> torch.Tensor:
    """A small constant numpy table as a tensor of ``like``'s dtype and
    device, made once per (table, dtype, device)."""
    a = np.ascontiguousarray(arr, dtype=np.float64)
    return _const_cached(a.tobytes(), a.shape, like.dtype, like.device)


def vecd_deff(t):
    """Effective deformation rate sqrt(2/3) |t| over the last axis."""
    return SQR2B3 * torch.sqrt(torch.sum(t * t, dim=-1))
