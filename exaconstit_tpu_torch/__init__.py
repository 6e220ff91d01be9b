"""ExaConstit in PyTorch: the crystal-plasticity FEM framework on CUDA.

A port of the JAX package ``exaconstit_tpu`` (which stays in the
repository as the reference it is tested against).  The module tree
mirrors it name for name (``config/``, ``mesh/``, ``fem/``, ``models/``,
``solvers/``, ``driver.py``, ``cli.py``); the one TPU kernel of the
reference, the f32 trust-region stage of the point solve, is a CUDA C++
kernel here (``csrc/dogleg_voce.cu`` behind ``solvers/dogleg_cuda.py``).

Conventions kept from the reference so the two packages compare like
with like:

* component-major layouts with the point/element batch LAST:
  ``x (8, N)``, ``J (8, 8, N)``, state ``(nsv, npts)``, flat ``(3*nn,)``
  nodal vectors, EA blocks ``(24, 24, ne)``;
* f64 for state, coordinates and the Newton residual; f32 exactly
  where the reference drops to f32 (the point-solve stage, the lagged
  tangent, the EA block build, the inner PCG);
* true-f32 contractions: TF32 is never used (``set_precision_policy``).

Nothing here is differentiated, so the entry points run under
``torch.inference_mode()``.
"""

import torch


def set_precision_policy():
    """Force true-f32 matmuls and convolutions, as the reference forces
    "highest" matmul precision: the f32 point solve, the f32 EA build and
    the f32 inner PCG all lose their convergence under TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
