"""Small dense linear solves, batched over points.

Port of ``exaconstit_tpu.solvers.linalg_small``: Gauss-Jordan elimination
with partial pivoting, the same arithmetic as the reference's
``solve_dense``, which solves one point and is vmapped there.  Here the
point batch is the leading axis and the elimination runs on the
component-major ``evptn_cm.solve_dense_cm`` over a transposed view.
"""

from __future__ import annotations

from ..models.evptn_cm import solve_dense_cm


def solve_dense(A, b):
    """Solve A x = b per point: A (N, n, n), b (N, n) or (N, n, k).

    The pivot of each column is the first row of largest magnitude at or
    below the diagonal, as in the reference."""
    x = solve_dense_cm(A.permute(1, 2, 0),
                       b.T if b.ndim == 2 else b.permute(1, 2, 0))
    return x.T if b.ndim == 2 else x.permute(2, 0, 1)
