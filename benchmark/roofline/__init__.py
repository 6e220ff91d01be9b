"""The yardstick of the roofline shares: peaks, and the operations and
bytes each measured piece of work needs, from its shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): 67 TFLOP/s in float32 and 34 TFLOP/s in float64
outside the tensor cores, 3.35 TB/s of HBM bandwidth.  A share is the
least time the card could take, the larger of operations over the peak
rate and bytes over the bandwidth, over the measured time; each input
byte is counted read once and each output byte written once.
"""

from __future__ import annotations

PEAK_FLOPS = {4: 67e12, 8: 34e12}  # by the item size of the arithmetic
PEAK_BYTES_PER_S = 3.35e12

# The point-solve kernel's f32 stage (``csrc/dogleg_voce.cu``): a frozen
# copy of ``solvers/dogleg_cuda.py``'s counts, per point from the serial
# algorithm (FMA = 2; each division, square root, logf, expf, sinf or
# cosf = 1).  One residual and Jacobian evaluation costs
# 41 (expmap and quaternion product) + 40 (rotation matrix) + 117
# (lattice rates) + 288 (12 slip rates and slopes) + 221 (residual) +
# 1040 (kinetics Jacobian blocks) + 111 (kinematics Jacobian blocks) =
# 1858; a trust-region step 144 (row equilibration) + 696 (Gauss-Jordan)
# + 33 (Newton step check) + 297 (Cauchy point) + 104 (dogleg blend) +
# 211 (model decrease and radius) = 1485 more.
OPS_RESJAC = 1858
OPS_START = OPS_RESJAC + 17  # one evaluation and |r|
OPS_ITER = 1485 + OPS_RESJAC
# bytes per point: 27 f32 inputs and the active byte read; x (8) and J
# (64) f32, the converged byte and the int32 count written
BYTES_PER_POINT = 27 * 4 + 1 + 72 * 4 + 1 + 4


def stage_work(n_points, iters_sum):
    """(f32 operations, bytes) of the stage for ``n_points`` points whose
    trust-region iteration counts sum to ``iters_sum``."""
    return (n_points * OPS_START + iters_sum * OPS_ITER,
            n_points * BYTES_PER_POINT)


# The operator apply y = K x (``MechSystem.apply_k``): gather of the
# element vectors, the element products, scatter-add to the nodes.
# EA: each element's 24 x 24 block times its 24-vector, 2 * 576
# operations, and the 24 sums of the scatter.  PA: per quadrature point
# the reference gradient of u (9 outputs of 8 terms, 144 operations),
# the 9 x 9 point tensor times it (162) and the transposed gradient back
# to the 8 nodes (144), and the scatter's 24 sums per element.
EA_OPS_PER_ELEMENT = 2 * 576 + 24
PA_OPS_PER_POINT = 144 + 162 + 144
PA_SCATTER_OPS_PER_ELEMENT = 24


def operator_apply(kind, k_numel, k_itemsize, x_numel, x_itemsize,
                   index_bytes):
    """(operations, bytes) of one apply: the operator data read once in
    the type it is stored in, x read and y written once in theirs, and
    an index map's tables (the mesh-file path) read once."""
    nbytes = k_numel * k_itemsize + 2 * x_numel * x_itemsize + index_bytes
    if kind == "ea":
        ne = k_numel // 576
        return ne * EA_OPS_PER_ELEMENT, nbytes
    npts = k_numel // 81
    ne = npts // 8
    return (npts * PA_OPS_PER_POINT + ne * PA_SCATTER_OPS_PER_ELEMENT,
            nbytes)


def bound_seconds(ops, nbytes, itemsize=4):
    """The least time of ``ops`` operations in the item size's arithmetic
    and ``nbytes`` of memory traffic, and which of the two sets it."""
    t_ops = ops / PEAK_FLOPS[itemsize]
    t_mem = nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")
