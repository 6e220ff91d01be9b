"""The EA operator apply on the strided map: a CUDA kernel pair.

``ea_apply(k_cm, emap, x)`` is y = K x for the element blocks ``k_cm``
(24, 24, ne), contiguous, on the ``space.StructuredMap`` ``emap`` of an
order-1 voxel brick, with x and y flat (3*nn,) nodal vectors on the
card.  It launches the hand-written kernels of ``csrc/ea_apply.cu``
(built with nvcc on first use into ``exaconstit_tpu_torch/build/``,
keyed by a hash of the source and the flags, and loaded with ctypes): an
element pass that reads each block in place, gathers u through the
grid's strides and sums its 24 columns in a fixed order, and a node pass
that sums each node's element rows in ascending local-node order, as
``StructuredMap.scatter_add`` does.  f32 blocks meet an f64 x in
registers; blocks wider than x (f64 blocks, f32 x) are cast to x's type
first, as the plain form casts them.  It has no threshold and no switch.

``operators.apply_ea`` takes it where ``engages`` holds (the card, the
strided map of order 1, contiguous blocks) and its plain form, the
einsum and the map's scatter, everywhere else: the CPU (where the tests
hold it against the JAX package), an ``IndexMap``, the sharded maps and
order 2.  ``engages`` is the one test of the blocks' shape and layout;
the launch raises on the rest of what the kernels do not take (dtypes,
devices, x's shape and layout).  The launches allocate only with ``torch.empty``, run on the
current stream and never synchronise, so a CUDA graph can capture them.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..utils import nvcc, profiling
from .space import StructuredMap

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ea_apply.cu"
NEN = 8  # the kernels are built for order-1 hexes
NDOF = 3 * NEN
f32, f64 = torch.float32, torch.float64
# ea_apply_*'s C arguments: K, x, el_y, y, nx, ny, nz, the stream
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# (blocks' dtype, x's dtype) -> entry point
ENTRY = {(f32, f32): "ea_apply_f32", (f32, f64): "ea_apply_f32_f64",
         (f64, f64): "ea_apply_f64"}
# ea_apply_build_info's kernels
KERNELS = ("element f32", "element f32 blocks f64 x", "element f64",
           "node f32", "node f64")


class EAApplyKernel(nvcc.KernelLibrary):
    """The built kernel library and its launch count: ``launches`` grows
    by one per apply on the card (two kernel launches) and nowhere
    else."""

    def __init__(self):
        super().__init__(SOURCE, tuple(ENTRY.values()), ARGTYPES,
                         "ea_apply_build_info", KERNELS)

    def launch(self, k_cm, x, grid):
        """The two kernels on the current stream: (y, el_y), y (3*nn,) in
        x's type and the element vectors el_y (3, 8, ne) the node pass
        summed, for the blocks ``k_cm`` on the (nx, ny, nz) ``grid``.
        The blocks' shape and layout are ``engages``'s to decide (they
        must be (24, 24, nx*ny*nz) and contiguous); this checks the rest
        (``check_inputs``)."""
        check_inputs(k_cm, x, grid)
        # one allocation an apply: the element vectors, then y
        n_el = 3 * NEN * k_cm.shape[-1]
        out = x.new_empty(n_el + x.numel())
        el_y, y = out[:n_el].view(3, NEN, -1), out[n_el:]
        # the cheapest stream handle (torch.cuda.current_stream builds a
        # Stream object); inside a capture, the capture's stream
        stream = torch._C._cuda_getCurrentRawStream(x.get_device())
        name = ENTRY[(k_cm.dtype, x.dtype)]
        err = getattr(self.lib(), name)(
            k_cm.data_ptr(), x.data_ptr(), el_y.data_ptr(), y.data_ptr(),
            *grid, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        self.launches += 1
        return y, el_y


KERNEL = EAApplyKernel()


def engages(k_cm, emap, x):
    """Whether ``operators.apply_ea`` takes the kernels: x on the card,
    the strided map of an order-1 grid, and its blocks (24, 24, ne)
    contiguous."""
    return (x.is_cuda and isinstance(emap, StructuredMap) and emap.p == 1
            and k_cm.shape == (NDOF, NDOF, emap.nx * emap.ny * emap.nz)
            and k_cm.is_contiguous())


def check_inputs(k_cm, x, grid):
    """Raise ValueError unless the kernels take these tensors beyond what
    ``engages`` decides: f32 blocks with f32 or f64 x, or f64 blocks with
    f64 x, both on x's CUDA device (the current one, where the kernels
    launch), and x contiguous of an order-1 (nx, ny, nz) grid's shape."""
    dev = x.get_device()
    if dev < 0 or dev != torch.cuda.current_device() \
            or k_cm.get_device() != dev or (k_cm.dtype, x.dtype) not in ENTRY:
        raise ValueError(f"ea_apply: the blocks and x must be f32 and f32, "
                         f"f32 and f64 or f64 and f64 on the current CUDA "
                         f"device, not {k_cm.dtype} on {k_cm.device} and "
                         f"{x.dtype} on {x.device}")
    nx, ny, nz = grid
    shape = (3 * (nx + 1) * (ny + 1) * (nz + 1),)
    if x.shape != shape or not x.is_contiguous():
        raise ValueError(f"ea_apply: x must be a contiguous tensor of shape "
                         f"{shape}, not {tuple(x.shape)}"
                         + ("" if x.is_contiguous() else " (not contiguous)"))


def ea_apply(k_cm, emap, x):
    """y = K x on the strided map ``emap`` through the kernels, for the
    inputs that ``engages`` admitted (``operators.apply_ea``), each
    apply also counted as ``operator.ea_kernel_applies`` to the current
    recorder (``utils.profiling``; none inside a capture)."""
    if k_cm.dtype.itemsize > x.dtype.itemsize:
        k_cm = k_cm.to(x.dtype)
    y = KERNEL.launch(k_cm, x, (emap.nx, emap.ny, emap.nz))[0]
    profiling.count("operator.ea_kernel_applies")
    return y
