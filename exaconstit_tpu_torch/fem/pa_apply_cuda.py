"""The PA operator apply on an index map: CUDA kernel pair + plain version.

``pa_apply(d_pa, dshape, x, emap)`` is y = K x for the partial-assembly
tensor ``d_pa`` (3, 3, 3, 3, nq, ne) on the ``space.IndexMap`` ``emap``
(a mesh file on one device).  For tensors on the card it launches the
hand-written kernels of ``csrc/pa_apply.cu`` (built with nvcc on first
use into ``exaconstit_tpu_torch/build/``, keyed by a hash of the source
and the flags, and loaded with ctypes): an element pass that gathers u,
contracts each point and sums the points, and a node pass that sums the
element vectors over the incidence table in its order.  It has no
threshold and no switch, and raises on what the kernels do not take.
For tensors on the CPU it runs the plain version, today's
``operators.apply_pa_gradient_cm`` on ``emap.gather(x)`` followed by
``emap.scatter_add``, which the CPU tests hold against the JAX package
and the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..utils import nvcc, profiling
from . import operators as ops

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "pa_apply.cu"
NEN = NQ = 8  # the kernels are built for order-1 hexes
# pa_apply_f32/_f64's C arguments: D, dshape, x, conn_t, table, el_y, y,
# ne, nn, valence, the stream
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
ENTRY = {torch.float32: "pa_apply_f32", torch.float64: "pa_apply_f64"}
# pa_apply_build_info's kernels
KERNELS = ("element f32", "element f64", "node f32", "node f64")


class PAApplyKernel(nvcc.KernelLibrary):
    """The built kernel library and its launch count: ``launches`` grows
    by one per apply on the card (two kernel launches) and nowhere
    else."""

    def __init__(self):
        super().__init__(SOURCE, tuple(ENTRY.values()), ARGTYPES,
                         "pa_apply_build_info", KERNELS)

    def launch(self, d_pa, dshape, x, conn_t, table):
        """The two kernels on the current stream: (y, el_y), y (3*nn,)
        and the element vectors el_y (3, 8, ne) the node pass summed."""
        check_inputs(d_pa, dshape, x, conn_t, table)
        ne, nn = conn_t.shape[1], table.shape[1]
        # the cheapest allocations and stream handle (measured on the card:
        # torch.cuda.current_stream builds a Stream object, 6 us of the
        # Krylov loop's host time a call against 0.3)
        el_y = x.new_empty((3, NEN, ne))
        y = torch.empty_like(x)
        stream = torch._C._cuda_getCurrentRawStream(x.get_device())
        err = getattr(self.lib(), ENTRY[x.dtype])(
            d_pa.data_ptr(), dshape.data_ptr(), x.data_ptr(),
            conn_t.data_ptr(), table.data_ptr(), el_y.data_ptr(),
            y.data_ptr(), ne, nn, table.shape[0], stream)
        if err != 0:
            raise RuntimeError(f"{ENTRY[x.dtype]} launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return y, el_y


KERNEL = PAApplyKernel()


def check_inputs(d_pa, dshape, x, conn_t, table):
    """Raise ValueError unless the kernels take these tensors: f32 or f64
    in x's type, int64 index tables, all contiguous on x's CUDA device
    (the current one, where the kernels launch), with the shapes of an
    order-1 hex map."""
    dev, dtype = x.get_device(), x.dtype
    if dev < 0 or dtype not in ENTRY or dev != torch.cuda.current_device():
        raise ValueError(f"pa_apply: x must be f32 or f64 on the current "
                         f"CUDA device, not {dtype} on {x.device}")
    ne, nn = conn_t.shape[-1], table.shape[-1]
    for name, t, shape, dt in (
            ("d_pa", d_pa, (3, 3, 3, 3, NQ, ne), dtype),
            ("dshape", dshape, (NQ, NEN, 3), dtype),
            ("x", x, (3 * nn,), dtype),
            ("conn_t", conn_t, (NEN, ne), torch.int64),
            ("table", table, (table.shape[0], nn), torch.int64)):
        if t.dtype != dt or t.get_device() != dev or t.shape != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"pa_apply: {name} must be a contiguous {dt} tensor of "
                f"shape {shape} on {x.device}, not {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
                + ("" if t.is_contiguous() else " (not contiguous)"))


def pa_apply_reference(d_pa, dshape, x, emap):
    """Plain-torch version of the apply (the CPU path and the oracle) on
    any element map: the strided and the sharded maps take it on the
    card too."""
    return emap.scatter_add(ops.apply_pa_gradient_cm(d_pa, dshape,
                                                     emap.gather(x)))


def pa_apply(d_pa, dshape, x, emap):
    """y = K x on the index map ``emap``; on the card the kernels, each
    apply also counted as ``operator.pa_kernel_applies`` to the current
    recorder (``utils.profiling``)."""
    if x.device.type == "cpu":
        return pa_apply_reference(d_pa, dshape, x, emap)
    y = KERNEL.launch(d_pa, dshape, x, emap.conn_t, emap.table)[0]
    profiling.count("operator.pa_kernel_applies")
    return y
