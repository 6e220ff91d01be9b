"""Python wrapper for the native voxel-coarsening tool.

Port of ``exaconstit_tpu.utils.voxel_coarsen`` (host code, numpy and
ctypes, copied so that the port imports nothing of the JAX package):
coarsens ExaCA voxel grain data by blocked majority vote, the workflow
counterpart of ExaConstit's Rust/PyO3 ``voxel_coarsen`` extension.  Uses
the C++ shared library ``native/libvoxel_coarsen.so`` (``native/Makefile``)
through ctypes, with a numpy fallback when the library is not built.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "..", "..", "native", "libvoxel_coarsen.so")


def _load():
    global _LIB
    if _LIB is None and os.path.exists(_LIB_PATH):
        lib = ctypes.CDLL(_LIB_PATH)
        lib.voxel_coarsen.restype = ctypes.c_int
        lib.voxel_coarsen.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32)]
        _LIB = lib
    return _LIB


def voxel_coarsen(data, box_size, coarsen_size, seed=0):
    """Coarsen ExaCA-ordered (y-fastest) voxel ids by majority vote.

    data: flat int32 array of len bx*by*bz; returns the coarse grid
    (x-fastest) of len (bx*by*bz)/coarsen_size^3.
    """
    bx, by, bz = (int(b) for b in box_size)
    cs = int(coarsen_size)
    if bx % cs or by % cs or bz % cs:
        raise ValueError(f"box {box_size} not divisible by {cs}")
    data = np.ascontiguousarray(data, dtype=np.int32).reshape(-1)
    assert data.size == bx * by * bz
    nout = data.size // cs ** 3
    lib = _load()
    if lib is not None:
        out = np.empty(nout, dtype=np.int32)
        rc = lib.voxel_coarsen(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            bx, by, bz, cs, seed,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError("voxel_coarsen failed")
        return out
    # numpy fallback (first-mode majority; deterministic tie-break)
    # CA data: y fastest over bx?? -- mirror the Rust indexing exactly
    j = np.arange(data.size) % bx
    i = (np.arange(data.size) // bx) % by
    k = np.arange(data.size) // (bx * by)
    block = (i // cs) + (j // cs) * (bx // cs) + \
        (k // cs) * ((bx * by) // cs ** 2)
    offset = block * cs ** 3 + (i % cs) + (j % cs) * cs + (k % cs) * cs * cs
    blocked = np.empty_like(data)
    blocked[offset] = data
    blocked = blocked.reshape(nout, cs ** 3)
    out = np.empty(nout, dtype=np.int32)
    for c in range(nout):
        vals, counts = np.unique(blocked[c], return_counts=True)
        out[c] = vals[np.argmax(counts)]
    return out


def voxel_coarsen_file(path, coarsen_size, seed=0):
    """File-based entry matching the Rust API: reads an ExaCA csv-ish file
    with 2 header lines and columns x,y,z,grain_id."""
    raw = np.loadtxt(path, delimiter=",", skiprows=2, comments="%")
    x, y, z, g = (raw[:, i].astype(np.int64) for i in range(4))
    box = (int(x.max() - x.min() + 1), int(y.max() - y.min() + 1),
           int(z.max() - z.min() + 1))
    return box, voxel_coarsen(g.astype(np.int32), box, coarsen_size, seed)
