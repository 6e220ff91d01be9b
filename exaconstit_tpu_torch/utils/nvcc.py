"""nvcc builds of the port's CUDA sources into shared libraries with a
plain C interface, loaded with ctypes by their wrappers
(``solvers/dogleg_cuda.py``, ``fem/pa_apply_cuda.py``,
``fem/ea_apply_cuda.py``).

A library is built on first use into ``exaconstit_tpu_torch/build/``,
named after its source and keyed by a hash of the source and the flags,
so a process finds it there until either changes.  ``KernelLibrary``
loads such a library with the plain C interface the apply kernels share.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
# sm_90a (Hopper), IEEE divisions and square roots (no --use_fast_math),
# and ptxas's registers and spills in the build log
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_command(source, out_path, flags=FLAGS) -> list:
    """The nvcc command line that builds ``source`` into ``out_path``."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is None:
            raise RuntimeError(f"nvcc not found: the CUDA toolkit is needed "
                               f"to build {Path(source).name}")
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    return [nvcc, *flags, "-o", str(out_path), str(source)]


def library_path(source, flags=FLAGS) -> Path:
    """Where the library of ``source`` built with ``flags`` lies."""
    source = Path(source)
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}_{key[:16]}.so"


def build(source, flags=FLAGS) -> tuple[Path, str]:
    """Compile ``source`` unless this source is already built with these
    flags; returns (library path, nvcc's output, "" if nothing was
    built).  The output is also kept beside the library (``.log``)."""
    path = library_path(source, flags)
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(source, tmp, flags),
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {Path(source).name}:\n{log}")
        os.replace(tmp, path)
        path.with_suffix(".log").write_text(log)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, log


class KernelLibrary:
    """A CUDA source built on first use and loaded with ctypes: its
    ``entries``, each taking ``argtypes`` and returning a CUDA error
    code, and ``info``, which reports for each of ``kernels`` in turn
    the runtime's registers and local bytes per thread, static shared
    bytes, resident blocks per SM and threads per block.  ``launches``
    is for the wrapper to count its applies on the card, so a run can
    show that its applies went through the kernels."""

    def __init__(self, source, entries, argtypes, info, kernels):
        self.source, self.entries, self.argtypes = source, entries, argtypes
        self.info, self.kernels = info, kernels
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def library_path(self) -> Path:
        return library_path(self.source)

    def build(self) -> Path:
        """Compile the kernels unless this source is already built."""
        path, log = build(self.source)
        self.build_log = log or self.build_log
        return path

    def lib(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name in self.entries:
                getattr(lib, name).argtypes = self.argtypes
                getattr(lib, name).restype = ctypes.c_int
            info = getattr(lib, self.info)
            info.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
            info.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def build_info(self) -> dict:
        """{kernel: registers and local (stack and spill) bytes per
        thread, static shared bytes, resident blocks per SM and threads
        per block}, as the CUDA runtime reports them for the current
        device."""
        out = {}
        for which, name in enumerate(self.kernels):
            vals = [ctypes.c_int(0) for _ in range(5)]
            err = getattr(self.lib(), self.info)(
                which, *(ctypes.byref(v) for v in vals))
            if err != 0:
                raise RuntimeError(f"{self.info}: CUDA error {err}")
            out[name] = dict(zip(("registers", "local_bytes", "shared_bytes",
                                  "blocks_per_sm", "threads"),
                                 (v.value for v in vals)))
        return out
