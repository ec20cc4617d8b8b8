"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.
Libraries are named by a hash of their source, of the ``csrc`` headers the
source includes (``deps``) and of their ``nvcc`` flags, and live in
``build/kernels`` at the repository root (listed in ``.gitignore``), so a
changed source, header or flag rebuilds and an unchanged one loads at once.
``build_kernels`` starts one ``nvcc`` per source, all together, and waits
for them.

Nothing here runs at import: the CPU tests import every module, on hosts
with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


class CudaKernel:
    """One ``csrc`` source, its exported launch function and launch count.

    ``launch(*args)`` calls the C entry point, which launches the kernel
    on the given stream and returns ``cudaGetLastError()``; a non-zero
    status raises.  ``launches`` counts successful launches and is reset
    by whoever wants to count a run (``chip_smoke.py``).  ``extra_flags``
    are this source's own ``nvcc`` flags, after ``NVCC_FLAGS``.  ``deps``
    names the headers beside the source that it includes: their bytes go
    into the library's name, so an edited header cannot load a stale build.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 extra_flags: Sequence[str] = (), deps: Sequence[str] = ()):
        self.source = CSRC / source
        self.deps = [self.source.parent / d for d in deps]
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.flags = (*NVCC_FLAGS, *extra_flags)
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._fn = None
        self._err = None

    @property
    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for dep in self.deps:
            h.update(b"\0" + dep.name.encode() + b"\0" + dep.read_bytes())
        h.update("\0".join(self.flags).encode())
        digest = h.hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{digest}.so"

    def _start_build(self):
        """Start ``nvcc`` for this source; None when already built."""
        out = self.lib_path
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *self.flags, "-I", str(self.source.parent), "-o",
               str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def _finish_build(self, started):
        proc, tmp, out = started
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{log}")
        os.replace(tmp, out)

    def function(self, symbol: str, argtypes: Sequence):
        """Another exported function of the library (built and loaded at
        first use); it returns a CUDA status, which ``status_ok`` checks."""
        if self._lib is None:
            build_kernels([self])
            self._lib = ctypes.CDLL(str(self.lib_path))
            err = self._lib.vbr_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err = err
        fn = getattr(self._lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        return fn

    def status_ok(self, status: int, what: str) -> None:
        if status != 0:
            msg = self._err(status).decode()
            raise RuntimeError(f"{what} failed: {msg} ({status})")

    def launch(self, *args):
        if self._fn is None:
            self._fn = self.function(self.symbol, self.argtypes)
        status = self._fn(
            *args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        self.status_ok(status, f"{self.symbol} launch")
        self.launches += 1


def build_kernels(kernels: Sequence[CudaKernel]) -> None:
    """Build every missing library, one ``nvcc`` per source, in parallel."""
    started = [(k, k._start_build()) for k in kernels]
    errors = []
    for k, s in started:
        if s is None:
            continue
        try:
            k._finish_build(s)
        except RuntimeError as e:  # finish the others, then report all
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Validate a kernel argument before its pointer is passed on."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
