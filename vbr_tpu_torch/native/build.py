"""Build the port's native host library (``vbr_host.cpp``) with ``g++``.

The library is named by a hash of its source, of the compiler flags and of
the machine's architecture, and lives in ``build/host`` at the repository
root (listed in ``.gitignore``), so an edited source or flag, or a copy of
the tree on another architecture, builds anew and an unchanged one loads at
once.
Nothing here runs at import.  By hand::

    python -m vbr_tpu_torch.native.build
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "vbr_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
# no -march=native and no contraction: the emission's (v + base) * spacing
# + origin must round after every operation, as numpy does
FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")


def lib_path(source: Path = None, flags=FLAGS) -> Path:
    """Where the library of ``source`` (default ``SOURCE``) built with
    ``flags`` lives."""
    source = SOURCE if source is None else source
    h = hashlib.sha256(source.read_bytes())
    h.update("\0".join((*flags, platform.machine())).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: Path = None, flags=FLAGS) -> Path:
    """The library's path, compiled first when it is missing; raises
    ``RuntimeError`` when there is no ``g++`` or it fails."""
    source = SOURCE if source is None else source
    out = lib_path(source, flags)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's host library "
                           f"{source.name} cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([gxx, *flags, str(source), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {source.name}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build())
