"""Build a hand-written CUDA source into a shared library with ``nvcc``.

Every kernel of the port is a ``csrc/*.cu`` file with a plain C interface,
compiled on first use into ``build/kernels/`` under the repository root
and loaded with ``ctypes``.  Nothing here runs when the module is
imported: the CPU tests import the kernel modules on machines without
``nvcc``.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under PyTorch's ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels cannot be built")


def build_library(source: pathlib.Path, flags: tuple[str, ...],
                  stem: str) -> tuple[pathlib.Path, str]:
    """Compile ``source`` into ``build/kernels/lib<stem>_<tag>.so``.

    ``tag`` hashes the source and the flags, so an edited source is
    rebuilt and an unchanged one is reused.  The library is written under
    a temporary name and renamed, so a concurrent reader never sees a
    partial file.  Returns the library's path and the compiler's output
    (empty when the library was already built).  Raises ``RuntimeError``
    with the compiler's output when ``nvcc`` fails.
    """
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{stem}_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr
