"""Build the port's CUDA sources into plain-C shared libraries.

Each kernel's ``.cu`` file under ``src/repro_torch/csrc/`` is compiled
with ``nvcc`` for ``sm_90a`` at first use into ``build/repro_torch/`` of
the checkout and loaded with ``ctypes`` by its wrapper.  A library is
named after its source and keyed by a hash of the source and the flags,
so every kernel keeps its own file and an edited source rebuilds.
Nothing here runs at import time: this module is imported by the CPU
tests, where there is no ``nvcc``.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "source at first use and need the CUDA toolkit")


def library_path(source: pathlib.Path,
                 flags: tuple = NVCC_FLAGS) -> pathlib.Path:
    """Where the library built from ``source`` with ``flags`` lives."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def build(source: pathlib.Path, flags: tuple = NVCC_FLAGS) -> pathlib.Path:
    """Compile ``source`` unless it was built already with these flags;
    returns the library path.  The compiler's report (``-Xptxas=-v``:
    registers, shared memory, spills) is kept beside it as ``<lib>.log``."""
    out = library_path(source, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} with code "
                           f"{proc.returncode}:\n{proc.stderr}")
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)            # atomic: concurrent builds agree
    return out
