"""Build a CUDA source of ``repro_torch/csrc`` into a shared library at first use.

``nvcc`` compiles ``csrc/<name>.cu`` for ``sm_90a`` into a ``.so`` with a plain
C interface, which is loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). The library lands in ``csrc/build/`` under a name that carries
a hash of the source, of every shared header ``csrc/*.cuh`` and of the flags,
so an edited source or header is rebuilt and a current one is reused. ptxas's
report (registers, shared memory and spills of each kernel) is kept beside
the library as ``<library>.ptxas.txt``. Nothing here runs at import: the CPU
tests import every module of the package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def ptxas_report(lib: Path) -> Path:
    """Where ``build`` keeps ptxas's report for the library ``lib``."""
    return lib.with_name(lib.name + ".ptxas.txt")


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def sass_census(lib: Path) -> dict[str, int]:
    """Counts of the Hopper instructions in a built library's SASS: ``HGMMA``
    (wgmma), ``UTMALDG`` (TMA loads) and ``HMMA`` (mma.sync), from
    ``cuobjdump -sass`` of the toolkit that holds ``nvcc``."""
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "UTMALDG", "HMMA")}


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a current build exists; return its path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(name, Path(tmp)), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        ptxas_report(out).write_text(proc.stderr)
        os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, building it if needed.

    Each kernel module caches the loaded library with its ctypes signatures.
    """
    return ctypes.CDLL(str(build(name)))
