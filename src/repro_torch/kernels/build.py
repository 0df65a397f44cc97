"""Build and load the port's CUDA kernels (``nvcc`` + ``ctypes``).

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``build/`` at the root of the checkout (listed in ``.gitignore``).  The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded.  :func:`build`
starts one ``nvcc`` per source, all at once, and waits for all of them.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build"

# kernel library name -> its CUDA source under csrc/
SOURCES: dict[str, str] = {"fused_pyramid": "fused_pyramid.cu"}

NVCC_FLAGS: tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``.  Raises when there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin"
            " and PATH): the CUDA kernels cannot be built on this machine"
        )
    return found


def library_path(name: str) -> Path:
    """Where library ``name`` is (or will be) built: ``build/lib<name>-<hash>.so``
    with the hash over the source text and the compiler flags."""
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every library in ``names`` (default: all) that is not built
    yet, one ``nvcc`` process per source started together.  Returns each
    library's compiler output (``-Xptxas -v`` register/spill report; empty
    for a library that was already built).  Raises ``RuntimeError`` with
    the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).is_file()]
    reports = {n: "" for n in names}
    if not todo:
        return reports
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for n in todo:
        final = library_path(n)
        tmp = final.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            final,
        )
    failed = []
    for n, (proc, tmp, final) in procs.items():
        out, _ = proc.communicate()
        reports[n] = out
        if proc.returncode == 0:
            os.replace(tmp, final)  # atomic: readers never see a partial file
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {SOURCES[n]}:\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed (once per
    process)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
