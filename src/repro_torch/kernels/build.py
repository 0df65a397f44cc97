"""Build and load the port's CUDA kernels (``nvcc`` + ``ctypes``).

Each source under ``src/repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``build/`` at the root of the checkout (listed in ``.gitignore``).  The
sources share the header ``csrc/sm90_mma.cuh``.  The library's file name
carries a hash of its source, the headers and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.  :func:`build`
starts one ``nvcc`` per source, all at once, and waits for all of them.

:class:`CudaKernel` binds one C entry point of a library and counts its
launches; every library exports ``<library>_error_string`` to turn a
returned ``cudaError_t`` into text.  :func:`reset_launch_counts` zeroes the
count of every kernel of the port.  A launch made while a CUDA stream is
being captured into a graph runs nothing: inside :func:`recording_launches`
the calling thread's launches are tallied instead of counted, and whoever
replays the graph adds the tally with :func:`add_launches` per replay.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build"

# kernel library name -> its CUDA source under csrc/
SOURCES: dict[str, str] = {
    "fused_pyramid": "fused_pyramid.cu",
    "online_sop": "online_sop.cu",
    "ssd_scan": "ssd_scan.cu",
    "ssd_scan_bwd": "ssd_scan_bwd.cu",
}

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
    with the hash over the source text, the shared headers (``csrc/*.cuh``)
    and the compiler flags."""
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
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
    process), with its ``<name>_error_string`` signature set."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    err = getattr(lib, f"{name}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    return lib


# every kernel of the port, in the order its module created it
KERNELS: list[CudaKernel] = []


class CudaKernel:
    """One C entry point ``symbol`` of library ``library``, with its
    ``argtypes``, the TPU kernel it ``replaces`` (file:line) and its launch
    count.

    ``launches`` is bumped once per successful :meth:`call` (and nowhere
    else, apart from :func:`add_launches` for each replay of a captured
    graph), so a run can show it went through the kernel."""

    def __init__(self, library: str, symbol: str, argtypes: list,
                 replaces: str):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    @property
    def source(self) -> str:
        """The kernel's CUDA source, relative to the checkout's root."""
        return str((CSRC / SOURCES[self.library]).relative_to(_PKG.parents[1]))

    def lib(self) -> ctypes.CDLL:
        return load(self.library)

    def check(self, rc: int, what: str) -> None:
        """Raise if a C entry point of the library returned an error."""
        if rc != 0:
            msg = getattr(self.lib(), f"{self.library}_error_string")(rc)
            raise RuntimeError(
                f"CUDA kernel {self.symbol}: {what} failed: error {rc}"
                f" ({msg.decode()})"
            )

    def call(self, *args) -> None:
        """Launch through the C entry point; raises if it is refused."""
        if self._fn is None:
            fn = getattr(self.lib(), self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
        self.check(self._fn(*args), "launch")
        tally = getattr(_capture, "tally", None)
        if tally is None:
            self.launches += 1
        else:
            tally[self] = tally.get(self, 0) + 1


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


# per thread: the tally of launches recorded into a graph being captured
_capture = threading.local()


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's launches are recorded into the
    yielded ``{kernel: launches}`` tally and not counted: a launch issued
    during a stream capture runs nothing until the graph is replayed."""
    tally: dict[CudaKernel, int] = {}
    prev = getattr(_capture, "tally", None)
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = prev


def add_launches(tally: dict) -> None:
    """Count one replay of a captured graph whose capture recorded
    ``tally``: each kernel's launches go up by its recorded launches."""
    for kernel, n in tally.items():
        kernel.launches += n
