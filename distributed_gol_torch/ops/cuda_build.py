"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface (``lib<name>-<digest>.so`` under ``build/kernels/`` at
the root of the checkout), loaded with ``ctypes``.  The digest covers the
sources and the flags, so an edited kernel rebuilds and an unchanged one
is reused.  Nothing is built at import: the first :func:`load` of a kernel
builds it, and :func:`build` builds several at once, one ``nvcc`` process
per source, all started together.

A missing ``nvcc`` or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("resident", "tiled", "tiled_skip", "probing", "frontier")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on ``PATH``."""
    candidates = [
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc",
        Path("/usr/local/cuda/bin/nvcc"),
    ]
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives, keyed by its sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) of the build of kernel ``name``."""
    return library_path(name).with_suffix(".log").read_text()


def build(*names: str) -> None:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started before any is awaited."""
    todo = [n for n in (names or KERNELS) if not library_path(n).is_file()]
    if not todo:
        return
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            lib.gol_error_string.argtypes = [ctypes.c_int]
            lib.gol_error_string.restype = ctypes.c_char_p
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a ``cudaError_t`` other than 0."""
    if err != 0:
        msg = lib.gol_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err} ({msg})")
