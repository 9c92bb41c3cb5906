"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` compiles on first use into a shared library
with a plain C interface, under ``build/pio_tpu_torch_kernels/`` at the
repository root. A library's file name carries a hash of its source, of
every header under ``csrc/`` and of the compiler flags, so an edited source
or header rebuilds and an unchanged one is loaded as it is. :func:`build_all` starts one ``nvcc`` per source, all at
once, and waits for them together.

Nothing here runs at import: the CPU tests import the ops modules on
machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pio_tpu_torch_kernels"

#: kernel name → source file under csrc/
SOURCES: Dict[str, str] = {
    "embedding_bag": "embedding_bag.cu",
    "embedding_bag_bwd": "embedding_bag_bwd.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    """One compiled library: where it is, how long the build took (0 when
    it was already on disk) and what ``ptxas -v`` reported."""

    path: Path
    seconds: float
    log: str


_LOCK = threading.Lock()
_BUILT: Dict[str, Built] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``),
    then ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of pio_tpu_torch are built from source on first use"
        )
    return found


def library_path(name: str) -> Path:
    """Target of ``name``: keyed by the hash of its source, the headers
    under ``csrc/`` (any source may include them) and the flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Compile every named kernel not yet on disk, all ``nvcc`` runs at once.

    Raises ``RuntimeError`` with the compiler's output when one fails.
    """
    names = list(SOURCES if names is None else names)
    with _LOCK:
        todo = [n for n in names if n not in _BUILT]
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            path = library_path(name)
            if path.is_file():
                _BUILT[name] = Built(path, 0.0, "")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
            # the nvcc builds start together and are awaited under _LOCK
            # on purpose: one build of each kernel per process
            # pio: disable=lock-blocking-call
            procs[name] = (path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        failed = []
        for name, (path, tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
            _BUILT[name] = Built(path, time.perf_counter() - t0, log)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return {n: _BUILT[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        built = build_all([name])[name]
        with _LOCK:
            lib = _LIBS.setdefault(name, ctypes.CDLL(str(built.path)))
    return lib
