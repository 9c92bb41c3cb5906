"""Native (C++) host libraries of the port, built with ``g++`` on first use.

The port's copy of the reference's native build, for the three libraries
the port runs:

- ``event_log.cpp`` — the append-only binary event log with its filtered
  scan, repair and compaction in C++ (:mod:`pio_tpu_torch.storage.eventlog`
  wraps it as a storage backend);
- ``als_pack.cpp`` — the ALS host side: the degree counts, the (user,
  item) edge sort, the rating and delta item wire encoders and the block
  packer (:mod:`pio_tpu_torch.models.als`);
- ``topn_host.cpp`` — the fused scan-and-select top-N of the host serving
  path (:mod:`pio_tpu_torch.ops.topn`).

Build model: no wheels, no pybind11 — ``g++ -O3 -march=native`` at first
use, into ``build/pio_tpu_torch_native/<name>-<src+flags sha>-<isa>.so``
at the repository root, so a library rebuilds when its source, the flags
or the host's instruction set change (a ``-march=native`` binary never
loads on a CPU that lacks its instructions). Each build writes a file of
its own process and renames it into place, so processes that build at
once never load a half-written library. ``ctypes`` loads the result.

Unlike the reference, a failed build is an error (:class:`NativeBuildError`,
with the compiler's output): callers never fall back to numpy on their
own. ``PIO_TPU_NO_NATIVE`` is the one way to ask for the numpy routes.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

log = logging.getLogger("pio_tpu_torch.native")

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[1] / "build" / "pio_tpu_torch_native"

FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_cache: Dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    """``g++`` could not be run, or it failed; the message holds its
    output."""


def _host_isa_tag() -> str:
    """Short tag of this host's instruction-set features, part of the
    library's cache key (see the module docstring)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return hashlib.sha256(line.encode()).hexdigest()[:8]
    except OSError:
        pass
    return hashlib.sha256(
        f"{platform.system()}-{platform.machine()}-"
        f"{platform.processor()}".encode()
    ).hexdigest()[:8]


def build_library(name: str, src_dir: Optional[Path] = None,
                  build_dir: Optional[Path] = None) -> Path:
    """Compile ``<src_dir>/<name>.cpp`` (this package's by default) into
    ``build_dir`` and return the library's path; an unchanged source is
    not compiled again. Raises :class:`NativeBuildError` on failure."""
    src = Path(src_dir or SRC_DIR) / f"{name}.cpp"
    out_dir = Path(build_dir or BUILD_DIR)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(FLAGS).encode()
    ).hexdigest()[:16]
    out = out_dir / f"{name}-{digest}-{_host_isa_tag()}.so"
    if out.is_file():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"cannot run g++ for {src}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"g++ failed for {src} (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    log.info("built native library %s", out)
    return out


def _load(name: str, declare) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, its functions
    declared by ``declare(lib)``; one build and load per process."""
    with _lock:
        lib = _cache.get(name)
        if lib is None:
            # first-use compile fills the cache: serializing the build
            # under _lock is the point (one compiler run per library)
            # pio: disable=lock-blocking-call
            lib = ctypes.CDLL(str(build_library(name)))
            declare(lib)
            _cache[name] = lib
        return lib


def _declare_als_pack(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.als_pack_count.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i64p,
    ]
    lib.als_pack_count.restype = ctypes.c_int64
    lib.als_pack_fill.argtypes = [
        i32p, i32p, f32p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, i64p, ctypes.c_int64, i32p, i32p, f32p,
    ]
    lib.als_pack_fill.restype = ctypes.c_int
    lib.als_sort_by_entity.argtypes = [
        i32p, i32p, f32p, ctypes.c_int64, ctypes.c_int32, i64p, i32p, f32p,
    ]
    lib.als_sort_by_entity.restype = ctypes.c_int
    lib.als_sort_within_entity.argtypes = [i32p, f32p, ctypes.c_int32, i64p]
    lib.als_sort_within_entity.restype = ctypes.c_int
    lib.als_delta_count.argtypes = [i32p, i64p, ctypes.c_int32]
    lib.als_delta_count.restype = ctypes.c_int64
    lib.als_delta_fill.argtypes = [
        i32p, i64p, ctypes.c_int32, ctypes.c_int64, u8p, u8p, i32p, u8p,
    ]
    lib.als_delta_fill.restype = ctypes.c_int
    lib.als_rating_codes.argtypes = [f32p, ctypes.c_int64, u8p]
    lib.als_rating_codes.restype = ctypes.c_int64


def _declare_topn_host(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.topn_host_f32.argtypes = [
        f32p, f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, ctypes.c_int64, ctypes.c_int32, i64p, f32p,
    ]
    lib.topn_host_f32.restype = ctypes.c_int


_NUM_STR = 9  # string columns in a PelResult (see event_log.cpp)


class PelResult(ctypes.Structure):
    """The columnar result of ``pel_scan`` (freed by ``pel_free_result``)."""

    _fields_ = [
        ("n", ctypes.c_int64),
        ("time_us", ctypes.POINTER(ctypes.c_int64)),
        ("ctime_us", ctypes.POINTER(ctypes.c_int64)),
        # POINTER(c_char), not c_char_p: arenas are length-delimited binary
        # (c_char_p would truncate at the first NUL on conversion)
        ("arena", ctypes.POINTER(ctypes.c_char) * _NUM_STR),
        ("off", ctypes.POINTER(ctypes.c_uint32) * _NUM_STR),
    ]


def _declare_event_log(lib: ctypes.CDLL) -> None:
    lib.pel_append.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int,  # do_sync (durability knob)
    ]
    lib.pel_append.restype = ctypes.c_int
    lib.pel_scan.argtypes = [
        ctypes.c_char_p,  # path
        ctypes.c_char_p, ctypes.c_int,  # event_names set, count
        ctypes.c_char_p, ctypes.c_char_p,  # entity_type, entity_id
        ctypes.c_char_p, ctypes.c_char_p,  # target type/id
        ctypes.c_char_p,  # event_id
        ctypes.c_int64, ctypes.c_int64,  # start, until (us)
        ctypes.c_int, ctypes.c_int64,  # reversed, limit
        ctypes.POINTER(PelResult),
    ]
    lib.pel_scan.restype = ctypes.c_int
    lib.pel_free_result.argtypes = [ctypes.POINTER(PelResult)]
    lib.pel_free_result.restype = None
    for name in ("pel_count", "pel_repair", "pel_compact"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int64


def event_log_lib() -> ctypes.CDLL:
    """The event-log library (built on first use)."""
    return _load("event_log", _declare_event_log)


def als_pack_lib() -> ctypes.CDLL:
    """The ALS host packer library (built on first use)."""
    return _load("als_pack", _declare_als_pack)


def topn_host_lib() -> ctypes.CDLL:
    """The host top-N scorer library (built on first use)."""
    return _load("topn_host", _declare_topn_host)
