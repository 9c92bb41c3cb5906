"""Device profiler traces: the serving hook (``PIO_TPU_PROFILE=dir``) and
the whole-run trace of ``run_train``.

The port's copy of ``pio_tpu/obs/profile.py`` on ``torch.profiler``
(CPU and, on a CUDA device, CUDA activity), written as Chrome-trace JSON
(``trace.json``; open it in Perfetto or ``chrome://tracing``).

:class:`DeviceProfileHook` captures ONE trace covering the first N device
executions after deploy (N from ``PIO_TPU_PROFILE_EXECUTIONS``, default
8), then gets out of the way; :meth:`DeviceProfileHook.restart` (``POST
/debug/profile.json?restart=1``) rotates the output into a numbered
subdirectory (``capture-0001`` …) and captures the NEXT N executions.

Four rules of the port's profiler shape the hook and the trace:

- **A session belongs to the thread that started it.** ``torch.profiler``
  keeps its state per thread, and a stop from another thread is ignored
  with a warning, leaving the session running. Serving's executions run
  on whichever request thread took them, so the hook starts and stops its
  session on a thread of its own (:class:`_Session`). The CUDA activity
  (CUPTI) covers every thread's kernels; the CPU activity records that
  thread's ops only.
- **One session a process.** Kineto runs one session at a time. A hook
  that finds one already running (another ``torch.profiler`` user)
  disables itself and says so under ``error`` in :meth:`to_dict`; as in
  the reference, a profiler failure never fails a query.
- **Stop after the stream drains.** The N-th execution synchronizes the
  device before it stops the session, so kernels still in flight are
  recorded.
- **Guard both ends of the window** (:func:`open_window`,
  :func:`close_window`). On the H100 the profiler drops kernel records
  at the ends of a session: the first few kernels of a session (one to
  seven, more as the process ages), and kernels whose device timestamps,
  converted to the host's clock, fall outside the session, which they
  miss by up to ~17 ms (``scripts/torch_profiler_window.py``; PERF.md). A CUDA window
  therefore idles :data:`WINDOW_PAD_S` after the start and before the
  stop, and launches :data:`SENTINELS` sentinel kernels
  (``torch.cuda._sleep``'s ``spin_kernel``) after the first idle and
  again before the last, each group synchronized; the work between them
  is recorded whole when more than :data:`SENTINELS` of the sentinels
  are (:func:`window_complete`). Count kernels without the sentinels.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import re
import threading
import time
from typing import Optional

import torch

from pio_tpu_torch.utils import knobs

log = logging.getLogger("pio_tpu_torch.obs")

ENV_DIR = "PIO_TPU_PROFILE"
ENV_N = "PIO_TPU_PROFILE_EXECUTIONS"

#: the Chrome trace a session writes into its directory
TRACE_FILE = "trace.json"

#: seconds a session's owner thread may take to start or to stop and
#: write its trace
_SESSION_TIMEOUT_S = 300.0


#: idle seconds a CUDA window keeps after its start and before its stop:
#: three times the device-to-host clock error seen (~17 ms)
WINDOW_PAD_S = 0.05

#: sentinel kernels launched at each end of a CUDA window: five times the
#: most head records a session has been seen to drop (51, twelve minutes
#: into a process)
SENTINELS = 256

#: the sentinel's kernel function (``torch.cuda._sleep``); a trace names
#: it with its namespace and signature
SENTINEL_KERNEL = "spin_kernel"
_SENTINEL_RX = re.compile(rf"\b{SENTINEL_KERNEL}\b")


def is_sentinel(kernel_name: str) -> bool:
    """Is this kernel (a profiler's or a trace's name) a sentinel?"""
    return _SENTINEL_RX.search(kernel_name) is not None


def _sentinels() -> None:
    for _ in range(SENTINELS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def open_window() -> None:
    """Right after a CUDA session starts: idle, then the head sentinels."""
    time.sleep(WINDOW_PAD_S)
    _sentinels()


def close_window() -> None:
    """Right before a CUDA session stops: drain the device, then the tail
    sentinels, then idle."""
    torch.cuda.synchronize()
    _sentinels()
    time.sleep(WINDOW_PAD_S)


def window_complete(sentinels_seen: int) -> bool:
    """Were the kernels between the sentinel groups all recorded? The
    profiler drops records at a window's ends only, so one sentinel of
    each group seen (more than one group's count) means yes."""
    return sentinels_seen > SENTINELS


def sentinels_seen(prof) -> int:
    """The sentinel kernels a stopped session recorded."""
    return sum(e.count for e in prof.key_averages() if is_sentinel(e.key))


def _activities(cuda: bool) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start(cuda: bool):
    """A started session (a CUDA window opened)."""
    prof = torch.profiler.profile(activities=_activities(cuda))
    prof.start()
    if cuda:
        open_window()
    return prof


def _stop_and_write(prof, directory: str, cuda: bool) -> str:
    """Close the window, stop the session and write its Chrome trace into
    ``directory``; returns the trace's path. A CUDA trace whose
    sentinels say it lost an end of its window is written all the same,
    with a warning."""
    if cuda:
        close_window()
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, TRACE_FILE)
    prof.export_chrome_trace(path)
    if cuda:
        seen = sentinels_seen(prof)
        if not window_complete(seen):
            log.warning("profile trace %s may miss kernels at its ends "
                        "(%d of %d sentinels recorded)", path, seen,
                        2 * SENTINELS)
    return path


def profiler_running() -> bool:
    """Is a ``torch.profiler`` session running anywhere in the process?"""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


class _Session:
    """One ``torch.profiler`` session, started and stopped on a thread of
    its own; :meth:`stop` writes the trace into ``directory``."""

    def __init__(self, directory: str, cuda: bool):
        self.directory = directory
        self._cuda = cuda
        self._stop = threading.Event()
        self._out: queue.Queue = queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name="pio-tpu-torch-profile", daemon=True)
        self._thread.start()
        ok, err = self._out.get(timeout=_SESSION_TIMEOUT_S)
        if not ok:
            self._thread.join(timeout=_SESSION_TIMEOUT_S)
            raise err

    def _run(self) -> None:
        try:
            prof = _start(self._cuda)
        except Exception as e:
            self._out.put((False, e))
            return
        self._out.put((True, None))
        self._stop.wait()
        try:
            self._out.put((True, _stop_and_write(prof, self.directory,
                                                 self._cuda)))
        except Exception as e:
            self._out.put((False, e))

    def stop(self) -> str:
        """Stop the session (the device drained and the tail sentinels
        launched first) and return the trace's path."""
        self._stop.set()
        ok, got = self._out.get(timeout=_SESSION_TIMEOUT_S)
        self._thread.join(timeout=_SESSION_TIMEOUT_S)
        if not ok:
            raise got
        return got


class DeviceProfileHook:
    """Context manager factory wrapped around the device-execute stage.

    Inert (one attribute check) unless constructed with a directory —
    the query server builds it from the environment via :meth:`from_env`.
    ``cuda`` traces the card's kernels too: the serving device is CUDA.
    """

    def __init__(self, directory: str = "", first_n: int = 8,
                 cuda: bool = False):
        self.directory = directory
        self.first_n = first_n
        self.cuda = cuda
        self._lock = threading.Lock()
        self._seen = 0
        self._session: Optional[_Session] = None
        self._done = not directory
        self._captures = 0  # restarts (completed or aborted windows)
        self._error: Optional[str] = None

    @classmethod
    def from_env(cls, cuda: bool = False) -> "DeviceProfileHook":
        return cls(knobs.knob_str(ENV_DIR), knobs.knob_int(ENV_N), cuda)

    def to_dict(self) -> dict:
        """Status for ``GET /debug/profile.json`` (the reference's keys,
        and ``error`` once a profiler failure disabled the hook)."""
        with self._lock:
            out = {
                "configured": bool(self.directory),
                "directory": self.directory,
                "firstN": self.first_n,
                "seen": self._seen,
                "active": self._session is not None,
                "armed": bool(self.directory) and not self._done,
                "captures": self._captures,
            }
            if self._error is not None:
                out["error"] = self._error
            return out

    def _disable(self, what: str, e: BaseException) -> None:
        log.error("PIO_TPU_PROFILE %s failed; disabled: %s", what, e)
        self._error = f"{what}: {e}"
        self._done = True

    def _stop_session(self) -> None:
        """Stop the running session (lock held)."""
        session, self._session = self._session, None
        try:
            path = session.stop()
            log.info("profile trace written to %s", path)
        except Exception as e:
            self._disable("stop", e)

    def restart(self, first_n: int = 0) -> dict:
        """Re-arm for the next ``first_n`` (default: the configured N)
        device executions, rotating output into a fresh numbered
        subdirectory so earlier captures survive. Safe while a capture
        is mid-flight — the active session is stopped first."""
        with self._lock:
            if not self.directory:
                return {"restarted": False,
                        "message": f"{ENV_DIR} not configured"}
            if self._session is not None:
                self._stop_session()
            if first_n > 0:
                self.first_n = first_n
            self._captures += 1
            base = self.directory.rstrip("/").rsplit("/capture-", 1)[0]
            self.directory = os.path.join(
                base, f"capture-{self._captures:04d}"
            )
            self._seen = 0
            self._done = False
            self._error = None
            log.info("profile hook re-armed: next %d executions -> %s",
                     self.first_n, self.directory)
        return self.to_dict() | {"restarted": True}

    @contextlib.contextmanager
    def capture(self):
        """Wrap one device execution: the first call of a window starts
        the session, the ``first_n``-th synchronizes the device and stops
        it. A profiler failure disables the hook rather than failing the
        query."""
        if self._done:
            yield
            return
        with self._lock:
            if not self._done and self._session is None and self._seen == 0:
                if profiler_running():
                    self._disable("start", RuntimeError(
                        "another torch.profiler session is running in "
                        "this process"))
                else:
                    try:
                        self._session = _Session(self.directory, self.cuda)
                        log.info("profiling first %d device executions "
                                 "-> %s", self.first_n, self.directory)
                    except Exception as e:
                        self._disable("start", e)
        try:
            yield
        finally:
            with self._lock:
                if self._session is not None:
                    self._seen += 1
                    if self._seen >= self.first_n:
                        self._stop_session()
                        self._done = True


@contextlib.contextmanager
def trace(directory: str, cuda: bool):
    """A ``torch.profiler`` trace of the block into ``directory`` (the
    whole-run trace of ``run_train``): started and stopped on the calling
    thread, a CUDA window guarded at both ends. Refuses to start while
    another session runs."""
    if profiler_running():
        raise RuntimeError(
            "a torch.profiler session is already running in this process")
    prof = _start(cuda)
    try:
        yield prof
    finally:
        _stop_and_write(prof, directory, cuda)
