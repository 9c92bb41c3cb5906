"""The traced run's device record: the harness's spans, a guarded profiler
window, and their reduction to busy time, idle gaps and kernel counts.

The window is a frozen copy of the port's guarded CUDA window
(``pio_tpu_torch/obs/profile.py``): on the H100 the profiler drops
records at the ends of a session, so the window idles ``PAD_S`` after
its start and before its stop, and launches ``SENTINELS`` sentinel
kernels (``torch.cuda._sleep``) after the first idle and again before the
last, each group synchronized. The sentinels also set the clock: the
host's time right after the head group has drained is taken as the end
of its last kernel, which corrects the device-to-host conversion of the
records' timestamps (off by up to ~17 ms) before the host's spans are
laid over them.

Busy time is the union of the intervals in which any operation (kernel,
copy or fill; the sentinels left out) ran on the device, inside the
measured window; the idle share is the rest of the window. Only the
profiler's own records are kept: no chrome trace is written.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

SENTINELS = 256
PAD_S = 0.05
SENTINEL_KERNEL = "spin_kernel"

#: entries kept in each list of the result's ``breakdown``
TOP = 10
#: longest kernel name kept in the breakdown (templates run long)
NAME_CHARS = 160


class Op(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


def is_sentinel(name: str) -> bool:
    return SENTINEL_KERNEL in name


def is_kernel(name: str) -> bool:
    """A launch: not a copy or a fill, nor a sentinel."""
    return not name.startswith(("Memcpy", "Memset")) and not is_sentinel(name)


class Spans:
    """The harness's own spans, on the host's wall clock (the profiler's
    records are on it too), in memory until the run ends."""

    def __init__(self) -> None:
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t, time.time_ns()))


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, merged intervals covering the same points."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals: Sequence[Tuple[int, int]], lo: int,
         hi: int) -> List[Tuple[int, int]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def idle_gaps(busy: Sequence[Tuple[int, int]], lo: int,
              hi: int) -> List[Tuple[int, int]]:
    """The stretches of ``[lo, hi)`` that the merged ``busy`` leaves."""
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _label(spans: Sequence[Tuple[str, int, int]], t_ns: int) -> str:
    """The innermost harness span open at host time ``t_ns``."""
    best: Optional[Tuple[str, int, int]] = None
    for sp in spans:
        if sp[1] <= t_ns < sp[2] and (best is None or sp[1] >= best[1]):
            best = sp
    return best[0] if best is not None else "harness"


def reduce(ops: Sequence[Op], spans: Sequence[Tuple[str, int, int]],
           t0_ns: int, t1_ns: int, head_host_ns: Optional[int]) -> Dict:
    """The window ``[t0_ns, t1_ns)`` (host clock) of the records ``ops``:
    busy and window seconds, kernel launches, the device operations that
    took most time and the longest idle gaps by the span that was open.
    ``head_host_ns`` is the host time at which the head sentinels had
    drained (None: no calibration)."""
    # the profiler's own clock is off by milliseconds at most, so the
    # window's middle tells the two groups apart
    mid = (t0_ns + t1_ns) // 2
    head = [o for o in ops if is_sentinel(o.name) and o.start_ns < mid]
    tail = [o for o in ops if is_sentinel(o.name) and o.start_ns >= mid]
    offset = 0
    if head_host_ns is not None and head:
        offset = head_host_ns - max(o.end_ns for o in head)
    lo, hi = t0_ns - offset, t1_ns - offset
    work = [o for o in ops if not is_sentinel(o.name)]
    busy = union(clip([(o.start_ns, o.end_ns) for o in work], lo, hi))
    busy_ns = sum(e - s for s, e in busy)
    per_name: Dict[str, int] = {}
    kernels = 0
    for o in work:
        if o.end_ns <= lo or o.start_ns >= hi:
            continue
        per_name[o.name] = (per_name.get(o.name, 0)
                            + min(o.end_ns, hi) - max(o.start_ns, lo))
        if is_kernel(o.name) and lo <= o.start_ns:
            kernels += 1
    top_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle_gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (t1_ns - t0_ns) / 1e9,
        "kernels": kernels,
        "sentinels": [len(head), len(tail)],
        "complete": len(head) == len(tail) == SENTINELS,
        "device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in top_ops],
        "idle_gaps": [[_label(spans, (s + e) // 2 + offset), (e - s) / 1e9]
                      for s, e in gaps],
    }


class DeviceTrace:
    """A guarded ``torch.profiler`` window of CUDA activity around the
    measured window; :meth:`ops` gives its device records afterwards."""

    def __init__(self) -> None:
        self.prof = None
        self.head_host_ns: Optional[int] = None

    @staticmethod
    def _sentinels() -> None:
        import torch

        for _ in range(SENTINELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()

    def __enter__(self) -> "DeviceTrace":
        import torch

        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        time.sleep(PAD_S)
        self._sentinels()
        self.head_host_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        import torch

        torch.cuda.synchronize()
        self._sentinels()
        time.sleep(PAD_S)
        with warnings.catch_warnings():
            # one session, one cycle: its note on cycles does not apply
            warnings.simplefilter("ignore", UserWarning)
            self.prof.__exit__(*exc)
        return False

    def ops(self) -> List[Op]:
        """Every record of an operation on the device, from the
        profiler's raw results (no per-event objects are built)."""
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            s = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            if hasattr(e, "end_ns"):
                end = e.end_ns()
            elif hasattr(e, "duration_ns"):
                end = s + e.duration_ns()
            else:
                end = s + e.duration_us() * 1000
            out.append(Op(e.name(), int(s), int(end)))
        return out

