#!/usr/bin/env python3
"""Looks for kernel records that ``torch.profiler`` loses, on one GPU.

Late in ``chip_smoke.py`` the profiler has counted fewer kernels than a
call launched (0, 1 and 10 for a ``batch_predict`` that launches 6 or
more). This script runs one long process that profiles a known number of
launches again and again, in turns across the ways a session can be
held (``--variants``), and prints for each way how many sessions counted
fewer launches than were made:

- ``count``: as ``chip_smoke.count_kernels`` did before the fix (CUDA
  activity, ``acc_events=True``, a device synchronize before the session
  stops);
- ``no_acc``: the same without ``acc_events``;
- ``cpu_cuda``: CPU and CUDA activity;
- ``no_sync``: the session stops without a synchronize;
- ``pad_end``: a synchronize and 50 ms of idle time before the stop;
- ``busy``: ``count`` while another thread runs matrix products and
  synchronizes in a loop (a server's request threads);
- ``owner``: the session started and stopped on a thread of its own
  while the launches come from the main thread (the profile hook's
  shape);
- ``pad``: 20 ms of idle time after the start and before the stop;
- ``tail``: 64 sentinel kernels (``torch.cuda._sleep``, the
  ``spin_kernel``) after the synchronize, then a synchronize;
- ``pad_tail``, ``owner_pad_tail``: both;
- ``window``, ``owner_window``, ``busy_window``: the window
  ``pio_tpu_torch/obs/profile.py`` holds (``open_window`` after the
  start: ``WINDOW_PAD_S`` idle and ``SENTINELS`` sentinels;
  ``close_window`` before the stop: a synchronize, ``SENTINELS``
  sentinels and ``WINDOW_PAD_S`` idle), as ``count_kernels``, ``device_busy``, the profile hook and
  ``run_train``'s trace hold a session; a session whose sentinels say it
  is incomplete (``window_complete``) is counted apart.

The counted kernels are the ``neg`` kernels of the workload only, so the
busy thread's and the sentinels' launches do not count. Every 10th
session is a heavy one (20,000 launches) so that the profiler's buffers
grow as they do in a long run. For each session with a loss, the lost
launches' positions (by the correlation ids of the host's launch
records) say whether the head or the tail of the window went. Each
session also records the gap between each kernel's start on the device
and its launch on the host (the same correlation id), and between the
last kernel's end and the host's stop time, in the profiler's clock: a
large or negative value there is the device-to-host clock conversion
erring by that much. One JSON line a session goes to ``--out``; a
summary JSON line is printed last.

Usage: ``python3 scripts/torch_profiler_window.py [--seconds 240]
[--variants count,pad,tail,pad_tail,owner_pad_tail]
[--out build/profiler_window.jsonl]``
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import statistics
import sys
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from pio_tpu_torch.obs import profile as window  # noqa: E402

ALL_VARIANTS = ("count", "no_acc", "cpu_cuda", "no_sync", "pad_end", "busy",
                "owner", "pad", "tail", "pad_tail", "owner_pad_tail",
                "window", "owner_window", "busy_window")
PAD_S = 0.02
SENTINELS = 64


def neg_launches(x: torch.Tensor, k: int) -> None:
    for _ in range(k):
        x.neg_()


def sentinels() -> None:
    for _ in range(SENTINELS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def kineto_kernels(prof):
    """(kernel events, host launch records in launch order) of a stopped
    session."""
    evs = prof.profiler.kineto_results.events()
    kernels, launches = [], []
    for e in evs:
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA and \
                not name.startswith(("Memcpy", "Memset")) and \
                kind in ("", "kernel", "concurrent_kernel"):
            kernels.append(e)
        elif "LaunchKernel" in name:
            launches.append(e)
    launches.sort(key=lambda e: e.start_ns())
    return kernels, launches


def workload(variant: str, x: torch.Tensor, k: int) -> None:
    if variant.endswith("window"):
        window.open_window()
        neg_launches(x, k)
        window.close_window()
        return
    if "pad" in variant and variant != "pad_end":
        time.sleep(PAD_S)
    neg_launches(x, k)
    if variant != "no_sync":
        torch.cuda.synchronize()
    if "tail" in variant:
        sentinels()
    if variant == "pad_end":
        time.sleep(0.05)
    elif "pad" in variant:
        time.sleep(PAD_S)


def run_session(variant: str, x: torch.Tensor, k: int, stop_ns: list):
    acts = [ProfilerActivity.CUDA]
    if variant == "cpu_cuda":
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    if variant.startswith("owner"):
        return owner_session(variant, acts, x, k, stop_ns)
    with profile(activities=acts, acc_events=variant != "no_acc") as prof:
        workload(variant, x, k)
        stop_ns.append(time.time_ns())
    return prof


def owner_session(variant, acts, x, k, stop_ns):
    """Start and stop the session on a helper thread; launch here."""
    cmd, out = queue.Queue(), queue.Queue()

    def owner():
        p = profile(activities=acts)
        p.start()
        out.put(None)
        cmd.get()
        p.stop()
        out.put(p)

    t = threading.Thread(target=owner, daemon=True)
    t.start()
    out.get(timeout=60)
    workload(variant, x, k)
    stop_ns.append(time.time_ns())
    cmd.put(None)
    prof = out.get(timeout=60)
    t.join(timeout=60)
    return prof


def busy_loop(stop: threading.Event) -> None:
    a = torch.randn(1024, 1024, device="cuda")
    while not stop.is_set():
        for _ in range(4):
            a = torch.mm(a, a).clamp_(-1, 1)
        torch.cuda.synchronize()


def where_lost(ours, launches, k: int):
    """Positions (in launch order) of the launches without a kernel
    record: ``head``, ``tail``, ``both`` or ``middle``."""
    seen = {e.correlation_id() for e in ours}
    own = launches[:k] if len(launches) >= k else launches
    lost = [i for i, e in enumerate(own) if e.correlation_id() not in seen]
    if not lost:
        return None, None
    head = lost[0] == 0
    tail = lost[-1] == len(own) - 1
    where = ("both" if head and tail else "head" if head
             else "tail" if tail else "middle")
    return where, [lost[0], lost[-1], len(lost), len(own)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=240.0)
    ap.add_argument("--variants", default=",".join(ALL_VARIANTS))
    ap.add_argument("--out", default="build/profiler_window.jsonl")
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    bad = set(variants) - set(ALL_VARIANTS)
    if bad:
        ap.error(f"unknown variants {sorted(bad)}")
    if not torch.cuda.is_available():
        print("torch_profiler_window: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    x = torch.zeros(1 << 20, device="cuda")
    t0 = time.monotonic()
    summary = {v: {"sessions": 0, "short": 0, "lost": 0,
                   "first_short_s": None, "where": {}, "incomplete": 0}
               for v in variants}
    drift = []
    n = 0
    with open(args.out, "w") as f:
        while time.monotonic() - t0 < args.seconds:
            n += 1
            variant = variants[n % len(variants)]
            k = 20_000 if n % 10 == 0 else (6 if n % 3 else 200)
            stop_flag = threading.Event()
            busy = None
            if variant.startswith("busy"):
                busy = threading.Thread(target=busy_loop, args=(stop_flag,),
                                        daemon=True)
                busy.start()
                time.sleep(0.005)
            stop_ns: list = []
            prof = run_session(variant, x, k, stop_ns)
            stop_flag.set()
            if busy is not None:
                busy.join(timeout=60)
            kernels, launches = kineto_kernels(prof)
            ours = [e for e in kernels if "neg" in e.name()]
            spins = sum("spin" in e.name() for e in kernels)
            by_corr = {e.correlation_id(): e.start_ns() for e in launches}
            lags = [e.start_ns() - by_corr[e.correlation_id()]
                    for e in ours if e.correlation_id() in by_corr]
            tail = (stop_ns[0] - max(e.start_ns() + e.duration_ns()
                                     for e in ours)) if ours else None
            where, span = (where_lost(ours, launches, k)
                           if not variant.startswith("busy")
                           else (None, None))
            age = round(time.monotonic() - t0, 3)
            row = {"n": n, "age_s": age, "variant": variant, "launched": k,
                   "counted": len(ours), "sentinels": spins,
                   "lost_where": where, "lost_span": span,
                   "lag_us_min": round(min(lags) / 1e3, 1) if lags else None,
                   "lag_us_med": round(statistics.median(lags) / 1e3, 1)
                   if lags else None,
                   "tail_us": round(tail / 1e3, 1) if tail is not None
                   else None}
            f.write(json.dumps(row) + "\n")
            s = summary[variant]
            s["sessions"] += 1
            if variant.endswith("window") and \
                    not window.window_complete(spins):
                s["incomplete"] += 1
            if len(ours) < k:
                s["short"] += 1
                s["lost"] += k - len(ours)
                if where:
                    s["where"][where] = s["where"].get(where, 0) + 1
                if s["first_short_s"] is None:
                    s["first_short_s"] = age
            if lags:
                drift.append((age, min(lags) / 1e3))
    quarters = []
    if drift:
        q = max(1, len(drift) // 4)
        for i in range(0, len(drift), q):
            part = [d for _, d in drift[i:i + q]]
            quarters.append({"from_s": drift[i][0],
                             "lag_us_min": round(min(part), 1),
                             "lag_us_med": round(statistics.median(part), 1)})
    print(json.dumps({"sessions": n, "by_variant": summary,
                      "launch_to_start_by_quarter": quarters}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
