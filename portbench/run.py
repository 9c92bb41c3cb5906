"""Run one cell of ``BENCHMARK.json`` on this machine's CUDA device.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the CUDA context, the
inputs and weights made from the seed, a warm-up at the cell's own
shapes) is timed from the process's start; then the cell's unit of work
runs back to back until ``--seconds`` have passed, and the window ends
with the last unit begun inside it. After the window the program's state
is freed and the cell's correctness check runs against the plain
reference. With ``--trace 0`` the result reports the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones, read from a guarded
profiler window around the measured window.

The last lines on standard error are the compared numbers beside their
limits; the last line on standard output is the result, one JSON object.
Without enough CUDA devices, with anything of JAX or the JAX package
loaded once the window has closed, or with a traced window whose ends
the profiler did not record whole, the run prints no result and exits
with a code other than 0.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """``time.perf_counter()`` at the start of this process (read from
    ``/proc``, to its clock tick), or now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

from portbench import guard, spec, trace  # noqa: E402

#: the fixed cache directories of the program's builds and kernels,
#: under ``portbench/.cache/`` in the checkout
CACHE_ENV = {
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TRITON_CACHE_DIR": "triton",
    "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
    "CUDA_CACHE_PATH": "cuda",
}


def fixed_caches(root: Path = spec.ROOT) -> None:
    """Point every build and kernel cache the program may use at a fixed
    directory of the checkout; keep libraries from loading JAX."""
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(root / spec.PACKAGE / ".cache" / sub)
    os.environ["USE_FLAX"] = "0"


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def within(readings: Dict[str, float], limits: Dict[str, float],
           ) -> List[Tuple[str, float, float, bool]]:
    """``(name, value, limit, within)`` for every number compared; a
    number without a limit in the cell's file is held to 0."""
    return [(k, v, float(limits.get(k, 0.0)), bool(v <= limits.get(k, 0.0)))
            for k, v in readings.items()]


def _num(x: float):
    return x if math.isfinite(x) else str(x)


def execute(bench: dict, cell: dict, seed: int, seconds: float,
            traced: bool, device: str = "cuda", t_start: float = T_START,
            root: Path = spec.ROOT, config: Optional[dict] = None,
            mix: Optional[dict] = None,
            limits: Optional[dict] = None) -> Tuple[dict, list]:
    """One run of ``cell``: (the result object, the checks). ``config``,
    ``mix`` and ``limits`` replace the cell's files where given."""
    import torch

    from portbench import peaks
    from portbench.readers import Run

    name = cell["name"]
    config = config or spec.load_config(bench, cell["config"], root)
    mix = mix or spec.load_mix(cell["traffic"], root)
    limits = spec.load_limits(name, root) if limits is None else limits
    drv = spec.load_driver(mix["driver"], root).Driver(config, mix, seed,
                                                       device)
    cuda = torch.device(device).type == "cuda"
    t_setup = time.perf_counter()
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    split = {"before_driver": t_setup - t_start,
             **getattr(drv, "setup_split", {})}

    spans = trace.Spans()
    units: List[dict] = []
    unit_s: List[float] = []
    window = trace.DeviceTrace() if traced else contextlib.nullcontext()
    with window:
        t0, t0_ns = time.perf_counter(), time.time_ns()
        while not units or time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            with spans.span(drv.unit_name):
                units.append(drv.unit(len(units)))
            unit_s.append(time.perf_counter() - t)
        t1, t1_ns = time.perf_counter(), time.time_ns()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = (trace.reduce(window.ops(), spans.items, t0_ns, t1_ns,
                            window.head_host_ns) if traced else None)
    drv.release()
    checks = within(drv.readings(), limits)

    kind = torch.cuda.get_device_name() if cuda else "cpu"
    least = [u.get("least_s") for u in units]
    run = Run(
        cell=name, setup_s=setup_s, window_s=t1 - t0, units=len(units),
        steps=sum(u.get("steps", 0) for u in units),
        totals={k: float(sum(u.get(k) or 0 for u in units))
                for k in {k for u in units for k in u}
                - {"steps", "flops", "least_s"}},
        flops=float(sum(u.get("flops", 0) for u in units)),
        least_s=None if None in least else float(sum(least)),
        peak=peaks.for_device(kind) if cuda else None, trace=summary)
    metrics = {}
    kind_of = "per_layer" if traced else "end_to_end"
    for m in spec.metrics_of(bench, name, kind_of):
        value = spec.load_metric(m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": int(memory_peak)}
    if cuda:
        dev["power"] = power_limit()
    result = {
        "correct": all(ok for *_, ok in checks),
        "attempted": int(sum(u["attempted"] for u in units)),
        "failed": int(sum(u["failed"] for u in units)),
        "metrics": metrics, "device": dev,
    }
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        result["trace"] = {k: summary[k]
                           for k in ("kernels", "sentinels", "complete")}
    result["window"] = {"units": len(unit_s), "unit_s_min": min(unit_s),
                        "unit_s_median": statistics.median(unit_s),
                        "unit_s_max": max(unit_s)}
    result["setup_split_s"] = split
    result["checks"] = {k: {"value": _num(v), "limit": lim}
                        for k, v, lim, _ in checks}
    return result, checks


def report(result: dict, checks: list) -> None:
    """The compared numbers as the last lines of standard error, the
    result as the last line of standard output."""
    sys.stdout.flush()
    for k, v, lim, ok in checks:
        print(f"check {k} {v!r} limit {lim!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches()
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    import torch

    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = execute(bench, cell, args.seed, args.seconds,
                             bool(args.trace))
    found = guard.forbidden_modules()
    if found:
        print(f"portbench: loaded JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    if result.get("trace") and not result["trace"]["complete"]:
        print("portbench: the profiler lost part of the window's ends, so "
              "its busy time and launches are not whole (sentinels seen: "
              f"{result['trace']['sentinels']} of {trace.SENTINELS} "
              "each)", file=sys.stderr)
        return 4
    report(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
