"""The readings that the cells' limits are set from.

    python -m portbench.readings --workload <cell> --seeds 1,2,3 [--variants program,control]

For each seed, the cell's own set-up and the window's first run, cut to
the steps the check follows (the window's call at the cell's size, no
timing), then each variant's compared numbers: ``program`` (the
program's output), the ``control`` (the reference in the next precision
down, TF32, in the program's place) and the faults a training cell can
have (``half_batch``, ``unchanged``). Prints one JSON line a seed and
variant, and a summary: for each number the largest program reading and
the smallest reading of every other variant.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

from portbench import spec
from portbench.training import CHECK_STEPS

VARIANTS = ("program", "control", "half_batch", "unchanged")


def read_seed(bench: dict, cell: dict, seed: int, variants=None,
              device: str = "cuda", config=None, mix=None) -> Dict[str, dict]:
    """``{variant: {number: reading}}`` of one seed."""
    config = config or spec.load_config(bench, cell["config"])
    mix = mix or spec.load_mix(cell["traffic"])
    drv = spec.load_driver(mix["driver"]).Driver(config, mix, seed, device)
    drv.setup()
    drv.unit(0, steps=CHECK_STEPS)
    drv.release()
    return {v: drv.readings(v) for v in (variants or VARIANTS)}


def summary(rows: List[dict]) -> dict:
    out: Dict[str, Dict[str, float]] = {}
    for r in rows:
        for name, value in r["numbers"].items():
            slot = out.setdefault(name, {})
            if r["variant"] == "program":
                slot["program_max"] = max(slot.get("program_max", 0.0), value)
            else:
                key = f"{r['variant']}_min"
                slot[key] = min(slot.get(key, float("inf")), value)
    return out


def main(argv=None) -> int:
    from portbench.run import fixed_caches

    ap = argparse.ArgumentParser(prog="python -m portbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="")
    args = ap.parse_args(argv)
    fixed_caches()
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    variants = [v for v in args.variants.split(",") if v] or None
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        for variant, numbers in read_seed(bench, cell, seed,
                                          variants).items():
            row = {"cell": cell["name"], "seed": seed, "variant": variant,
                   "numbers": numbers}
            rows.append(row)
            print(json.dumps(row), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
    print(json.dumps({"cell": cell["name"], "summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
