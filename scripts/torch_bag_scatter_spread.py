#!/usr/bin/env python3
"""How far kernel A (the bag scatter, d_table) and its plain version move
from run to run on one GPU, and how far each lies from a fixed-order sum.

For each shape of ``tests/test_torch_embedding_grad.py``'s ``CARD_SHAPES``
(the same inputs, made the same way from seed 13), in f32 and bf16, calls
``N`` times (default 20):

- the kernel (``embedding_bag_backward_table``) on the card;
- the plain version (``embedding_bag_backward_table_plain``) on the card,
  whose ``index_add_`` adds with atomics in an order that changes between
  runs;

and computes once, on the CPU from the same inputs, the plain version
(``index_add_`` there adds the contributions in slot order) and the same
sum in float64. Prints one JSON object a case: the spread of each card
version against its own first run (max abs difference over the runs), and
the max abs difference of each against the CPU f32 and f64 sums.

Usage: ``python3 scripts/torch_bag_scatter_spread.py [--runs N]
[--case ID]``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pio_tpu_torch.ops import embedding as temb  # noqa: E402

#: (id, B, L, V, D, table a row view one row in, pattern) — the test's
CASES = [
    ("bags", 64, 32, 1000, 128, False, ""),
    ("one-slot", 1, 1, 1000, 128, False, ""),
    ("no-bags", 0, 8, 1000, 128, False, ""),
    ("zero-weight-bag", 4, 16, 1000, 128, False, "zero-bag"),
    ("every-slot-one-row", 16, 64, 1000, 128, False, "one-row"),
    ("unaligned-view", 3, 7, 1000, 130, True, ""),
    ("one-column", 32, 16, 3000, 1, False, ""),
    ("heavy-row-among-light", 1500, 32, 1000, 128, False, "heavy-row"),
    ("l-not-a-tile", 40, 45, 1000, 128, False, ""),
]


def card_case(dev, B, L, V, D, view, pattern, dtype):
    """The test's ``_card_case``: the same draws in the same order."""
    rng = np.random.default_rng(13)
    full = torch.from_numpy(
        rng.standard_normal((V + 1, D), dtype=np.float32)).to(dev, dtype)
    table = full[1:] if view else full[:V]
    ids = rng.integers(0, V, size=(B, L), dtype=np.int32)
    w = rng.random((B, L), dtype=np.float32) + 0.01
    w /= np.linalg.norm(w, axis=1, keepdims=True) if L else 1
    if pattern == "zero-bag":
        w[1] = 0.0
    if pattern == "one-row":
        ids[:] = 7
    if pattern == "heavy-row":
        ids[::4, 0] = 7
    gfull = torch.from_numpy(
        rng.standard_normal((B + 1, D), dtype=np.float32)).to(dev)
    g = gfull[1:] if view else gfull[:B]
    return table, torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev), g


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def spread(outs) -> float:
    return max(max_abs(o, outs[0]) for o in outs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--case", default=None, help="one case id of CASES")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bag_scatter_spread: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    for cid, B, L, V, D, view, pattern in CASES:
        if args.case and cid != args.case:
            continue
        for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            table, ids, w, g = card_case(dev, B, L, V, D, view, pattern, dtype)
            kern = [temb.embedding_bag_backward_table(g, ids, w, V, dtype)
                    for _ in range(args.runs)]
            plain = [temb.embedding_bag_backward_table_plain(g, ids, w, V, dtype)
                     for _ in range(args.runs)]
            torch.cuda.synchronize()
            gc, idc, wc = g.cpu(), ids.cpu(), w.cpu()
            cpu32 = temb.embedding_bag_backward_table_plain(gc, idc, wc, V, dtype)
            contrib = (gc.double()[:, None, :] * wc.double()[:, :, None]).reshape(
                B * L, D)
            cpu64 = torch.zeros((V, D), dtype=torch.float64).index_add_(
                0, idc.reshape(-1).long(), contrib)
            print(json.dumps({
                "case": f"{dname}-{cid}", "runs": args.runs,
                "kernel_spread": spread(kern),
                "plain_card_spread": spread(plain),
                "kernel_vs_cpu_f32_max": max(max_abs(k, cpu32) for k in kern),
                "kernel_vs_cpu_f64_max": max(max_abs(k, cpu64) for k in kern),
                "plain_card_vs_cpu_f32_max": max(max_abs(p, cpu32) for p in plain),
                "kernel_vs_plain_card_max": max(
                    max_abs(k, p) for k in kern for p in plain),
                "device": smi,
            }), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
