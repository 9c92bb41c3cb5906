#!/usr/bin/env python3
"""Kernel B of pio_tpu_torch (the bag dot, d_w) alone on one GPU.

Builds the backward kernels and prints what ``ptxas -v`` says of kernel B
(registers of each instantiation, and the warps an SM holds at its block
size, computed from them). Holds kernel B against its plain version, the
same bits on two calls, and times both in turns (CUDA events, as
``chip_smoke.py`` takes them) at the training shape (11314 bags x 256
slots over [65537, 128], f32 and bf16), at the same slots cut into 45256
bags of 64 (the L check), on the main path's own bags (the template's
preparator over ``chip_smoke.py``'s synthetic corpus, every slot, padding
too) and at ``chip_smoke.py``'s edge shapes; then at D = 32, 64 and 128
over the training slots. Each timed row has the bytes the design moves
through L2 and their rate, and its share of the bound.

``--root DIR`` imports ``pio_tpu_torch`` from another checkout (a
``git archive`` of another commit), so that two designs are compared in
one call on one card: run it as parent, change, change, parent. Prints one
JSON object a line; ``--check`` stops after one call at the training shape.

Usage: ``python3 scripts/torch_bag_dot.py [--root DIR] [--check] [--seed N]``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the H100's registers and resident warps and blocks an SM
SM_REGISTERS, SM_WARPS, SM_BLOCKS = 65536, 64, 32


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def out(**row) -> None:
    print(json.dumps(row), flush=True)


def ptxas_dot(log: str, threads: int) -> list:
    """Registers of each bag_dot_kernel instantiation in a ``ptxas -v`` log,
    and the warps an SM holds at ``threads`` a block (registers go to a
    warp in steps of 8 a thread)."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
        if "spill stores" in line:
            spill = line.split(":", 1)[-1].strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "bag_dot_kernel" in name:
            regs = int(m.group(1))
            warps = threads // 32
            by_regs = SM_REGISTERS // (32 * 8 * -(-regs // 8))
            blocks = min(SM_BLOCKS, SM_WARPS // warps, by_regs // warps)
            rows.append({"kernel": name, "registers": regs, "stack": spill,
                         "warps_an_sm": blocks * warps})
            name = None
    return rows


def g_rows_read(cs, geo, B: int, L: int, D: int) -> int:
    """Rows of g the design reads (``chip_smoke.dot_g_rows``); the first
    design (one warp a bag, 8 slots of each lane group a round) one a
    round."""
    if hasattr(geo, "warps"):
        return cs.dot_g_rows(geo, B, L, D)
    return B * -(-L // (8 * 32 // geo.group_lanes))


def dot_geometry(emb, g, table, L):
    try:
        return emb._dot_geometry(g, table, L)
    except TypeError:  # the first design's geometry does not depend on L
        return emb._dot_geometry(g, table)


def time_dot(cs, emb, name, g, table, ids, timed=True) -> dict:
    """Kernel B vs its plain version: the same bits twice, max |err|, then
    kernel and plain ms in turns, the bytes through L2 and the bound."""
    B, L = ids.shape
    D = table.shape[1]

    def run():
        return emb.embedding_bag_backward_weights(g, table, ids)

    def plain():
        return emb.embedding_bag_backward_weights_plain(g, table, ids)

    tol = cs.BWD_TOL * max(1, D) ** 0.5
    got = cs.launched_twice(name, run, "BACKWARD_WEIGHTS_LAUNCHES", B * L * D > 0)
    err = float((got - plain()).abs().max()) if got.numel() else 0.0
    row = {"case": name, "B": B, "L": L, "D": D, "dtype": str(table.dtype)[6:],
           "max_abs_err": err, "tol": tol, "within_tol": err <= tol}
    if B * L * D and timed:
        row.update(cs.timed_in_turns({"kernel_ms": run, "plain_ms": plain}))
        geo = dot_geometry(emb, g, table, L)
        row["geometry"] = geo._asdict()
        row["gathered_bytes"] = cs.dot_gathered_bytes(
            B, L, D, table.element_size(), g_rows_read(cs, geo, B, L, D))
        row["gathered_tb_s"] = row["gathered_bytes"] / row["kernel_ms"] / 1e9
        row.update(cs.dot_bound(ids.cpu().numpy(), D, table.element_size()))
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
    out(**row)
    return row


def main_path_bags(cs, seed: int):
    """The prepared bags of ``chip_smoke.py``'s training corpus."""
    from pio_tpu_torch.templates.textclassification import (
        PreparatorParams, TextPreparator, TrainingData)

    rng = np.random.default_rng(seed + 1)
    docs, labels = cs.synth_corpus(rng, cs.N_DOCS, cs.N_WORDS, coverage=True)
    pd = TextPreparator(PreparatorParams()).prepare(None, TrainingData(docs, labels))
    return pd.ids, pd.weights, pd.vectorizer.n_features


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="checkout to import pio_tpu_torch from")
    ap.add_argument("--check", action="store_true", help="one call at the training shape")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bag_dot: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from pio_tpu_torch.ops import _build
    from pio_tpu_torch.ops import embedding as emb

    cs = _chip_smoke()  # its pio_tpu_torch imports resolve to the one above
    out(root=os.path.abspath(args.root), device=torch.cuda.get_device_name(0))
    built = _build.build_all(["embedding_bag_bwd"])["embedding_bag_bwd"]
    threads = getattr(emb, "_DOT_THREADS", getattr(emb, "_BWD_THREADS", 256))
    out(build_seconds=built.seconds, ptxas_bag_dot=ptxas_dot(built.log, threads))

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    V, D, B, L = cs.MAX_FEATURES + 1, cs.HIDDEN, cs.N_DOCS, cs.BAG_WIDTH
    ids_np, _ = cs.random_bags(rng, B, L, V)
    g_np = rng.standard_normal((B, D), dtype=np.float32)
    ids, g = cs.card_tensors(dev, ids_np, g_np)
    table = torch.from_numpy(rng.standard_normal((V, D), dtype=np.float32)).to(dev)
    if args.check:
        time_dot(cs, emb, "training f32", g, table, ids, timed=False)
        return 0

    time_dot(cs, emb, "training f32", g, table, ids)
    time_dot(cs, emb, "training bf16", g, table.to(torch.bfloat16), ids)
    # the L check: the same slots as 4x the bags of a quarter of the slots
    # (g's rows repeated), in turns with the training shape
    short = ids.reshape(4 * B, L // 4)
    g4 = g.repeat_interleave(4, dim=0)
    time_dot(cs, emb, "same slots, 45256 x 64", g4, table, short)
    out(case="L check", **cs.timed_in_turns({
        f"{B}x{L}_ms": lambda: emb.embedding_bag_backward_weights(g, table, ids),
        f"{4 * B}x{L // 4}_ms": lambda: emb.embedding_bag_backward_weights(g4, table, short),
    }))
    out(case="D sweep", **cs.dot_d_sweep(g, table, ids))
    for dtype in (torch.float32, torch.bfloat16):
        for name, spec in cs.BWD_EDGE_SHAPES.items():
            e_g, e_t, e_ids, _ = cs.bwd_edge_case(rng, dev, dtype, *spec)
            time_dot(cs, emb, f"{name} {str(dtype)[6:]}", e_g, e_t, e_ids)
    m_ids, _, m_V = main_path_bags(cs, args.seed)
    (m_ids,) = cs.card_tensors(dev, m_ids)
    m_g = torch.from_numpy(np.random.default_rng(args.seed + 3).standard_normal(
        (len(m_ids), D), dtype=np.float32)).to(dev)
    m_t = torch.from_numpy(np.random.default_rng(args.seed + 4).standard_normal(
        (m_V, D), dtype=np.float32)).to(dev)
    time_dot(cs, emb, "main path bags f32", m_g, m_t, m_ids)
    return 0


if __name__ == "__main__":
    sys.exit(main())
