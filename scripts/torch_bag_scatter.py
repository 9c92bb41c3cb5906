#!/usr/bin/env python3
"""Kernel A of pio_tpu_torch (the bag scatter, d_table) alone on one GPU.

Builds the backward kernels (printing ``ptxas -v``), holds kernel A against
its plain version and times both in turns (CUDA events, as
``chip_smoke.py`` takes them) at the training shape (11314 bags x 256 slots
over [65537, 128], f32 and bf16), the NB shape (one column over 20 x 65537
rows), every slot on one row (16 x 64), and the main path's own bags (the
template's preparator over ``chip_smoke.py``'s synthetic corpus); then at
D = 32, 64 and 128 over the training slots. With ``--tiles`` it also times
the geometries of other block sizes, twice the blocks, and g in two
passes.

``--root DIR`` imports ``pio_tpu_torch`` from another checkout (a
``git archive`` of another commit), so that two designs are compared in
one call on one card: run it as parent, change, change, parent. Prints one
JSON object a line; ``--check`` stops after one call at the training shape;
``--bits DIR`` saves d_table of three cases the first time and compares
the bits of later runs with it (the summation order is the design's
contract).

Usage: ``python3 scripts/torch_bag_scatter.py [--root DIR] [--check]
[--tiles] [--bits DIR] [--seed N]``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def out(**row) -> None:
    print(json.dumps(row), flush=True)


def time_scatter(cs, emb, name, g, ids, w, n_rows, dtype, tiles=False,
                 bits=None) -> dict:
    """Kernel A vs its plain version: the same bits twice, max |err| (the
    plain version's atomic order moves its last bits from run to run), then
    kernel and plain ms in turns."""
    plan = emb.bag_plan(ids, w, n_rows)

    def run():
        return emb.embedding_bag_backward_table(g, ids, w, n_rows, dtype, plan=plan)

    def plain():
        return emb.embedding_bag_backward_table_plain(g, ids, w, n_rows, dtype)

    ref = plain().float()
    tol = cs.BWD_TOL
    if dtype == torch.bfloat16:
        tol = cs.BF16_STEP * float(ref.abs().max())
    got = cs.launched_twice(name, run, "BACKWARD_TABLE_LAUNCHES", True)
    err = float((got.float() - ref).abs().max())
    row = {"case": name, "D": g.shape[1], "dtype": str(dtype)[6:],
           "max_abs_err": err, "tol": tol, "within_tol": err <= tol,
           **cs.slots_a_row(plan), **cs.timed_in_turns({"kernel_ms": run, "plain_ms": plain})}
    redesigned = hasattr(emb, "_scatter_geo")  # an older checkout has no tiling
    if redesigned:
        geo = emb._scatter_geometry(g, n_rows, dtype)
        row["geometry"] = geo._asdict()
        row["gathered_bytes"] = cs.scatter_gathered_bytes(
            geo, g.shape[0], g.shape[1], plan.n_cells, n_rows, got.element_size())
        row["gathered_tb_s"] = row["gathered_bytes"] / row["kernel_ms"] / 1e9
    if tiles and redesigned:
        row["tiles"] = tile_sweep(cs, emb, g, w, plan, dtype, ref, tol)
        row["device_us_by_kernel"] = by_kernel(run)
    if bits:
        # the first run saves its output, the next ones compare their bits
        path = os.path.join(bits, name.replace(" ", "_") + ".pt")
        if os.path.exists(path):
            row["same_bits_as_saved"] = bool(torch.equal(torch.load(path).to(got.device), got))
        else:
            os.makedirs(bits, exist_ok=True)
            torch.save(got.cpu(), path)
    out(**row)
    return row


def by_kernel(fn, n: int = 10) -> dict:
    """Device microseconds a call of ``fn`` spends in each kernel
    (``torch.profiler``, mean over ``n`` calls)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / n
            for e in prof.key_averages() if e.self_device_time_total > 0}


def tile_sweep(cs, emb, g, w, plan, dtype, ref, tol) -> list:
    """Kernel A at other block sizes, twice the blocks, and g in two passes."""
    base = emb._scatter_geometry(g, plan.n_rows, dtype)
    geos = [emb._scatter_geometry(g, plan.n_rows, dtype, threads=t)
            for t in (1024, 512, 256)]
    geos += [base._replace(grid_x=2 * base.grid_x),
             base._replace(chunk_bags=-(-base.chunk_bags // 2))]
    D = g.shape[1]
    for dt in (8, 16):  # wider slices, g in as many passes as it takes
        if D % dt == 0 and dt > base.dt:
            geos.append(base._replace(dt=dt, grid_y=D // dt, chunk_bags=(
                emb._SCATTER_SMEM_BYTES // (emb._smem_stride(dt) * 4))))
    fns = {}
    for k, geo in enumerate(geos):
        cs.max_err(f"tiles {geo}", emb._launch_scatter(g, w, plan, dtype, geo).float(),
                   ref, tol)
        fns[k] = lambda geo=geo: emb._launch_scatter(g, w, plan, dtype, geo)
    times = cs.timed_in_turns(fns)
    return [{**geo._asdict(), "kernel_ms": times[k]} for k, geo in enumerate(geos)]


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
    ap.add_argument("--tiles", action="store_true", help="time other tile geometries")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bits", help="directory: save each case's d_table the first "
                    "time, compare its bits the next times")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bag_scatter: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from pio_tpu_torch.ops import _build
    from pio_tpu_torch.ops import embedding as emb

    cs = _chip_smoke()  # its pio_tpu_torch imports resolve to the one above
    out(root=os.path.abspath(args.root), device=torch.cuda.get_device_name(0))
    built = _build.build_all(["embedding_bag_bwd"])["embedding_bag_bwd"]
    out(build_seconds=built.seconds, ptxas=built.log.splitlines())

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    V, D, B, L = cs.MAX_FEATURES + 1, cs.HIDDEN, cs.N_DOCS, cs.BAG_WIDTH
    ids_np, w_np = cs.random_bags(rng, B, L, V)
    w_np[:, -16:] = 0.0  # padding, as in chip_smoke.py's phase 8
    g_np = rng.standard_normal((B, D), dtype=np.float32)
    ids, w, g = cs.card_tensors(dev, ids_np, w_np, g_np)
    if args.check:
        plan = emb.bag_plan(ids, w, V)
        got = emb.embedding_bag_backward_table(g, ids, w, V, plan=plan)
        torch.cuda.synchronize()
        err = cs.max_err("training f32", got, emb.embedding_bag_backward_table_plain(
            g, ids, w, V), cs.BWD_TOL)
        out(case="training f32", max_abs_err=err, launches=emb.BACKWARD_TABLE_LAUNCHES)
        return 0

    time_scatter(cs, emb, "training f32", g, ids, w, V, torch.float32, args.tiles,
                 args.bits)
    time_scatter(cs, emb, "training bf16", g, ids, w, V, torch.bfloat16)
    out(case="D sweep", **cs.scatter_d_sweep(g, ids, w, V))
    C = len(cs.LABELS)
    y = rng.integers(0, C, size=B)
    keys = torch.from_numpy((y[:, None] * V + ids_np).astype(np.int32)).to(dev)
    time_scatter(cs, emb, "nb feature sums", torch.ones((B, 1), device=dev), keys, w,
                 C * V, torch.float32, args.tiles)
    e_ids = torch.full((16, 64), 7, dtype=torch.int32, device=dev)
    e_w = torch.from_numpy(cs.random_bags(rng, 16, 64, 1000)[1]).to(dev)
    e_g = torch.from_numpy(rng.standard_normal((16, 128), dtype=np.float32)).to(dev)
    time_scatter(cs, emb, "every slot on one row", e_g, e_ids, e_w, 1000, torch.float32,
                 bits=args.bits)
    m_ids, m_w, m_V = main_path_bags(cs, args.seed)
    m_ids, m_w = cs.card_tensors(dev, m_ids, m_w)
    m_g = torch.from_numpy(np.random.default_rng(args.seed + 3).standard_normal(
        (len(m_ids), D), dtype=np.float32)).to(dev)
    time_scatter(cs, emb, "main path bags f32", m_g, m_ids, m_w, m_V, torch.float32,
                 args.tiles, args.bits)
    return 0


if __name__ == "__main__":
    sys.exit(main())
