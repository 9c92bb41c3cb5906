#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (pio_tpu_torch) on one GPU.

Drives the port's text-classification serving path at the template's full
width (V = 65537 TF-IDF rows with the pad row, H = 128, bag width
L = 256, C = 20 labels, batch chunk 1024) on random weights made from
``--seed``, through the hand-written CUDA embedding-bag kernel:

1. print the card's name and power limit;
2. build every kernel of the path from ``pio_tpu_torch/ops/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card, and time
   kernel, plain version, the library call and the bound (CUDA events),
   printing beside each time the share of weight-0 slots and the achieved
   gather rate, and on a line of its own the previous design's recorded
   time; time each batch shape again at the plans that other SM
   residencies would give; then check the edge shapes of the launch plan
   (one slot, an unaligned row view, no bags, a bag of weight-0 slots),
   each called twice for the same bits;
4. build a full-width model from a synthetic 20-label corpus;
5. serve 8 ``POST /queries.json`` through the port's query server, checked
   against a CPU copy of the model run through the plain version;
6. run ``MLPAlgorithm.batch_predict`` over 1024 queries and check it against
   the loop of ``predict`` and the CPU copy;
7. check that the served path launched the kernel (launch counters).

Usage: ``python3 chip_smoke.py [--seed N]``. Exits non-zero when no CUDA
device is available or any phase fails. The line before the last holds
``nvidia-smi``'s name and power limit, the one before it the kernels' JSON
summary, and the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pio_tpu_torch.controller.engine import EngineParams, get_engine_factory  # noqa: E402
from pio_tpu_torch.convert import text_mlp_from_reference  # noqa: E402
from pio_tpu_torch.models.tfidf import TfIdfVectorizer  # noqa: E402
from pio_tpu_torch.ops import _build  # noqa: E402
from pio_tpu_torch.ops import embedding  # noqa: E402
from pio_tpu_torch.parallel.context import ComputeContext  # noqa: E402
from pio_tpu_torch.server.query_server import create_query_server  # noqa: E402
from pio_tpu_torch.templates.textclassification import (  # noqa: E402
    MLPAlgorithm,
    MLPParams,
    Query,
    _query_bag,
    _stack_bags,
)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, f32 outside the
# tensor cores (the kernel's FMAs are f32 whatever the table type)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

MAX_FEATURES = 65536  # PreparatorParams.max_features → V = 65537
HIDDEN = 128  # MLPParams.hidden
BAG_WIDTH = 256  # PreparatorParams.max_doc_tokens
N_QUERIES = 1024  # the batch chunk of batch_predict
N_HTTP = 8
# the 20 Newsgroups labels: the usual public benchmark of this task
LABELS = [
    "alt.atheism", "comp.graphics", "comp.os.ms-windows.misc",
    "comp.sys.ibm.pc.hardware", "comp.sys.mac.hardware", "comp.windows.x",
    "misc.forsale", "rec.autos", "rec.motorcycles", "rec.sport.baseball",
    "rec.sport.hockey", "sci.crypt", "sci.electronics", "sci.med",
    "sci.space", "soc.religion.christian", "talk.politics.guns",
    "talk.politics.mideast", "talk.politics.misc", "talk.religion.misc",
]
# kernel vs plain version: the same f32 products summed in another order;
# bag weights are L2-normalized (as TF-IDF bags are), so outputs are O(1)
# and 1e-4 leaves two orders of magnitude over f32 rounding at L = 256.
# bf16 tables convert to f32 exactly before the multiply, so the same limit.
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-4}
CONF_TOL = 1e-5  # served confidence vs the CPU copy (f32 softmax)
# device ms of the kernel's previous design (one 128-thread block per bag
# walking L slot by slot, 4-byte loads, padding read), measured by this
# script at commit 1f8eded on an NVIDIA H100 80GB HBM3 at 700 W. Printed
# for comparison on a line of its own, never in the kernels' JSON line.
PREV_KERNEL_MS = {
    "serving f32": 0.02732, "serving bf16": 0.02222, "one query f32": 0.01473,
    "wide f32": 0.04500, "served batch (TF-IDF bags)": 0.02431,
    "served query (TF-IDF bag)": 0.01176,
}
# shapes the launch plan treats apart: name -> (B, L, D, table is a row view)
EDGE_SHAPES = {
    "one slot": (1, 1, 128, False),
    # D = 130 and a pointer one row in: 8-byte (f32) or 4-byte (bf16) lanes
    "unaligned row view": (3, 7, 130, True),
    "no bags": (0, 8, 128, False),
    "zero-weight bag": (4, 16, 128, False),
}
# warps of the kernel an SM holds, as the plan may assume it; at B = 1024,
# D = 128 on 132 SMs these give a bag 2, 4, 8 and 16 warps
SWEEP_WARPS_PER_SM = (16, 32, 64, 128)


def log(msg: str) -> None:
    print(msg, flush=True)


#: ~10 ms of device spin at the H100's clock: longer than the host takes to
#: enqueue the timed launches, so the events read device time and not the
#: host's launch rate (which bounds a one-query bag otherwise)
QUEUE_FILL_CYCLES = 20_000_000


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_FILL_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed_in_turns(fns: dict, rounds: int = 3) -> dict:
    """Median of ``rounds`` timings each, the functions taking turns."""
    names = list(fns)
    runs = {n: [] for n in names}
    for r in range(rounds):
        order = names if r % 2 == 0 else names[::-1]
        for n in order:
            runs[n].append(cuda_ms(fns[n]))
    return {n: float(np.median(v)) for n, v in runs.items()}


def bound(ids: np.ndarray, w: np.ndarray, D: int, elem_bytes: int) -> dict:
    """Least time the card could take for one embedding bag over these bags.

    The work depends on the data: a slot of weight 0 needs no row. Bytes:
    each distinct table row of a non-zero slot, read once, plus the ids and
    weights of every slot (4 B each) and the f32 output. Operations: one
    f32 multiply-add (2 flops) per non-zero slot and column. Also the time
    of the row bytes the gather of the non-zero slots issues, for reference.
    """
    B, L = ids.shape
    live = w != 0
    nnz = int(live.sum())
    rows = len(np.unique(ids[live]))
    io = 8 * B * L + 4 * B * D
    bytes_ms = (rows * D * elem_bytes + io) / PEAK_BYTES_S * 1e3
    ops_ms = 2 * nnz * D / PEAK_F32_FLOP_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "gather_bytes_ms": (nnz * D * elem_bytes + io) / PEAK_BYTES_S * 1e3,
        "distinct_rows": rows,
        "nonzero_slots": nnz,
        "zero_share": 1 - nnz / max(1, B * L),
    }


def run_twice(name: str, table, ids, w) -> torch.Tensor:
    """The kernel's output; fails unless a second call gives the same bits."""
    out = embedding.embedding_bag(table, ids, w)
    again = embedding.embedding_bag(table, ids, w)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    return out


def max_err(name: str, out, ref, tol: float) -> float:
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel output not finite / bad shape")
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    if err > tol:
        raise AssertionError(f"{name}: kernel vs plain max |err| {err} > {tol}")
    return err


def case_row(name, table, ids_np, tol, err) -> dict:
    B, L = ids_np.shape
    V, D = table.shape
    return {
        "case": name, "B": B, "L": L, "V": V, "D": D,
        "dtype": str(table.dtype).replace("torch.", ""),
        "align": embedding._align(table.data_ptr()),
        "plan": embedding._plan_for(table, B, L)._asdict(),
        "max_abs_err": err, "tol": tol,
    }


def plan_sweep(name, table, ids, w, ref, tol) -> None:
    """Kernel time at the plans that other SM residencies would give."""
    B, L = ids.shape
    plans = {k: embedding._plan_for(table, B, L, warps_per_sm=k)
             for k in SWEEP_WARPS_PER_SM}
    for k, plan in plans.items():
        max_err(f"{name}, plan for {k} warps an SM",
                embedding._launch(table, ids, w, plan), ref, tol)
    times = timed_in_turns({
        k: (lambda plan=plan: embedding._launch(table, ids, w, plan))
        for k, plan in plans.items()
    })
    log("  plan sweep: " + json.dumps([
        {"warps_per_sm": k, "warps_per_bag": p.warps_per_bag,
         "bags_per_block": p.bags_per_block, "kernel_ms": times[k]}
        for k, p in plans.items()
    ]))


def check_kernel(name, table, ids_np, w_np, tol) -> dict:
    """Kernel vs plain version on the card, then kernel/plain/library times."""
    dev = table.device
    ids = torch.from_numpy(ids_np).to(dev)
    w = torch.from_numpy(w_np).to(dev)
    out = run_twice(name, table, ids, w)
    ref = embedding.embedding_bag_plain(table, ids, w)
    err = max_err(name, out, ref, tol)
    w_lib = w.to(table.dtype)  # F.embedding_bag wants weights of the table type
    times = timed_in_turns({
        "kernel_ms": lambda: embedding.embedding_bag(table, ids, w),
        "plain_ms": lambda: embedding.embedding_bag_plain(table, ids, w),
        "library_ms": lambda: F.embedding_bag(
            ids, table, per_sample_weights=w_lib, mode="sum"
        ),
    })
    elem = table.element_size()
    row = {
        **case_row(name, table, ids_np, tol, err), **times,
        **bound(ids_np, w_np, table.shape[1], elem),
    }
    # row bytes the kernel read (non-zero slots) per second of its time
    row["gather_tb_s"] = (row["nonzero_slots"] * table.shape[1] * elem
                          / row["kernel_ms"] / 1e9)
    log(f"  {json.dumps(row)}")
    log(f"  recorded, not measured in this run: the previous design's "
        f"kernel_ms {PREV_KERNEL_MS[name]} (commit 1f8eded, NVIDIA H100 "
        f"80GB HBM3 at 700 W)")
    if len(ids_np) > 1:
        plan_sweep(name, table, ids, w, ref, tol)
    return row


def check_edge(name, table, ids_np, w_np, tol) -> dict:
    """Kernel vs plain version at a shape the plan treats apart (untimed)."""
    dev = table.device
    ids = torch.from_numpy(ids_np).to(dev)
    w = torch.from_numpy(w_np).to(dev)
    before = embedding.KERNEL_LAUNCHES
    out = run_twice(name, table, ids, w)
    if len(ids_np) and embedding.KERNEL_LAUNCHES != before + 2:
        raise AssertionError(f"{name}: the wrapper did not launch the kernel")
    err = max_err(name, out, embedding.embedding_bag_plain(table, ids, w), tol)
    zero_bags = torch.from_numpy(~w_np.any(axis=1)).to(dev)
    if out[zero_bags].any():
        raise AssertionError(f"{name}: a bag of weight-0 slots is not 0")
    row = case_row(name, table, ids_np, tol, err)
    log(f"  {json.dumps(row)}")
    return row


def random_bags(rng, B, L, V):
    """Uniform ids in [0, V) and L2-normalized positive weights, every slot
    used — the heaviest bag a TF-IDF query of width L can give."""
    ids = rng.integers(0, V, size=(B, L), dtype=np.int32)
    w = rng.random((B, L), dtype=np.float32) + 0.01
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    return ids, w.astype(np.float32)


def phase_kernels(rng, dev) -> list:
    log("phase 3: kernel vs plain version on the card")
    rows = []
    table = torch.from_numpy(
        rng.standard_normal((MAX_FEATURES + 1, HIDDEN), dtype=np.float32)
    ).to(dev)
    ids, w = random_bags(rng, N_QUERIES, BAG_WIDTH, MAX_FEATURES + 1)
    rows.append(check_kernel("serving f32", table, ids, w, TOL[torch.float32]))
    rows.append(check_kernel(
        "serving bf16", table.to(torch.bfloat16), ids, w, TOL[torch.bfloat16]
    ))
    rows.append(check_kernel(
        "one query f32", table, ids[:1].copy(), w[:1].copy(), TOL[torch.float32]
    ))
    query = torch.from_numpy(ids[:1].copy()).to(dev)
    zeros = torch.zeros(query.shape, device=dev)
    # where one bag's time goes: the same launch with every weight 0 reads
    # ids and weights but no row; an empty kernel is the launch alone
    log("  one query, without its rows: " + json.dumps(timed_in_turns({
        "zero_weights_ms": lambda: embedding.embedding_bag(table, query, zeros),
        "empty_kernel_ms": lambda: torch.cuda._sleep(1),
    })))
    del table
    wide = torch.from_numpy(
        rng.standard_normal((50000, 256), dtype=np.float32)
    ).to(dev)
    ids, w = random_bags(rng, 4096, 64, 50000)
    rows.append(check_kernel("wide f32", wide, ids, w, TOL[torch.float32]))
    del wide
    log("  edge shapes (untimed)")
    for dtype in (torch.float32, torch.bfloat16):
        for name, (B, L, D, view) in EDGE_SHAPES.items():
            full = torch.from_numpy(
                rng.standard_normal((1001, D), dtype=np.float32)
            ).to(dev, dtype)
            # view "row 1 on": a contiguous table whose pointer is off by a row
            table = full[1:] if view else full[:1000]
            ids, w = random_bags(rng, B, L, 1000)
            if name == "zero-weight bag":
                w[1] = 0.0
            check_edge(f"{name} {str(dtype)[6:]}", table, ids, w, TOL[dtype])
    return rows


def _word(i: int) -> str:
    """Distinct 4-letter token for each i < 26**4."""
    s = ""
    for _ in range(4):
        i, r = divmod(i, 26)
        s += chr(ord("a") + r)
    return s


def synth_corpus(rng, n_docs: int, n_words: int, coverage: bool):
    """Documents of Zipf-distributed 4-letter words, label-dependent.

    With ``coverage`` every one of the ``n_words`` words appears in some
    document, so the fitted vocabulary is capped by ``max_features``.
    """
    words = np.array([_word(i) for i in range(n_words)])
    labels = [LABELS[k % len(LABELS)] for k in range(n_docs)]
    extra = np.array_split(rng.permutation(n_words), n_docs) if coverage else None
    docs = []
    for k in range(n_docs):
        # post lengths vary widely; the longest exceed the bag width
        n_tokens = int(rng.integers(100, 1200))
        ranks = np.minimum(rng.zipf(1.1, size=n_tokens) - 1, n_words - 1)
        idx = (ranks + 3001 * (k % len(LABELS))) % n_words
        if extra is not None:
            idx = np.concatenate([idx, extra[k]])
        docs.append(" ".join(words[idx]))
    return docs, labels


def phase_model(args):
    log("phase 4: full-width model from a synthetic 20-label corpus")
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    docs, _ = synth_corpus(rng, 1200, 70000, coverage=True)
    vec = TfIdfVectorizer.fit(docs, max_features=MAX_FEATURES)
    V = vec.n_features
    if V != MAX_FEATURES + 1:
        raise AssertionError(f"vocabulary gives V={V}, want {MAX_FEATURES + 1}")
    queries, _ = synth_corpus(rng, N_QUERIES, 70000, coverage=False)
    g = ComputeContext.local(args.seed, device="cpu").generator()
    C = len(LABELS)
    arrays = {
        "w_in": torch.randn(V, HIDDEN, generator=g).numpy(),
        "b_in": (0.1 * torch.randn(HIDDEN, generator=g)).numpy(),
        "w_out": (torch.randn(HIDDEN, C, generator=g) / HIDDEN ** 0.5).numpy(),
        "b_out": (0.1 * torch.randn(C, generator=g)).numpy(),
        "vocab": vec.vocab, "idf": vec.idf, "labels": sorted(LABELS),
        "bag_width": BAG_WIDTH, "token_cap": BAG_WIDTH,
    }
    gpu = text_mlp_from_reference(arrays)
    cpu = text_mlp_from_reference(arrays, device="cpu")
    lens = [len(vec.transform_doc(q)[0]) for q in queries]
    log(f"  V={V} H={HIDDEN} C={C} L={BAG_WIDTH}; query bags: "
        f"{min(lens)}..{max(lens)} tokens (median {int(np.median(lens))}), "
        f"{sum(n > BAG_WIDTH for n in lens)} truncated; "
        f"{time.perf_counter() - t0:.1f} s")
    return gpu, cpu, queries


def same_answer(got: dict, want, where: str) -> None:
    if got["label"] != want.label or abs(got["confidence"] - want.confidence) > CONF_TOL:
        raise AssertionError(f"{where}: got {got}, CPU plain copy {want.to_dict()}")


def post(conn: http.client.HTTPConnection, body: bytes):
    """``POST /queries.json`` on ``conn`` → (status, decoded JSON answer)."""
    conn.request("POST", "/queries.json", body,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def phase_http(gpu, cpu, queries) -> int:
    log(f"phase 5: {N_HTTP} POST /queries.json through the query server")
    engine = get_engine_factory("templates.textclassification")()
    ep = EngineParams(algorithm_params_list=(("mlp", MLPParams()),))
    algo = MLPAlgorithm()
    embedding.KERNEL_LAUNCHES = 0
    server = create_query_server(engine, ep, [gpu], host="127.0.0.1", port=0)
    with server:
        # one keep-alive connection, as a client that sends many queries has
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
        ms, answers = [], []
        for k, text in enumerate(queries[:N_HTTP]):
            t0 = time.perf_counter()
            status, got = post(conn, json.dumps({"text": text}).encode())
            ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"query {k}: HTTP {status} {got}")
            answers.append(got)
        launches = embedding.KERNEL_LAUNCHES
        status, _ = post(conn, b"{not json")
        conn.close()
        if status != 400:
            raise AssertionError(f"malformed JSON got HTTP {status}, want 400")
    # checked after the timed requests: the CPU copy's torch threads would
    # otherwise compete with the server thread for the host's cores
    for k, (text, got) in enumerate(zip(queries, answers)):
        same_answer(got, algo.predict(cpu, Query(text=text)), f"query {k}")
    # the same queries in process, host clock: featurization alone, and
    # predict (featurization + model on the card + host softmax)
    texts = queries[:N_HTTP]
    feat_ms = [host_ms(lambda t=t: _query_bag(
        gpu.vectorizer, t, gpu.bag_width, gpu.token_cap)) for t in texts]
    pred_ms = [host_ms(lambda t=t: algo.predict(gpu, Query(text=t)))
               for t in texts]
    log(f"  {N_HTTP} answers match the CPU copy; kernel launches {launches}")
    log(f"  host clock, ms per query: request {rounded(ms)}; predict in "
        f"process {rounded(pred_ms)}; featurization alone {rounded(feat_ms)}")
    if launches < N_HTTP:
        raise AssertionError(f"served path launched the kernel {launches} times")
    return launches


def host_ms(fn) -> float:
    """Host-clock ms of one call of ``fn``, the card drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def rounded(xs) -> list:
    return [round(x, 3) for x in xs]


def phase_batch(gpu, cpu, queries):
    log(f"phase 6: batch_predict over {N_QUERIES} queries vs the predict loop")
    algo = MLPAlgorithm()
    qs = [(i, Query(text=t)) for i, t in enumerate(queries)]
    embedding.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    batch = dict(algo.batch_predict(gpu, qs))
    batch_ms = (time.perf_counter() - t0) * 1e3
    loop = {i: algo.predict(gpu, q) for i, q in qs}
    launches = embedding.KERNEL_LAUNCHES
    ref = dict(algo.batch_predict(cpu, qs))
    for i, _ in qs:
        same_answer(batch[i].to_dict(), loop[i], f"batch vs loop, query {i}")
        same_answer(batch[i].to_dict(), ref[i], f"batch vs CPU copy, query {i}")
    log(f"  {N_QUERIES} batch answers equal the loop and the CPU copy; "
        f"batch_predict {batch_ms:.1f} ms (host clock); kernel launches "
        f"{launches}")
    if launches < 1 + N_QUERIES:
        raise AssertionError(f"batch + loop launched the kernel {launches} times")
    return launches, qs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on; the port computes in f32")

    log("phase 2: build the kernels with nvcc")
    built = _build.build_all()
    for name, b in built.items():
        log(f"  {name}: {b.path.name} built in {b.seconds:.1f} s")
        for line in b.log.splitlines():
            log(f"    {line}")

    rng = np.random.default_rng(args.seed)
    shapes = phase_kernels(rng, dev)
    gpu, cpu, queries = phase_model(args)
    http_launches = phase_http(gpu, cpu, queries)
    batch_launches, qs = phase_batch(gpu, cpu, queries)
    log(f"phase 7: kernel launches on the served path: {http_launches} "
        f"(HTTP) + {batch_launches} (batch + loop)")

    log("timing on the served path's own bags")
    w_in = gpu.mlp.w_in
    ids, w = _stack_bags(gpu, qs)
    shapes.append(check_kernel("served batch (TF-IDF bags)", w_in, ids, w,
                               TOL[torch.float32]))
    shapes.append(check_kernel("served query (TF-IDF bag)", w_in, ids[:1].copy(),
                               w[:1].copy(), TOL[torch.float32]))

    main_row = shapes[0]
    summary = {
        "name": "embedding_bag",
        "route": "cuda",
        "source": "pio_tpu_torch/ops/csrc/embedding_bag.cu",
        "replaces": "pio_tpu/ops/embedding.py:132",
        "launches": http_launches + batch_launches,
        "max_abs_err": main_row["max_abs_err"],
        "max_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"],
        "kernel_ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": shapes,
    }
    print(json.dumps({"kernels": [summary]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
