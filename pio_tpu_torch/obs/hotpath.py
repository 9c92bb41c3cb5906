"""Aggregated hot-path latency budget: ``/debug/hotpath.json``.

The port's copy of ``pio_tpu/obs/hotpath.py`` (the port imports nothing
of ``pio_tpu``).

Turns a path's stage histogram (``pio_tpu_<name>_stage_seconds``) plus
an end-to-end histogram into a per-stage budget: for each stage the
count, average, p50 and p95, and — the number the hot-path work is
judged against — the **attributed fraction**: how much of the average
end-to-end request the named top-level stages explain, so the gap between
a request's in-process and end-to-end time has named owners.

Budget math: a stage's per-request cost is its total observed seconds
divided by the number of *requests* (not stage observations — a stage
that only runs for some requests is amortized over all of them, which
is what a budget means). Top-level stages (no ``.`` in the name) tile
the request and sum toward the attributed fraction; dotted substages
(``execute.device``, ``admit.queue``, ``store.flush``) attribute time
*within* an enclosing stage and are reported but excluded from the sum
— counting both would attribute the same microseconds twice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from pio_tpu_torch.obs.metrics import bucket_quantile


def _ms(v: Optional[float]) -> Optional[float]:
    return round(v * 1e3, 4) if v is not None else None


def _merged_stage_cells(hist) -> Dict[str, list]:
    """stage name -> cells (a tracer with extra labels, e.g. per-engine,
    has one cell per (labels, stage) combination)."""
    out: Dict[str, list] = {}
    for values, cell in list(hist._cells.items()):
        out.setdefault(values[-1], []).append(cell)
    return out


def _merge_snapshots(cells, pool: bool) -> Tuple[List[int], float, int]:
    buckets: List[int] = []
    total, count = 0.0, 0
    for cell in cells:
        b, s, c = cell._snapshot(pool)
        if not buckets:
            buckets = list(b)
        else:
            buckets = [x + y for x, y in zip(buckets, b)]
        total += s
        count += c
    return buckets, total, count


# pio: endpoint=/debug/hotpath.json
def hotpath_payload(tracer, e2e_cell, stage_order: Sequence[str] = (),
                    pool: bool = True,
                    slow_threshold_s: Optional[float] = None) -> dict:
    """The ``/debug/hotpath.json`` body for one instrumented path.

    ``tracer`` supplies the per-stage histogram; ``e2e_cell`` is the
    end-to-end (accept→write) latency histogram cell the same requests
    were observed into. ``pool`` reads shm-aggregated values when the
    cells are bound (pool workers then all report the pool-wide budget).
    """
    hist = tracer.stage_histogram
    e2e_buckets, e2e_sum, e2e_count = e2e_cell._snapshot(pool)
    edges = e2e_cell._edges

    payload: dict = {
        "path": tracer.name,
        "requestCount": e2e_count,
        "e2e": {
            "avgMs": _ms(e2e_sum / e2e_count) if e2e_count else None,
            "p50Ms": _ms(bucket_quantile(edges, e2e_buckets,
                                          e2e_count, 0.50)),
            "p95Ms": _ms(bucket_quantile(edges, e2e_buckets,
                                          e2e_count, 0.95)),
        },
        "stages": [],
        "substages": [],
    }
    if slow_threshold_s is not None:
        payload["slowThresholdMs"] = _ms(slow_threshold_s)
    if hist is None:
        return payload

    by_stage = _merged_stage_cells(hist)
    order = [s for s in stage_order if s in by_stage]
    order += sorted(s for s in by_stage if s not in order)

    attributed_s = 0.0
    for stage in order:
        buckets, total, count = _merge_snapshots(by_stage[stage], pool)
        top_level = "." not in stage
        entry = {
            "stage": stage,
            "count": count,
            # budget: stage seconds amortized over REQUESTS, so stages
            # that run for a subset of requests still sum correctly
            "avgMs": _ms(total / e2e_count) if e2e_count else None,
            "p50Ms": _ms(bucket_quantile(hist.buckets, buckets,
                                          count, 0.50)),
            "p95Ms": _ms(bucket_quantile(hist.buckets, buckets,
                                          count, 0.95)),
        }
        if top_level and e2e_count:
            attributed_s += total / e2e_count
        payload["stages" if top_level else "substages"].append(entry)

    if e2e_count and e2e_sum > 0:
        e2e_avg = e2e_sum / e2e_count
        payload["attributedMsPerRequest"] = _ms(attributed_s)
        payload["attributedFraction"] = round(attributed_s / e2e_avg, 4)
        payload["residualMsPerRequest"] = _ms(e2e_avg - attributed_s)
        payload["residualFraction"] = round(
            1.0 - attributed_s / e2e_avg, 4
        )
    return payload
