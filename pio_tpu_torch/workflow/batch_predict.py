"""Batch predict — bulk offline scoring from a query file.

Rebuild of the reference's ``BatchPredict.main``
(``tools/src/main/scala/o/a/p/workflow/BatchPredict.scala`` [v0.12],
UNVERIFIED path; see SURVEY.md): input file of JSON-lines queries → load the
deployed model → ``Algorithm.batch_predict`` → serving per query → JSON-lines
output. Where the reference distributes via an RDD of queries, algorithms
here can override ``batch_predict`` with one vectorized device program.

The port's copy of ``pio_tpu/workflow/batch_predict.py`` (the port imports
nothing of ``pio_tpu``). The models load onto the context's device: CUDA
unless the caller's context names the CPU.
"""

from __future__ import annotations

import json
import logging
from typing import Optional

from pio_tpu_torch.controller.params import ParamsError, params_from_dict
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.workflow.core_workflow import load_models_for_instance
from pio_tpu_torch.workflow.deploy_common import (
    resolve_instance_id,
    resolve_query_class,
    to_jsonable,
)
from pio_tpu_torch.workflow.engine_json import EngineVariant, build_engine

log = logging.getLogger("pio_tpu_torch.batchpredict")


def run_batch_predict(
    variant: EngineVariant,
    input_path: str,
    output_path: str,
    instance_id: Optional[str] = None,
    ctx: Optional[ComputeContext] = None,
) -> int:
    """Score every query line; returns the number scored. ``ctx``
    defaults to a CUDA context.

    Output lines: ``{"query": ..., "prediction": ...}`` — malformed query
    lines produce ``{"query": ..., "error": ...}`` instead of aborting the
    run (parity with batch ingestion's per-item statuses).
    """
    ctx = ctx or ComputeContext.create()
    engine, engine_params = build_engine(variant)
    instance_id = resolve_instance_id(variant, instance_id)
    models = load_models_for_instance(
        instance_id, engine, engine_params, ctx, variant=variant
    )
    pairs = engine.algorithms_with_models(engine_params, models)
    serving = engine.make_serving(engine_params)
    qc = resolve_query_class(pairs)

    n = 0
    with open(input_path) as fin, open(output_path, "w") as fout:
        # Stage 1: parse queries (keeping raw line pairing for errors)
        parsed = []
        for line in fin:
            line = line.strip()
            if not line:
                continue
            try:
                raw = json.loads(line)
                query = params_from_dict(qc, raw) if qc else raw
                parsed.append((raw, query, None))
            except (json.JSONDecodeError, ParamsError) as e:
                parsed.append((line, None, str(e)))

        # Stage 2: supplement ONCE per query (same semantics as the query
        # server), then batch predict per algorithm (vectorized when
        # overridden)
        supplemented = {
            i: serving.supplement(q)
            for i, (_, q, err) in enumerate(parsed)
            if err is None
        }
        supplied = list(supplemented.items())  # built in ascending-i order
        per_algo = [
            dict(algo.batch_predict(model, supplied)) for algo, model in pairs
        ]

        # Stage 3: serve + write
        for i, (raw, _, err) in enumerate(parsed):
            if err is not None:
                fout.write(json.dumps({"query": raw, "error": err}) + "\n")
                continue
            predictions = [p[i] for p in per_algo]
            result = serving.serve(supplemented[i], predictions)
            fout.write(
                json.dumps(
                    {"query": raw, "prediction": to_jsonable(result)}
                )
                + "\n"
            )
            n += 1
    log.info("batch predict: %d queries scored -> %s", n, output_path)
    return n
