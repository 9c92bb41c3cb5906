"""CoreWorkflow — the training and evaluation runs, with their bookkeeping.

Counterpart of ``pio_tpu/workflow/core_workflow.py``: record an
EngineInstance as RUNNING, run ``Engine.train``, persist the models as one
pickled blob with a checksum manifest, and mark the run COMPLETED with its
per-phase seconds — or FAILED with the error recorded.
:func:`load_models_for_instance` verifies and loads the blob for serving.
:func:`run_evaluation` sweeps an evaluation's engine params (``pio eval``)
and records an EvaluationInstance with the winner.

A persisted model holds host values only: every tensor in it is pickled
as a numpy array, so a blob holds no CUDA storage. Loading puts the
tensors on the device the caller's context names, so a model trained on
the card loads on the CPU and the reverse. A blob that fails verification
falls back, given the variant, to the newest older COMPLETED instance whose
blob verifies (last known good), as in the reference. With
``WorkflowParams.checkpoint_every`` the run names a snapshot directory,
keyed on the variant and its params unless ``checkpoint_dir`` is given,
and ``Engine.train`` snapshots each algorithm there.

Each run records its step stream into a trainwatch ``StepRecorder`` (the
``/train.json`` of ``pio train --status-port``) under a device watch
(``/device.json``), and appends one row to the run ledger,
``$PIO_TPU_HOME/runs/<engine-id>.jsonl``, COMPLETED or FAILED
(best-effort: a ledger that cannot be written never fails the run).
``WorkflowParams.profile_dir`` takes a ``torch.profiler`` trace of the
whole train there (``obs/profile.py``).

With ``PIO_TPU_SHARDED_PERSIST=1`` the shardable models' big arrays go
out as per-shard records and a shard manifest before the blob
(``workflow/shard_store.py``; shards → shard manifest → blob → blob
manifest), one shard a device of the run, and a load reassembles them on
any device count. Under a process group every rank trains: an algorithm
whose class sets ``splits_over_group`` (the ALS ones, the text MLP,
logreg, two-tower and the sequence model) splits its work over the
ranks, and naive Bayes trains a whole copy on each rank (a warning names
it). Only the coordinator (rank 0)
writes: the engine instance, the models, the run ledger row and the
profile trace; the other ranks wait at a barrier and return the
coordinator's instance id. Each run is a trace of :data:`TRAIN_TRACER`
whose spans are its phases (``Engine.train``'s and ``persist``), so the
log records of a phase carry the run's trace id. A model that is a
:class:`~pio_tpu_torch.controller.components.PersistentModel` persists
itself (its ``save`` returning True), and the blob keeps None in its
place; a ``save`` that returns False falls back to the blob. A load gets
such a model from its algorithm's ``model_class.load``, from the same
instance as the blob.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime as _dt
import hashlib
import io
import json as _json
import logging
import pickle
import traceback
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from pio_tpu_torch import DeviceLike
from pio_tpu_torch.controller.components import PersistentModel
from pio_tpu_torch.controller.engine import Engine, EngineParams
from pio_tpu_torch.controller.evaluation import (
    EngineParamsGenerator,
    Evaluation,
    MetricEvaluator,
    MetricEvaluatorResult,
)
from pio_tpu_torch.controller.params import params_to_dict, params_to_json
from pio_tpu_torch.obs import devicewatch, trainwatch
from pio_tpu_torch.obs.metrics import REGISTRY, monotonic_s
from pio_tpu_torch.obs.tracing import Tracer
from pio_tpu_torch.obs.profile import trace
from pio_tpu_torch.parallel import distributed
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.records import (
    EngineInstance,
    EvaluationInstance,
    Model,
    RunStatus,
)
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.workflow.engine_json import EngineVariant
from pio_tpu_torch.workflow import shard_store
from pio_tpu_torch.workflow.params import WorkflowParams

log = logging.getLogger("pio_tpu_torch.workflow")

#: the training-run tracer (process-global registry): every run lands in
#: its ring and feeds pio_tpu_train_stage_seconds, labelled by the
#: phases (read / prepare / train.<i>_<algo> / persist). Wide buckets:
#: reads take milliseconds, a large ALS run minutes.
TRAIN_TRACER = Tracer(
    "train", registry=REGISTRY,
    stages=("read", "prepare", "persist"),
    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
             300.0, 1800.0, 7200.0),
)

#: Models-store id suffix of the checksum manifest written next to each
#: pickled blob: {"sha256": ..., "size": ...}. Blob first, manifest second,
#: as in the reference.
MANIFEST_SUFFIX = ".manifest"


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device → its values as a host numpy array."""
    return t.detach().cpu().numpy()


def _tensor_from_host(array: np.ndarray) -> torch.Tensor:
    """The unpickling side of :class:`_HostPickler`: a CPU tensor (a
    :class:`_DeviceUnpickler` puts it on its device instead)."""
    return torch.from_numpy(array)


class _HostPickler(pickle.Pickler):
    """Pickles every tensor as a host numpy array."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return _tensor_from_host, (_to_host(obj),)
        return NotImplemented


class _DeviceUnpickler(pickle.Unpickler):
    """Unpickles :class:`_HostPickler`'s tensors onto ``device``."""

    def __init__(self, file, device: torch.device):
        super().__init__(file)
        self.device = device

    def find_class(self, module, name):
        if (module, name) == (__name__, _tensor_from_host.__name__):
            return lambda array: torch.from_numpy(array).to(self.device)
        return super().find_class(module, name)


def serialize_models(models: Sequence[Any]) -> bytes:
    """Default model persistence (≙ reference Kryo blob): one pickle of the
    model list, every tensor in it as a host numpy array."""
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(list(models))
    return buf.getvalue()


def deserialize_models(blob: bytes, device: DeviceLike = "cpu") -> List[Any]:
    """The models of :func:`serialize_models`, their tensors on ``device``.
    Unpickle only blobs this program wrote."""
    return _DeviceUnpickler(io.BytesIO(blob), torch.device(device)).load()


def run_train(
    engine: Engine,
    engine_params: EngineParams,
    variant: EngineVariant,
    workflow_params: WorkflowParams = WorkflowParams(),
    ctx: Optional[ComputeContext] = None,
) -> str:
    """Train + persist; returns the engine-instance id (reference
    ``CoreWorkflow.runTrain``). ``ctx`` defaults to a CUDA context seeded
    with ``workflow_params.seed``."""
    if ctx is None:
        ctx = ComputeContext.create(seed=workflow_params.seed)
    if ctx.group is not None:
        whole = [n for n, _ in engine_params.algorithm_params_list
                 if not engine.algorithm_class_map[n].splits_over_group]
        if whole:
            log.warning(
                "process group of %d ranks: %s train a whole copy on every "
                "rank and only rank 0's is kept (naive Bayes has no "
                "multi-device path, as in the reference)", ctx.world_size,
                whole)
    if ctx.group is not None and not ctx.is_coordinator:
        return _run_train_rank(engine, engine_params, workflow_params, ctx)
    instances = Storage.get_meta_data_engine_instances()
    now = _utcnow()
    instance = EngineInstance(
        id="",
        status=RunStatus.RUNNING,
        start_time=now,
        end_time=now,
        engine_id=variant.engine_id,
        engine_version=variant.engine_version,
        engine_variant=variant.path or variant.engine_id,
        engine_factory=variant.engine_factory,
        batch=workflow_params.batch,
        env={},
        jax_conf=variant.jax_conf,
        data_source_params=params_to_json(engine_params.data_source_params),
        preparator_params=params_to_json(engine_params.preparator_params),
        algorithms_params=_json.dumps(
            [
                {"name": n, "params": params_to_dict(p)}
                for n, p in engine_params.algorithm_params_list
            ],
            sort_keys=True,
        ),
        serving_params=params_to_json(engine_params.serving_params),
    )
    instance_id = instances.insert(instance)
    instance = instances.get(instance_id)
    if ctx.group is not None:
        # the other ranks return this id
        torch.distributed.broadcast_object_list([instance_id], src=0)
    log.info("training started: instance %s on %s", instance_id, ctx.device)

    if workflow_params.checkpoint_every > 0:
        from pio_tpu_torch.workflow.checkpoint import (
            default_checkpoint_dir,
            state_fingerprint,
        )

        # the default dir keys on the engine variant + params (not the
        # per-run instance id): a preempted run restarted with the same
        # config finds its snapshots; the data fingerprint recorded
        # inside guards against resuming across a data change
        stable_key = state_fingerprint(
            variant.engine_id,
            variant.engine_factory,
            instance.data_source_params,
            instance.preparator_params,
            instance.algorithms_params,
        )
        ckpt_dir = workflow_params.checkpoint_dir or default_checkpoint_dir(
            stable_key
        )
        ctx = dataclasses.replace(
            ctx,
            checkpoint_base=ckpt_dir,
            checkpoint_every=workflow_params.checkpoint_every,
        )

    # the telemetry plane: the recorder collects the step stream of the
    # training loops, renders /train.json for the status sidecar, and
    # lands in the run ledger on exit
    recorder = trainwatch.StepRecorder(instance_id, variant.engine_id)
    params_hash = hashlib.sha256(
        "\n".join([
            instance.data_source_params or "",
            instance.preparator_params or "",
            instance.algorithms_params or "",
            instance.serving_params or "",
        ]).encode()
    ).hexdigest()[:16]

    def _append_run_record(status: str, train_s: float, timings: dict,
                           error: Optional[str] = None) -> None:
        # best-effort by design: a full disk or a torn runs dir must
        # never fail (or un-fail) the run itself
        try:
            rec = trainwatch.run_record(
                run_id=instance_id,
                engine_id=variant.engine_id,
                status=status,
                train_seconds=train_s,
                phases={
                    k.replace(":", "."): float(v)
                    for k, v in recorder.phases.items()
                } or {
                    k.replace(":", "."): float(v)
                    for k, v in timings.items()
                },
                params_hash=params_hash,
                step_summary=recorder.summary(),
                num_devices=ctx.num_devices,
                error=error,
            )
            path = trainwatch.append_run(rec)
            log.info("run record appended to %s", path)
        except Exception as exc:
            log.warning("run-ledger append failed: %s", exc)

    t0 = monotonic_s()
    timings: dict = {}
    try:
        # the device watch samples memory and attributes the trainers'
        # first dispatches for the run's duration; the status sidecar
        # serves its payload as /device.json while steps stream
        with trainwatch.recording(recorder), devicewatch.watching(
            devicewatch.DeviceWatch(device=ctx.device)
        ), TRAIN_TRACER.trace(
            "train", instanceId=instance_id, engineId=variant.engine_id
        ) as tr:
            with contextlib.ExitStack() as stack:
                if workflow_params.profile_dir:
                    # a torch.profiler trace of the whole train
                    stack.enter_context(trace(
                        workflow_params.profile_dir,
                        cuda=ctx.device.type == "cuda"))
                models = engine.train(
                    ctx,
                    engine_params,
                    skip_sanity_check=workflow_params.skip_sanity_check,
                    stop_after_read=workflow_params.stop_after_read,
                    stop_after_prepare=workflow_params.stop_after_prepare,
                    timings=timings,
                )
            train_s = monotonic_s() - t0
            if (workflow_params.stop_after_read
                    or workflow_params.stop_after_prepare):
                instances.update(instance.with_status(RunStatus.ABORTED))
                log.info("run %s aborted early by stop-after flag",
                         instance_id)
                return instance_id

            recorder.set_phase("persist")
            t_persist = monotonic_s()
            with tr.span("persist"):
                # a PersistentModel handles itself (save() True); every
                # other model goes into the Models store's pickled blob
                persisted_externally = [
                    isinstance(m, PersistentModel)
                    and bool(m.save(instance_id, algo_params, ctx))
                    for (_, algo_params), m in zip(
                        engine_params.algorithm_params_list, models)
                ]
                models_store = Storage.get_model_data_models()
                blob_models = [None if ext else m for ext, m
                               in zip(persisted_externally, models)]
                if shard_store.sharded_persist_enabled():
                    # shard records + shard manifest before the blob,
                    # which keeps placeholders: a torn persist leaves
                    # shards without a blob, never a blob naming missing
                    # shards
                    blob_models = shard_store.save_sharded(
                        models_store, instance_id, blob_models,
                        n_shards=ctx.num_devices,
                        mesh_shape=[ctx.num_devices],
                    )
                blob = serialize_models(blob_models)
                models_store.insert(Model(id=instance_id, models=blob))
                manifest = _json.dumps(
                    {"sha256": hashlib.sha256(blob).hexdigest(),
                     "size": len(blob)},
                    sort_keys=True,
                ).encode()
                models_store.insert(
                    Model(id=instance_id + MANIFEST_SUFFIX, models=manifest)
                )
            timings["persist"] = round(monotonic_s() - t_persist, 3)
            recorder.set_phase_seconds("persist", timings["persist"])
            recorder.set_phase("done")

            instances.update(dataclasses.replace(
                instance.with_status(RunStatus.COMPLETED),
                env={
                    "train_seconds": f"{train_s:.3f}",
                    "num_devices": str(ctx.num_devices),
                    "device": str(ctx.device),
                    # per-phase wall seconds (read / prepare /
                    # train:<i>_<algo> / persist)
                    **{f"phase_{k}": str(v) for k, v in timings.items()},
                },
            ))
            _append_run_record("COMPLETED", train_s, timings)
            log.info("training finished: instance %s (%.2fs, %d model(s))",
                     instance_id, train_s, len(models))
            if ctx.group is not None:
                distributed.barrier()  # the run is written: ranks go on
            return instance_id
    except Exception:
        err = traceback.format_exc()
        instances.update(dataclasses.replace(
            instance.with_status(RunStatus.FAILED), env={"error": err[-4000:]}
        ))
        # failed runs land in the ledger too: a crash is trend data
        _append_run_record("FAILED", monotonic_s() - t0, timings, error=err)
        log.error("training FAILED: instance %s\n%s", instance_id, err)
        raise


def _run_train_rank(engine: Engine, engine_params: EngineParams,
                    workflow_params: WorkflowParams,
                    ctx: ComputeContext) -> str:
    """A rank other than the coordinator in :func:`run_train`: take the
    coordinator's instance id, train (the collectives pair with the
    coordinator's), write nothing, and wait at the barrier until the
    coordinator has persisted the run."""
    got = [None]
    torch.distributed.broadcast_object_list(got, src=0)
    instance_id = got[0]
    log.info("training started: rank %d of instance %s on %s", ctx.rank,
             instance_id, ctx.device)
    recorder = trainwatch.StepRecorder(instance_id, "")
    with trainwatch.recording(recorder):
        engine.train(
            ctx, engine_params,
            skip_sanity_check=workflow_params.skip_sanity_check,
            stop_after_read=workflow_params.stop_after_read,
            stop_after_prepare=workflow_params.stop_after_prepare,
            timings={},
        )
    if not (workflow_params.stop_after_read
            or workflow_params.stop_after_prepare):
        distributed.barrier()
    return instance_id


def _verified_blob_models(
    models_store, instance_id: str, device: torch.device,
    n_devices: Optional[int] = None,
) -> List[Any]:
    """Fetch + checksum-verify + deserialize one instance's model blob.

    Raises RuntimeError on a missing record, a checksum mismatch against
    the instance's manifest, or a blob that fails to unpickle. A missing
    manifest (pre-manifest instance, or crash between blob and manifest
    writes) loads unverified, as in the reference.
    """
    record = models_store.get(instance_id)
    if record is None:
        raise RuntimeError(f"no models stored for instance {instance_id!r}")
    manifest = models_store.get(instance_id + MANIFEST_SUFFIX)
    if manifest is not None:
        try:
            want = _json.loads(manifest.models.decode("utf-8"))["sha256"]
        except Exception as e:
            raise RuntimeError(
                f"unreadable model manifest for instance {instance_id!r}: {e}"
            ) from e
        got = hashlib.sha256(record.models).hexdigest()
        if got != want:
            raise RuntimeError(
                f"model blob for instance {instance_id!r} failed checksum "
                f"verification (manifest {want}, blob {got})"
            )
    try:
        models = deserialize_models(record.models, device)
    except Exception as e:
        raise RuntimeError(
            f"model blob for instance {instance_id!r} failed to "
            f"deserialize: {e}"
        ) from e
    # a shard-stripped blob reassembles from its verified shards
    return shard_store.restore_sharded(
        models_store, instance_id, models, n_devices=n_devices,
        device=device,
    )


def load_models_for_instance(
    instance_id: str,
    engine: Engine,
    engine_params: EngineParams,
    ctx: ComputeContext,
    variant: Optional[EngineVariant] = None,
) -> List[Any]:
    """The persisted models of ``instance_id``, their tensors on
    ``ctx.device``, one per algorithm of ``engine_params`` (reference
    ``Engine.prepareDeploy``).

    Raises RuntimeError on a missing record, a blob that fails its
    manifest's checksum or does not unpickle, or a model count that does
    not match ``engine``'s algorithms. With ``variant`` given, a blob that
    fails verification does not fail the load: the loader falls back to
    the newest older COMPLETED instance of the same variant whose blob
    verifies — last known good — and returns that instead.
    """
    models_store = Storage.get_model_data_models()
    try:
        models = _verified_blob_models(models_store, instance_id, ctx.device,
                                       ctx.num_devices)
    except RuntimeError as primary_err:
        if variant is None:
            raise
        log.error(
            "model load for instance %s failed (%s); searching for last "
            "known good", instance_id, primary_err,
        )
        models = None
        candidates = Storage.get_meta_data_engine_instances().get_completed(
            variant.engine_id,
            variant.engine_version,
            variant.path or variant.engine_id,
        )
        for cand in candidates:
            if cand.id == instance_id:
                continue
            try:
                models = _verified_blob_models(models_store, cand.id,
                                               ctx.device, ctx.num_devices)
            except RuntimeError as e:
                log.warning("fallback candidate %s also bad: %s", cand.id, e)
                continue
            log.warning(
                "serving last known good instance %s in place of %s",
                cand.id, instance_id,
            )
            # PersistentModel loads below come from the same instance as
            # the blob, or externally persisted models would mix runs
            instance_id = cand.id
            break
        if models is None:
            raise primary_err
    names = [n for n, _ in engine_params.algorithm_params_list]
    unknown = [n for n in names if n not in engine.algorithm_class_map]
    if len(models) != len(names) or unknown:
        raise RuntimeError(
            f"instance {instance_id!r} holds {len(models)} model(s); the "
            f"engine params name algorithms {names}"
        )
    out = []
    for (name, algo_params), blob_model in zip(
            engine_params.algorithm_params_list, models):
        if blob_model is not None:
            out.append(blob_model)
            continue
        algo_cls = engine.algorithm_class_map[name]
        model_cls = getattr(algo_cls, "model_class", None)
        if model_cls is None or not issubclass(model_cls, PersistentModel):
            raise RuntimeError(
                f"algorithm {name!r}: model was persisted externally but "
                f"{algo_cls.__name__} declares no PersistentModel model_class"
            )
        out.append(model_cls.load(instance_id, algo_params, ctx))
    return out


def run_evaluation(
    evaluation: Evaluation,
    generator: EngineParamsGenerator,
    workflow_params: WorkflowParams = WorkflowParams(),
    ctx: Optional[ComputeContext] = None,
    evaluation_class: str = "",
    generator_class: str = "",
) -> MetricEvaluatorResult:
    """Sweep the generator's engine params, record the winner (reference
    ``EvaluationWorkflow.runEvaluation``). Returns the result; the
    EvaluationInstance row carries its JSON. ``ctx`` defaults to a CUDA
    context seeded with ``workflow_params.seed``."""
    if ctx is None:
        ctx = ComputeContext.create(seed=workflow_params.seed)
    instances = Storage.get_meta_data_evaluation_instances()
    now = _utcnow()
    instance = EvaluationInstance(
        id="",
        status=RunStatus.RUNNING,
        start_time=now,
        end_time=now,
        evaluation_class=evaluation_class or type(evaluation).__name__,
        engine_params_generator_class=(
            generator_class or type(generator).__name__),
        batch=workflow_params.batch,
    )
    instance_id = instances.insert(instance)
    instance = instances.get(instance_id)
    log.info("evaluation started: instance %s on %s", instance_id, ctx.device)
    try:
        evaluator = MetricEvaluator(evaluation.metric, evaluation.other_metrics)
        result = evaluator.evaluate(
            ctx, evaluation.engine, generator.engine_params_list
        )
        instances.update(dataclasses.replace(
            instance.with_status(RunStatus.COMPLETED),
            evaluator_results=f"{result.metric_header}: {result.best_score}",
            evaluator_results_json=result.to_json(),
        ))
        return result
    except Exception:
        err = traceback.format_exc()
        instances.update(dataclasses.replace(
            instance.with_status(RunStatus.FAILED),
            evaluator_results=err[-4000:],
        ))
        log.error("evaluation FAILED: instance %s\n%s", instance_id, err)
        raise
