"""Sharded model persistence: per-shard records + a shard manifest.

The port of ``pio_tpu/workflow/shard_store.py``. Models that implement
:class:`ShardableModel` persist their large arrays as **per-shard
records** in the Models store (row slices along dim 0, one per training
device) plus a **shard manifest** recording the saved mesh shape, every
array's shape, dtype and partition spec, and a sha256 per shard. The
pickled blob keeps :class:`ShardPlaceholder` markers where the arrays
were. The manifest is the reference's, field for field: the same arrays
give the same JSON bytes.

Write order is crash-safe by construction: shards → shard manifest →
blob → blob manifest. A crash anywhere leaves either a previous
generation intact or a stripped blob whose manifest is missing or does
not verify; both raise at load, and the loader's last-known-good fallback
takes over.

Shards are plain row slices, so loading on another device count is
concat + re-place (counted by ``pio_tpu_shard_reshard_total``): a model
saved over 4 devices loads on 2 or 1 unchanged.

Gate: ``PIO_TPU_SHARDED_PERSIST=1`` (default off: the single-blob path is
unchanged). Failpoint ``shard.reshard`` fires on a load that reshards.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json as _json
import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.obs.metrics import REGISTRY
from pio_tpu_torch.storage.records import Model
from pio_tpu_torch.utils import knobs

log = logging.getLogger("pio_tpu_torch.workflow")

#: Models-store id suffix of the per-instance shard manifest.
SHARD_MANIFEST_SUFFIX = ".shards"

_SHARD_RESHARD = REGISTRY.counter(
    "pio_tpu_shard_reshard_total",
    "Sharded checkpoint loads whose device count differed from the "
    "mesh shape the shards were saved on (concat + re-place)",
)


@dataclasses.dataclass(frozen=True)
class ShardPlaceholder:
    """Marks a stripped array inside a pickled blob; the real bytes live
    in shard records named by the shard manifest."""

    name: str
    shape: Tuple[int, ...]
    dtype: str


class ShardableModel:
    """Protocol mixin for models whose big arrays persist sharded.

    Subclasses set ``shard_template`` (a partition-rule registry name)
    and implement :meth:`shard_arrays` (name → host array of every
    tensor to persist sharded) and :meth:`replace_shard_arrays` (a copy
    with those arrays swapped: placeholders in at save, restored tensors
    at load).
    """

    # plain class attribute, not an annotated field: dataclass subclasses
    # must not inherit it as a defaulted field ahead of their own
    shard_template = ""

    def shard_arrays(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def replace_shard_arrays(self, arrays: Dict[str, Any]):
        raise NotImplementedError


def sharded_persist_enabled() -> bool:
    """True when ``PIO_TPU_SHARDED_PERSIST=1``."""
    return knobs.knob_str("PIO_TPU_SHARDED_PERSIST") == "1"


def is_stripped(model: Any) -> bool:
    """True if ``model`` carries :class:`ShardPlaceholder` leaves."""
    if not isinstance(model, ShardableModel):
        return False
    return any(
        isinstance(v, ShardPlaceholder) for v in model.shard_arrays().values()
    )


def _spec_to_json(spec) -> List[Any]:
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


def _spec_entries(model: ShardableModel, arrays: Dict[str, np.ndarray]):
    """name → partition spec (JSON-ready) from the model's rule template."""
    from pio_tpu_torch.parallel.partition import match_partition_rules, rules_for

    try:
        rules = rules_for(model.shard_template)
    except KeyError:
        rules = []
    specs = match_partition_rules(rules, arrays)
    return {name: _spec_to_json(specs[name]) for name in arrays}


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_sharded(
    models_store,
    instance_id: str,
    models: List[Any],
    n_shards: int,
    mesh_shape: Optional[List[int]] = None,
) -> List[Any]:
    """Persist every ShardableModel's arrays as shard records; returns
    the blob-ready model list with those arrays stripped to placeholders.

    Writes the shard records first and the shard manifest last, so a
    partial write never yields a manifest naming missing bytes.
    """
    n_shards = max(1, int(n_shards))
    manifest: Dict[str, Any] = {
        "version": 1,
        "n_shards": n_shards,
        "mesh_shape": list(mesh_shape or [n_shards]),
        "algos": [],
    }
    stripped: List[Any] = list(models)
    any_sharded = False
    for algo_idx, model in enumerate(models):
        if not isinstance(model, ShardableModel):
            manifest["algos"].append(None)
            continue
        arrays = {k: _host(v) for k, v in model.shard_arrays().items()}
        entries = []
        specs = _spec_entries(model, arrays)
        placeholders: Dict[str, Any] = {}
        for arr_idx, (name, arr) in enumerate(sorted(arrays.items())):
            shards = []
            row = 0
            for shard_idx, piece in enumerate(
                np.array_split(arr, n_shards, axis=0)
            ):
                payload = np.ascontiguousarray(piece).tobytes()
                shard_id = (
                    f"{instance_id}.shard.{algo_idx}.{arr_idx}.{shard_idx}"
                )
                models_store.insert(Model(id=shard_id, models=payload))
                shards.append({
                    "id": shard_id,
                    "sha256": hashlib.sha256(payload).hexdigest(),
                    "size": len(payload),
                    "rows": [row, row + len(piece)],
                })
                row += len(piece)
            entries.append({
                "name": name,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "spec": specs[name],
                "shards": shards,
            })
            placeholders[name] = ShardPlaceholder(
                name, tuple(arr.shape), str(arr.dtype)
            )
        manifest["algos"].append(
            {"template": model.shard_template, "arrays": entries}
        )
        stripped[algo_idx] = model.replace_shard_arrays(placeholders)
        any_sharded = True
    if any_sharded:
        models_store.insert(Model(
            id=instance_id + SHARD_MANIFEST_SUFFIX,
            models=_json.dumps(manifest, sort_keys=True).encode(),
        ))
    return stripped


def read_manifest(models_store, instance_id: str) -> dict:
    """The instance's shard manifest; RuntimeError when it is missing or
    unreadable."""
    record = models_store.get(instance_id + SHARD_MANIFEST_SUFFIX)
    if record is None:
        raise RuntimeError(
            f"instance {instance_id!r}: blob is shard-stripped but no "
            f"shard manifest exists (torn sharded persist)"
        )
    try:
        return _json.loads(record.models.decode("utf-8"))
    except Exception as e:
        raise RuntimeError(
            f"unreadable shard manifest for instance {instance_id!r}: {e}"
        ) from e


def restore_sharded(
    models_store,
    instance_id: str,
    models: List[Any],
    n_devices: Optional[int] = None,
    device: Any = "cpu",
) -> List[Any]:
    """Reassemble stripped models from verified shard records, their
    arrays as float tensors on ``device``.

    Every shard is checksummed against the shard manifest before any
    byte is interpreted; a missing manifest, a missing shard or a
    checksum mismatch raises RuntimeError, which the caller's
    last-known-good fallback handles like a torn blob. A device count
    other than the saved mesh's reassembles the same (counted).
    """
    if not any(is_stripped(m) for m in models):
        return models
    manifest = read_manifest(models_store, instance_id)
    algos = manifest.get("algos", [])
    saved_shape = manifest.get("mesh_shape") or [manifest.get("n_shards", 1)]
    if n_devices is not None and int(np.prod(saved_shape)) != int(n_devices):
        failpoint("shard.reshard")
        _SHARD_RESHARD.inc()
        log.info(
            "resharding instance %s: saved on mesh %s, loading on %d "
            "device(s)", instance_id, saved_shape, n_devices,
        )
    out = list(models)
    for algo_idx, model in enumerate(models):
        if not is_stripped(model):
            continue
        if algo_idx >= len(algos) or algos[algo_idx] is None:
            raise RuntimeError(
                f"instance {instance_id!r}: algorithm {algo_idx} is "
                f"shard-stripped but absent from the shard manifest"
            )
        arrays: Dict[str, torch.Tensor] = {}
        for entry in algos[algo_idx]["arrays"]:
            pieces = []
            for shard in entry["shards"]:
                rec = models_store.get(shard["id"])
                if rec is None:
                    raise RuntimeError(
                        f"missing shard record {shard['id']!r} for "
                        f"instance {instance_id!r}"
                    )
                got = hashlib.sha256(rec.models).hexdigest()
                if got != shard["sha256"] or len(rec.models) != shard["size"]:
                    raise RuntimeError(
                        f"shard {shard['id']!r} failed checksum "
                        f"verification (manifest {shard['sha256']}, "
                        f"got {got})"
                    )
                lo, hi = shard["rows"]
                # bytearray: one copy, writable (frombuffer over the
                # record bytes would alias an immutable buffer)
                pieces.append(np.frombuffer(
                    bytearray(rec.models), dtype=entry["dtype"]
                ).reshape([hi - lo] + list(entry["shape"][1:])))
            arr = (np.concatenate(pieces, axis=0) if len(pieces) > 1
                   else pieces[0])
            if list(arr.shape) != list(entry["shape"]):
                raise RuntimeError(
                    f"shard set for {entry['name']!r} reassembles to "
                    f"{list(arr.shape)}, manifest says {entry['shape']}"
                )
            arrays[entry["name"]] = torch.from_numpy(arr).to(device)
        out[algo_idx] = model.replace_shard_arrays(arrays)
    return out


def verify_manifest(models_store, instance_id: str) -> int:
    """Check every shard record of the instance against its manifest's
    sha256 and size; returns the number of shards verified (raises
    RuntimeError on the first that fails)."""
    manifest = read_manifest(models_store, instance_id)
    n = 0
    for algo in manifest.get("algos", []):
        if algo is None:
            continue
        for entry in algo["arrays"]:
            for shard in entry["shards"]:
                rec = models_store.get(shard["id"])
                if rec is None or len(rec.models) != shard["size"] or \
                        hashlib.sha256(rec.models).hexdigest() \
                        != shard["sha256"]:
                    raise RuntimeError(f"shard {shard['id']!r} does not "
                                       "verify against its manifest")
                n += 1
    return n
