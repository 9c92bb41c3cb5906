"""Helpers shared by the query server and batch predict — one copy of the
serve-path plumbing so online and offline scoring can't drift apart.

The port's copy of ``pio_tpu/workflow/deploy_common.py`` (the port imports
nothing of ``pio_tpu``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.workflow.engine_json import EngineVariant


def to_jsonable(obj: Any) -> Any:
    """Prediction object → JSON-able structure (to_dict > dataclass > raw)."""
    if hasattr(obj, "to_dict"):
        return obj.to_dict()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    return obj


def resolve_instance_id(
    variant: EngineVariant, instance_id: Optional[str]
) -> str:
    """Explicit id, or the latest COMPLETED instance for this variant."""
    if instance_id is not None:
        return instance_id
    latest = Storage.get_meta_data_engine_instances().get_latest_completed(
        variant.engine_id,
        variant.engine_version,
        variant.path or variant.engine_id,
    )
    if latest is None:
        raise RuntimeError(
            f"no COMPLETED engine instance for engine "
            f"{variant.engine_id!r} - run train first"
        )
    return latest.id


def resolve_query_class(pairs: Sequence[Tuple[Any, Any]]) -> Optional[type]:
    """The single query dataclass declared by the algorithms (None = raw
    dict queries). Conflicting declarations are an engine bug."""
    query_classes = {getattr(algo, "query_class", None) for algo, _ in pairs}
    query_classes.discard(None)
    if not query_classes:
        return None
    if len(query_classes) > 1:
        raise ValueError(
            "algorithms declare conflicting query classes: "
            + ", ".join(sorted(c.__name__ for c in query_classes))
        )
    (qc,) = query_classes
    return qc
