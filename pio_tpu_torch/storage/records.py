"""Metadata records stored by the meta-data stores.

Rebuild of the reference's ``data/.../data/storage/{Apps,Channels,
EngineInstances,Models}.scala`` case classes (UNVERIFIED paths; see
SURVEY.md provenance warning).

The port's copy of ``pio_tpu/storage/records.py`` (the port imports nothing
of ``pio_tpu``).
"""

from __future__ import annotations

import datetime as _dt
import secrets
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


@dataclass(frozen=True)
class App:
    """A logical application namespace for events (reference ``App``)."""

    id: int
    name: str
    description: Optional[str] = None


@dataclass(frozen=True)
class AccessKey:
    """API key granting event ingest/query for one app.

    ``events`` is the whitelist of event names the key may write; empty means
    all (reference ``AccessKey``).
    """

    key: str
    app_id: int
    events: Tuple[str, ...] = ()

    @staticmethod
    def generate(app_id: int, events: Tuple[str, ...] = ()) -> "AccessKey":
        return AccessKey(key=secrets.token_urlsafe(32), app_id=app_id, events=events)


@dataclass(frozen=True)
class Channel:
    """A named event sub-stream within an app (reference ``Channel``)."""

    id: int
    name: str
    app_id: int

    NAME_CONSTRAINT = "channel names must be 1-16 chars, alphanumeric or '-'"

    @staticmethod
    def is_valid_name(name: str) -> bool:
        return (
            0 < len(name) <= 16
            and all(c.isalnum() or c == "-" for c in name)
        )


class RunStatus:
    """Engine/Evaluation instance lifecycle states (reference status strings)."""

    INIT = "INIT"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    ABORTED = "ABORTED"
    FAILED = "FAILED"


@dataclass(frozen=True)
class EngineInstance:
    """Record of one training run (reference ``EngineInstance``).

    Params are stored as JSON strings, exactly as the reference keeps the
    ``engine.json`` fragments that produced the run.
    """

    id: str
    status: str
    start_time: _dt.datetime
    end_time: _dt.datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict = field(default_factory=dict)
    jax_conf: dict = field(default_factory=dict)  # reference: sparkConf
    data_source_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"

    def with_status(self, status: str) -> "EngineInstance":
        return replace(self, status=status, end_time=_utcnow())


@dataclass(frozen=True)
class EvaluationInstance:
    """Record of one evaluation run (reference ``EvaluationInstance``)."""

    id: str
    status: str
    start_time: _dt.datetime
    end_time: _dt.datetime
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: dict = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""

    def with_status(self, status: str) -> "EvaluationInstance":
        return replace(self, status=status, end_time=_utcnow())


@dataclass(frozen=True)
class Model:
    """A trained model blob keyed by engine-instance id (reference ``Model``)."""

    id: str
    models: bytes
