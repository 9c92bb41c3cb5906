"""Storage registry — env-var-driven backend wiring.

The port's copy of ``pio_tpu/storage/registry.py`` (the port imports
nothing of ``pio_tpu``), cut to the backends ported so far. Three
repositories (METADATA, EVENTDATA, MODELDATA) each bound to a named source;
sources declare a backend type, in the same ``PIO_STORAGE_*`` scheme:

    PIO_STORAGE_REPOSITORIES_METADATA_SOURCE=MEM
    PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE=MEM
    PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE=FS
    PIO_STORAGE_SOURCES_MEM_TYPE=memory
    PIO_STORAGE_SOURCES_FS_TYPE=localfs
    PIO_STORAGE_SOURCES_FS_PATH=/path/to/models

Backend types: ``memory`` (every repository) and ``localfs`` (models
only). Every other type — ``sqlite``, ``parquet``, ``eventlog``,
``partlog``, ``searchable`` and ``blob`` — raises
:class:`StorageConfigError` as not yet ported, and so does an unset
METADATA or EVENTDATA repository, whose quickstart default is ``sqlite``:
there is no quiet fallback to memory. An unset MODELDATA repository is
``localfs`` under ``$PIO_TPU_HOME/models`` (default ``~/.pio_tpu``).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from pio_tpu_torch.storage import base
from pio_tpu_torch.storage.localfs import LocalFSModels
from pio_tpu_torch.storage.memory import (
    MemApps,
    MemChannels,
    MemEngineInstances,
    MemEvaluationInstances,
    MemLEvents,
    MemModels,
    MemPEvents,
)

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")

#: backend types of the reference that the port does not have yet
NOT_PORTED = ("sqlite", "parquet", "eventlog", "partlog", "searchable", "blob")


class StorageConfigError(base.StorageError):
    pass


def pio_home() -> str:
    home = os.environ.get("PIO_TPU_HOME") or os.path.join(
        os.path.expanduser("~"), ".pio_tpu"
    )
    os.makedirs(home, exist_ok=True)
    return home


class _SourceConfig:
    def __init__(self, name: str, type_: str, path: Optional[str]):
        self.name = name
        self.type = type_
        self.path = path


#: config aliases → canonical backend type, as in the reference
_TYPE_ALIASES = {"fts": "searchable", "elasticsearch": "searchable"}


def _source_config(repo: str) -> _SourceConfig:
    src_name = os.environ.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "")
    if src_name:
        type_ = os.environ.get(f"PIO_STORAGE_SOURCES_{src_name}_TYPE")
        if not type_:
            raise StorageConfigError(
                f"source {src_name!r} referenced by {repo} has no "
                f"PIO_STORAGE_SOURCES_{src_name}_TYPE"
            )
        path = os.environ.get(f"PIO_STORAGE_SOURCES_{src_name}_PATH")
        t = type_.lower()
        cfg = _SourceConfig(src_name, _TYPE_ALIASES.get(t, t), path)
    elif repo == "MODELDATA":  # quickstart defaults
        cfg = _SourceConfig("DEFAULT_FS", "localfs", None)
    else:
        cfg = _SourceConfig("DEFAULT_SQLITE", "sqlite", None)
    if cfg.type in NOT_PORTED:
        raise StorageConfigError(
            f"{repo}: backend {cfg.type!r} (source {cfg.name}) is not yet "
            f"ported to pio_tpu_torch; use 'memory'"
            + (" or 'localfs'" if repo == "MODELDATA" else "")
        )
    return cfg


class Storage:
    """Process-wide registry with per-config caching (thread-safe)."""

    _lock = threading.RLock()
    _mem: Dict[str, object] = {}

    @classmethod
    def _memory(cls, kind: str, factory):
        with cls._lock:
            if kind not in cls._mem:
                cls._mem[kind] = factory()
            return cls._mem[kind]

    @classmethod
    def reset(cls) -> None:
        """Drop the memory stores (tests use this between isolated runs)."""
        with cls._lock:
            cls._mem.clear()

    # -- metadata stores ----------------------------------------------------
    @classmethod
    def _meta(cls, kind: str, factory):
        cfg = _source_config("METADATA")
        if cfg.type == "memory":
            return cls._memory(kind, factory)
        raise StorageConfigError(f"backend {cfg.type!r} cannot serve METADATA")

    @classmethod
    def get_meta_data_apps(cls) -> base.Apps:
        return cls._meta("apps", MemApps)

    @classmethod
    def get_meta_data_channels(cls) -> base.Channels:
        return cls._meta("channels", MemChannels)

    @classmethod
    def get_meta_data_engine_instances(cls) -> base.EngineInstances:
        return cls._meta("engine_instances", MemEngineInstances)

    @classmethod
    def get_meta_data_evaluation_instances(cls) -> base.EvaluationInstances:
        return cls._meta("evaluation_instances", MemEvaluationInstances)

    # -- event stores -------------------------------------------------------
    @classmethod
    def get_levents(cls) -> base.LEvents:
        cfg = _source_config("EVENTDATA")
        if cfg.type == "memory":
            return cls._memory("levents", MemLEvents)
        raise StorageConfigError(f"backend {cfg.type!r} cannot serve EVENTDATA")

    @classmethod
    def get_pevents(cls) -> base.PEvents:
        return MemPEvents(cls.get_levents())

    # -- model store --------------------------------------------------------
    @classmethod
    def get_model_data_models(cls) -> base.Models:
        cfg = _source_config("MODELDATA")
        if cfg.type == "memory":
            return cls._memory("models", MemModels)
        if cfg.type == "localfs":
            return LocalFSModels(cfg.path or os.path.join(pio_home(), "models"))
        raise StorageConfigError(f"backend {cfg.type!r} cannot serve MODELDATA")
