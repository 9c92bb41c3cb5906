"""Storage layer: SPI traits, backends, registry, columnar event frames.

The port's copy of ``pio_tpu/storage/__init__.py`` (the port imports
nothing of ``pio_tpu``). Backends: in-memory, SQLite (the quickstart
default), the native event log (the at-scale event store), Parquet shards
(bulk reads), the searchable SQLite + FTS5 store, LocalFS model files and
the content-addressed blob store. The registry (:class:`Storage`) picks
them from ``PIO_STORAGE_*``; the heavier backends load on first use.
"""

from pio_tpu_torch.storage.base import (
    AccessKeys,
    Apps,
    Channels,
    EngineInstances,
    EvaluationInstances,
    LEvents,
    Models,
    PEvents,
    StorageError,
)
from pio_tpu_torch.storage.frame import EventFrame
from pio_tpu_torch.storage.records import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EvaluationInstance,
    Model,
    RunStatus,
)
from pio_tpu_torch.storage.registry import Storage, StorageConfigError, pio_home

#: exported name → its module, imported on first access (pyarrow, the
#: native build and the FTS tables stay out of a plain ``import``)
_LAZY = {
    "EventLogEvents": "eventlog",
    "ParquetPEvents": "parquet",
    "SearchableClient": "searchable",
    "SearchableEvents": "searchable",
    "SearchableApps": "searchable",
    "SearchableEngineInstances": "searchable",
    "SearchableEvaluationInstances": "searchable",
    "SearchError": "searchable",
    "BlobBackend": "blobstore",
    "BlobModels": "blobstore",
    "FileBlobBackend": "blobstore",
    "HTTPBlobBackend": "blobstore",
    "open_blob_backend": "blobstore",
    "register_blob_scheme": "blobstore",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


__all__ = [
    "AccessKey",
    "AccessKeys",
    "App",
    "Apps",
    "Channel",
    "Channels",
    "EngineInstance",
    "EngineInstances",
    "EvaluationInstance",
    "EvaluationInstances",
    "EventFrame",
    "LEvents",
    "Model",
    "Models",
    "PEvents",
    "RunStatus",
    "Storage",
    "StorageConfigError",
    "StorageError",
    "pio_home",
    *_LAZY,
]
