"""Storage registry — env-var-driven backend wiring.

The port's copy of ``pio_tpu/storage/registry.py`` (the port imports
nothing of ``pio_tpu``), with every backend of the reference but the
partitioned log. Three
repositories (METADATA, EVENTDATA, MODELDATA) each bound to a named source;
sources declare a backend type, in the same ``PIO_STORAGE_*`` scheme:

    PIO_STORAGE_REPOSITORIES_METADATA_SOURCE=DB
    PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE=DB
    PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE=FS
    PIO_STORAGE_SOURCES_DB_TYPE=sqlite
    PIO_STORAGE_SOURCES_DB_PATH=/path/to/pio.db
    PIO_STORAGE_SOURCES_FS_TYPE=localfs
    PIO_STORAGE_SOURCES_FS_PATH=/path/to/models

Unset → the quickstart defaults under ``$PIO_TPU_HOME`` (default
``~/.pio_tpu``): SQLite at ``pio.db`` for metadata and events, localfs
under ``models`` for models. Backend types, with the reference's
repository rules:

- ``sqlite`` and ``memory``: every repository;
- ``eventlog`` (events only): the native C++ append-only log, the
  at-scale event store (``PATH`` a directory, default
  ``$PIO_TPU_HOME/eventlog``);
- ``parquet`` (events, bulk PEvents only): Parquet shards (``PATH`` a
  directory, default ``$PIO_TPU_HOME/events``); ``get_levents`` refuses it;
- ``searchable`` (aliases ``fts`` and ``elasticsearch``): SQLite + FTS5
  search over events, apps and run metadata, for METADATA and EVENTDATA
  (and the plain model table for MODELDATA); ``PATH`` a database file,
  default ``$PIO_TPU_HOME/pio-search.db``;
- ``localfs`` (models only);
- ``blob`` (models only): content-addressed, URI-schemed (``PATH``
  ``file:///dir`` or ``http://host:port`` of ``pio blobserver``; default
  ``file://$PIO_TPU_HOME/blobmodels``).

- ``partlog`` (events only): the partitioned, replicated event log
  (``PATH`` a directory, default ``$PIO_TPU_HOME/partlog``; partitions,
  segment size and followers from ``PIO_TPU_PARTLOG_*`` /
  ``PIO_TPU_REPL_*``).
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Dict, Optional

from pio_tpu_torch.storage import base
from pio_tpu_torch.storage.localfs import LocalFSModels
from pio_tpu_torch.storage.memory import (
    MemAccessKeys,
    MemApps,
    MemChannels,
    MemEngineInstances,
    MemEvaluationInstances,
    MemLEvents,
    MemModels,
    MemPEvents,
)
from pio_tpu_torch.storage.sqlite import (
    SQLiteAccessKeys,
    SQLiteApps,
    SQLiteChannels,
    SQLiteClient,
    SQLiteEngineInstances,
    SQLiteEvaluationInstances,
    SQLiteEvents,
    SQLiteModels,
    SQLitePEvents,
)
from pio_tpu_torch.utils import knobs

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")


class StorageConfigError(base.StorageError):
    pass


_homes_made: set = set()


def pio_home() -> str:
    home = knobs.knob_str("PIO_TPU_HOME") or os.path.join(
        os.path.expanduser("~"), ".pio_tpu"
    )
    if home not in _homes_made:  # once per path — this sits on the
        os.makedirs(home, exist_ok=True)  # per-request ingest hot path
        _homes_made.add(home)
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
    return cfg


class Storage:
    """Process-wide registry with per-config caching (thread-safe)."""

    _lock = threading.RLock()
    _clients: Dict[str, object] = {}
    _mem: Dict[str, object] = {}
    _facades: Dict[str, object] = {}  # hot-path store facades (reset-scoped)
    _reset_hooks: list = []  # weakref-wrapped callables

    @classmethod
    def add_reset_hook(cls, hook) -> None:
        """Register a callable invoked by :meth:`reset` — for caches
        OUTSIDE the registry that hold records read through it (e.g. the
        event server's positive access-key cache, which must not keep
        authenticating keys from a store that was just reset). Bound
        methods are held weakly so registering never pins a server.

        Registration drops the hooks whose referent is gone and does not
        add a hook already registered, so the list stays as long as the
        live hooks, however many servers are built between resets."""
        try:
            ref = weakref.WeakMethod(hook)
        except TypeError:  # plain function/lambda: hold directly
            ref = (lambda h=hook: h)
        with cls._lock:
            live = [r for r in cls._reset_hooks if r() is not None]
            if not any(r() == hook for r in live):
                live.append(ref)
            cls._reset_hooks = live

    # -- internal -----------------------------------------------------------
    @classmethod
    def _sqlite_client(cls, cfg: _SourceConfig) -> SQLiteClient:
        path = cfg.path or os.path.join(pio_home(), "pio.db")
        key = f"sqlite:{path}"
        with cls._lock:
            if key not in cls._clients:
                cls._clients[key] = SQLiteClient(path)
            return cls._clients[key]

    @classmethod
    def _searchable_client(cls, cfg: _SourceConfig):
        from pio_tpu_torch.storage.searchable import SearchableClient

        path = cfg.path or os.path.join(pio_home(), "pio-search.db")
        key = f"searchable:{path}"
        with cls._lock:
            if key not in cls._clients:
                cls._clients[key] = SearchableClient(path)
            return cls._clients[key]

    @classmethod
    def _eventlog(cls, cfg: _SourceConfig):
        from pio_tpu_torch.storage.eventlog import EventLogEvents

        path = cfg.path or os.path.join(pio_home(), "eventlog")
        key = f"eventlog:{path}"
        with cls._lock:
            if key not in cls._clients:
                cls._clients[key] = EventLogEvents(path)
            return cls._clients[key]

    @classmethod
    def _partlog(cls, cfg: _SourceConfig):
        from pio_tpu_torch.storage.partlog import PartitionedEventLog

        path = cfg.path or os.path.join(pio_home(), "partlog")
        key = f"partlog:{path}"
        with cls._lock:
            if key not in cls._clients:
                cls._clients[key] = PartitionedEventLog(path)
            return cls._clients[key]

    @classmethod
    def _memory(cls, kind: str, factory):
        with cls._lock:
            if kind not in cls._mem:
                cls._mem[kind] = factory()
            return cls._mem[kind]

    @classmethod
    def reset(cls) -> None:
        """Drop cached clients and memory stores (tests use this between
        isolated homes), then run the reset hooks."""
        with cls._lock:
            cls._clients.clear()
            cls._mem.clear()
            cls._facades.clear()
            hooks = list(cls._reset_hooks)
        _homes_made.clear()  # re-create homes on next touch
        for ref in hooks:  # outside the lock: hooks take their own locks
            hook = ref()
            if hook is not None:
                hook()
        with cls._lock:
            cls._reset_hooks = [r for r in cls._reset_hooks if r() is not None]

    # -- metadata stores ----------------------------------------------------
    @classmethod
    def _meta(cls, sqlite_cls, mem_kind: str, mem_factory,
              searchable_cls_name: str = ""):
        cfg = _source_config("METADATA")
        if cfg.type == "sqlite":
            return sqlite_cls(cls._sqlite_client(cfg))
        if cfg.type == "memory":
            return cls._memory(mem_kind, mem_factory)
        if cfg.type == "searchable":
            # the same relational traits + FTS5 search() where the store
            # has a searchable body (apps, run records); imported lazily
            from pio_tpu_torch.storage import searchable

            impl = (getattr(searchable, searchable_cls_name)
                    if searchable_cls_name else sqlite_cls)
            return impl(cls._searchable_client(cfg))
        raise StorageConfigError(f"backend {cfg.type!r} cannot serve METADATA")

    @classmethod
    def get_meta_data_apps(cls) -> base.Apps:
        return cls._meta(SQLiteApps, "apps", MemApps, "SearchableApps")

    @classmethod
    def get_meta_data_access_keys(cls) -> base.AccessKeys:
        return cls._meta(SQLiteAccessKeys, "access_keys", MemAccessKeys)

    @classmethod
    def get_meta_data_channels(cls) -> base.Channels:
        return cls._meta(SQLiteChannels, "channels", MemChannels)

    @classmethod
    def get_meta_data_engine_instances(cls) -> base.EngineInstances:
        return cls._meta(
            SQLiteEngineInstances, "engine_instances", MemEngineInstances,
            "SearchableEngineInstances",
        )

    @classmethod
    def get_meta_data_evaluation_instances(cls) -> base.EvaluationInstances:
        return cls._meta(
            SQLiteEvaluationInstances, "evaluation_instances",
            MemEvaluationInstances, "SearchableEvaluationInstances",
        )

    @classmethod
    def sqlite_clients(cls) -> Dict[str, SQLiteClient]:
        """repository label → SQLiteClient for every repository configured
        on the sqlite or searchable backend (opening a client applies
        pending schema migrations): the surface of `pio upgrade`; raises
        StorageConfigError on misconfiguration."""
        out: Dict[str, SQLiteClient] = {}
        for repo in REPOSITORIES:
            cfg = _source_config(repo)
            if cfg.type == "sqlite":
                out[repo] = cls._sqlite_client(cfg)
            elif cfg.type == "searchable":
                # the searchable store rides the same schema and migration
                # ladder: `pio upgrade` must see it too
                out[repo] = cls._searchable_client(cfg)
        return out

    # -- event stores -------------------------------------------------------
    @classmethod
    def get_levents(cls) -> base.LEvents:
        # the one facade on the per-request ingest hot path, memoized
        # KEYED ON the config env fingerprint — a caller that swaps
        # PIO_STORAGE_*/PIO_TPU_HOME without Storage.reset() still gets
        # the right backend (tests re-home per case this way)
        env = os.environ
        src = env.get("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE")
        fp = (env.get("PIO_TPU_HOME"), src)
        if src:
            fp += (env.get(f"PIO_STORAGE_SOURCES_{src}_TYPE"),
                   env.get(f"PIO_STORAGE_SOURCES_{src}_PATH"))
        hit = cls._facades.get("levents")
        if hit is not None and hit[0] == fp:
            return hit[1]
        with cls._lock:
            # build INSIDE the lock: reset() clears _facades under the
            # same lock, so a facade built from pre-reset env config can
            # never be stored into the post-reset cache
            hit = cls._facades.get("levents")
            if hit is not None and hit[0] == fp:
                return hit[1]
            built = cls._build_levents()
            cls._facades["levents"] = (fp, built)
            return built

    @classmethod
    def _build_levents(cls) -> base.LEvents:
        cfg = _source_config("EVENTDATA")
        if cfg.type == "sqlite":
            return SQLiteEvents(cls._sqlite_client(cfg))
        if cfg.type == "memory":
            return cls._memory("levents", MemLEvents)
        if cfg.type == "eventlog":
            return cls._eventlog(cfg)
        if cfg.type == "partlog":
            return cls._partlog(cfg)
        if cfg.type == "searchable":
            from pio_tpu_torch.storage.searchable import SearchableEvents

            return SearchableEvents(cls._searchable_client(cfg))
        if cfg.type == "parquet":
            raise StorageConfigError(
                "parquet backend is bulk-only (PEvents); pair it with sqlite "
                "or memory LEvents via a second source"
            )
        raise StorageConfigError(f"backend {cfg.type!r} cannot serve EVENTDATA")

    @classmethod
    def get_pevents(cls) -> base.PEvents:
        cfg = _source_config("EVENTDATA")
        if cfg.type == "sqlite":
            return SQLitePEvents(SQLiteEvents(cls._sqlite_client(cfg)))
        if cfg.type == "memory":
            return MemPEvents(cls._memory("levents", MemLEvents))
        if cfg.type == "eventlog":
            return base.PEventsAdapter(cls._eventlog(cfg))
        if cfg.type == "partlog":
            return base.PEventsAdapter(cls._partlog(cfg))
        if cfg.type == "searchable":
            from pio_tpu_torch.storage.searchable import SearchableEvents

            return SQLitePEvents(SearchableEvents(cls._searchable_client(cfg)))
        if cfg.type == "parquet":
            from pio_tpu_torch.storage.parquet import ParquetPEvents

            return ParquetPEvents(cfg.path or os.path.join(pio_home(), "events"))
        raise StorageConfigError(f"backend {cfg.type!r} cannot serve EVENTDATA")

    # -- model store --------------------------------------------------------
    @classmethod
    def get_model_data_models(cls) -> base.Models:
        cfg = _source_config("MODELDATA")
        if cfg.type == "sqlite":
            return SQLiteModels(cls._sqlite_client(cfg))
        if cfg.type == "memory":
            return cls._memory("models", MemModels)
        if cfg.type == "localfs":
            return LocalFSModels(cfg.path or os.path.join(pio_home(), "models"))
        if cfg.type == "searchable":
            # model blobs have no searchable body; the plain sqlite trait
            # over the same file serves them
            return SQLiteModels(cls._searchable_client(cfg))
        if cfg.type == "blob":
            from pio_tpu_torch.storage.blobstore import (
                BlobModels, open_blob_backend,
            )

            uri = cfg.path or "file://" + os.path.join(pio_home(), "blobmodels")
            return BlobModels(open_blob_backend(uri))
        raise StorageConfigError(f"backend {cfg.type!r} cannot serve MODELDATA")

    # -- health -------------------------------------------------------------
    @classmethod
    def verify_all_data_objects(cls) -> Dict[str, bool]:
        """Connectivity self-check used by ``pio status``
        (reference ``Storage.verifyAllDataObjects``)."""
        checks = {
            "METADATA/apps": cls.get_meta_data_apps,
            "METADATA/access_keys": cls.get_meta_data_access_keys,
            "METADATA/channels": cls.get_meta_data_channels,
            "METADATA/engine_instances": cls.get_meta_data_engine_instances,
            "METADATA/evaluation_instances": cls.get_meta_data_evaluation_instances,
            "EVENTDATA/pevents": cls.get_pevents,
            "MODELDATA/models": cls.get_model_data_models,
        }
        # parquet serves the bulk interface only — probing LEvents there
        # would flag a correctly configured deployment as broken. A broken
        # EVENTDATA config must still be reported, not raised.
        try:
            eventdata_type = _source_config("EVENTDATA").type
        except StorageConfigError:
            eventdata_type = None
        if eventdata_type != "parquet":
            checks["EVENTDATA/levents"] = cls.get_levents
        out = {}
        for name, fn in checks.items():
            try:
                fn()
                out[name] = True
            except Exception:  # a broken config is reported, not raised
                out[name] = False
        return out
