"""The ``PIO_TPU_*`` environment knobs the port reads, with their defaults.

The port's own reader (the reference's registry is
``pio_tpu/utils/knobs.py``, which the port does not import). A knob not
declared here is a programming error, so a misspelt name raises instead
of reading as unset.
"""

from __future__ import annotations

import os

from pio_tpu_torch.utils import envutil

#: name → the value an unset (or empty) variable means
_DEFAULTS = {
    # scoring placement of the top-N scorer: `device`, `host` or `auto`
    # (by batch size); unset, a scorer on CUDA scores on the card and one
    # on the CPU routes by batch size
    "PIO_TPU_SERVE_DEVICE": "",
    # any value: the ALS host side and the host top-N scorer take their
    # numpy routes instead of the native libraries (pio_tpu_torch/native),
    # which are otherwise built and used; a failed build raises
    "PIO_TPU_NO_NATIVE": "",
    # resident serving parameters (server/residency.py): `1` on, `0` off,
    # `auto` on when the serving device is CUDA
    "PIO_TPU_DEVICE_RESIDENT": "auto",
    # the resident scorer's query wire: `int8`, `float32`, or `auto` (int8
    # when the model carries training scales)
    "PIO_TPU_SERVE_WIRE": "auto",
    # what an acknowledged write means on durable media
    # (storage/durability.py): `commit`, `batch` or `os`
    "PIO_TPU_DURABILITY": "batch",
    # the app of a bundled `pio eval` sweep called with no app name
    # (templates/common.py:eval_app_name)
    "PIO_TPU_EVAL_APP": "",
    # per-device parameter budget in bytes (parallel/partition.py); 0 means
    # no limit
    "PIO_TPU_DEVICE_BUDGET_BYTES": "0",
    # -- serving under concurrency (server/query_server.py, bucketcache.py,
    # batchlane.py, worker_pool.py), the reference's names and defaults --
    # micro-batching window, microseconds; 0 disables
    "PIO_TPU_SERVE_MICROBATCH_US": "0",
    # `0` pins the micro-batcher on instead of probing whether it wins
    "PIO_TPU_SERVE_MICROBATCH_ADAPTIVE": "1",
    # seconds before an "off" probe verdict is measured again (0: never)
    "PIO_TPU_MB_REPROBE_S": "30",
    # comma-separated batch-size bucket ladder override
    "PIO_TPU_BATCH_BUCKETS": "",
    # `1`/`0` force or forbid the bucket warmup sweep
    "PIO_TPU_BUCKET_WARMUP": "",
    # `0` disables the shared-memory batch lane of a device-worker pool
    "PIO_TPU_BATCH_LANE": "1",
    # batch-lane slots per worker, payload bytes per slot, reply wait
    "PIO_TPU_LANE_SLOTS": "64",
    "PIO_TPU_LANE_SLOT_BYTES": "16384",
    "PIO_TPU_LANE_TIMEOUT_S": "0.25",
    # a pool worker's heartbeat age past which /healthz fails
    "PIO_TPU_HEARTBEAT_MAX_AGE_S": "30",
    # -- the device ops plane (obs/profile.py, devicewatch.py,
    # server/train_status.py), the reference's names and defaults --
    # directory for the serving profile hook's traces; unset disables
    "PIO_TPU_PROFILE": "",
    # device executions captured per profile window
    "PIO_TPU_PROFILE_EXECUTIONS": "8",
    # `0` keeps the device watch's sampler thread off
    "PIO_TPU_DEVICEWATCH": "1",
    # device sampler period, seconds
    "PIO_TPU_DEVICEWATCH_INTERVAL_S": "2.0",
    # `pio train`'s status sidecar port: 0 an ephemeral one, negative
    # none
    "PIO_TPU_TRAIN_STATUS_PORT": "0",
    # -- the multi-device paths (parallel/distributed.py, models/als.py,
    # server/query_server.py, workflow/shard_store.py), the reference's
    # names and defaults --
    # `host:port` of rank 0's rendezvous; unset = one process
    "PIO_TPU_COORDINATOR": "",
    # world size of the process group
    "PIO_TPU_NUM_PROCESSES": "",
    # this process's rank
    "PIO_TPU_PROCESS_ID": "",
    # the ALS group wire: `auto`/`compact` ship the encoded edge wire,
    # 1/n a rank, `blocked` the host-packed float32 blocks
    "PIO_TPU_ALS_MESH_WIRE": "auto",
    # `1` serves the recommendation factor tables sharded over the
    # serving devices of the process
    "PIO_TPU_MESH_SERVE": "0",
    # `1` persists shardable models as per-shard records + a shard
    # manifest
    "PIO_TPU_SHARDED_PERSIST": "0",
    # -- the streamed epoch feed (parallel/stream.py) and the failpoints
    # (faults/), the reference's names and defaults --
    # streamed training-span chunk size, MB; <= 0 streams in one chunk
    "PIO_TPU_TRAIN_STREAM_MB": "64",
    # failpoint spec, e.g. `stream.put=error:once`; unset arms nothing
    "PIO_TPU_FAULTS": "",
    # -- the event and model stores (storage/blobstore.py) --
    # bearer key an `http://` blob backend sends to the blob daemon
    "PIO_TPU_BLOB_ACCESS_KEY": "",
    # -- the request plane (obs/slo.py, slog.py, tracing.py, qos/,
    # server/plugins.py), the reference's names and defaults --
    # comma-separated SLO specs, e.g. `p99=50ms:99.9,availability=99.9`
    "PIO_TPU_SLO": "",
    # admission-control spec, e.g. `rps=500,queue=64,deadline=100ms`
    "PIO_TPU_QOS": "",
    # slow-trace capture threshold, ms (0: the tightest latency SLO, else
    # the live p99 once there are 64 requests)
    "PIO_TPU_SLOW_TRACE_MS": "0",
    # `1` renders every log record as one JSON line on stderr
    "PIO_TPU_LOG_JSON": "",
    # entries of the structured-log ring behind /logs.json
    "PIO_TPU_LOG_RING": "512",
    # comma-separated plugin modules imported at server start
    "PIO_TPU_PLUGINS": "",
    # -- the pool plane and the router (obs/fleet.py, server/dashboard.py,
    # router/), the reference's names and defaults --
    # comma-separated `name=host:port` members to scrape or route across
    "PIO_TPU_FLEET_TARGETS": "",
    # fleet scrape period, seconds
    "PIO_TPU_FLEET_INTERVAL_S": "5.0",
    # the dashboard's trainer status sidecar (its /train.json)
    "PIO_TPU_TRAIN_STATUS_URL": "",
    # SLO burn rate above which the router sheds a member
    "PIO_TPU_ROUTER_BURN_LIMIT": "2.0",
    # replication lag where the router's scoring starts to penalise
    "PIO_TPU_ROUTER_LAG_SOFT_BYTES": "67108864.0",
    # hedged second request delay, milliseconds; 0 disables
    "PIO_TPU_ROUTER_HEDGE_MS": "0.0",
    # -- the HTTP fronts (server/http.py, server/evfront.py), the
    # reference's names and defaults --
    # the query server's front: `threaded` or `evloop`
    "PIO_TPU_HTTP_FRONT": "threaded",
    # listen(2) backlog of both fronts, read when a server is built
    "PIO_TPU_HTTP_BACKLOG": "128",
    # a connection silent this long is closed, seconds (both fronts)
    "PIO_TPU_HTTP_IDLE_TIMEOUT_S": "30.0",
    # pipelined requests the evloop front serves between two flushes
    "PIO_TPU_HTTP_MAX_PIPELINE": "16",
    # cap on any request body, MiB (read when server/http.py is imported)
    "PIO_TPU_MAX_BODY_MB": "4096.0",
    # cap on a structured (JSON, form, packed) body, MiB (read at import)
    "PIO_TPU_MAX_JSON_BODY_MB": "64.0",
    # PEM certificate of every threaded server; unset serves plain HTTP
    "PIO_TPU_SSL_CERTFILE": "",
    # PEM private key (unset: the certificate file bundles it)
    "PIO_TPU_SSL_KEYFILE": "",
    # -- ALS (models/als.py) --
    # the item side of the ALS edge wire: `auto`, `delta12` or `planes`
    "PIO_TPU_ALS_ITEM_WIRE": "auto",
}

#: knobs whose value must be positive; another value reads as the default
_POSITIVE = frozenset({
    "PIO_TPU_LANE_SLOTS", "PIO_TPU_LANE_SLOT_BYTES",
    "PIO_TPU_LANE_TIMEOUT_S", "PIO_TPU_HEARTBEAT_MAX_AGE_S",
    "PIO_TPU_PROFILE_EXECUTIONS", "PIO_TPU_FLEET_INTERVAL_S",
    "PIO_TPU_ROUTER_BURN_LIMIT", "PIO_TPU_ROUTER_LAG_SOFT_BYTES",
    "PIO_TPU_HTTP_BACKLOG", "PIO_TPU_HTTP_IDLE_TIMEOUT_S",
    "PIO_TPU_HTTP_MAX_PIPELINE", "PIO_TPU_MAX_BODY_MB",
    "PIO_TPU_MAX_JSON_BODY_MB",
})


def knob_raw(name: str):
    """The knob's stripped value, or None when it is unset or empty (the
    reference's ``knob_raw``: the distributed contract tells "unset" from
    any value)."""
    _DEFAULTS[name]  # a knob not declared here raises KeyError
    v = os.environ.get(name, "").strip()
    return v or None


def knob_str(name: str) -> str:
    """The knob's value, stripped, or its declared default when unset."""
    default = _DEFAULTS[name]
    return os.environ.get(name, "").strip() or default


def knob_int(name: str) -> int:
    """The knob as an integer: :func:`envutil.env_int` with the declared
    default and positivity (a value that is not one warns and reads as the
    default, as the reference's ``knob_int`` does)."""
    return envutil.env_int(name, int(_DEFAULTS[name]),
                           positive=name in _POSITIVE)


def knob_float(name: str) -> float:
    """The knob as a float: :func:`envutil.env_float`, with
    :func:`knob_int`'s fallback (NaN reads as the default too)."""
    return envutil.env_float(name, float(_DEFAULTS[name]),
                             positive=name in _POSITIVE)
