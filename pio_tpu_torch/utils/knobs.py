"""The ``PIO_TPU_*`` environment knobs the port reads, with their defaults.

The port's own registry (the reference's is ``pio_tpu/utils/knobs.py``,
which the port does not import): every knob is declared here once, with
its parse kind, default and a one-line doc. A knob not declared here is a
programming error, so a misspelt name raises instead of reading as unset.

``python -m pio_tpu_torch lint`` holds the tree to it: ``knob-default-drift``
flags a ``PIO_TPU_*`` read that bypasses this table or reads it as another
kind, and ``knob-doc-drift`` keeps ``pio_tpu_torch/KNOBS.md`` equal to
:func:`markdown_table` (regenerate it with ``python -m
pio_tpu_torch.utils.knobs``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from pio_tpu_torch.utils import envutil


@dataclass(frozen=True)
class Knob:
    """One declared configuration knob."""

    name: str
    kind: str                      # "int" | "float" | "str"
    default: object                # the value an unset (or empty) env means
    doc: str
    positive: bool = False         # numeric knobs: a value <= 0 reads as default

    def default_repr(self) -> str:
        """The default as it appears in the knob table's cell."""
        return "(empty)" if self.default == "" else str(self.default)


_DECLARATIONS: Tuple[Knob, ...] = (
    # -- serving placement and wires --------------------------------------
    Knob("PIO_TPU_SERVE_DEVICE", "str", "",
         "top-N scoring placement: `device`, `host` or `auto` (by batch "
         "size); unset, a scorer on CUDA scores on the card and one on "
         "the CPU routes by batch size"),
    Knob("PIO_TPU_NO_NATIVE", "str", "",
         "any value takes the numpy routes instead of the native host "
         "libraries (pio_tpu_torch/native)"),
    Knob("PIO_TPU_DEVICE_RESIDENT", "str", "auto",
         "resident serving parameters: `1` on, `0` off, `auto` on when "
         "the serving device is CUDA"),
    Knob("PIO_TPU_SERVE_WIRE", "str", "auto",
         "the resident scorer's query wire: `int8`, `float32`, or `auto` "
         "(int8 when the model carries training scales)"),
    Knob("PIO_TPU_EVAL_APP", "str", "",
         "the app of a bundled `pio eval` sweep called with no app name"),
    Knob("PIO_TPU_DEVICE_BUDGET_BYTES", "int", 0,
         "per-device parameter budget, bytes; 0 means no limit"),
    # -- serving under concurrency ----------------------------------------
    Knob("PIO_TPU_SERVE_MICROBATCH_US", "float", 0.0,
         "micro-batching window, microseconds; 0 disables"),
    Knob("PIO_TPU_SERVE_MICROBATCH_ADAPTIVE", "str", "1",
         "`0` pins the micro-batcher on instead of probing whether it wins"),
    Knob("PIO_TPU_MB_REPROBE_S", "float", 30.0,
         "seconds before an `off` probe verdict is measured again "
         "(0: never)"),
    Knob("PIO_TPU_BATCH_BUCKETS", "str", "",
         "comma-separated batch-size bucket ladder override"),
    Knob("PIO_TPU_BUCKET_WARMUP", "str", "",
         "`1`/`0` force or forbid the bucket warmup sweep"),
    Knob("PIO_TPU_BATCH_LANE", "str", "1",
         "`0` disables the shared-memory batch lane of a device-worker "
         "pool"),
    Knob("PIO_TPU_LANE_SLOTS", "int", 64,
         "batch-lane slots per worker", positive=True),
    Knob("PIO_TPU_LANE_SLOT_BYTES", "int", 16384,
         "payload bytes per batch-lane slot", positive=True),
    Knob("PIO_TPU_LANE_TIMEOUT_S", "float", 0.25,
         "batch-lane reply wait, seconds", positive=True),
    Knob("PIO_TPU_HEARTBEAT_MAX_AGE_S", "float", 30.0,
         "a pool worker's heartbeat age past which /healthz fails",
         positive=True),
    # -- the device ops plane ---------------------------------------------
    Knob("PIO_TPU_PROFILE", "str", "",
         "directory for the serving profile hook's traces; unset disables"),
    Knob("PIO_TPU_PROFILE_EXECUTIONS", "int", 8,
         "device executions captured per profile window", positive=True),
    Knob("PIO_TPU_DEVICEWATCH", "str", "1",
         "`0` keeps the device watch's sampler thread off"),
    Knob("PIO_TPU_DEVICEWATCH_INTERVAL_S", "float", 2.0,
         "device sampler period, seconds"),
    Knob("PIO_TPU_TRAIN_STATUS_PORT", "int", 0,
         "`pio train`'s status sidecar port: 0 an ephemeral one, "
         "negative none"),
    # -- the multi-device paths -------------------------------------------
    Knob("PIO_TPU_COORDINATOR", "str", "",
         "`host:port` of rank 0's rendezvous; unset = one process"),
    Knob("PIO_TPU_NUM_PROCESSES", "str", "",
         "world size of the process group"),
    Knob("PIO_TPU_PROCESS_ID", "str", "", "this process's rank"),
    Knob("PIO_TPU_ALS_MESH_WIRE", "str", "auto",
         "the ALS group wire: `auto`/`compact` ship the encoded edge "
         "wire, `blocked` the host-packed float32 blocks"),
    Knob("PIO_TPU_MESH_SERVE", "str", "0",
         "`1` serves the recommendation factor tables sharded over the "
         "serving devices of the process"),
    Knob("PIO_TPU_SHARDED_PERSIST", "str", "0",
         "`1` persists shardable models as per-shard records + a shard "
         "manifest"),
    # -- the streamed epoch feed and the failpoints -----------------------
    Knob("PIO_TPU_TRAIN_STREAM_MB", "float", 64.0,
         "streamed training-span chunk size, MB; <= 0 streams in one "
         "chunk"),
    Knob("PIO_TPU_FAULTS", "str", "",
         "failpoint spec, e.g. `stream.put=error:once`; unset arms "
         "nothing"),
    # -- storage / durability ---------------------------------------------
    Knob("PIO_TPU_HOME", "str", "",
         "state directory root; unset means `~/.pio_tpu`"),
    Knob("PIO_TPU_DURABILITY", "str", "batch",
         "what an acknowledged write means on durable media: `commit`, "
         "`batch` or `os`"),
    Knob("PIO_TPU_BLOB_ACCESS_KEY", "str", "",
         "bearer key an `http://` blob backend sends to the blob daemon"),
    Knob("PIO_TPU_PARTLOG_PARTITIONS", "int", 4,
         "partitioned-log partition count (the manifest wins on reopen)",
         positive=True),
    Knob("PIO_TPU_PARTLOG_SEGMENT_BYTES", "int", 4 * 1024 * 1024,
         "partitioned-log segment roll size, bytes", positive=True),
    Knob("PIO_TPU_PARTLOG_REPLICAS", "str", "",
         "comma-separated follower `host:port` replica addresses"),
    Knob("PIO_TPU_REPL_MIN_ACKS", "int", 1,
         "follower acks required per append (1 when replicas are "
         "configured, else 0)"),
    Knob("PIO_TPU_REPL_ACK_TIMEOUT_S", "float", 2.0,
         "replication ack wait, seconds", positive=True),
    Knob("PIO_TPU_REPL_CONNECT_DEADLINE_S", "float", 10.0,
         "replication connect retry deadline, seconds", positive=True),
    # -- the request plane ------------------------------------------------
    Knob("PIO_TPU_SLO", "str", "",
         "comma-separated SLO specs, e.g. "
         "`p99=50ms:99.9,availability=99.9`"),
    Knob("PIO_TPU_QOS", "str", "",
         "admission-control spec, e.g. `rps=500,queue=64,deadline=100ms`"),
    Knob("PIO_TPU_SLOW_TRACE_MS", "float", 0.0,
         "slow-trace capture threshold, ms (0: the tightest latency SLO, "
         "else the live p99 once there are 64 requests)"),
    Knob("PIO_TPU_LOG_JSON", "str", "",
         "`1` renders every log record as one JSON line on stderr"),
    Knob("PIO_TPU_LOG_RING", "int", 512,
         "entries of the structured-log ring behind /logs.json"),
    Knob("PIO_TPU_PLUGINS", "str", "",
         "comma-separated plugin modules imported at server start"),
    # -- the pool plane and the router ------------------------------------
    Knob("PIO_TPU_FLEET_TARGETS", "str", "",
         "comma-separated `name=host:port` members to scrape or route "
         "across"),
    Knob("PIO_TPU_FLEET_INTERVAL_S", "float", 5.0,
         "fleet scrape period, seconds", positive=True),
    Knob("PIO_TPU_TRAIN_STATUS_URL", "str", "",
         "the dashboard's trainer status sidecar (its /train.json)"),
    Knob("PIO_TPU_ROUTER_BURN_LIMIT", "float", 2.0,
         "SLO burn rate above which the router sheds a member",
         positive=True),
    Knob("PIO_TPU_ROUTER_LAG_SOFT_BYTES", "float", 64.0 * 1024 * 1024,
         "replication lag where the router's scoring starts to penalise",
         positive=True),
    Knob("PIO_TPU_ROUTER_HEDGE_MS", "float", 0.0,
         "hedged second request delay, milliseconds; 0 disables"),
    # -- the HTTP fronts --------------------------------------------------
    Knob("PIO_TPU_HTTP_FRONT", "str", "threaded",
         "the query server's front: `threaded` or `evloop`"),
    Knob("PIO_TPU_HTTP_BACKLOG", "int", 128,
         "listen(2) backlog of both fronts, read when a server is built",
         positive=True),
    Knob("PIO_TPU_HTTP_IDLE_TIMEOUT_S", "float", 30.0,
         "a connection silent this long is closed, seconds (both fronts)",
         positive=True),
    Knob("PIO_TPU_HTTP_MAX_PIPELINE", "int", 16,
         "pipelined requests the evloop front serves between two flushes",
         positive=True),
    Knob("PIO_TPU_MAX_BODY_MB", "float", 4096.0,
         "cap on any request body, MiB (read when server/http.py is "
         "imported)", positive=True),
    Knob("PIO_TPU_MAX_JSON_BODY_MB", "float", 64.0,
         "cap on a structured (JSON, form, packed) body, MiB (read at "
         "import)", positive=True),
    Knob("PIO_TPU_SSL_CERTFILE", "str", "",
         "PEM certificate of every threaded server; unset serves plain "
         "HTTP"),
    Knob("PIO_TPU_SSL_KEYFILE", "str", "",
         "PEM private key (unset: the certificate file bundles it)"),
    # -- ALS --------------------------------------------------------------
    Knob("PIO_TPU_ALS_ITEM_WIRE", "str", "auto",
         "the item side of the ALS edge wire: `auto`, `delta12` or "
         "`planes`"),
    # -- debug ------------------------------------------------------------
    Knob("PIO_TPU_DEBUG_SYNC", "str", "",
         "`1`/`raise`/`log` arms the instrumented lock runtime (read when "
         "a lock is created)"),
)

#: name -> declaration; the canonical knob inventory
KNOBS: Dict[str, Knob] = {k.name: k for k in _DECLARATIONS}


def get(name: str) -> Knob:
    """The declaration for ``name`` (KeyError when undeclared)."""
    return KNOBS[name]


def all_knobs() -> Tuple[Knob, ...]:
    """Every declaration, sorted by name."""
    return tuple(sorted(_DECLARATIONS, key=lambda k: k.name))


def knob_raw(name: str) -> Optional[str]:
    """The knob's stripped value, or None when it is unset or empty (the
    reference's ``knob_raw``: the distributed contract tells "unset" from
    any value)."""
    get(name)  # a knob not declared here raises KeyError
    v = os.environ.get(name, "").strip()
    return v or None


def knob_str(name: str) -> str:
    """The knob's value, stripped, or its declared default when unset."""
    return os.environ.get(name, "").strip() or str(get(name).default)


def knob_int(name: str) -> int:
    """The knob as an integer: :func:`envutil.env_int` with the declared
    default and positivity (a value that is not one warns and reads as the
    default, as the reference's ``knob_int`` does)."""
    k = get(name)
    return envutil.env_int(name, int(k.default), positive=k.positive)


def knob_float(name: str) -> float:
    """The knob as a float: :func:`envutil.env_float`, with
    :func:`knob_int`'s fallback (NaN reads as the default too)."""
    k = get(name)
    return envutil.env_float(name, float(k.default), positive=k.positive)


def markdown_table() -> str:
    """The body of ``pio_tpu_torch/KNOBS.md``: one row a knob."""
    lines = ["| Knob | Type | Default | Description |",
             "| --- | --- | --- | --- |"]
    for k in all_knobs():
        lines.append(
            f"| `{k.name}` | {k.kind} | `{k.default_repr()}` | {k.doc} |"
        )
    return "\n".join(lines)


if __name__ == "__main__":  # regenerates pio_tpu_torch/KNOBS.md's table
    print(markdown_table())
