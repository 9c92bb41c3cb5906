"""Length-prefixed replication protocol: leader → follower streaming.

Wire format (all little-endian): each message is
``<u32 header_len><header JSON>`` followed by exactly ``header["len"]``
raw bytes when the header carries a ``len`` field. Messages:

- leader → follower ``{"op": "hello", "partitions": N}`` — handshake;
- follower → leader ``{"op": "state", "pos": {"0": n0, ...}}`` — the
  follower's verified byte position per partition (its torn tails are
  repaired before reporting, so a leader never re-sends into garbage);
- leader → follower ``{"op": "append", "p": k, "pos": start,
  "len": L}`` + L raw framed-record bytes — must land exactly at the
  follower's current position for partition ``k``;
- follower → leader ``{"op": "ack", "p": k, "pos": end}`` — the bytes
  are on the follower's disk (fsynced per ``PIO_TPU_DURABILITY``).

The leader side (:class:`Replicator`) PULLS from the partition segment
logs rather than queueing blobs: each follower link tracks how far it
has shipped, and catch-up after a reconnect and live streaming are the
same code path — read committed bytes past the follower's position,
send, await ack. Reconnects go through ``retrying()`` with decorrelated
jitter and a per-connect deadline, so a restarting follower is re-joined
without a thundering herd.

Durability gating: at ``PIO_TPU_DURABILITY=commit`` the partition flush
calls :meth:`Replicator.wait_acked` before acking the client — a 201
then means the event is on ``PIO_TPU_REPL_MIN_ACKS`` followers' disks.
``batch``/``os`` replicate asynchronously.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

from pio_tpu_torch.utils import knobs
from pio_tpu_torch.faults import FaultInjected, failpoint
from pio_tpu_torch.obs import REGISTRY, monotonic_s
from pio_tpu_torch.qos.deadline import Deadline
from pio_tpu_torch.storage import base
from pio_tpu_torch.storage.durability import IntervalSyncer
from pio_tpu_torch.storage.partlog import framing
from pio_tpu_torch.storage.retry import is_transient, retrying
from pio_tpu_torch.utils.envutil import env_int

log = logging.getLogger("pio_tpu_torch.partlog.repl")

#: comma list of follower addresses (``host:port,host:port``) the leader
#: streams to; empty/unset → replication off
REPLICAS_VAR = "PIO_TPU_PARTLOG_REPLICAS"
#: followers whose acks a commit-durability flush must collect
MIN_ACKS_VAR = "PIO_TPU_REPL_MIN_ACKS"
#: how long a commit-durability flush waits for those acks
ACK_TIMEOUT_VAR = "PIO_TPU_REPL_ACK_TIMEOUT_S"
DEFAULT_ACK_TIMEOUT_S = 2.0
#: per-reconnect-attempt deadline fed to retrying()
CONNECT_DEADLINE_VAR = "PIO_TPU_REPL_CONNECT_DEADLINE_S"

_LEN = struct.Struct("<I")
_MAX_CHUNK = 1 << 20  # catch-up read granularity

_REPL_BYTES = REGISTRY.counter(
    "pio_tpu_repl_bytes_total",
    "Framed record bytes shipped to each follower",
    ("follower",),
)
_REPL_ACKS = REGISTRY.counter(
    "pio_tpu_repl_acks_total",
    "Replication appends acknowledged by each follower",
    ("follower",),
)
_REPL_RECONNECTS = REGISTRY.counter(
    "pio_tpu_repl_reconnects_total",
    "Follower connections (re)established by the leader",
    ("follower",),
)
_REPL_LAG = REGISTRY.gauge(
    "pio_tpu_repl_lag_bytes",
    "Leader committed position minus follower acked position",
    ("partition", "follower"),
)
_ACK_SECONDS = REGISTRY.histogram(
    "pio_tpu_repl_ack_seconds",
    "Send-to-ack round trip of one replication append",
    ("partition", "follower"),
)


def replica_addrs() -> List[Tuple[str, int]]:
    """Parse :data:`REPLICAS_VAR`; bad entries are dropped loudly."""
    raw = knobs.knob_str(REPLICAS_VAR).strip()
    out: List[Tuple[str, int]] = []
    if not raw:
        return out
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        host, _, port = item.rpartition(":")
        try:
            out.append((host or "127.0.0.1", int(port)))
        except ValueError:
            log.warning("ignoring bad %s entry %r", REPLICAS_VAR, item)
    return out


# -- wire helpers ------------------------------------------------------------
def _send_msg(sock: socket.socket, header: dict,
              body: bytes = b"") -> None:
    h = json.dumps(header, separators=(",", ":")).encode()
    sock.sendall(_LEN.pack(len(h)) + h + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("replication peer closed the stream")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> Tuple[dict, bytes]:
    (hlen,) = _LEN.unpack(_recv_exact(sock, 4))
    if hlen > 1 << 20:
        raise base.StorageError(
            f"replication header of {hlen} bytes exceeds the 1 MiB cap"
        )
    header = json.loads(_recv_exact(sock, hlen).decode())
    body = b""
    blen = int(header.get("len", 0))
    if blen:
        body = _recv_exact(sock, blen)
    return header, body


# -- follower ----------------------------------------------------------------
class FollowerServer:
    """Read-replica process endpoint: mirrors each partition stream into
    one append-only file (``p003.repl``) under ``root``, fsyncing per
    the durability mode, and acks every append. The mirrored files are
    valid framed-record streams, so a :class:`PartitionedEventLog`
    promoted from them (``partlog/failover.py``) serves scans directly —
    read-replica serving is "open the follower root"."""

    def __init__(self, root: str, host: str = "127.0.0.1", port: int = 0):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._syncer = IntervalSyncer()
        self._lock = threading.Lock()  # serializes file appends
        self._stop = threading.Event()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self.host, self.port = self._srv.getsockname()[:2]
        self._threads: List[threading.Thread] = []
        self._accept = threading.Thread(
            target=self._accept_loop, name="partlog-follower", daemon=True
        )
        self._accept.start()

    def _path(self, partition: int) -> str:
        return os.path.join(self.root, f"p{partition:03d}.repl")

    def positions(self, partitions: int) -> Dict[int, int]:
        """Verified byte position per partition; torn tails (a follower
        crash mid-append) are repaired — loudly — before reporting, so
        the leader resumes from bytes that actually verify."""
        out: Dict[int, int] = {}
        with self._lock:
            for k in range(partitions):
                path = self._path(k)
                # recovery-time truncation: no append may interleave
                # with the repair, so the fsync stays under the lock
                framing.repair(path)  # pio: disable=lock-blocking-call
                out[k] = (
                    os.path.getsize(path) if os.path.exists(path) else 0
                )
        return out

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # listener closed by stop()
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="partlog-follower-conn", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            hello, _ = _recv_msg(conn)
            if hello.get("op") != "hello":
                raise base.StorageError(
                    f"replication handshake expected hello, got "
                    f"{hello.get('op')!r}"
                )
            partitions = int(hello["partitions"])
            # record the topology beside the mirrors: failover promotion
            # reads the partition count from here
            manifest = os.path.join(self.root, "MANIFEST.json")
            if not os.path.exists(manifest):
                with open(manifest, "w") as f:
                    json.dump({"version": 1, "partitions": partitions}, f)
            pos = self.positions(partitions)
            _send_msg(conn, {
                "op": "state",
                "pos": {str(k): v for k, v in pos.items()},
            })
            while not self._stop.is_set():
                header, body = _recv_msg(conn)
                if header.get("op") != "append":
                    raise base.StorageError(
                        f"unexpected replication op {header.get('op')!r}"
                    )
                k = int(header["p"])
                start = int(header["pos"])
                end = self._append(k, start, body)
                failpoint("repl.ack")
                _send_msg(conn, {"op": "ack", "p": k, "pos": end})
        except (ConnectionError, OSError):
            pass  # leader went away; it reconnects and re-handshakes
        except Exception:
            log.exception("follower connection failed")
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _append(self, partition: int, start: int, data: bytes) -> int:
        path = self._path(partition)
        with self._lock:
            size = os.path.getsize(path) if os.path.exists(path) else 0
            if start != size:
                # positions are contiguous within a connection and
                # re-negotiated by handshake — a mismatch means the
                # streams diverged; drop the connection, never the data
                raise base.StorageError(
                    f"replication position mismatch for partition "
                    f"{partition}: leader sent {start}, follower is at "
                    f"{size}"
                )
            with open(path, "ab") as f:
                f.write(data)
                f.flush()
                if self._syncer.due(path):
                    os.fsync(f.fileno())
                    self._syncer.mark(path)
            return size + len(data)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=1.0)


# -- leader ------------------------------------------------------------------
class _FollowerLink:
    """Leader-side pump for ONE follower: connect → handshake → stream
    everything past the follower's position, forever."""

    def __init__(self, owner, addr: Tuple[str, int], wake: threading.Condition):
        self.owner = owner  # Replicator
        self.addr = addr
        self.label = f"{addr[0]}:{addr[1]}"
        self.wake = wake
        self.sock: Optional[socket.socket] = None
        self.sent: Dict[int, int] = {}
        self.acked: Dict[int, int] = {}
        self.thread = threading.Thread(
            target=self._run, name=f"partlog-repl-{self.label}", daemon=True
        )

    def _connect(self) -> None:
        failpoint("repl.connect")
        s = socket.create_connection(self.addr, timeout=2.0)
        s.settimeout(5.0)
        try:
            _send_msg(s, {
                "op": "hello", "partitions": self.owner.partitions,
            })
            state, _ = _recv_msg(s)
            if state.get("op") != "state":
                raise base.StorageError(
                    f"replication handshake expected state, got "
                    f"{state.get('op')!r}"
                )
            pos = {int(k): int(v) for k, v in state["pos"].items()}
        except Exception:
            s.close()
            raise
        self.sock = s
        self.sent = dict(pos)
        with self.wake:
            self.acked = dict(pos)
            self.wake.notify_all()
        _REPL_RECONNECTS.inc(follower=self.label)
        log.info("replication link up to %s (positions %s)",
                 self.label, pos)

    def _run(self) -> None:
        deadline_s = knobs.knob_float(CONNECT_DEADLINE_VAR)
        while not self.owner.stopped.is_set():
            if self.sock is None:
                try:
                    # jittered, deadline-bounded reconnect: transient
                    # refusals (follower restarting) retry with
                    # decorrelated backoff; a dead follower surfaces
                    # after the deadline and we go around again
                    retrying(
                        self._connect,
                        site="partlog.repl.connect",
                        attempts=8,
                        base_s=0.05,
                        deadline=Deadline(deadline_s * 1000.0),
                        classify=lambda e: isinstance(
                            e, (OSError, FaultInjected)
                        ) or is_transient(e),
                    )
                except Exception as e:
                    if self.owner.stopped.is_set():
                        return
                    log.warning(
                        "replication connect to %s failed (%s); "
                        "retrying", self.label, e,
                    )
                    self.owner.stopped.wait(0.2)
                    continue
            try:
                progressed = self._pump()
            except (ConnectionError, OSError, base.StorageError,
                    FaultInjected) as e:
                log.warning(
                    "replication link to %s dropped: %s", self.label, e
                )
                self._close_sock()
                continue
            if not progressed:
                with self.wake:
                    self.wake.wait(timeout=0.05)

    def _pump(self) -> bool:
        """Ship one round of pending bytes; returns True on progress."""
        progressed = False
        for k in range(self.owner.partitions):
            committed = self.owner.committed(k)
            sent = self.sent.get(k, 0)
            while sent < committed:
                chunk = self.owner.read_range(
                    k, sent, min(committed, sent + _MAX_CHUNK)
                )
                if not chunk:
                    break
                failpoint("repl.send")
                t0 = monotonic_s()
                _send_msg(self.sock, {
                    "op": "append", "p": k, "pos": sent,
                    "len": len(chunk),
                }, chunk)
                ack, _ = _recv_msg(self.sock)
                if ack.get("op") != "ack" or int(ack.get("p", -1)) != k:
                    raise base.StorageError(
                        f"replication expected ack for partition {k}, "
                        f"got {ack!r}"
                    )
                _ACK_SECONDS.observe(
                    monotonic_s() - t0,
                    partition=str(k), follower=self.label,
                )
                sent = int(ack["pos"])
                self.sent[k] = sent
                _REPL_BYTES.inc(len(chunk), follower=self.label)
                _REPL_ACKS.inc(follower=self.label)
                with self.wake:
                    self.acked[k] = sent
                    self.wake.notify_all()
                progressed = True
            _REPL_LAG.set(
                max(committed - self.acked.get(k, 0), 0),
                partition=str(k), follower=self.label,
            )
        return progressed

    def _close_sock(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None


class Replicator:
    """Leader-side replication: one :class:`_FollowerLink` per replica
    address, pulling from the owner's partition segment logs."""

    def __init__(self, owner, addrs: List[Tuple[str, int]]):
        #: owner duck type: ``partitions`` (int), ``committed(k)``,
        #: ``read_range(k, start, end)``
        self._owner = owner
        self.partitions = owner.partitions
        self.stopped = threading.Event()
        self._wake = threading.Condition()
        # the unset default is topology-dependent (1 when replicas are
        # configured, 0 standalone) — a computed default the static
        # registry cannot express, so this one read stays on env_int
        # pio: disable=knob-default-drift
        self.min_acks = env_int(
            MIN_ACKS_VAR, 1 if addrs else 0, positive=False
        )
        if self.min_acks > len(addrs):
            # loud misconfiguration, same policy as durability.mode():
            # silently capping to the replica count would quietly weaken
            # the commit-durability guarantee the operator asked for
            raise base.StorageError(
                f"{MIN_ACKS_VAR}={self.min_acks} exceeds the "
                f"{len(addrs)} replica(s) configured in {REPLICAS_VAR}: "
                "commit durability could never collect that many acks"
            )
        self.ack_timeout_s = knobs.knob_float(ACK_TIMEOUT_VAR)
        self._links = [
            _FollowerLink(self, a, self._wake) for a in addrs
        ]
        for link in self._links:
            link.thread.start()

    def committed(self, k: int) -> int:
        return self._owner.committed(k)

    def read_range(self, k: int, start: int, end: int) -> bytes:
        return self._owner.read_range(k, start, end)

    def notify(self) -> None:
        """New committed bytes: wake the link pumps."""
        with self._wake:
            self._wake.notify_all()

    def wait_acked(self, partition: int, pos: int,
                   timeout_s: Optional[float] = None) -> None:
        """Block until ``min_acks`` followers acked ``>= pos`` for the
        partition; raises StorageError on timeout. The commit-durability
        gate: called INSIDE the partition flush, so the group-commit 201
        implies follower durability. The error message deliberately does
        not say "unreachable" — an ack timeout must fail fast to the
        circuit breaker, not burn the request's budget in retries."""
        if timeout_s is None:
            timeout_s = self.ack_timeout_s
        need = self.min_acks  # construction guarantees <= len(links)
        if need <= 0:
            return
        deadline = monotonic_s() + timeout_s
        with self._wake:
            while True:
                got = sum(
                    1 for link in self._links
                    if link.acked.get(partition, 0) >= pos
                )
                if got >= need:
                    return
                remaining = deadline - monotonic_s()
                if remaining <= 0:
                    raise base.StorageError(
                        f"replication ack timeout: {got}/{need} "
                        f"followers acked partition {partition} to "
                        f"{pos} within {timeout_s:.2f}s"
                    )
                self._wake.wait(timeout=remaining)

    # pio: endpoint=/storage.json
    def lag_snapshot(self) -> List[dict]:
        """Topology view: per (follower, partition) acked positions."""
        out = []
        with self._wake:
            for link in self._links:
                out.append({
                    "follower": link.label,
                    "connected": link.sock is not None,
                    "acked": {
                        str(k): link.acked.get(k, 0)
                        for k in range(self.partitions)
                    },
                })
        return out

    def stop(self) -> None:
        self.stopped.set()
        self.notify()
        for link in self._links:
            link._close_sock()
            link.thread.join(timeout=2.0)
