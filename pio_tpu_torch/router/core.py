"""Serving-router core: health-gated affine pick, forward with one
retry, SLO-aware spreading, QoS-vocabulary shedding.

The port's copy of ``pio_tpu/router/core.py`` (the port imports nothing of
``pio_tpu``).

The router is the front tier of the serving fabric: it owns no model
bytes, only a :class:`~pio_tpu_torch.router.ring.Ring` over the configured
members plus a continuously refreshed health/load view (ingested from
the embedded fleet aggregator's ``fleet_payload()``).  Request flow:

1. **pick** — ``router.pick`` failpoint, then rank replicas for the
   entity id (affinity + rendezvous), restricted to routable members
   (not scrape-``down``, not passively forced down, see below).  Keyless
   requests (the packed int8 wire carries no entity id) spread by load
   score with a rotation tiebreak instead.
2. **spread** — replicas whose worst SLO burn is at or past the burn
   limit are demoted behind calm ones; when *every* replica burns,
   classes with a non-zero priority floor (``batchpredict``/``shadow``)
   are shed with the standard QoS vocabulary (503 + ``Retry-After``)
   while ``interactive`` rides the least-burning replica.
3. **forward** — ``router.forward`` failpoint per attempt, then relay
   over a keep-alive upstream connection.  A transport error marks the
   member passively down for ``forced_down_s`` (so the very next pick
   skips it — scrape confirmation follows within two intervals) and the
   request is retried ONCE on the next replica in ring order.  Upstream
   status codes, including 5xx, are relayed as-is: a delivered response
   is the member's answer, not the router's to rewrite.

Shedding raises :class:`Shed`; the daemon maps it onto 429/503 with
``Retry-After`` via the qos helpers so clients see one overload grammar
whether a member or the router said no.
"""

from __future__ import annotations

import http.client
import logging
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

from pio_tpu_torch.utils import knobs
from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.obs import monotonic_s
from pio_tpu_torch.obs.metrics import MetricsRegistry
from pio_tpu_torch.qos.policy import priority_floor
from pio_tpu_torch.router.ring import Ring

log = logging.getLogger("pio_tpu_torch.router")

__all__ = [
    "BURN_LIMIT_ENV",
    "DEFAULT_BURN_LIMIT",
    "DEFAULT_LAG_SOFT_BYTES",
    "HEDGE_ENV",
    "LAG_SOFT_ENV",
    "MemberState",
    "ServingRouter",
    "Shed",
    "UpstreamReply",
]

#: worst-burn at/over which a replica is demoted (and non-interactive
#: classes shed when every replica is there). 2.0 = burning the error
#: budget at twice the sustainable rate, the classic page threshold.
BURN_LIMIT_ENV = "PIO_TPU_ROUTER_BURN_LIMIT"
DEFAULT_BURN_LIMIT = 2.0

#: replication lag that adds +1.0 to a member's load score — soft
#: pressure away from laggy followers, never a hard gate.
LAG_SOFT_ENV = "PIO_TPU_ROUTER_LAG_SOFT_BYTES"
DEFAULT_LAG_SOFT_BYTES = 64 * 1024 * 1024

#: per-request hedge budget in milliseconds: after this long without a
#: primary answer, the same query is fired at the next ring replica and
#: the first answer wins. 0 / unset = hedging off (the default — tail
#: hedging doubles worst-case member load, an operator opt-in).
HEDGE_ENV = "PIO_TPU_ROUTER_HEDGE_MS"

#: headers relayed member-ward: the QoS/trace vocabulary must survive
#: the hop (priority floors honored end-to-end) but hop-by-hop framing
#: must not.
_FORWARD_HEADER_PREFIX = "x-pio-"
_FORWARD_HEADERS = ("content-type", "authorization")
_DROP_REPLY_HEADERS = frozenset(
    ("connection", "keep-alive", "transfer-encoding", "content-length")
)


class Shed(Exception):
    """The router itself refused the request (no routable member, or
    SLO pressure + priority floor). Carries the QoS vocabulary."""

    def __init__(self, status: int, reason: str, retry_after_s: float):
        super().__init__(f"shed: {reason}")
        self.status = status
        self.reason = reason
        self.retry_after_s = retry_after_s


#: (status, reply headers, body bytes, member name)
UpstreamReply = Tuple[int, Dict[str, str], bytes, str]


@dataclass
class MemberState:
    """Router-side view of one serving member."""

    name: str
    base_url: str
    host: str
    port: int
    status: str = "unknown"        # scrape view: up|stale|down|unknown
    burn: float = 0.0              # worst SLO burn across objectives
    lag_bytes: int = 0             # worst follower replication lag
    generation: Optional[str] = None   # last verified-deployed instance
    forced_down_until: float = 0.0     # passive-failure gate (monotonic)
    #: device-budget headroom from the member's fleet row; None until
    #: scraped. <= 0 demotes the member before it burns SLO budget.
    headroom_bytes: Optional[float] = None
    #: aux members (rollout candidates) hold a pooled upstream but never
    #: join the incumbent ring or take undiverted traffic
    aux: bool = False


class _UpstreamPool:
    """Keep-alive ``http.client`` connections to one member; handler
    threads check one out per request and return it after a clean,
    fully-read response (anything else closes it)."""

    def __init__(self, host: str, port: int, timeout_s: float):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self._idle: List[http.client.HTTPConnection] = []
        self._lock = threading.Lock()

    def _checkout(self) -> http.client.HTTPConnection:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout_s
        )

    def _checkin(self, c: http.client.HTTPConnection) -> None:
        with self._lock:
            if len(self._idle) < 8:
                self._idle.append(c)
                return
        c.close()

    def request(self, method, path, body, headers):  # pio: hotpath=zerocopy
        """One relayed exchange; the request body bytes are handed to
        the kernel as-is (no re-encode, no staging copy)."""
        c = self._checkout()
        try:
            c.request(method, path, body=body, headers=headers)
            r = c.getresponse()
            out = r.read()
            reply = {}
            for k, v in r.getheaders():
                if k.lower() not in _DROP_REPLY_HEADERS:
                    reply[k] = v
            status = r.status
            reuse = not r.will_close
        except Exception:
            try:
                c.close()
            except Exception:
                pass
            raise
        if reuse:
            self._checkin(c)
        else:
            c.close()
        return status, reply, out

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for c in idle:
            try:
                c.close()
            except Exception:
                pass


def forward_headers(headers: Dict[str, str]) -> Dict[str, str]:
    """The member-ward header set: ``X-Pio-*`` (priority, deadline,
    trace) plus content framing; hop-by-hop headers stay behind."""
    out = {}
    for k, v in headers.items():
        lk = k.lower()
        if lk.startswith(_FORWARD_HEADER_PREFIX) or lk in _FORWARD_HEADERS:
            out[k] = v
    return out


class ServingRouter:
    """Pick/forward engine shared by the daemon and tests.

    ``targets`` is the configured fleet as ``(name, base_url)`` pairs
    (the :func:`pio_tpu_torch.obs.fleet.parse_targets` shape).
    """

    def __init__(
        self,
        targets: Sequence[Tuple[str, str]],
        registry: MetricsRegistry,
        partitions: Optional[int] = None,
        burn_limit: Optional[float] = None,
        lag_soft_bytes: Optional[float] = None,
        timeout_s: float = 5.0,
        forced_down_s: float = 10.0,
        hedge_ms: Optional[float] = None,
    ):
        if not targets:
            raise ValueError("router needs at least one member target")
        self.burn_limit = (
            burn_limit if burn_limit is not None
            else knobs.knob_float(BURN_LIMIT_ENV)
        )
        self.lag_soft_bytes = (
            lag_soft_bytes if lag_soft_bytes is not None
            else knobs.knob_float(LAG_SOFT_ENV)
        )
        if hedge_ms is None:
            hedge_ms = knobs.knob_float(HEDGE_ENV)
        self.hedge_s = max(float(hedge_ms), 0.0) / 1e3
        self.timeout_s = timeout_s
        self.forced_down_s = forced_down_s
        #: opaque rollout hooks (see router/rollout.py). ``_observer``
        #: sees every completed relay off the return path; ``_divert``
        #: may put a canary member in front of the ring plan. Stored
        #: untyped and called through locals so the relay keeps its
        #: zero-copy/blocking contract regardless of what a controller
        #: plugs in.
        self._observer = None
        self._divert = None
        self._members: Dict[str, MemberState] = {}
        self._pools: Dict[str, _UpstreamPool] = {}
        for name, base_url in targets:
            parts = urlsplit(base_url)
            host = parts.hostname or "127.0.0.1"
            port = parts.port or (443 if parts.scheme == "https" else 80)
            self._members[name] = MemberState(
                name=name, base_url=base_url, host=host, port=port
            )
            self._pools[name] = _UpstreamPool(host, port, timeout_s)
        self.ring = Ring(self._members.keys(), partitions)
        self._lock = threading.Lock()
        self._rr = 0
        self.obs = registry
        self._forwarded = registry.counter(
            "pio_tpu_router_forwarded_total",
            "Requests relayed to a member (retries counted there too)",
            ("member",),
        )
        self._retried = registry.counter(
            "pio_tpu_router_retried_total",
            "Relays that were the one-shot retry after a transport "
            "error, labeled by the member that absorbed the retry",
            ("member",),
        )
        self._shed = registry.counter(
            "pio_tpu_router_shed_total",
            "Requests the router itself refused, by reason",
            ("reason",),
        )
        self._forward_errors = registry.counter(
            "pio_tpu_router_forward_errors_total",
            "Transport failures talking to a member",
            ("member",),
        )
        self._deploys = registry.counter(
            "pio_tpu_router_deploys_total",
            "Deploy pushes by member and outcome "
            "(verified / rejected / error)",
            ("member", "outcome"),
        )
        self._hedged = registry.counter(
            "pio_tpu_router_hedged_total",
            "Relays that fired a hedge at the next replica, by outcome "
            "(primary_won / hedge_won / error)",
            ("outcome",),
        )
        self._pick_seconds = registry.histogram(
            "pio_tpu_router_pick_seconds",
            "Replica ranking latency (health gate + ring rank + spread)",
        )
        self._ring_size = registry.gauge(
            "pio_tpu_router_ring_size",
            "Members currently routable (scrape-live, not forced down)",
        )
        self._member_routable = registry.gauge(
            "pio_tpu_router_member_routable",
            "1 while the member is in the ring, else 0",
            ("member",),
        )
        for name in self._members:
            self._forwarded.labels(name)
            self._retried.labels(name)
            self._forward_errors.labels(name)
            self._member_routable.set(0.0, member=name)
        self._ring_size.set(0.0)

    # -- membership / rollout hooks ----------------------------------------
    def set_observer(self, observer) -> None:
        """Install (or clear, with None) the completed-relay hook:
        ``observer(method, path, body, headers, entity_id, priority,
        member, status, body_out, elapsed_s)``. Must never raise."""
        self._observer = observer

    def set_divert(self, divert) -> None:
        """Install (or clear, with None) the canary divert hook:
        ``divert(entity_id, priority) -> member_name | None`` consulted
        at pick time; a returned routable member fronts the plan with
        the normal ring order behind it (retry covers it dying)."""
        self._divert = divert

    def add_member(self, name: str, base_url: str,
                   aux: bool = False) -> MemberState:
        """Register a member at runtime. ``aux`` members (rollout
        candidates) get a pooled upstream and metric cells but stay out
        of the ring and take no traffic unless diverted."""
        with self._lock:
            existing = self._members.get(name)
            if existing is not None:
                return existing
            parts = urlsplit(base_url)
            host = parts.hostname or "127.0.0.1"
            port = parts.port or (443 if parts.scheme == "https" else 80)
            ms = MemberState(
                name=name, base_url=base_url, host=host, port=port, aux=aux
            )
            self._members[name] = ms
            self._pools[name] = _UpstreamPool(host, port, self.timeout_s)
        self._forwarded.labels(name)
        self._retried.labels(name)
        self._forward_errors.labels(name)
        if not aux:
            self.ring = Ring(
                [n for n, m in self._members.items() if not m.aux],
                self.ring.partitions,
            )
        self._refresh_gauges()
        return ms

    def remove_member(self, name: str) -> None:
        """Drop a member and close its keep-alive upstream sockets
        immediately — a removed member must leave no open FDs behind."""
        with self._lock:
            ms = self._members.pop(name, None)
            pool = self._pools.pop(name, None)
        if pool is not None:
            pool.close()
        if ms is None:
            return
        self._member_routable.set(0.0, member=name)
        if not ms.aux:
            self.ring = Ring(
                [n for n, m in self._members.items() if not m.aux],
                self.ring.partitions,
            )
        self._refresh_gauges()

    def has_member(self, name: str) -> bool:
        return name in self._members

    def member(self, name: str) -> Optional[MemberState]:
        return self._members.get(name)

    def ring_members(self) -> List[MemberState]:
        """The non-aux members (the incumbent ring's population)."""
        return [ms for ms in self._members.values() if not ms.aux]

    def upstream_request(self, member: str, method, path, body, headers):
        """One exchange over ``member``'s keep-alive pool (the rollout
        mirror path; the relay itself goes through :meth:`forward`)."""
        pool = self._pools.get(member)
        if pool is None:
            raise KeyError(f"unknown member {member!r}")
        return pool.request(method, path, body, headers)

    # -- health/load ingestion --------------------------------------------
    # pio: consumes=/fleet.json
    def ingest_fleet(self, payload: dict) -> None:
        """Fold a ``fleet_payload()`` snapshot into the member table:
        scrape status, per-member worst burn, worst follower lag."""
        lag_by_follower: Dict[str, int] = {}
        for leader in (payload.get("partlog") or {}).get("leaders", []):
            for part in leader.get("partitionDetail", []):
                for f in part.get("followers", []):
                    name, lag = f.get("follower"), f.get("lagBytes")
                    if name is None or lag is None:
                        continue
                    lag_by_follower[name] = max(
                        lag_by_follower.get(name, 0), int(lag)
                    )
        with self._lock:
            for entry in payload.get("members", []):
                ms = self._members.get(entry.get("member"))
                if ms is None:
                    continue
                ms.status = entry.get("status") or "unknown"
                slo = entry.get("slo") or {}
                burn = slo.get("worstBurn")
                ms.burn = float(burn) if burn is not None else 0.0
                dev = entry.get("devices") or {}
                headroom = dev.get("headroomBytes")
                ms.headroom_bytes = (
                    float(headroom) if headroom is not None else None
                )
                ms.lag_bytes = lag_by_follower.get(ms.name, 0)
        self._refresh_gauges()

    def _refresh_gauges(self) -> None:
        now = monotonic_s()
        n = 0
        for ms in list(self._members.values()):
            ok = self._routable(ms, now)
            n += 1 if (ok and not ms.aux) else 0
            self._member_routable.set(1.0 if ok else 0.0, member=ms.name)
        self._ring_size.set(float(n))

    @staticmethod
    def _routable(ms: MemberState, now: float) -> bool:
        # "unknown" rides: before the first scrape pass the router must
        # not blackhole the fleet — a truly dead member fails its first
        # forward and is forced down right there.
        if ms.forced_down_until > now:
            return False
        return ms.status in ("up", "stale", "unknown")

    def note_failure(self, member: str) -> None:
        """Passive health: a transport error takes the member out of
        the ring immediately, without waiting for the scrape loop's
        stale->down progression."""
        ms = self._members.get(member)
        if ms is None:
            return
        self._forward_errors.inc(member=member)
        ms.forced_down_until = monotonic_s() + self.forced_down_s
        # a dead member's keep-alive sockets go NOW, not when they idle
        # out: every parked connection is an FD pointing at a corpse
        pool = self._pools.get(member)
        if pool is not None:
            pool.close()
        self._refresh_gauges()
        log.warning(
            "member %s forced down for %.1fs after transport error",
            member, self.forced_down_s,
        )

    def note_deploy(self, member: str, instance_id: str,
                    outcome: str) -> None:
        self._deploys.inc(member=member, outcome=outcome)
        if outcome == "verified":
            ms = self._members.get(member)
            if ms is not None:
                ms.generation = instance_id

    # -- pick --------------------------------------------------------------
    def _load_score(self, ms: MemberState) -> float:
        score = ms.burn + ms.lag_bytes / self.lag_soft_bytes
        if ms.headroom_bytes is not None and ms.headroom_bytes <= 0.0:
            # exhausted device memory weighs like a full burn-limit of SLO burn:
            # the member demotes before it starts failing for real
            score += self.burn_limit
        return score

    def _pressured(self, ms: MemberState) -> bool:
        """Demotion gate: SLO burn at/over the limit, or device budget
        headroom exhausted (the member would start thrashing/rejecting
        before the burn shows up in its scrape)."""
        if ms.burn >= self.burn_limit:
            return True
        return ms.headroom_bytes is not None and ms.headroom_bytes <= 0.0

    def _spread_order(self, routable: List[str]) -> List[str]:
        with self._lock:
            self._rr += 1
            rot = self._rr % len(routable)
        rotated = routable[rot:] + routable[:rot]
        # stable sort: equal load scores keep the rotation, so an idle
        # fleet round-robins instead of hammering the first member
        return sorted(
            rotated, key=lambda m: self._load_score(self._members[m])
        )

    def pick(self, entity_id: Optional[str],
             priority: str = "") -> List[MemberState]:
        """Ordered forward plan for one request; raises :class:`Shed`
        when the router must answer the overload itself."""
        t0 = monotonic_s()
        failpoint("router.pick")
        routable = [
            name for name, ms in self._members.items()
            if not ms.aux and self._routable(ms, t0)
        ]
        if not routable:
            self._shed.inc(reason="no_members")
            raise Shed(503, "no_members", self.forced_down_s)
        if entity_id:
            order = self.ring.rank(entity_id, routable)
        else:
            order = self._spread_order(routable)
        calm = [
            m for m in order if not self._pressured(self._members[m])
        ]
        if calm:
            if len(calm) != len(order):
                # demote pressured replicas (burning, or out of device
                # headroom) behind calm ones, both halves keeping ring
                # order (affinity still wins among calm)
                order = calm + [m for m in order if m not in calm]
        else:
            if priority_floor(priority) > 0.0:
                # every replica is pressured: non-interactive classes
                # are the error budget's relief valve, exactly as
                # on-member
                self._shed.inc(reason="slo_burn")
                raise Shed(503, "slo_burn", self.forced_down_s)
            order = sorted(order, key=lambda m: self._load_score(
                self._members[m]))
        divert = self._divert
        if divert is not None:
            cand = divert(entity_id, priority)
            if cand is not None and cand not in order:
                cms = self._members.get(cand)
                if cms is not None and self._routable(cms, t0):
                    # canary front: the candidate takes the request,
                    # the incumbent plan stays behind it as the retry
                    order = [cand] + order
        self._pick_seconds.observe(monotonic_s() - t0)
        return [self._members[m] for m in order]

    # -- forward -----------------------------------------------------------
    def forward(self, method, path, body, headers,
                entity_id=None, priority=""):  # pio: hotpath=zerocopy
        """Relay one request, retrying once on the next replica after a
        transport error.  ``body`` goes through untouched — on the
        packed int8 wire that is the zero-copy contract end to end.
        With ``PIO_TPU_ROUTER_HEDGE_MS`` set, interactive requests that
        outlive the hedge budget race the next replica instead."""
        plan = self.pick(entity_id, priority)
        hdrs = forward_headers(headers)
        if (self.hedge_s > 0.0 and len(plan) >= 2
                and priority_floor(priority) == 0.0):
            return self._forward_hedged(
                method, path, body, hdrs, plan, entity_id, priority
            )
        last_exc = None
        for attempt, ms in enumerate(plan[:2]):
            failpoint("router.forward")
            t0 = monotonic_s()
            try:
                status, reply, out = self._pools[ms.name].request(
                    method, path, body, hdrs
                )
            except Exception as e:
                self.note_failure(ms.name)
                last_exc = e
                continue
            self._forwarded.inc(member=ms.name)
            if attempt:
                self._retried.inc(member=ms.name)
            self._observe_relay(method, path, body, hdrs, entity_id,
                                priority, ms.name, status, out,
                                monotonic_s() - t0)
            return status, reply, out, ms.name
        self._shed.inc(reason="upstream_unreachable")
        raise Shed(503, "upstream_unreachable", self.forced_down_s) \
            from last_exc

    def _forward_hedged(self, method, path, body, hdrs, plan,
                        entity_id, priority):
        """Tail-latency hedge: the primary gets ``hedge_s`` to answer;
        then (or immediately on a primary transport error) the same
        request fires at the next replica and the first answer wins —
        the loser finishes in the background against its own pool."""
        cond = threading.Condition()
        results: List[Tuple[MemberState, Tuple]] = []
        errors: List[MemberState] = []

        def attempt(ms):
            try:
                got = self._pools[ms.name].request(method, path, body, hdrs)
            except Exception:
                self.note_failure(ms.name)
                with cond:
                    errors.append(ms)
                    cond.notify_all()
                return
            with cond:
                results.append((ms, got))
                cond.notify_all()

        primary, backup = plan[0], plan[1]
        t0 = monotonic_s()
        threading.Thread(
            target=attempt, args=(primary,), daemon=True
        ).start()
        with cond:
            # the hedge budget itself — an intentional bounded wait,
            # the whole point of the opt-in knob
            # pio: disable=hotpath-blocking
            cond.wait_for(lambda: results or errors,
                          timeout=self.hedge_s)
            need_hedge = not results
        if not need_hedge:
            ms, (status, reply, out) = results[0]
            self._forwarded.inc(member=ms.name)
            self._observe_relay(method, path, body, hdrs, entity_id,
                                priority, ms.name, status, out,
                                monotonic_s() - t0)
            return status, reply, out, ms.name
        failpoint("router.forward.hedge")
        threading.Thread(
            target=attempt, args=(backup,), daemon=True
        ).start()
        deadline = monotonic_s() + self.timeout_s + 1.0
        with cond:
            while not results and len(errors) < 2:
                remaining = deadline - monotonic_s()
                if remaining <= 0.0:
                    break
                # racing two in-flight upstreams; bounded by the pool
                # timeout either way
                cond.wait(remaining)  # pio: disable=hotpath-blocking
            got = list(results)
        if not got:
            self._hedged.inc(outcome="error")
            self._shed.inc(reason="upstream_unreachable")
            raise Shed(503, "upstream_unreachable", self.forced_down_s)
        ms, (status, reply, out) = got[0]
        won = "primary_won" if ms.name == primary.name else "hedge_won"
        self._hedged.inc(outcome=won)
        self._forwarded.inc(member=ms.name)
        if won == "hedge_won":
            self._retried.inc(member=ms.name)
        self._observe_relay(method, path, body, hdrs, entity_id, priority,
                            ms.name, status, out, monotonic_s() - t0)
        return status, reply, out, ms.name

    def _observe_relay(self, method, path, body, hdrs, entity_id,
                       priority, member, status, out, elapsed_s) -> None:
        observer = self._observer
        if observer is None:
            return
        try:
            observer(method, path, body, hdrs, entity_id, priority,
                     member, status, out, elapsed_s)
        except Exception:
            pass

    # -- introspection -----------------------------------------------------
    # pio: endpoint=/router.json
    def snapshot(self) -> dict:
        """The ``/router.json`` member/ring view (schema documented in
        docs/observability.md)."""
        now = monotonic_s()
        members = []
        for ms in list(self._members.values()):
            members.append({
                "member": ms.name,
                "url": ms.base_url,
                "status": ms.status,
                "routable": self._routable(ms, now),
                "aux": ms.aux,
                "worstBurn": round(ms.burn, 4),
                "lagBytes": ms.lag_bytes,
                "headroomBytes": ms.headroom_bytes,
                "generation": ms.generation,
                "forwarded": int(self._forwarded.value(ms.name)),
                "retried": int(self._retried.value(ms.name)),
                "errors": int(self._forward_errors.value(ms.name)),
            })
        routable = [
            m["member"] for m in members if m["routable"] and not m["aux"]
        ]
        return {
            "ring": {
                "members": list(self.ring.members),
                "partitions": self.ring.partitions,
                "routable": routable,
                "size": len(routable),
            },
            "policy": {
                "burnLimit": self.burn_limit,
                "lagSoftBytes": self.lag_soft_bytes,
                "forcedDownSeconds": self.forced_down_s,
                "hedgeMs": round(self.hedge_s * 1e3, 3),
            },
            "members": members,
        }

    def close(self) -> None:
        for pool in self._pools.values():
            pool.close()
