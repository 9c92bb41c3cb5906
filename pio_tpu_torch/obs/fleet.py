"""Fleet telemetry aggregator — cross-host metric federation.

The port's copy of ``pio_tpu/obs/fleet.py`` (the port imports nothing of
``pio_tpu``).

One process per engine (PAPER.md's layer map) means fleet state lives
scattered across N ``/metrics`` endpoints. This module is the pull side
of the telemetry plane: a :class:`FleetAggregator` scrapes each member's
``/metrics``, ``/readyz``, ``/slo.json``, ``/storage.json`` (and
``/stats.json`` best-effort, for shard/residency placement) on a
jittered interval, then

- re-exposes the union of every member's metrics on its host registry
  with a ``pio_tpu_member="host:port"`` label injected per sample
  (:func:`pio_tpu_torch.obs.promparse.with_labels` +
  :func:`pio_tpu_torch.obs.promparse.merge` — counters sum, histograms merge
  bucket-wise, so one scrape of the aggregator equals the sum of the
  per-member scrapes), and
- builds the ``/fleet.json`` payload (:meth:`FleetAggregator.fleet_payload`)
  — the documented contract the serving router (``router/core.py``) consumes: member
  liveness/readiness/staleness, worst SLO burn rate per objective across
  members, partlog topology with per-partition per-follower replication
  lag and fleet-wide min-acked positions, and engine placement.

Staleness semantics: a member that stops answering keeps its last-seen
snapshot (no silent disappearance from the federated sums) and walks
``up -> stale -> down`` as the age of its last good scrape crosses
``stale_after_s`` then ``down_after_s``. A member that has *never*
answered is ``down`` from its first failed scrape.

Own metric families (on the registry passed in):

- ``pio_tpu_fleet_member_up{member}`` — 1 while the member's scrape is
  fresh, else 0;
- ``pio_tpu_fleet_scrape_age_seconds{member}`` — age of the last good
  scrape (-1 until one succeeds);
- ``pio_tpu_fleet_scrapes_total{member}`` — scrape attempts;
- ``pio_tpu_fleet_scrape_errors_total{member,reason}`` — failed scrapes
  by ``unreachable`` / ``http`` / ``parse`` reason.
"""

from __future__ import annotations

import json
import random
import threading
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from pio_tpu_torch.utils import knobs
from pio_tpu_torch.obs import promparse
from pio_tpu_torch.obs.metrics import MetricsRegistry, monotonic_s
from pio_tpu_torch.obs.promparse import ParsedMetrics

#: env fallback for ``pio fleet --targets`` / embedded aggregators
TARGETS_ENV = "PIO_TPU_FLEET_TARGETS"
INTERVAL_ENV = "PIO_TPU_FLEET_INTERVAL_S"

DEFAULT_INTERVAL_S = 5.0
#: multiples of the scrape interval after which a silent member is
#: marked stale, then down
STALE_AFTER_INTERVALS = 2.5
DOWN_AFTER_INTERVALS = 5.0


def parse_targets(spec: Optional[str]) -> List[Tuple[str, str]]:
    """``"host:port,http://h2:9001"`` -> ``[(member, base_url), ...]``.
    The member name is always ``host:port`` (the label value); a bare
    target gets an ``http://`` scheme."""
    out: List[Tuple[str, str]] = []
    seen = set()
    for raw in (spec or "").split(","):
        t = raw.strip().rstrip("/")
        if not t:
            continue
        url = t if "://" in t else f"http://{t}"
        member = url.split("://", 1)[1]
        if member in seen:
            continue
        seen.add(member)
        out.append((member, url))
    return out


def _default_fetch(url: str, timeout: float) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


class _Member:
    """Scrape state for one fleet member (last-seen data retained)."""

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url
        self.attempts = 0
        self.errors = 0
        self.last_error: Optional[str] = None
        #: monotonic_s of the last successful /metrics scrape, or None
        self.last_ok: Optional[float] = None
        self.metrics: Optional[ParsedMetrics] = None
        self.ready: Optional[bool] = None
        self.ready_report: Optional[dict] = None
        self.slo: Optional[dict] = None
        self.storage: Optional[dict] = None
        self.stats: Optional[dict] = None
        self.train: Optional[dict] = None
        self.device: Optional[dict] = None
        self.routerd: Optional[dict] = None
        self.rollout: Optional[dict] = None

    def age_s(self) -> Optional[float]:
        if self.last_ok is None:
            return None
        return monotonic_s() - self.last_ok

    def status(self, stale_after_s: float, down_after_s: float) -> str:
        age = self.age_s()
        if age is None:
            return "down" if self.attempts else "unknown"
        if age <= stale_after_s:
            return "up"
        if age <= down_after_s:
            return "stale"
        return "down"

    def role(self) -> str:
        if self.routerd is not None:
            return "router"
        if self.storage is not None and "role" in self.storage:
            return str(self.storage["role"])
        if self.train is not None:
            return "trainer"
        if self.stats is not None and "residency" in self.stats:
            return "query"
        if self.storage is not None:
            return "event"
        return "unknown"


class FleetAggregator:
    """Scrapes fleet members and federates their telemetry.

    ``fetch(url, timeout) -> bytes`` is injectable so failure-mode tests
    can fake members without sockets. ``registry`` is the registry the
    fleet gauges live on and whose ``/metrics`` carries the federated
    re-exposition (a collector is registered on it here).
    """

    def __init__(
        self,
        targets: List[Tuple[str, str]],
        registry: MetricsRegistry,
        interval_s: Optional[float] = None,
        stale_after_s: Optional[float] = None,
        down_after_s: Optional[float] = None,
        timeout_s: float = 3.0,
        fetch: Optional[Callable[[str, float], bytes]] = None,
    ):
        if interval_s is None:
            interval_s = knobs.knob_float(INTERVAL_ENV)
        self.interval_s = interval_s
        self.stale_after_s = (
            stale_after_s if stale_after_s is not None
            else STALE_AFTER_INTERVALS * interval_s
        )
        self.down_after_s = (
            down_after_s if down_after_s is not None
            else DOWN_AFTER_INTERVALS * interval_s
        )
        self.timeout_s = timeout_s
        self._fetch = fetch or _default_fetch
        self._members = [_Member(name, url) for name, url in targets]
        #: completed full scrape passes (readiness gate for fleetd)
        self.passes = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.obs = registry
        self._member_up = registry.gauge(
            "pio_tpu_fleet_member_up",
            "1 while the member's last /metrics scrape is fresh, else 0",
            ("member",),
        )
        self._scrape_age = registry.gauge(
            "pio_tpu_fleet_scrape_age_seconds",
            "Age of the member's last successful scrape (-1 before one)",
            ("member",),
        )
        self._scrapes = registry.counter(
            "pio_tpu_fleet_scrapes_total",
            "Scrape attempts against fleet members",
            ("member",),
        )
        self._scrape_errors = registry.counter(
            "pio_tpu_fleet_scrape_errors_total",
            "Failed member scrapes by reason",
            ("member", "reason"),
        )
        registry.add_collector(self.federated_lines)
        for m in self._members:
            self._member_up.set(0.0, member=m.name)
            self._scrape_age.set(-1.0, member=m.name)

    # -- scraping ----------------------------------------------------------
    def _get_json(self, m: _Member, path: str) -> Optional[dict]:
        try:
            return json.loads(
                self._fetch(m.url + path, self.timeout_s).decode("utf-8")
            )
        except Exception:
            return None

    def _get_ready(self, m: _Member) -> Tuple[Optional[bool], Optional[dict]]:
        """Readiness is carried in the status code (503 when not ready),
        so the HTTPError path is a *successful* probe."""
        try:
            body = self._fetch(m.url + "/readyz", self.timeout_s)
            return True, self._maybe_json(body)
        except urllib.error.HTTPError as e:
            try:
                body = e.read()
            except Exception:
                body = b""
            return False, self._maybe_json(body)
        except Exception:
            return None, None

    @staticmethod
    def _maybe_json(body: bytes) -> Optional[dict]:
        try:
            got = json.loads(body.decode("utf-8"))
            return got if isinstance(got, dict) else None
        except Exception:
            return None

    def scrape_member(self, m: _Member) -> bool:
        """One scrape pass over one member. Returns True when /metrics
        was fetched and parsed; JSON endpoints are best-effort and only
        overwrite the retained snapshot on success."""
        self._scrapes.inc(member=m.name)
        m.attempts += 1
        try:
            raw = self._fetch(m.url + "/metrics", self.timeout_s)
        except urllib.error.HTTPError as e:
            self._record_error(m, "http", f"HTTP {e.code} on /metrics")
            return False
        except Exception as e:
            self._record_error(
                m, "unreachable", f"{type(e).__name__}: {e}"
            )
            return False
        try:
            parsed = promparse.parse_prometheus_text(raw.decode("utf-8"))
            # a fresh registry legitimately exposes only HELP/TYPE heads
            # (labeled families with no cells yet); a body yielding
            # neither samples nor TYPE declarations is not exposition
            if not parsed.samples and not parsed.types and raw.strip():
                raise ValueError("no exposition parsed from non-empty body")
        except Exception as e:
            self._record_error(m, "parse", f"{type(e).__name__}: {e}")
            return False
        ready, report = self._get_ready(m)
        slo = self._get_json(m, "/slo.json")
        storage = self._get_json(m, "/storage.json")
        stats = self._get_json(m, "/stats.json")
        train = self._get_json(m, "/train.json")
        device = self._get_json(m, "/device.json")
        routerd = self._get_json(m, "/router.json")
        rollout = (
            self._get_json(m, "/rollout.json")
            if routerd is not None else None
        )
        with self._lock:
            m.metrics = parsed
            m.last_ok = monotonic_s()
            m.last_error = None
            if ready is not None:
                m.ready, m.ready_report = ready, report
            if slo is not None:
                m.slo = slo
            if storage is not None:
                m.storage = storage
            if stats is not None:
                m.stats = stats
            if train is not None:
                m.train = train
            if device is not None:
                m.device = device
            if routerd is not None:
                m.routerd = routerd
            if rollout is not None:
                m.rollout = rollout
        return True

    def _record_error(self, m: _Member, reason: str, msg: str) -> None:
        m.errors += 1
        m.last_error = msg
        self._scrape_errors.inc(member=m.name, reason=reason)

    def scrape_once(self) -> int:
        """Scrape every member; returns how many answered."""
        ok = 0
        for m in self._members:
            if self.scrape_member(m):
                ok += 1
        self._refresh_gauges()
        self.passes += 1
        return ok

    def _refresh_gauges(self) -> None:
        for m in self._members:
            st = m.status(self.stale_after_s, self.down_after_s)
            self._member_up.set(1.0 if st == "up" else 0.0, member=m.name)
            age = m.age_s()
            self._scrape_age.set(
                round(age, 3) if age is not None else -1.0, member=m.name
            )

    # -- background loop ---------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="fleet-scraper", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=self.timeout_s + 1.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:
                pass  # a scrape pass must never kill the loop
            # +/-10% jitter so N aggregators don't align on one member
            delay = self.interval_s * random.uniform(0.9, 1.1)
            if self._stop.wait(delay):
                return

    # -- federation --------------------------------------------------------
    def members(self) -> List[_Member]:
        return list(self._members)

    def federated_lines(self) -> List[str]:
        """Exposition lines for the union of every member's last-seen
        metrics, each sample stamped ``pio_tpu_member="name"``. Members
        currently down still contribute their retained snapshot. The
        aggregator's own ``pio_tpu_fleet_*`` families are dropped from
        member snapshots (the host registry already renders them)."""
        with self._lock:
            snaps = [
                (m.name, m.metrics) for m in self._members
                if m.metrics is not None
            ]
        if not snaps:
            return []
        labeled = [
            promparse.with_labels(pm, pio_tpu_member=name)
            for name, pm in snaps
        ]
        merged = promparse.merge(*labeled)
        for key in [
            k for k in merged.samples
            if promparse.family_base(k[0], merged.types).startswith(
                "pio_tpu_fleet_"
            )
        ]:
            merged.samples.pop(key, None)
            merged.exemplars.pop(key, None)
        for fam in [f for f in list(merged.types)
                    if f.startswith("pio_tpu_fleet_")]:
            merged.types.pop(fam, None)
            merged.helps.pop(fam, None)
        return promparse.render(merged)

    # -- /fleet.json -------------------------------------------------------
    # pio: endpoint=/fleet.json
    def fleet_payload(self) -> dict:
        """The router contract (documented in docs/observability.md)."""
        with self._lock:
            members = [self._member_entry(m) for m in self._members]
            slo = self._slo_rollup()
            partlog = self._partlog_rollup()
            placement = self._placement()
            devices = self._devices_rollup()
        counts = {"up": 0, "stale": 0, "down": 0, "unknown": 0}
        for e in members:
            counts[e["status"]] = counts.get(e["status"], 0) + 1
        return {
            "fleet": {
                "members": len(members),
                "up": counts["up"],
                "stale": counts["stale"],
                "down": counts["down"] + counts["unknown"],
                "scrapeIntervalSeconds": self.interval_s,
                "staleAfterSeconds": self.stale_after_s,
                "downAfterSeconds": self.down_after_s,
            },
            "members": members,
            "slo": slo,
            "partlog": partlog,
            "placement": placement,
            "devices": devices,
        }

    def _member_entry(self, m: _Member) -> dict:
        age = m.age_s()
        training = None
        if m.train is not None:
            # compact view of the member's /train.json (full payload on
            # the member itself; the fleet view carries the progress row)
            training = {
                "runId": m.train.get("runId"),
                "phase": m.train.get("phase"),
                "algo": m.train.get("algo"),
                "step": m.train.get("step"),
                "totalSteps": m.train.get("totalSteps"),
                "epoch": m.train.get("epoch"),
                "progress": m.train.get("progress"),
                "etaSeconds": m.train.get("etaSeconds"),
                "loss": m.train.get("loss"),
            }
        devices = None
        if m.device is not None:
            # compact view of the member's /device.json (full payload on
            # the member; the fleet row carries the memory-pressure facts
            # a budget-driven eviction policy steers by)
            rows = m.device.get("devices") or []
            devices = {
                "mode": m.device.get("mode"),
                "count": len(rows),
                "bytesInUse": sum(
                    int(r.get("bytesInUse") or 0) for r in rows
                ),
                "peakBytes": max(
                    (int(r.get("peakBytes") or 0) for r in rows),
                    default=0,
                ),
                "budgetBytes": m.device.get("budgetBytes"),
                "headroomBytes": m.device.get("headroomBytes"),
                "generation": m.device.get("generation"),
                "compiles": (m.device.get("compiles") or {}).get("total"),
            }
        slo = None
        if m.slo is not None:
            # per-member worst burn across its objectives: the serving
            # router's spreading weight (the fleet-level rollup only
            # names the single worst member per objective)
            top = None
            for s in m.slo.get("slos", []):
                for burn in (s.get("burnRates") or {}).values():
                    if burn is not None and (top is None or burn > top):
                        top = burn
            slo = {"worstBurn": top}
        fabric = None
        if m.routerd is not None:
            # compact front-tier row (full payload on the member's own
            # /router.json): ring occupancy is what the dashboard needs
            ring = m.routerd.get("ring") or {}
            fabric = {
                "members": ring.get("members"),
                "routable": ring.get("routable"),
                "size": ring.get("size"),
                "partitions": ring.get("partitions"),
            }
        rollout = None
        if m.rollout is not None and m.rollout.get("stage") != "idle":
            # compact progressive-delivery row (full decision trail on
            # the router's own /rollout.json): stage + judge verdict is
            # what the fleet dashboard steers by
            judge = m.rollout.get("judge") or {}
            shadow = m.rollout.get("shadow") or {}
            trail = m.rollout.get("trail") or []
            rollout = {
                "stage": m.rollout.get("stage"),
                "generation": m.rollout.get("generation"),
                "candidateInstance": m.rollout.get("candidateInstance"),
                "incumbentInstance": m.rollout.get("incumbentInstance"),
                "lastVerdict": judge.get("lastVerdict"),
                "shadowSamples": shadow.get("samples"),
                "mismatchRate": shadow.get("mismatchRate"),
                "canaryRequests": (
                    (m.rollout.get("canary") or {}).get("requests")
                ),
                "lastTransition": trail[-1] if trail else None,
            }
        return {
            "member": m.name,
            "url": m.url,
            "status": m.status(self.stale_after_s, self.down_after_s),
            "role": m.role(),
            "ready": m.ready,
            "scrapeAgeSeconds": round(age, 3) if age is not None else None,
            "scrapes": m.attempts,
            "scrapeErrors": m.errors,
            "lastError": m.last_error,
            "slo": slo,
            "training": training,
            "devices": devices,
            "router": fabric,
            "rollout": rollout,
        }

    def _devices_rollup(self) -> dict:
        """Fleet-wide device memory view: per-member bytes,
        headroom and per-device rows — the eviction-policy input of
        a router that sheds the member with the least headroom."""
        per_member = {}
        tightest = None
        for m in self._members:
            if m.device is None:
                continue
            rows = m.device.get("devices") or []
            entry = {
                "mode": m.device.get("mode"),
                "bytesInUse": sum(
                    int(r.get("bytesInUse") or 0) for r in rows
                ),
                "budgetBytes": m.device.get("budgetBytes"),
                "headroomBytes": m.device.get("headroomBytes"),
                "generation": m.device.get("generation"),
                "devices": [
                    {
                        "device": r.get("device"),
                        "bytesInUse": r.get("bytesInUse"),
                        "peakBytes": r.get("peakBytes"),
                        "limitBytes": r.get("limitBytes"),
                    }
                    for r in rows
                ],
            }
            per_member[m.name] = entry
            head = entry["headroomBytes"]
            if head is not None and (
                tightest is None or head < tightest["headroomBytes"]
            ):
                tightest = {"member": m.name, "headroomBytes": head}
        return {"members": per_member, "tightest": tightest}

    def _slo_rollup(self) -> dict:
        """Worst burn rate per objective name across members: the router
        sheds away from whichever replica burns budget fastest."""
        worst: Dict[str, dict] = {}
        for m in self._members:
            for s in (m.slo or {}).get("slos", []):
                name = s.get("name")
                if not name:
                    continue
                burns = s.get("burnRates") or {}
                top_window, top_burn = None, None
                for window, burn in burns.items():
                    if burn is None:
                        continue
                    if top_burn is None or burn > top_burn:
                        top_window, top_burn = window, burn
                if top_burn is None:
                    continue
                cur = worst.get(name)
                if cur is None or top_burn > cur["burn"]:
                    worst[name] = {
                        "member": m.name,
                        "burn": top_burn,
                        "window": top_window,
                        "objective": s.get("objective"),
                        "errorBudgetRemaining":
                            s.get("errorBudgetRemaining"),
                        "firing": [
                            a.get("severity")
                            for a in s.get("alerts", [])
                            if a.get("firing")
                        ],
                    }
        return {"worstBurn": worst}

    def _partlog_rollup(self) -> dict:
        """Partlog topology: per-leader per-partition committed bytes,
        per-follower acked/lag, and min-acked across followers (the
        fleet-wide durable floor the router can read)."""
        leaders = []
        for m in self._members:
            topo = m.storage
            if not topo or topo.get("backend") != "partlog":
                continue
            if topo.get("role") not in (None, "leader"):
                continue
            repl = topo.get("replication") or {}
            followers = repl.get("followers") or []
            parts = []
            for detail in topo.get("partition_detail", []):
                k = str(detail.get("partition"))
                committed = detail.get("committed_bytes", 0)
                f_rows = []
                acked_vals = []
                for f in followers:
                    acked = (f.get("acked") or {}).get(k)
                    lag = (
                        max(committed - acked, 0)
                        if acked is not None else None
                    )
                    if acked is not None:
                        acked_vals.append(acked)
                    f_rows.append({
                        "follower": f.get("follower"),
                        "connected": f.get("connected"),
                        "ackedBytes": acked,
                        "lagBytes": lag,
                    })
                parts.append({
                    "partition": detail.get("partition"),
                    "committedBytes": committed,
                    "minAckedBytes":
                        min(acked_vals) if acked_vals else None,
                    "followers": f_rows,
                })
            leaders.append({
                "member": m.name,
                "partitions": topo.get("partitions"),
                "durability": topo.get("durability"),
                "minAcks": repl.get("min_acks"),
                "replicas": repl.get("replicas"),
                "partitionDetail": parts,
            })
        return {"leaders": leaders}

    def _placement(self) -> List[dict]:
        """Which member holds which engine bytes, and how: device
        resident, mesh sharded, or host mirror."""
        out = []
        for m in self._members:
            st = m.stats
            if not st:
                continue
            res = st.get("residency") or {}
            shard = st.get("sharding") or {}
            mode = (
                "mesh" if shard.get("enabled")
                else "resident" if res.get("enabled")
                else "host"
            )
            entry = {
                "member": m.name,
                "mode": mode,
                "paramBytes": res.get("paramBytes", 0),
                "scorers": [
                    {
                        "name": sc.get("name"),
                        "paramBytes": sc.get("paramBytes"),
                        "sharded": sc.get("sharded"),
                        "retired": sc.get("retired"),
                    }
                    for sc in res.get("scorers", [])
                ],
            }
            if shard.get("enabled"):
                entry["sharding"] = shard
            if "worker" in st:
                entry["worker"] = st["worker"]
                entry["poolSize"] = st.get("poolSize")
            out.append(entry)
        return out
