"""Progressive-delivery rollout controller.

The port's copy of ``pio_tpu/router/rollout.py`` (the port imports nothing of
``pio_tpu``).

Drives one candidate engine instance through **shadow -> canary ->
promoted** against the live serving ring, with automatic rollback at
every stage:

- **shadow** — the router keeps relaying every request to the incumbent
  exactly as before (the ``# pio: hotpath=zerocopy`` relay is untouched:
  the controller observes completed relays through an opaque hook and
  mirrors a budgeted sample to the candidate asynchronously, with
  ``X-Pio-Priority: shadow``).  Answers are diffed — result parity for
  byte-identical bodies, itemScores set + score-delta histogram for JSON
  recommendations — and latency reservoirs track both sides' p50/p95.
- **canary** — a configurable keyspace fraction is routed to the
  candidate *for real*.  The fraction is carved with the same rendezvous
  hash the ring uses (:func:`~pio_tpu_torch.router.ring.hrw_score` over a
  rollout-stable seed), so the canary keyspace is stable and
  entity-affine: one entity is either fully on the candidate or fully
  off it, across the whole stage.
- **judge** — every tick, a dedicated :class:`~pio_tpu_torch.obs.slo.SLOEngine`
  evaluates the candidate's own scrape (availability from
  ``pio_tpu_queries_total`` / ``pio_tpu_query_errors_total``) through
  one fast/slow multi-window burn pair, alongside the shadow mismatch
  rate, the shadow latency ratio, and candidate reachability.  Any
  firing signal rolls the rollout back — the candidate can never hold
  traffic for more than one judging window past a regression.
- **promote / rollback** — both ride the manifest-verified deploy path
  (:func:`~pio_tpu_torch.router.deploy.push_deploy`): a member's generation
  flips only on a verified 200, and rollback re-pushes the incumbent
  manifest byte-identically (same sha256 set — the property the test
  suite pins).

Every transition lands in a durable decision trail (who, when, which
signal, which window) served on ``/rollout.json`` and federated into
``/fleet.json``.  Chaos hooks: ``rollout.mirror`` / ``rollout.judge`` /
``rollout.promote`` / ``rollout.rollback`` failpoints.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.obs import monotonic_s, promparse
from pio_tpu_torch.obs.metrics import MetricsRegistry
from pio_tpu_torch.obs.slo import SLOEngine, SLObjective
from pio_tpu_torch.qos.policy import PRIORITY_HEADER
from pio_tpu_torch.router.deploy import push_deploy
from pio_tpu_torch.router.ring import hrw_score

log = logging.getLogger("pio_tpu_torch.router.rollout")

__all__ = [
    "RolloutConfig",
    "RolloutController",
    "RolloutMetrics",
    "STAGES",
    "diff_answers",
]

#: stage -> numeric code for the ``pio_tpu_rollout_stage`` gauge
STAGES: Dict[str, int] = {
    "pending": 0,
    "deploying": 1,
    "shadow": 2,
    "canary": 3,
    "promoting": 4,
    "promoted": 5,
    "rolling_back": 6,
    "rolled_back": 7,
    "failed": 8,
}
TERMINAL = ("promoted", "rolled_back", "failed")

#: score-delta buckets for the shadow parity histogram (absolute
#: difference between incumbent and candidate scores for the same item)
SCORE_DELTA_BUCKETS = (
    1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 10.0,
)

_HRW_SPAN = float(2 ** 64)


@dataclass
class RolloutConfig:
    """Knobs for one progressive rollout (the ``POST /rollout`` body)."""

    candidate_instance: str
    #: candidate serving members as (name, base_url) pairs — the
    #: ``parse_targets`` shape; these join the router as aux members
    #: (pooled upstreams, never in the incumbent ring)
    candidate_targets: Sequence[Tuple[str, str]] = ()
    #: discovered from the ring members' ``GET /deploy.json`` when None
    incumbent_instance: Optional[str] = None
    #: fraction of live incumbent traffic mirrored during shadow/canary
    shadow_rate: float = 0.25
    #: shadow samples required before the stage may advance
    shadow_min_samples: int = 50
    #: minimum wall time in shadow before advancing
    shadow_hold_s: float = 10.0
    #: mismatch fraction at/over which the rollout rolls back
    mismatch_limit: float = 0.02
    #: |score delta| below which differing JSON answers still match
    score_tolerance: float = 1e-3
    #: candidate shadow p95 may be at most this multiple of incumbent's
    latency_limit_x: float = 5.0
    #: keyspace fraction served by the candidate during canary
    canary_fraction: float = 0.1
    #: minimum wall time in canary before promoting
    canary_hold_s: float = 30.0
    #: candidate-served requests required before promoting
    canary_min_requests: int = 20
    judge_interval_s: float = 2.0
    #: fast/slow burn windows for the candidate availability judge
    judge_fast_s: float = 30.0
    judge_slow_s: float = 120.0
    #: burn rate both windows must exceed to trigger rollback
    burn_limit: float = 2.0
    availability_objective: float = 0.99
    #: consecutive candidate scrape failures before rollback
    down_after_failures: int = 3
    #: advance/promote automatically; False parks at each gate until
    #: :meth:`RolloutController.approve` is called
    auto: bool = True

    def validate(self) -> None:
        if not self.candidate_instance:
            raise ValueError("rollout needs a candidate engineInstanceId")
        if not self.candidate_targets:
            raise ValueError(
                "rollout needs at least one candidate target "
                "(name=host:port)"
            )
        if not 0.0 <= self.shadow_rate <= 1.0:
            raise ValueError("shadow_rate must be in [0, 1]")
        if not 0.0 <= self.canary_fraction <= 1.0:
            raise ValueError("canary_fraction must be in [0, 1]")
        if not 0.0 < self.availability_objective < 1.0:
            raise ValueError("availability_objective must be in (0, 1)")


class RolloutMetrics:
    """``pio_tpu_rollout_*`` families, registered once per registry and
    shared by consecutive rollouts (registration is idempotent)."""

    def __init__(self, registry: MetricsRegistry):
        self.stage = registry.gauge(
            "pio_tpu_rollout_stage",
            "Current rollout stage as a code (0 pending, 1 deploying, "
            "2 shadow, 3 canary, 4 promoting, 5 promoted, "
            "6 rolling_back, 7 rolled_back, 8 failed)",
        )
        self.generation = registry.gauge(
            "pio_tpu_rollout_generation",
            "Monotone count of rollouts started on this router",
        )
        self.transitions = registry.counter(
            "pio_tpu_rollout_transitions_total",
            "Rollout stage transitions, labeled by the stage entered",
            ("to",),
        )
        self.mirrored = registry.counter(
            "pio_tpu_rollout_mirrored_total",
            "Shadow mirror attempts by outcome "
            "(ok / error / dropped)",
            ("outcome",),
        )
        self.shadow_samples = registry.counter(
            "pio_tpu_rollout_shadow_samples_total",
            "Diffed shadow answers by verdict (match / mismatch)",
            ("verdict",),
        )
        self.canary_requests = registry.counter(
            "pio_tpu_rollout_canary_requests_total",
            "Live requests served by the candidate during canary",
        )
        self.judge = registry.counter(
            "pio_tpu_rollout_judge_total",
            "Judge ticks by verdict (ok / rollback)",
            ("verdict",),
        )
        self.score_delta = registry.histogram(
            "pio_tpu_rollout_score_delta",
            "Absolute score difference between incumbent and candidate "
            "for the same recommended item (shadow diffing)",
            buckets=SCORE_DELTA_BUCKETS,
        )


def _item_scores(body: bytes) -> Optional[Dict[str, float]]:
    """``{item: score}`` when the body is a JSON prediction carrying
    ``itemScores`` (the reference recommendation answer shape)."""
    import json

    try:
        got = json.loads(body.decode("utf-8"))
    except Exception:
        return None
    if not isinstance(got, dict):
        return None
    rows = got.get("itemScores")
    if not isinstance(rows, list):
        return None
    out: Dict[str, float] = {}
    for row in rows:
        if not isinstance(row, dict):
            return None
        item = row.get("item", row.get("iid"))
        score = row.get("score")
        if item is None or score is None:
            return None
        out[str(item)] = float(score)
    return out


def diff_answers(
    inc_status: int,
    inc_body: bytes,
    cand_status: int,
    cand_body: bytes,
    score_tolerance: float = 1e-3,
) -> Tuple[bool, List[float]]:
    """Shadow parity verdict: ``(match, score_deltas)``.

    Status codes must agree; byte-identical bodies match outright; JSON
    answers carrying ``itemScores`` match when they recommend the same
    item set with every score within ``score_tolerance`` (the deltas are
    returned for the histogram either way).  Anything else is a
    mismatch.
    """
    if inc_status != cand_status:
        return False, []
    if bytes(inc_body) == bytes(cand_body):
        return True, []
    a, b = _item_scores(inc_body), _item_scores(cand_body)
    if a is None or b is None:
        return False, []
    if set(a) != set(b):
        return False, []
    deltas = [abs(a[k] - b[k]) for k in a]
    return all(d <= score_tolerance for d in deltas), deltas


def _percentiles(samples: Sequence[float]) -> Optional[dict]:
    if not samples:
        return None
    s = sorted(samples)

    def pct(q: float) -> float:
        idx = min(len(s) - 1, max(0, int(q * len(s))))
        return s[idx]

    return {
        "samples": len(s),
        "p50Ms": round(pct(0.50) * 1e3, 3),
        "p95Ms": round(pct(0.95) * 1e3, 3),
        "p99Ms": round(pct(0.99) * 1e3, 3),
    }


class RolloutController:
    """One candidate's journey through the stage machine.

    ``core`` is the live :class:`~pio_tpu_torch.router.core.ServingRouter`;
    the controller attaches itself through the router's opaque
    observe/divert hooks so the relay hot path keeps its zero-copy
    contract.  ``manifest_loader(instance_id) -> Optional[dict]`` and
    ``fetch(url, timeout) -> bytes`` are injectable for tests.
    """

    def __init__(
        self,
        core,
        config: RolloutConfig,
        metrics: RolloutMetrics,
        manifest_loader: Optional[Callable[[str], Optional[dict]]] = None,
        fetch: Optional[Callable[[str, float], bytes]] = None,
        admin_key: Optional[str] = None,
        generation: int = 1,
        started_by: str = "operator",
    ):
        config.validate()
        self.core = core
        self.cfg = config
        self.metrics = metrics
        self.admin_key = admin_key
        self.generation = generation
        self.started_by = started_by
        self._manifest_loader = manifest_loader
        if fetch is None:
            from pio_tpu_torch.obs.fleet import _default_fetch

            fetch = _default_fetch
        self._fetch = fetch

        self.stage = "pending"
        self.trail: List[dict] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stage_entered = monotonic_s()
        self._approved = threading.Event()
        if config.auto:
            self._approved.set()

        self.candidate_members = [name for name, _ in
                                  config.candidate_targets]
        self._candidate_set = frozenset(self.candidate_members)
        self.incumbent_instance = config.incumbent_instance
        #: sha256 set of the incumbent manifest at rollout start — the
        #: byte-identity witness rollback is checked against
        self.incumbent_shas: List[str] = []
        self._candidate_manifest: Optional[dict] = None
        self._incumbent_manifest: Optional[dict] = None
        #: ring members whose generation flipped to the candidate during
        #: promote (rollback must re-push the incumbent to exactly these)
        self._promoted_members: List[str] = []

        # shadow mirroring
        self._mirror_q: deque = deque(maxlen=256)
        self._mirror_wake = threading.Event()
        self._mirror_thread: Optional[threading.Thread] = None
        self._sample_acc = 0.0
        self._mirror_rr = 0
        self.shadow_matches = 0
        self.shadow_mismatches = 0
        self.shadow_dropped = 0
        self._lat_incumbent: deque = deque(maxlen=512)
        self._lat_candidate: deque = deque(maxlen=512)

        # canary accounting
        self.canary_requests = 0
        self.canary_errors = 0

        # judge
        self._canary_seed = f"rollout:{config.candidate_instance}"
        self._scrape_failures = 0
        self._cand_good = 0.0
        self._cand_total = 0.0
        self.judge_ticks = 0
        self.last_verdict: Optional[str] = None
        self.last_burn: Dict[str, float] = {}
        self.slo = SLOEngine(burn_windows=(
            (config.judge_fast_s, config.judge_slow_s,
             config.burn_limit, "rollback"),
        ))
        self.slo.add(
            SLObjective(
                name="candidate_availability",
                kind="availability",
                objective=config.availability_objective,
                window_s=config.judge_slow_s,
            ),
            self._candidate_good_total,
        )

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        """Deploy the candidate and run the stage machine in the
        background; transitions land on the decision trail."""
        if self._thread is not None:
            return
        self.metrics.generation.set(float(self.generation))
        self._thread = threading.Thread(
            target=self._run, name="rollout-controller", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._mirror_wake.set()
        self._approved.set()
        for t in (self._thread, self._mirror_thread):
            if t is not None:
                t.join(timeout=5.0)
        self._thread = self._mirror_thread = None

    def abort(self, by: str = "operator") -> None:
        """Operator bail-out: immediate rollback from any live stage."""
        with self._lock:
            if self.stage in TERMINAL:
                return
        self._rollback("operator_abort", f"aborted by {by}")

    def approve(self) -> None:
        """Release a non-auto rollout's current gate (shadow->canary or
        canary->promote)."""
        self._approved.set()

    def active(self) -> bool:
        return self.stage not in TERMINAL

    def _run(self) -> None:
        try:
            self._deploy_candidate()
        except Exception as e:
            log.exception("rollout: candidate deploy failed")
            self._rollback("candidate_deploy_failed",
                           f"{type(e).__name__}: {e}")
            return
        if self.stage in TERMINAL:
            return
        self._enter_shadow()
        while not self._stop.is_set() and self.stage in ("shadow", "canary"):
            if self._stop.wait(self.cfg.judge_interval_s):
                return
            try:
                self.judge_once()
            except Exception as e:
                log.exception("rollout: judge tick failed")
                self._rollback("judge_error", f"{type(e).__name__}: {e}")
                return

    # -- trail / transitions -------------------------------------------------
    # pio: endpoint=/rollout.json
    def _transition(self, to: str, signal: str, detail: str = "",
                    window: Optional[str] = None) -> None:
        with self._lock:
            frm = self.stage
            self.stage = to
            self._stage_entered = monotonic_s()
            entry = {
                # wall time: the decision trail is operator-facing
                # evidence, correlated with logs across hosts
                "at": time.time(),  # pio: disable=wallclock-duration
                "from": frm,
                "to": to,
                "signal": signal,
                "detail": detail,
                "window": window,
                "by": self.started_by,
            }
            self.trail.append(entry)
        self.metrics.stage.set(float(STAGES.get(to, -1)))
        self.metrics.transitions.inc(to=to)
        log.info("rollout %s: %s -> %s (%s%s)", self.cfg.candidate_instance,
                 frm, to, signal, f": {detail}" if detail else "")

    # -- deploy -------------------------------------------------------------
    def _load_manifest(self, instance_id: str) -> Optional[dict]:
        if self._manifest_loader is not None:
            return self._manifest_loader(instance_id)
        from pio_tpu_torch.router.deploy import load_manifest
        from pio_tpu_torch.storage import Storage

        return load_manifest(Storage.get_model_data_models(), instance_id)

    @staticmethod
    def _manifest_shas(manifest: Optional[dict]) -> List[str]:
        from pio_tpu_torch.router.deploy import manifest_digests

        if manifest is None:
            return []
        return sorted(
            sha for sha, _size in manifest_digests(manifest).values()
        )

    def _discover_incumbent(self) -> None:
        """Pin the incumbent instance from the ring members' own
        ``GET /deploy.json`` generation reports."""
        if self.incumbent_instance is not None:
            return
        import json

        for ms in self.core.ring_members():
            try:
                raw = self._fetch(
                    ms.base_url + "/deploy.json", self.core.timeout_s
                )
                got = json.loads(raw.decode("utf-8"))
            except Exception:
                continue
            iid = got.get("engineInstanceId")
            if iid:
                self.incumbent_instance = str(iid)
                return
        raise RuntimeError(
            "cannot discover the incumbent instance: no ring member "
            "answered GET /deploy.json (pass incumbentInstance explicitly)"
        )

    def _deploy_candidate(self) -> None:
        self._transition("deploying", "start",
                         f"candidate {self.cfg.candidate_instance}")
        self._discover_incumbent()
        self._candidate_manifest = self._load_manifest(
            self.cfg.candidate_instance
        )
        self._incumbent_manifest = self._load_manifest(
            self.incumbent_instance
        )
        self.incumbent_shas = self._manifest_shas(self._incumbent_manifest)
        for name, url in self.cfg.candidate_targets:
            self.core.add_member(name, url, aux=True)
        failures = []
        for name, url in self.cfg.candidate_targets:
            outcome, detail = push_deploy(
                url, self.cfg.candidate_instance, self._candidate_manifest,
                timeout_s=max(self.core.timeout_s, 60.0),
                admin_key=self.admin_key,
            )
            if outcome != "verified":
                failures.append(f"{name}: {outcome} ({detail})")
        if failures:
            raise RuntimeError("; ".join(failures))

    def _enter_shadow(self) -> None:
        self._transition("shadow", "candidate_verified",
                         f"{len(self.candidate_members)} candidate "
                         f"member(s) verified on "
                         f"{self.cfg.candidate_instance}")
        self._mirror_thread = threading.Thread(
            target=self._mirror_loop, name="rollout-mirror", daemon=True
        )
        self._mirror_thread.start()
        self.core.set_observer(self.observe)
        if not self.cfg.auto:
            self._approved.clear()

    # -- shadow mirroring ----------------------------------------------------
    def observe(self, method, path, body, headers, entity_id, priority,
                member, status, out, elapsed_s) -> None:
        """Router hook: one completed relay. Candidate-served relays
        feed canary accounting; incumbent-served ones feed the latency
        reservoir and (sampled) the mirror queue. Never raises."""
        try:
            if self.stage not in ("shadow", "canary"):
                return
            if member in self._candidate_set:
                with self._lock:
                    self.canary_requests += 1
                    if status >= 500:
                        self.canary_errors += 1
                    self._lat_candidate.append(elapsed_s)
                self.metrics.canary_requests.inc()
                return
            if priority == "shadow":
                return  # never mirror a mirror
            with self._lock:
                self._lat_incumbent.append(elapsed_s)
                self._sample_acc += self.cfg.shadow_rate
                if self._sample_acc < 1.0:
                    return
                self._sample_acc -= 1.0
                dropped = len(self._mirror_q) == self._mirror_q.maxlen
                self._mirror_q.append(
                    (method, path, bytes(body) if body is not None else b"",
                     dict(headers), entity_id, status, bytes(out))
                )
            if dropped:
                self.shadow_dropped += 1
                self.metrics.mirrored.inc(outcome="dropped")
            self._mirror_wake.set()
        except Exception:
            log.debug("rollout observer swallowed an error", exc_info=True)

    def _mirror_loop(self) -> None:
        while not self._stop.is_set():
            self._mirror_wake.wait(timeout=0.5)
            self._mirror_wake.clear()
            while True:
                try:
                    item = self._mirror_q.popleft()
                except IndexError:
                    break
                if self.stage not in ("shadow", "canary"):
                    continue
                self._mirror_one(*item)

    def _mirror_one(self, method, path, body, headers, entity_id,
                    inc_status, inc_body) -> None:
        name = self._pick_candidate(entity_id)
        if name is None:
            return
        try:
            failpoint("rollout.mirror")
            hdrs = {
                k: v for k, v in headers.items()
                if k.lower() in ("content-type",)
            }
            hdrs[PRIORITY_HEADER] = "shadow"
            t0 = monotonic_s()
            status, _reply, out = self.core.upstream_request(
                name, method, path, body, hdrs
            )
            self._lat_candidate.append(monotonic_s() - t0)
        except Exception:
            self.metrics.mirrored.inc(outcome="error")
            return
        self.metrics.mirrored.inc(outcome="ok")
        match, deltas = diff_answers(
            inc_status, inc_body, status, out,
            score_tolerance=self.cfg.score_tolerance,
        )
        for d in deltas:
            self.metrics.score_delta.observe(d)
        with self._lock:
            if match:
                self.shadow_matches += 1
            else:
                self.shadow_mismatches += 1
        self.metrics.shadow_samples.inc(
            verdict="match" if match else "mismatch"
        )

    def _pick_candidate(self, entity_id: Optional[str]) -> Optional[str]:
        live = [m for m in self.candidate_members
                if self.core.has_member(m)]
        if not live:
            return None
        if entity_id:
            return max(live, key=lambda m: hrw_score(m, str(entity_id)))
        self._mirror_rr += 1
        return live[self._mirror_rr % len(live)]

    # -- canary diversion ----------------------------------------------------
    def in_canary_keyspace(self, entity_id: str) -> bool:
        """Stable entity-affine fraction carve: the same rendezvous hash
        the ring runs, seeded per-rollout so consecutive rollouts canary
        different slices of the keyspace."""
        frac = self.cfg.canary_fraction
        if frac <= 0.0:
            return False
        if frac >= 1.0:
            return True
        return hrw_score(self._canary_seed, str(entity_id)) / _HRW_SPAN < frac

    def divert(self, entity_id, priority) -> Optional[str]:
        """Router hook consulted at pick time: the candidate member that
        should front this request, or None to route normally. Only real
        (non-shadow) traffic in the canary keyspace diverts; the
        incumbent plan stays behind the candidate, so a dead candidate
        costs one transparent retry, not an error."""
        try:
            if self.stage != "canary" or priority == "shadow":
                return None
            if not entity_id or not self.in_canary_keyspace(str(entity_id)):
                return None
            return self._pick_candidate(str(entity_id))
        except Exception:
            return None

    # -- judge --------------------------------------------------------------
    def _candidate_good_total(self) -> Tuple[float, float]:
        return self._cand_good, self._cand_total

    def _scrape_candidate(self) -> bool:
        """Pull every candidate's /metrics and fold the serving
        counters into the cumulative availability source."""
        good = total = 0.0
        any_ok = False
        for name, url in self.cfg.candidate_targets:
            try:
                raw = self._fetch(url + "/metrics", self.core.timeout_s)
                pm = promparse.parse_prometheus_text(raw.decode("utf-8"))
            except Exception:
                continue
            any_ok = True
            t = sum(pm.family("pio_tpu_queries_total").values())
            e = sum(pm.family("pio_tpu_query_errors_total").values())
            total += t
            good += max(t - e, 0.0)
        if any_ok:
            # monotone across partial scrapes: a member missing one tick
            # must not make the cumulative source step backwards
            self._cand_good = max(self._cand_good, good)
            self._cand_total = max(self._cand_total, total)
        return any_ok

    def _held_s(self) -> float:
        return monotonic_s() - self._stage_entered

    def judge_once(self, now: Optional[float] = None) -> str:
        """One judge tick: scrape, evaluate every rollback signal, then
        advance/promote when the stage's gate clears.  Returns the
        verdict (``ok`` / ``rollback`` / the stage entered).  Tests
        drive this directly with an explicit clock."""
        failpoint("rollout.judge")
        if self.stage not in ("shadow", "canary"):
            return self.stage
        t = monotonic_s() if now is None else now
        self.judge_ticks += 1

        if self._scrape_candidate():
            self._scrape_failures = 0
        else:
            self._scrape_failures += 1
            if self._scrape_failures >= self.cfg.down_after_failures:
                self.metrics.judge.inc(verdict="rollback")
                self.last_verdict = "rollback"
                self._rollback(
                    "candidate_unreachable",
                    f"{self._scrape_failures} consecutive scrape "
                    f"failures across "
                    f"{len(self.candidate_members)} candidate member(s)",
                )
                return "rollback"

        report = self.slo.evaluate(now=t)
        slo_row = report["slos"][0]
        self.last_burn = dict(slo_row["burnRates"])
        fast_key = f"{int(self.cfg.judge_fast_s)}s"
        slow_key = f"{int(self.cfg.judge_slow_s)}s"
        window_name = f"{fast_key}/{slow_key}"
        firing = any(a["firing"] for a in slo_row["alerts"])
        if firing and slo_row["total"] > 0:
            self.metrics.judge.inc(verdict="rollback")
            self.last_verdict = "rollback"
            self._rollback(
                "slo_burn",
                f"candidate availability burn "
                f"{self.last_burn.get(fast_key)} (fast) / "
                f"{self.last_burn.get(slow_key)} (slow) over limit "
                f"{self.cfg.burn_limit}",
                window=window_name,
            )
            return "rollback"

        with self._lock:
            samples = self.shadow_matches + self.shadow_mismatches
            mismatch_rate = (
                self.shadow_mismatches / samples if samples else 0.0
            )
            lat_inc = list(self._lat_incumbent)
            lat_cand = list(self._lat_candidate)
        if (samples >= self.cfg.shadow_min_samples
                and mismatch_rate > self.cfg.mismatch_limit):
            self.metrics.judge.inc(verdict="rollback")
            self.last_verdict = "rollback"
            self._rollback(
                "shadow_mismatch",
                f"mismatch rate {mismatch_rate:.4f} over limit "
                f"{self.cfg.mismatch_limit} ({samples} samples)",
            )
            return "rollback"
        if len(lat_inc) >= 20 and len(lat_cand) >= 20:
            p95_inc = _percentiles(lat_inc)["p95Ms"]
            p95_cand = _percentiles(lat_cand)["p95Ms"]
            if (p95_inc > 0.0
                    and p95_cand > p95_inc * self.cfg.latency_limit_x):
                self.metrics.judge.inc(verdict="rollback")
                self.last_verdict = "rollback"
                self._rollback(
                    "shadow_latency",
                    f"candidate p95 {p95_cand}ms over "
                    f"{self.cfg.latency_limit_x}x incumbent "
                    f"p95 {p95_inc}ms",
                )
                return "rollback"

        self.metrics.judge.inc(verdict="ok")
        self.last_verdict = "ok"

        held = self._held_s() if now is None else (t - self._stage_entered)
        if self.stage == "shadow":
            if (held >= self.cfg.shadow_hold_s
                    and samples >= self.cfg.shadow_min_samples
                    and self._approved.is_set()):
                self._enter_canary(samples, mismatch_rate)
                return "canary"
        elif self.stage == "canary":
            with self._lock:
                canaried = self.canary_requests
            if (held >= self.cfg.canary_hold_s
                    and canaried >= self.cfg.canary_min_requests
                    and self._approved.is_set()):
                self._promote(canaried)
                return self.stage
        return "ok"

    def _enter_canary(self, samples: int, mismatch_rate: float) -> None:
        self._transition(
            "canary", "shadow_clean",
            f"{samples} shadow samples, mismatch rate "
            f"{mismatch_rate:.4f}, diverting "
            f"{self.cfg.canary_fraction:.0%} of keyspace",
        )
        self.core.set_divert(self.divert)
        if not self.cfg.auto:
            self._approved.clear()

    # -- promote / rollback --------------------------------------------------
    def _promote(self, canaried: int) -> None:
        failpoint("rollout.promote")
        self._transition(
            "promoting", "canary_clean",
            f"{canaried} candidate-served requests, "
            f"burn {self.last_burn or '{}'}",
        )
        failures = []
        for ms in self.core.ring_members():
            outcome, detail = push_deploy(
                ms.base_url, self.cfg.candidate_instance,
                self._candidate_manifest,
                timeout_s=max(self.core.timeout_s, 60.0),
                admin_key=self.admin_key,
            )
            self.core.note_deploy(
                ms.name, self.cfg.candidate_instance, outcome
            )
            if outcome == "verified":
                self._promoted_members.append(ms.name)
            else:
                failures.append(f"{ms.name}: {outcome} ({detail})")
        if failures:
            self._rollback(
                "promote_failed",
                "; ".join(failures) or "unverified member(s)",
            )
            return
        self._detach()
        self._transition(
            "promoted", "all_verified",
            f"{len(self._promoted_members)} ring member(s) flipped to "
            f"{self.cfg.candidate_instance}",
        )
        self._teardown_candidates()

    def _rollback(self, signal: str, detail: str,
                  window: Optional[str] = None) -> None:
        with self._lock:
            if self.stage in TERMINAL or self.stage == "rolling_back":
                return
        # detach FIRST: no new traffic may reach the candidate while the
        # incumbent manifest is going back out
        self._detach()
        self._transition("rolling_back", signal, detail, window=window)
        try:
            failpoint("rollout.rollback")
        except Exception:
            log.warning("rollout.rollback failpoint fired during rollback")
        restore: List[Tuple[str, str]] = []
        for name in self._promoted_members:
            ms = self.core.member(name)
            if ms is not None:
                restore.append((name, ms.base_url))
        restore.extend(
            (name, url) for name, url in self.cfg.candidate_targets
        )
        restored = 0
        problems = []
        if self.incumbent_instance:
            for name, url in restore:
                outcome, detail_r = push_deploy(
                    url, self.incumbent_instance, self._incumbent_manifest,
                    timeout_s=max(self.core.timeout_s, 60.0),
                    admin_key=self.admin_key,
                )
                if name in self._promoted_members:
                    self.core.note_deploy(
                        name, self.incumbent_instance, outcome
                    )
                if outcome == "verified":
                    restored += 1
                else:
                    problems.append(f"{name}: {outcome}")
        self._promoted_members = []
        self._teardown_candidates()
        self._transition(
            "rolled_back", "incumbent_restored",
            f"incumbent {self.incumbent_instance} re-pushed to "
            f"{restored}/{len(restore)} member(s)"
            + (f"; unrestored: {', '.join(problems)}" if problems else ""),
        )
        self._stop.set()
        self._mirror_wake.set()

    def _detach(self) -> None:
        self.core.set_divert(None)
        self.core.set_observer(None)

    def _teardown_candidates(self) -> None:
        for name in self.candidate_members:
            try:
                self.core.remove_member(name)
            except Exception:
                pass

    # -- /rollout.json -------------------------------------------------------
    # pio: endpoint=/rollout.json
    def payload(self) -> dict:
        """The ``GET /rollout.json`` body (schema in
        docs/observability.md); federated into ``/fleet.json``."""
        with self._lock:
            samples = self.shadow_matches + self.shadow_mismatches
            body = {
                "stage": self.stage,
                "stageCode": STAGES.get(self.stage, -1),
                "generation": self.generation,
                "candidateInstance": self.cfg.candidate_instance,
                "incumbentInstance": self.incumbent_instance,
                "candidateMembers": list(self.candidate_members),
                "startedBy": self.started_by,
                "auto": self.cfg.auto,
                "config": {
                    "shadowRate": self.cfg.shadow_rate,
                    "shadowMinSamples": self.cfg.shadow_min_samples,
                    "shadowHoldSeconds": self.cfg.shadow_hold_s,
                    "mismatchLimit": self.cfg.mismatch_limit,
                    "scoreTolerance": self.cfg.score_tolerance,
                    "latencyLimitX": self.cfg.latency_limit_x,
                    "canaryFraction": self.cfg.canary_fraction,
                    "canaryHoldSeconds": self.cfg.canary_hold_s,
                    "canaryMinRequests": self.cfg.canary_min_requests,
                    "judgeIntervalSeconds": self.cfg.judge_interval_s,
                    "judgeWindowsSeconds": [
                        self.cfg.judge_fast_s, self.cfg.judge_slow_s
                    ],
                    "burnLimit": self.cfg.burn_limit,
                    "availabilityObjective":
                        self.cfg.availability_objective,
                },
                "shadow": {
                    "samples": samples,
                    "matches": self.shadow_matches,
                    "mismatches": self.shadow_mismatches,
                    "mismatchRate": round(
                        self.shadow_mismatches / samples, 4
                    ) if samples else 0.0,
                    "dropped": self.shadow_dropped,
                    "latency": {
                        "incumbent": _percentiles(self._lat_incumbent),
                        "candidate": _percentiles(self._lat_candidate),
                    },
                },
                "canary": {
                    "fraction": self.cfg.canary_fraction,
                    "requests": self.canary_requests,
                    "errors": self.canary_errors,
                },
                "judge": {
                    "ticks": self.judge_ticks,
                    "lastVerdict": self.last_verdict,
                    "burnRates": dict(self.last_burn),
                    "scrapeFailures": self._scrape_failures,
                },
                "incumbentManifestSha256": list(self.incumbent_shas),
                "trail": [dict(e) for e in self.trail],
            }
        return body
