"""The port's QoS package against the JAX package's, on the CPU.

- ``parse_qos`` and ``cache_key``: equal results, or the same error class
  and message, over hypothesis strings and JSON values (derandomized, no
  example database); ``policy_from_dict`` and ``resolve_policy``'s
  precedence (spec, ``PIO_TPU_QOS``, the variant's block).
- ``TokenBucket``, ``KeyedBuckets``, ``ConcurrencyLimiter``,
  ``CircuitBreaker``, ``StaleCache`` and ``Deadline``, each driven by the
  same scripted sequence on an injected clock: the same decision at every
  step. ``QoSGate``: the same admissions, sheds, breaker states and
  ``/qos.json`` snapshot; ``retry_after_header`` the same values.
- ``retrying`` with a ``Deadline``: the same attempts, the same raise, and
  ``pio_tpu_storage_retries_total`` counting the same retries.

No verdict depends on a sleep or a wall-clock rate: every clock is
injected, and the retry wrapper's sleeps are patched out in both.
"""

import json
import sqlite3
import threading

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import pio_tpu.qos as rq
import pio_tpu_torch.qos as pq
from pio_tpu.storage import retry as r_retry
from pio_tpu_torch.storage import retry as p_retry

PKGS = {"reference": rq, "port": pq}
SETTINGS = settings(max_examples=250, deadline=None, derandomize=True,
                    database=None)


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 (compared across packages)
        return ("error", type(e).__name__, str(e))


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


# ---------------------------------------------------------------- parsers
KEYS = ["rps", "burst", "key_rps", "key_burst", "inflight", "queue",
        "deadline", "cache", "fail_rate", "fail_window", "probes",
        "cooldown", "RPS", "bogus", ""]
VALUES = ["0", "1", "2.5", "100", "-3", "abc", "", "50ms", "2s", "1.5m",
          "3us", "1e2", "0.5", "7d"]
qos_text = st.one_of(
    st.lists(st.builds(lambda k, sep, v: f"{k}{sep}{v}",
                       st.sampled_from(KEYS), st.sampled_from(["=", ":", ""]),
                       st.sampled_from(VALUES)),
             max_size=5).map(",".join),
    st.text(max_size=30),
)


@SETTINGS
@given(qos_text)
def test_parse_qos_matches_reference(spec):
    got = outcome(pq.parse_qos, spec)
    want = outcome(rq.parse_qos, spec)
    if got[0] == "ok" and want[0] == "ok":
        got, want = got[1].to_dict(), want[1].to_dict()
    assert got == want


json_value = st.recursive(
    st.one_of(st.none(), st.booleans(), st.integers(-5, 5),
              st.floats(allow_nan=False), st.text(max_size=5)),
    lambda inner: st.one_of(st.lists(inner, max_size=3),
                            st.dictionaries(st.text(max_size=4), inner,
                                            max_size=3)),
    max_leaves=8,
)


@SETTINGS
@given(json_value)
def test_cache_key_matches_reference(value):
    assert pq.cache_key(value) == rq.cache_key(value)


def test_cache_key_is_order_free_and_falls_back_like_reference():
    a, b = {"user": "u1", "num": 3}, {"num": 3, "user": "u1"}
    assert pq.cache_key(a) == pq.cache_key(b) == rq.cache_key(a)
    odd = {1: {2, 3}}  # a set: not JSON, default=str renders it
    assert pq.cache_key(odd) == rq.cache_key(odd)


@pytest.mark.parametrize("block", [
    {"spec": "rps=10,queue=4"},
    {"rps": 5.0, "inflight": 2, "cache": 8},
    {"rps": 5, "nope": 1},
    {"inflight": "x"},
    {"spec": "bad"},
])
def test_policy_from_dict_matches_reference(block):
    got = outcome(pq.policy_from_dict, block)
    want = outcome(rq.policy_from_dict, block)
    if got[0] == "ok" and want[0] == "ok":
        got, want = got[1].to_dict(), want[1].to_dict()
    assert got == want


@pytest.mark.parametrize("spec,env,variant", [
    (None, None, None),
    ("rps=5", "inflight=2", {"qos": {"cache": 3}}),
    (None, "inflight=2", {"qos": {"cache": 3}}),
    (None, None, {"qos": {"cache": 3}}),
    (None, None, {"qos": "queue=7,inflight=1"}),
    (None, "bogus=1", None),
])
def test_resolve_policy_precedence_matches_reference(monkeypatch, spec, env,
                                                     variant):
    if env is None:
        monkeypatch.delenv("PIO_TPU_QOS", raising=False)
    else:
        monkeypatch.setenv("PIO_TPU_QOS", env)
    got = outcome(pq.resolve_policy, spec, variant)
    want = outcome(rq.resolve_policy, spec, variant)
    if got[0] == "ok" and want[0] == "ok":
        got = got[1] and got[1].to_dict()
        want = want[1] and want[1].to_dict()
    assert got == want


# ------------------------------------------------------------- mechanisms
BUCKET_SCRIPT = [  # (clock advance, cost, floor)
    (0.0, 1, 0.0), (0.0, 1, 0.0), (0.0, 1, 0.5), (0.05, 1, 0.0),
    (0.0, 1, 0.0), (0.2, 1, 0.25), (0.0, 2, 0.0), (1.0, 1, 0.5),
    (0.0, 1, 0.5), (0.0, 1, 0.5), (0.0, 1, 0.0), (3.0, 1, 0.0),
    (0.0, 0.5, 0.0), (0.013, 1, 0.0),
]


def test_token_bucket_decides_like_reference():
    out = {}
    for pkg, q in PKGS.items():
        clock = Clock()
        b = q.TokenBucket(rate=4.0, burst=3.0, clock=clock)
        steps = []
        for dt, cost, floor in BUCKET_SCRIPT:
            clock.tick(dt)
            ok, retry = b.try_acquire(cost, floor)
            steps.append((ok, round(retry, 12), round(b.level(), 12)))
        out[pkg] = steps
    assert out["port"] == out["reference"]
    assert any(ok for ok, _, _ in out["port"])
    assert any(not ok for ok, _, _ in out["port"])
    for pkg, q in PKGS.items():
        with pytest.raises(ValueError):
            q.TokenBucket(rate=0, burst=1)


def test_keyed_buckets_decide_like_reference():
    keys = ["a", "b", "a", "c", "a", "d", "b", "a", "e", "a"]
    out = {}
    for pkg, q in PKGS.items():
        clock = Clock()
        kb = q.KeyedBuckets(rate=1.0, burst=2.0, max_keys=3, clock=clock)
        steps = []
        for k, key in enumerate(keys):
            clock.tick(0.1 * (k % 3))
            ok, retry = kb.try_acquire(key)
            steps.append((ok, round(retry, 12), len(kb)))
        out[pkg] = steps
    assert out["port"] == out["reference"]


def test_concurrency_limiter_decides_like_reference():
    """Two slots, one queue place: the script takes both slots, fills the
    queue place from another thread, sheds the next entrant, times one
    out on an already-spent budget, and lets the queued one in on exit."""
    out = {}
    for pkg, q in PKGS.items():
        clock = Clock()
        lim = q.ConcurrencyLimiter(2, max_queue=1, clock=clock)
        steps = [lim.enter(), lim.enter(), (lim.inflight, lim.queued)]
        entered = {}
        waiter = threading.Thread(
            target=lambda: entered.setdefault("w", lim.enter()))
        waiter.start()
        for _ in range(2000):  # the waiter parks in the queue
            if lim.queued == 1:
                break
            threading.Event().wait(0.005)
        steps.append((lim.inflight, lim.queued))
        steps.append(lim.enter(timeout_s=0.0))  # queue full
        lim.exit()
        waiter.join(timeout=30)
        steps += [entered.get("w"), (lim.inflight, lim.queued)]
        # a free queue place but a spent budget: timeout, not a wait
        lim2 = q.ConcurrencyLimiter(1, max_queue=1, clock=clock)
        steps += [lim2.enter(), lim2.enter(timeout_s=0.0),
                  (lim2.inflight, lim2.queued)]
        out[pkg] = steps
    assert out["port"] == out["reference"]
    assert out["port"][4] == "queue_full" and out["port"][-2] == "timeout"


BREAKER_SCRIPT = [  # (clock advance, action): acquire then an outcome
    (0, "ok"), (0, "fail"), (0, "fail"), (0, "ok"), (0, "fail"),
    (0, "fail"), (0, "fail"), (1.0, "ok"), (3.0, "fail"), (1.5, "ok"),
    (0, "ok"), (0, "ok"), (0, "cancel"), (0, "ok"), (0, "ok"), (0, "fail"),
    (0, "fail"), (0, "fail"), (0, "fail"), (6.0, "fail"), (6.0, "ok"),
    (0, "ok"), (0, "ok"), (0, "ok"),
]


def test_circuit_breaker_decides_like_reference():
    out = {}
    for pkg, q in PKGS.items():
        clock = Clock()
        changes = []
        br = q.CircuitBreaker(failure_rate=0.5, window=4, cooldown_s=4.0,
                              probes=2, clock=clock,
                              on_state_change=changes.append)
        steps = []
        held = []
        for dt, action in BREAKER_SCRIPT:
            clock.tick(dt)
            call = br.acquire()
            steps.append((call.allowed, round(call.retry_after_s, 12),
                          br.state))
            if call.allowed:
                if action == "ok":
                    call.success()
                elif action == "fail":
                    call.failure()
                else:
                    held.append(call)  # released below, after a change
            steps.append(br.snapshot())
        for call in held:
            call.cancel()
        steps.append(br.allow())
        br.record_failure()
        br.record_success()
        steps.append(br.snapshot())
        out[pkg] = (steps, changes)
    assert out["port"] == out["reference"]
    assert "open" in out["port"][1] and "half_open" in out["port"][1]
    assert pq.breaker.STATE_CODES == rq.breaker.STATE_CODES


def test_stale_cache_answers_like_reference():
    out = {}
    for pkg, q in PKGS.items():
        c = q.StaleCache(3)
        steps = []
        for op, key in [("put", "a"), ("put", "b"), ("get", "a"),
                        ("put", "c"), ("put", "d"), ("get", "b"),
                        ("get", "a"), ("put", "a"), ("get", "c"),
                        ("get", "zz")]:
            if op == "put":
                c.put(key, {"v": key})
            else:
                steps.append(c.get(key))
        out[pkg] = (steps, len(c), c.stats())
        with pytest.raises(ValueError):
            q.StaleCache(0)
    assert out["port"] == out["reference"]
    assert pq.DEGRADED_HEADER == rq.DEGRADED_HEADER == "X-Pio-Degraded"
    assert pq.DEGRADED_VALUE == rq.DEGRADED_VALUE == "stale-cache"


@pytest.mark.parametrize("raw", [None, "", "  ", "250", "0.5", "1e3", "0",
                                 "-4", "abc", "nan", "inf"])
def test_deadline_matches_reference(raw):
    out = {}
    for pkg, q in PKGS.items():
        clock = Clock()
        got = outcome(q.Deadline.from_header, raw, 40.0, clock)
        if got[0] == "ok":
            d = got[1]
            steps = [round(d.remaining_s(), 12), d.expired()]
            clock.tick(0.039)
            steps += [round(d.remaining_s(), 12), d.expired()]
            clock.tick(10_000.0)
            steps += [d.expired()]
            got = ("ok", steps)
        out[pkg] = (got, outcome(q.parse_deadline_ms, raw))
    assert out["port"] == out["reference"]
    assert pq.DEADLINE_HEADER == rq.DEADLINE_HEADER


@pytest.mark.parametrize("retry_after", [0.0, 0.2, 1.0, 1.01, 59.5, 1000.0])
def test_retry_after_header_matches_reference(retry_after):
    assert (pq.retry_after_header(retry_after)
            == rq.retry_after_header(retry_after))


# ------------------------------------------------------------------- gate
GATE_SCRIPT = [  # (clock advance, priority, key, release the admission)
    (0.0, None, "k1", False), (0.0, "interactive", "k1", True),
    (0.0, "shadow", "k2", True), (0.0, "batchpredict", "k1", True),
    (0.5, None, "k1", True), (0.0, None, "k2", True), (0.0, "bogus", "k3", True),
    (2.0, "shadow", "k1", True), (0.0, None, "k1", True),
    (0.0, None, "k4", False), (0.0, None, "k5", True),
]


def gate_run(pkg):
    from pio_tpu.obs.metrics import MetricsRegistry as RReg
    from pio_tpu_torch.obs.metrics import MetricsRegistry as PReg

    q = PKGS[pkg]
    clock = Clock()
    reg = (PReg if pkg == "port" else RReg)()
    policy = q.parse_qos("rps=4,burst=5,key_rps=2,key_burst=2,inflight=2,"
                         "queue=0,cache=4,fail_window=2,cooldown=3s,"
                         "probes=1")
    gate = q.QoSGate(policy, reg, scope="queryserver", clock=clock)
    steps = []
    held = []
    for dt, prio, key, release in GATE_SCRIPT:
        clock.tick(dt)
        adm = gate.admit(priority=prio, key=key, timeout_s=0.0)
        steps.append((adm.ok, adm.reason, round(adm.retry_after_s, 12),
                      adm.retry_after_header() if not adm.ok else None))
        if not adm.ok:
            gate.count_shed(adm.reason)
        elif release:
            adm.release()
        else:
            held.append(adm)
    for adm in held:
        adm.release()
        adm.release()  # once only
    br = gate.breaker("scorer")
    assert gate.breaker("scorer") is br
    for _ in range(2):
        br.acquire().failure()
    gate.count_degraded()
    steps.append(gate.snapshot())
    lines = [line for line in reg.render() if "qos" in line]
    return steps, lines


def test_gate_admits_and_sheds_like_reference():
    got, want = gate_run("port"), gate_run("reference")
    assert got == want
    reasons = {s[1] for s in got[0][:-1]}
    assert {"rate_limit", "key_rate_limit", "queue_full"} <= reasons
    assert pq.SHED_REASONS == rq.SHED_REASONS
    assert got[0][-1]["breakers"]["scorer"]["state"] == "open"


# ------------------------------------------------------------ the retries
def retry_run(pkg, fail_times, exc, deadline_budget_ms):
    mod = {"port": p_retry, "reference": r_retry}[pkg]
    q = PKGS[pkg]
    clock = Clock()
    sleeps = []
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fail_times:
            raise exc
        return "done"

    deadline = (None if deadline_budget_ms is None
                else q.Deadline(deadline_budget_ms, clock=clock))
    before = mod._RETRIES.value("unit")
    orig = mod.time.sleep
    mod.time.sleep = lambda s: (sleeps.append(s), clock.tick(s))
    orig_uniform = mod.random.uniform
    mod.random.uniform = lambda a, b: (a + b) / 2
    try:
        got = outcome(lambda: mod.retrying(fn, site="unit",
                                           deadline=deadline))
    finally:
        mod.time.sleep = orig
        mod.random.uniform = orig_uniform
    return got, len(calls), sleeps, mod._RETRIES.value("unit") - before


@pytest.mark.parametrize("fail_times,exc,budget", [
    (0, None, None),
    (2, sqlite3.OperationalError("database is locked"), None),
    (3, sqlite3.OperationalError("database is busy"), None),
    (1, sqlite3.OperationalError("no such table"), None),
    (2, sqlite3.OperationalError("database is locked"), 30.0),
    (2, sqlite3.OperationalError("database is locked"), 500.0),
    (1, ValueError("not transient"), None),
])
def test_retrying_matches_reference(fail_times, exc, budget):
    got = retry_run("port", fail_times, exc, budget)
    want = retry_run("reference", fail_times, exc, budget)
    assert got == want


def test_retrying_classifies_injected_and_blob_errors_like_reference():
    from pio_tpu.faults import FaultInjected as RFault
    from pio_tpu.storage.base import StorageError as RStorageError
    from pio_tpu_torch.faults import FaultInjected as PFault
    from pio_tpu_torch.storage.base import StorageError as PStorageError

    for p_exc, r_exc in [
        (PFault("x"), RFault("x")),
        (PStorageError("blob server unreachable: refused"),
         RStorageError("blob server unreachable: refused")),
        (PStorageError("corrupt"), RStorageError("corrupt")),
        (sqlite3.OperationalError("locked"), sqlite3.OperationalError("locked")),
        (KeyError("k"), KeyError("k")),
    ]:
        assert p_retry.is_transient(p_exc) == r_retry.is_transient(r_exc)


def test_qos_json_keys_of_a_fresh_gate_match_reference():
    from pio_tpu.obs.metrics import MetricsRegistry as RReg
    from pio_tpu_torch.obs.metrics import MetricsRegistry as PReg

    spec = "inflight=1,queue=0,deadline=10ms,cache=2"
    got = pq.QoSGate(pq.parse_qos(spec), PReg(), "eventserver").snapshot()
    want = rq.QoSGate(rq.parse_qos(spec), RReg(), "eventserver").snapshot()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
