"""The port's tracer, structured logs, hot-path budget and SLO engine
against the JAX package's, on the CPU.

- ``parse_trace_header`` / ``format_trace_header``, ``parse_slo`` and
  ``parse_duration_s``: equal results, or the same error class and
  message, over hypothesis strings (derandomized, no example database).
- A ``Tracer`` driven by the same script on an injected clock (spans,
  injected spans, rebase, extend_total, links, notes, errors, the slow
  ring, worker ids, the id counter) gives the same traces and the same
  stage histograms; the active trace reaches deep layers and the log
  context in both.
- ``SLOEngine`` burn rates, budgets and alerts from the same recorded
  (good, total) history, and ``hotpath_payload`` from the same recorded
  durations: equal within 1e-12.
- Structured logs: the ring's filters, a record's entry, and each
  package's installed ring holding only its own package's records.
- The port's device watch names the enclosing trace, and ``run_train``
  records its phases as spans of one train trace.
"""

import dataclasses
import logging
import string

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pio_tpu.obs import hotpath as r_hotpath
from pio_tpu.obs import metrics as r_metrics
from pio_tpu.obs import slo as r_slo
from pio_tpu.obs import slog as r_slog
from pio_tpu.obs import tracing as r_tracing
from pio_tpu_torch.obs import devicewatch as p_devicewatch
from pio_tpu_torch.obs import hotpath as p_hotpath
from pio_tpu_torch.obs import metrics as p_metrics
from pio_tpu_torch.obs import slo as p_slo
from pio_tpu_torch.obs import slog as p_slog
from pio_tpu_torch.obs import tracing as p_tracing

#: both packages' modules, by role
PKGS = {
    "reference": dict(tracing=r_tracing, slo=r_slo, slog=r_slog,
                      hotpath=r_hotpath, metrics=r_metrics),
    "port": dict(tracing=p_tracing, slo=p_slo, slog=p_slog,
                 hotpath=p_hotpath, metrics=p_metrics),
}
#: hypothesis runs: the same examples on every run (a flake is refused)
SETTINGS = settings(max_examples=200, deadline=None, derandomize=True,
                    database=None)
#: the burn rates and the hot-path numbers are the same f64 arithmetic
#: on the same inputs: equal but for summation order, 1e-12
TOL = 1e-12


def outcome(fn, *args):
    """``("ok", result)`` or ``("error", class name, message)``."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 (compared across packages)
        return ("error", type(e).__name__, str(e))


def as_plain(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


# ------------------------------------------------------------ the parsers
ID_CHARS = string.ascii_letters + string.digits + "._:-/ "
header_text = st.one_of(
    st.text(max_size=40),
    st.text(alphabet=ID_CHARS, max_size=140),
    st.builds(lambda a, b: f"{a}/{b}", st.text(alphabet=ID_CHARS,
                                                 max_size=20),
              st.text(alphabet=ID_CHARS, max_size=20)),
    st.none(),
)


@SETTINGS
@given(header_text)
def test_parse_trace_header_matches_reference(value):
    assert (outcome(p_tracing.parse_trace_header, value)
            == outcome(r_tracing.parse_trace_header, value))


@SETTINGS
@given(st.text(alphabet=ID_CHARS, min_size=1, max_size=30),
       st.one_of(st.none(), st.text(alphabet=ID_CHARS, max_size=20)))
def test_format_trace_header_matches_reference(trace_id, parent):
    assert (p_tracing.format_trace_header(trace_id, parent)
            == r_tracing.format_trace_header(trace_id, parent))
    # a formatted header parses back the same way in both
    value = p_tracing.format_trace_header(trace_id, parent)
    assert (p_tracing.parse_trace_header(value)
            == r_tracing.parse_trace_header(value))


NUM = st.sampled_from(["0", "1", "50", "99.9", "100", "0.5", "2.", ".5",
                       "1e3", "-1", "", "12.5.1"])
UNIT = st.sampled_from(["us", "ms", "s", "m", "h", "d", "", "x", "MS"])
duration_text = st.one_of(st.builds(lambda n, u: n + u, NUM, UNIT),
                          st.text(max_size=12))
slo_text = st.one_of(
    st.builds(lambda name, n, u, sep, pct, w: f"{name}={n}{u}{sep}{pct}{w}",
              st.sampled_from(["p99", "p95", "P50", "lat", "9x", ""]),
              NUM, UNIT, st.sampled_from([":", "=", ";"]), NUM,
              st.sampled_from(["", "/6h", "/30m", "/1d", "/5x", "/"])),
    st.builds(lambda name, sep, pct: f"{name}{sep}{pct}",
              st.sampled_from(["availability", "avail", "errors",
                               "success", "uptime", "Availability"]),
              st.sampled_from(["=", ":"]), NUM),
    st.text(max_size=24),
)


@SETTINGS
@given(duration_text)
def test_parse_duration_matches_reference(text):
    assert (outcome(p_slo.parse_duration_s, text)
            == outcome(r_slo.parse_duration_s, text))


@SETTINGS
@given(slo_text)
def test_parse_slo_matches_reference(spec):
    got = outcome(p_slo.parse_slo, spec)
    want = outcome(r_slo.parse_slo, spec)
    if got[0] == "ok" and want[0] == "ok":
        got, want = as_plain(got[1]), as_plain(want[1])
    assert got == want


# ------------------------------------------------------------- the tracer
class Clock:
    """A monotonic clock that moves only when told."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


def traced_script(pkg, clock, wall):
    """The same tracer script in either package: (recent traces, slow
    ring, one found trace, stage histogram lines, log context seen inside
    a span, the active trace outside and inside)."""
    tracing = PKGS[pkg]["tracing"]
    reg = PKGS[pkg]["metrics"].MetricsRegistry()
    tr = tracing.Tracer("query", registry=reg,
                        stages=("accept", "parse", "execute"),
                        extra_labels={"engine_id": "e"}, ring=8, slow_ring=2)
    tr.slow_threshold_fn = lambda: 0.05
    seen = {}
    seen["outside"] = tracing.active_trace()
    tracing.add_active_span("ignored", 1.0)  # no trace: a no-op
    for k, (dur, adopt) in enumerate([(0.01, None), (0.2, ("up-1", "span")),
                                      (0.03, None), (0.07, ("up-2", None)),
                                      (0.001, None), (0.5, None)]):
        kw = {}
        if adopt:
            kw = {"trace_id": adopt[0], "parent": adopt[1]}
        with tr.trace("query", **kw, route="/q") as h:
            seen.setdefault("inside", tracing.active_trace() is h)
            h.rebase(0.002)
            h.add_span("accept", 0.002, rel_start_s=0.0)
            with h.span("parse"):
                clock.tick(dur / 4)
                seen.setdefault("ctx", PKGS[pkg]["slog"].TRACE_CONTEXT.get())
            tracing.add_active_span("execute.device", dur / 8)
            h.add_span("execute", dur / 2)
            clock.tick(dur / 2)
            h.link("member-a", "member-b")
            h.note(batch=k)
            if k == 2:
                h.mark_error()
        clock.tick(dur / 4)
        h.extend_total()
    try:
        with tr.trace("query"):
            clock.tick(0.01)
            raise KeyError("boom")
    except KeyError:
        pass
    tr.set_worker(3)
    with tr.trace("query") as h:
        clock.tick(0.002)
    worker_id = h.trace_id
    lines = [line for line in reg.render() if "stage_seconds" in line]
    return (tr.recent(10), tr.recent(10, slowest=False), tr.slow(5),
            tr.find("up-1"), tr.find("nope"), worker_id, tr.count, lines,
            seen)


def strip_wall(traces):
    """Trace dicts without their display wall time (time.time())."""
    if traces is None:
        return None
    if isinstance(traces, dict):
        return {k: v for k, v in traces.items() if k != "wallTime"}
    return [strip_wall(t) for t in traces]


def test_tracer_script_matches_reference(monkeypatch):
    out = {}
    for pkg, mods in PKGS.items():
        clock = Clock()
        monkeypatch.setattr(mods["tracing"], "monotonic_s", clock)
        wall = iter(np.arange(1e9, 1e9 + 100, 1.0))
        monkeypatch.setattr(mods["tracing"].time, "time",
                            lambda: float(next(wall)))
        out[pkg] = traced_script(pkg, clock, wall)
    got, want = out["port"], out["reference"]
    for k in range(5):
        assert strip_wall(got[k]) == strip_wall(want[k]), k
    assert got[5] == want[5] == "query-w3-8"
    assert got[6] == want[6] == 8
    assert got[7] == want[7]
    g_seen, w_seen = got[8], want[8]
    assert g_seen["outside"] is None and w_seen["outside"] is None
    assert g_seen["inside"] and w_seen["inside"]
    assert g_seen["ctx"] == w_seen["ctx"] == ("query-1", "parse")
    # the adopted id and parent, the error flag, the slow ring's members
    by_id = {t["id"]: t for t in got[0]}
    assert by_id["up-1"]["parent"] == "span"
    assert "parent" not in by_id["up-2"]
    assert [t["id"] for t in got[2]] == [t["id"] for t in want[2]]


def test_trace_ring_keeps_the_newest_and_evicts_in_order():
    out = {}
    for pkg, mods in PKGS.items():
        tr = mods["tracing"].Tracer("event", ring=3)
        ids = []
        for k in range(7):
            with tr.trace("event", trace_id=f"e-{k}") as h:
                ids.append(h.trace_id)
        out[pkg] = sorted(t["id"] for t in tr.recent(10))
    assert out["port"] == out["reference"] == ["e-4", "e-5", "e-6"]


# ------------------------------------------------------------------- SLOs
HISTORY = [  # (t, good, total): a counter pair sampled by the engine
    (0.0, 0, 0), (60.0, 95, 100), (200.0, 180, 200), (400.0, 380, 400),
    (1000.0, 900, 1000), (3000.0, 2950, 3000), (4000.0, 3900, 4000),
    (7200.0, 7150, 7200), (20000.0, 19990, 20000), (30000.0, 29900, 30000),
]


def slo_run(pkg, specs):
    mods = PKGS[pkg]
    reg = mods["metrics"].MetricsRegistry()
    eng = mods["slo"].SLOEngine(registry=reg)
    state = {"good": 0.0, "total": 0.0}
    for spec in specs:
        eng.add(mods["slo"].parse_slo(spec),
                lambda: (state["good"], state["total"]))
    out = []
    for t, good, total in HISTORY:
        state.update(good=float(good), total=float(total))
        out.append(eng.evaluate(now=t))
    gauges = {}
    for line in reg.render():
        if line.startswith("pio_tpu_slo_"):
            name, value = line.rsplit(" ", 1)
            gauges[name] = float(value)
    return out, gauges


def close(a, b) -> bool:
    """Equal structures, floats within TOL."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= TOL
    return a == b


@pytest.mark.parametrize("specs", [
    ["availability=99.9"],
    ["p99=50ms:99.9", "availability=99/6h"],
    ["p95=25ms:99/30m"],
])
def test_slo_burn_rates_match_reference(specs):
    got, got_gauges = slo_run("port", specs)
    want, want_gauges = slo_run("reference", specs)
    assert close(got, want)
    assert got_gauges.keys() == want_gauges.keys() and got_gauges
    for k in got_gauges:
        assert abs(got_gauges[k] - want_gauges[k]) <= TOL, k


def test_engine_for_specs_reads_count_le_like_reference():
    """A latency objective's good/total from a histogram cell's buckets
    (the threshold snaps down to an edge), an availability one from the
    request counters, in both packages."""
    durations = np.random.default_rng(3).exponential(0.03, size=500)
    out = {}
    for pkg, mods in PKGS.items():
        reg = mods["metrics"].MetricsRegistry()
        cell = reg.histogram("pio_tpu_request_seconds", "req",
                             ("engine_id",)).labels("e")
        for d in durations:
            cell.observe(float(d))
        eng = mods["slo"].engine_for_specs(
            ["p99=50ms:99.9", "p95=0.03s:95", "availability=99.5"], reg,
            availability_source=lambda: (495.0, 500.0),
            latency_cell_getter=lambda: cell)
        out[pkg] = (eng.evaluate(now=10.0), cell.count_le(0.05),
                    cell.quantile(0.99), cell.quantile(0.5))
    assert close(out["port"], out["reference"])


# ---------------------------------------------------------------- hotpath
def hotpath_run(pkg, seed):
    mods = PKGS[pkg]
    rng = np.random.default_rng(seed)
    reg = mods["metrics"].MetricsRegistry()
    tr = mods["tracing"].Tracer(
        "query", registry=reg,
        stages=("accept", "parse", "execute", "execute.device", "write"),
        extra_labels={"engine_id": "e"})
    e2e = reg.histogram("pio_tpu_e2e_seconds", "e2e",
                        ("engine_id",)).labels("e")
    for _ in range(300):
        stages = {s: float(rng.exponential(1e-3))
                  for s in ("accept", "parse", "execute", "write")}
        with tr.trace("query") as h:
            for s, d in stages.items():
                h.add_span(s, d, rel_start_s=0.0)
            h.add_span("execute.device", stages["execute"] * 0.8,
                       rel_start_s=0.0)
        e2e.observe(sum(stages.values()) * float(rng.uniform(1.0, 1.05)))
    return mods["hotpath"].hotpath_payload(
        tr, e2e, stage_order=("accept", "parse", "execute", "write",
                              "execute.device"),
        pool=False, slow_threshold_s=0.05)


@pytest.mark.parametrize("seed", [0, 1])
def test_hotpath_payload_matches_reference(seed):
    got, want = hotpath_run("port", seed), hotpath_run("reference", seed)
    assert close(got, want)
    assert [s["stage"] for s in got["stages"]] == [
        "accept", "parse", "execute", "write"]
    assert [s["stage"] for s in got["substages"]] == ["execute.device"]
    assert 0.9 < got["attributedFraction"] <= 1.0


def test_hotpath_without_requests_matches_reference():
    out = {}
    for pkg, mods in PKGS.items():
        reg = mods["metrics"].MetricsRegistry()
        tr = mods["tracing"].Tracer("event", registry=reg,
                                    stages=("accept",))
        e2e = reg.histogram("pio_tpu_e2e_seconds", "e2e").labels()
        out[pkg] = mods["hotpath"].hotpath_payload(tr, e2e, pool=False)
    assert out["port"] == out["reference"]


# ------------------------------------------------------------------- logs
def log_record(name, level, msg, exc=False):
    rec = logging.LogRecord(name, level, __file__, 1, msg, (), None)
    rec.created = 1_700_000_000.5
    if exc:
        try:
            raise ValueError("inner")
        except ValueError:
            import sys

            rec.exc_info = sys.exc_info()
    return rec


def test_log_ring_and_handler_match_reference():
    records = [
        ("pio_tpu_torch.query_server", logging.INFO, "served query"),
        ("pio_tpu_torch.storage", logging.WARNING, "slow flush"),
        ("other.lib", logging.DEBUG, "chatter"),
        ("pio_tpu_torch.query_server", logging.ERROR, "failed"),
    ] * 3
    out = {}
    for pkg, mods in PKGS.items():
        slog = mods["slog"]
        ring = slog.LogRing(cap=5)
        handler = slog.JsonLogHandler(ring, worker=2)
        token = slog.TRACE_CONTEXT.set(("t-9", "execute"))
        try:
            for k, (name, level, msg) in enumerate(records):
                handler.emit(log_record(name, level, f"{msg} {k}",
                                        exc=(k == 3)))
        finally:
            slog.TRACE_CONTEXT.reset(token)
        line = handler.format_line(log_record("x", logging.INFO, "one"))
        out[pkg] = (ring.snapshot(), ring.tail(2, level="warning"),
                    ring.tail(10, logger="pio_tpu_torch.q"),
                    ring.tail(10, trace_id="t-9"), ring.dropped, line,
                    outcome(ring.tail, 3, "loud"))
    assert out["port"] == out["reference"]


def test_each_package_ring_holds_its_own_records():
    """Both packages' handlers installed in one process: the port's ring
    never holds a reference record, nor the reference's a port record."""
    p_slog.install()
    r_slog.install()
    logging.getLogger("pio_tpu_torch.tracing_test").info("port-only")
    logging.getLogger("pio_tpu.tracing_test").info("reference-only")
    port_msgs = [e["msg"] for e in p_slog.logs_payload(n=512)["logs"]]
    ref_msgs = [e["msg"] for e in r_slog.logs_payload(n=512)["logs"]]
    assert "port-only" in port_msgs and "reference-only" not in port_msgs
    assert "reference-only" in ref_msgs and "port-only" not in ref_msgs
    assert (p_slog.logs_payload(n=1).keys()
            == r_slog.logs_payload(n=1).keys())
    assert logging.getLogger().handlers == [
        h for h in logging.getLogger().handlers
        if not isinstance(h, p_slog.JsonLogHandler)]


def test_log_inside_a_trace_carries_its_id():
    p_slog.install()
    tr = p_tracing.Tracer("query")
    with tr.trace("query", trace_id="carry-1"):
        logging.getLogger("pio_tpu_torch.tracing_test").info("inside")
    got = p_slog.logs_payload(trace_id="carry-1")["logs"]
    assert [e["msg"] for e in got] == ["inside"]
    assert got[0]["span"] is None


# ------------------------------------------------ deep layers of the port
def test_devicewatch_names_the_enclosing_trace():
    assert p_devicewatch._active_trace_id() is None
    tr = p_tracing.Tracer("query")
    with tr.trace("query", trace_id="dw-1"):
        assert p_devicewatch._active_trace_id() == "dw-1"
    assert p_devicewatch._active_trace_id() is None


def test_run_train_records_its_phases_as_spans(tmp_home, monkeypatch):
    from pio_tpu_torch.data.event import Event
    from pio_tpu_torch.parallel.context import ComputeContext
    from pio_tpu_torch.storage.records import App
    from pio_tpu_torch.storage.registry import Storage
    from pio_tpu_torch.workflow import core_workflow
    from pio_tpu_torch.workflow.engine_json import (
        build_engine,
        variant_from_dict,
    )

    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    Storage.reset()
    try:
        app_id = Storage.get_meta_data_apps().insert(App(0, "spans"))
        Storage.get_levents().write([
            Event("$set", "content", f"d{k}", properties={
                "text": f"word{k % 3} common", "label": f"l{k % 2}"})
            for k in range(8)], app_id)
        v = variant_from_dict({
            "id": "spans", "engineFactory": "templates.textclassification",
            "datasource": {"params": {"app_name": "spans"}},
            "algorithms": [{"name": "nb", "params": {}}]})
        engine, ep = build_engine(v)
        iid = core_workflow.run_train(
            engine, ep, v, ctx=ComputeContext.create(0, device="cpu"))
        got = [t for t in core_workflow.TRAIN_TRACER.recent(128)
               if t["meta"].get("instanceId") == iid]
    finally:
        Storage.reset()
    assert len(got) == 1
    assert [s["stage"] for s in got[0]["spans"]] == [
        "read", "prepare", "train.0_nb", "persist"]
