"""Dashboard server — evaluation results UI.

The port's copy of ``pio_tpu/server/dashboard.py`` (PredictionIO's
dashboard): a web UI listing completed ``EvaluationInstances`` newest
first with metric scores and the parameters that produced them, and the
serving, fleet, training and device views over the port's servers.

Routes:

- ``GET /``                      — HTML table of completed evaluations;
- ``GET /instances.json``        — same data as JSON;
- ``GET /instances/<id>.json``   — one instance incl. full evaluator results;
- ``GET /instances/<id>.html``   — the instance's stored HTML report;
- ``GET /serving.html``          — live serving view: pool-wide request
  totals + per-stage latency table scraped from a query server's
  ``/metrics``;
- ``GET /fleet.html``            — fleet panel: member
  liveness, replication lag and SLO burn rollup from an embedded
  :class:`~pio_tpu_torch.obs.fleet.FleetAggregator` (enabled by passing
  ``fleet_targets`` / setting ``PIO_TPU_FLEET_TARGETS``);
- ``GET /fleet.json``            — the same aggregator's router contract;
- ``GET /training.html``         — live training progress:
  one scrape of a ``pio train`` status sidecar's ``/train.json``
  (``--train-url`` / ``PIO_TPU_TRAIN_STATUS_URL``, or ``?url=``);
- ``GET /metrics``               — the dashboard's own scrape endpoint
  (carries the federated member metrics when the fleet panel is on).

All responses carry ``Access-Control-Allow-Origin: *`` (reference
``CorsSupport``).
"""

from __future__ import annotations

import html as _html
import json
from typing import Any, Optional, Tuple

from pio_tpu_torch.utils import knobs
from pio_tpu_torch.obs import HealthMonitor, MetricsRegistry
from pio_tpu_torch.obs import slog
from pio_tpu_torch.obs.promparse import ParsedMetrics, parse_prometheus_text
from pio_tpu_torch.server.http import (
    HTTPError, JsonHTTPServer, RawResponse, Request, Router, int_param,
    metrics_response,
)
from pio_tpu_torch.storage import RunStatus, Storage

_CORS = {"Access-Control-Allow-Origin": "*"}


def _html_response(page: str) -> RawResponse:
    return RawResponse(page, content_type="text/html; charset=UTF-8",
                       headers=dict(_CORS))


def _instance_summary(inst) -> dict:
    return {
        "id": inst.id,
        "status": inst.status,
        "startTime": inst.start_time.isoformat(),
        "endTime": inst.end_time.isoformat(),
        "evaluationClass": inst.evaluation_class,
        "engineParamsGeneratorClass": inst.engine_params_generator_class,
        "batch": inst.batch,
        "evaluatorResults": inst.evaluator_results,
    }


class DashboardService:
    """≙ reference ``DashboardService`` routes (+ the serving view)."""

    def __init__(self, query_url: str = "http://127.0.0.1:8000",
                 fleet_targets: Optional[str] = None,
                 train_url: Optional[str] = None):
        #: base URL of the query server (or any pool worker — in pool
        #: mode every worker's /metrics reports pool-wide totals) whose
        #: serving metrics /serving.html renders
        self.query_url = query_url.rstrip("/")
        #: base URL of a `pio train` status sidecar whose /train.json
        #: the /training.html view follows
        self.train_url = (
            train_url or knobs.knob_str("PIO_TPU_TRAIN_STATUS_URL")
        ).rstrip("/")
        self.obs = MetricsRegistry()
        self._pageviews = self.obs.counter(
            "pio_tpu_dashboard_pageviews_total",
            "Dashboard page renders",
            ("page",),
        )
        slog.install()
        self.obs.add_collector(slog.exposition_lines)
        self.health = HealthMonitor()
        self.health.add_readiness("storage", self._check_storage_ready)
        # embedded fleet aggregator: the lightweight
        # alternative to a standalone `pio fleet` daemon — same scrape
        # loop, federating onto the dashboard's own registry
        from pio_tpu_torch.obs.fleet import (
            TARGETS_ENV, FleetAggregator, parse_targets,
        )

        spec = (fleet_targets if fleet_targets is not None
                else knobs.knob_str(TARGETS_ENV))
        targets = parse_targets(spec)
        self.fleet: Optional[FleetAggregator] = (
            FleetAggregator(targets, registry=self.obs)
            if targets else None
        )
        self.router = Router()
        self.router.add("GET", "/", self.index)
        self.router.add("GET", "/instances\\.json", self.list_json)
        self.router.add("GET", "/instances/([^/]+)\\.json", self.get_json)
        self.router.add("GET", "/instances/([^/]+)\\.html", self.get_html)
        self.router.add("GET", "/serving\\.html", self.serving)
        self.router.add("GET", "/fleet\\.html", self.fleet_html)
        self.router.add("GET", "/fleet\\.json", self.fleet_json)
        self.router.add("GET", "/training\\.html", self.training_html)
        self.router.add("GET", "/devices\\.html", self.devices_html)
        self.router.add("GET", "/metrics", self.get_metrics)
        self.router.add("GET", "/logs\\.json", self.get_logs)
        self.router.add("GET", "/healthz", self.healthz)
        self.router.add("GET", "/readyz", self.readyz)

    def _completed(self):
        return Storage.get_meta_data_evaluation_instances().get_completed()

    def index(self, req: Request) -> Tuple[int, Any]:
        self._pageviews.inc(page="index")
        rows = []
        for i in self._completed():
            rows.append(
                "<tr>"
                f"<td><a href='/instances/{_html.escape(i.id)}.html'>"
                f"{_html.escape(i.id)}</a></td>"
                f"<td>{_html.escape(i.evaluation_class)}</td>"
                f"<td>{_html.escape(i.start_time.isoformat())}</td>"
                f"<td>{_html.escape(i.end_time.isoformat())}</td>"
                f"<td>{_html.escape(i.evaluator_results)}</td>"
                "</tr>"
            )
        page = (
            "<!doctype html><html><head><title>pio-tpu dashboard</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
            "padding:.4em .8em;text-align:left}</style></head><body>"
            "<h1>Evaluation Dashboard</h1>"
            "<p><a href='/serving.html'>serving metrics</a> &middot; "
            "<a href='/fleet.html'>fleet</a> &middot; "
            "<a href='/training.html'>training</a> &middot; "
            "<a href='/devices.html'>devices</a></p>"
            "<table><tr><th>Instance</th><th>Evaluation</th><th>Start</th>"
            "<th>End</th><th>Result</th></tr>"
            + "".join(rows)
            + "</table></body></html>"
        )
        return 200, _html_response(page)

    def list_json(self, req: Request) -> Tuple[int, Any]:
        return 200, [_instance_summary(i) for i in self._completed()]

    def _find(self, instance_id: str):
        return Storage.get_meta_data_evaluation_instances().get(instance_id)

    def get_json(self, req: Request) -> Tuple[int, Any]:
        inst = self._find(req.path_args[0])
        if inst is None:
            return 404, {"message": "evaluation instance not found"}
        out = _instance_summary(inst)
        try:
            out["results"] = json.loads(inst.evaluator_results_json or "null")
        except json.JSONDecodeError:
            out["results"] = None
        return 200, out

    def get_html(self, req: Request) -> Tuple[int, Any]:
        inst = self._find(req.path_args[0])
        if inst is None:
            return 404, {"message": "evaluation instance not found"}
        body = inst.evaluator_results_html or (
            "<html><body><pre>"
            + _html.escape(inst.evaluator_results_json or "(no results)")
            + "</pre></body></html>"
        )
        return 200, _html_response(body)

    # -- health/logs ----------------------------------------------
    def _check_storage_ready(self):
        Storage.get_meta_data_evaluation_instances()
        return True, "metadata store reachable"

    def healthz(self, req: Request) -> Tuple[int, Any]:
        ok, report = self.health.liveness()
        return (200 if ok else 503), report

    def readyz(self, req: Request) -> Tuple[int, Any]:
        ok, report = self.health.readiness()
        return (200 if ok else 503), report

    def get_logs(self, req: Request) -> Tuple[int, Any]:
        n = int_param(req.params, "n", 100, lo=0, hi=slog.ring().cap)
        try:
            return 200, slog.logs_payload(
                n=n,
                level=req.params.get("level"),
                trace_id=req.params.get("trace_id"),
                logger=req.params.get("logger"),
            )
        except ValueError as e:
            raise HTTPError(400, str(e))

    # -- serving observability ------------------------------------
    def get_metrics(self, req: Request) -> Tuple[int, Any]:
        return 200, metrics_response(self.obs.render())

    def _scrape_query_server(self) -> Tuple[Optional[ParsedMetrics],
                                            Optional[dict], str]:
        """(parsed /metrics, / status JSON, error message)."""
        import urllib.request

        try:
            with urllib.request.urlopen(
                self.query_url + "/metrics", timeout=3.0
            ) as r:
                pm = parse_prometheus_text(r.read().decode("utf-8"))
            with urllib.request.urlopen(self.query_url + "/", timeout=3.0) as r:
                status = json.loads(r.read().decode("utf-8"))
            return pm, status, ""
        except Exception as e:
            return None, None, f"{type(e).__name__}: {e}"

    def _fetch_json(self, path: str) -> Optional[dict]:
        """Best-effort GET of a query-server JSON endpoint (None on any
        failure — the serving page degrades panel-by-panel)."""
        import urllib.request

        try:
            with urllib.request.urlopen(
                self.query_url + path, timeout=3.0
            ) as r:
                return json.loads(r.read().decode("utf-8"))
        except Exception:
            return None

    def _slo_panel(self) -> str:
        """SLO/error-budget table from the query server's /slo.json."""
        data = self._fetch_json("/slo.json")
        if not data or not data.get("slos"):
            return (
                "<h2>SLOs</h2><p>none configured "
                "(<code>pio deploy --slo p99=50ms:99.9</code>)</p>"
            )
        rows = []
        for s in data["slos"]:
            firing = [a["severity"] for a in s.get("alerts", []) if a["firing"]]
            burns = s.get("burnRates", {})
            fast = burns.get("300s")
            slow = burns.get("3600s")
            rows.append(
                f"<tr><td>{_html.escape(s['name'])}</td>"
                f"<td>{s['objective'] * 100:.3g}%</td>"
                f"<td>{int(s['total'])}</td><td>{int(s['errors'])}</td>"
                f"<td>{s['errorBudgetRemaining'] * 100:.1f}%</td>"
                f"<td>{fast if fast is not None else 'n/a'}</td>"
                f"<td>{slow if slow is not None else 'n/a'}</td>"
                f"<td>{_html.escape(', '.join(firing) or '-')}</td></tr>"
            )
        return (
            "<h2>SLOs</h2>"
            "<table><tr><th>objective</th><th>target</th><th>requests</th>"
            "<th>errors</th><th>budget left</th><th>burn 5m</th>"
            "<th>burn 1h</th><th>alerts</th></tr>"
            + "".join(rows) + "</table>"
        )

    def _qos_panel(self) -> str:
        """Admission-control panel from the query server's /qos.json:
        shed counts by reason, token-bucket level, queue and
        inflight occupancy, breaker states."""
        data = self._fetch_json("/qos.json")
        if not data or not data.get("enabled"):
            return (
                "<h2>QoS</h2><p>admission control off "
                "(<code>pio deploy --qos 'rps=500,queue=64,"
                "deadline=100ms'</code>)</p>"
            )
        shed = data.get("shed", {})
        shed_rows = "".join(
            f"<tr><td>{_html.escape(reason)}</td><td>{int(n)}</td></tr>"
            for reason, n in sorted(shed.items())
        )
        parts = [
            "<h2>QoS</h2>",
            f"<p>admitted (pool-wide): {int(data.get('admitted', 0))}"
            f" &middot; degraded (stale-cache): "
            f"{int(data.get('degraded', 0))}</p>",
            "<table><tr><th>shed reason</th><th>count</th></tr>"
            + (shed_rows or "<tr><td colspan='2'>none</td></tr>")
            + "</table>",
        ]
        bucket = data.get("bucket")
        if bucket:
            parts.append(
                f"<p>engine bucket: {bucket['tokens']:.1f} / "
                f"{bucket['burst']:.0f} tokens "
                f"(refill {bucket['rate']:.0f}/s)</p>"
            )
        conc = data.get("concurrency")
        if conc:
            parts.append(
                f"<p>concurrency: {conc['inflight']}/{conc['maxInflight']} "
                f"inflight, {conc['queued']}/{conc['maxQueue']} queued</p>"
            )
        breakers = data.get("breakers") or {}
        if breakers:
            rows = "".join(
                f"<tr><td>{_html.escape(dep)}</td>"
                f"<td>{_html.escape(b['state'])}</td>"
                f"<td>{b['windowFailures']}/{b['windowSamples']}</td></tr>"
                for dep, b in sorted(breakers.items())
            )
            parts.append(
                "<table><tr><th>breaker</th><th>state</th>"
                "<th>failures</th></tr>" + rows + "</table>"
            )
        return "".join(parts)

    def _hotpath_panel(self) -> str:
        """Latency-attribution waterfall from /debug/hotpath.json: the
        per-stage budget of the average request and how much of the e2e
        latency the stages attribute (the residual is the
        instrumentation's blind spot)."""
        data = self._fetch_json("/debug/hotpath.json")
        if not data or not data.get("stages"):
            return (
                "<h2>Hot-path budget</h2><p>no attributed requests yet "
                "(<code>GET /debug/hotpath.json</code>)</p>"
            )
        fmt = lambda v: f"{v:.3f}" if v is not None else "n/a"
        entries = [(s, "") for s in data["stages"]] + [
            (s, "&nbsp;&nbsp;&#8627; ") for s in data.get("substages", [])
        ]
        rows = "".join(
            f"<tr><td>{indent}{_html.escape(s['stage'])}</td>"
            f"<td>{s['count']}</td>"
            f"<td>{fmt(s.get('avgMs'))}</td><td>{fmt(s.get('p50Ms'))}</td>"
            f"<td>{fmt(s.get('p95Ms'))}</td></tr>"
            for s, indent in entries
        )
        frac = data.get("attributedFraction")
        e2e = data.get("e2e") or {}
        budget_line = (
            f"<p>e2e avg {fmt(e2e.get('avgMs'))} ms &middot; attributed "
            f"{fmt(data.get('attributedMsPerRequest'))} ms"
            + (f" ({frac * 100:.1f}%)" if frac is not None else "")
            + f" &middot; residual {fmt(data.get('residualMsPerRequest'))}"
            f" ms over {data.get('requestCount', 0)} requests</p>"
        )
        return (
            "<h2>Hot-path budget</h2>" + budget_line
            + "<table><tr><th>stage</th><th>count</th>"
            "<th>avg/req</th><th>p50</th><th>p95</th></tr>"
            + rows + "</table>"
        )

    def _log_panel(self, n: int = 25) -> str:
        """Live tail of the query server's structured log ring."""
        data = self._fetch_json(f"/logs.json?n={n}")
        if not data or not data.get("logs"):
            return "<h2>Recent logs</h2><p>no log entries</p>"
        lines = []
        for e in data["logs"]:
            trace = f" [{e['trace_id']}]" if e.get("trace_id") else ""
            lines.append(_html.escape(
                f"{e.get('ts', '')} {e.get('level', ''):7s}"
                f"{trace} {e.get('logger', '')}: {e.get('msg', '')}"
            ))
        return (
            "<h2>Recent logs</h2><pre style='background:#f6f6f6;"
            "padding:1em;overflow-x:auto'>" + "\n".join(lines) + "</pre>"
        )

    # -- fleet federation ----------------------------------------
    def fleet_json(self, req: Request) -> Tuple[int, Any]:
        if self.fleet is None:
            return 404, {
                "message": "no fleet configured (set PIO_TPU_FLEET_TARGETS "
                           "or run `pio fleet --targets ...`)"
            }
        return 200, self.fleet.fleet_payload()

    def fleet_html(self, req: Request) -> Tuple[int, Any]:
        """Fleet panel: member liveness table, partlog replication lag,
        worst SLO burn per objective, and engine placement — rendered
        from the embedded aggregator's last scrape pass."""
        self._pageviews.inc(page="fleet")
        head = (
            "<!doctype html><html><head><title>pio-tpu fleet</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "table{border-collapse:collapse;margin-bottom:1em}"
            "td,th{border:1px solid #ccc;padding:.4em .8em;"
            "text-align:left}.up{color:#080}.stale{color:#a60}"
            ".down{color:#a00}</style></head><body><h1>Fleet</h1>"
        )
        if self.fleet is None:
            return 200, _html_response(
                head + "<p>no fleet configured — set "
                "<code>PIO_TPU_FLEET_TARGETS=host:port,...</code> or run "
                "<code>pio fleet --targets ...</code></p></body></html>"
            )
        pay = self.fleet.fleet_payload()
        f = pay["fleet"]
        summary = (
            f"<p>{f['members']} members: "
            f"<span class='up'>{f['up']} up</span>, "
            f"<span class='stale'>{f['stale']} stale</span>, "
            f"<span class='down'>{f['down']} down</span> "
            f"(scrape every {f['scrapeIntervalSeconds']:.1f}s)</p>"
        )
        member_rows = "".join(
            f"<tr><td>{_html.escape(m['member'])}</td>"
            f"<td class='{_html.escape(m['status'])}'>"
            f"{_html.escape(m['status'])}</td>"
            f"<td>{_html.escape(m['role'])}</td>"
            f"<td>{'yes' if m['ready'] else 'no' if m['ready'] is False else '?'}</td>"
            f"<td>{m['scrapeAgeSeconds'] if m['scrapeAgeSeconds'] is not None else 'never'}</td>"
            f"<td>{m['scrapeErrors']}</td>"
            f"<td>{_html.escape(m['lastError'] or '-')}</td></tr>"
            for m in pay["members"]
        )
        members = (
            "<h2>Members</h2><table><tr><th>member</th><th>status</th>"
            "<th>role</th><th>ready</th><th>scrape age (s)</th>"
            "<th>errors</th><th>last error</th></tr>"
            + member_rows + "</table>"
        )
        lag_rows = []
        for leader in pay["partlog"]["leaders"]:
            for part in leader["partitionDetail"]:
                for fol in part["followers"]:
                    lag_rows.append(
                        f"<tr><td>{_html.escape(str(leader['member']))}</td>"
                        f"<td>{part['partition']}</td>"
                        f"<td>{_html.escape(str(fol['follower']))}</td>"
                        f"<td>{part['committedBytes']}</td>"
                        f"<td>{fol['ackedBytes'] if fol['ackedBytes'] is not None else 'n/a'}</td>"
                        f"<td>{fol['lagBytes'] if fol['lagBytes'] is not None else 'n/a'}</td>"
                        f"<td>{'yes' if fol['connected'] else 'no'}</td></tr>"
                    )
        lag = (
            "<h2>Replication lag</h2>"
            + ("<table><tr><th>leader</th><th>partition</th>"
               "<th>follower</th><th>committed</th><th>acked</th>"
               "<th>lag (bytes)</th><th>connected</th></tr>"
               + "".join(lag_rows) + "</table>"
               if lag_rows else "<p>no replicated partlog members</p>")
        )
        burn_rows = "".join(
            f"<tr><td>{_html.escape(name)}</td>"
            f"<td>{_html.escape(str(w['member']))}</td>"
            f"<td>{w['burn']}</td>"
            f"<td>{_html.escape(str(w['window']))}</td>"
            f"<td>{_html.escape(', '.join(w['firing']) or '-')}</td></tr>"
            for name, w in sorted(pay["slo"]["worstBurn"].items())
        )
        slo = (
            "<h2>Worst SLO burn per objective</h2>"
            + ("<table><tr><th>objective</th><th>worst member</th>"
               "<th>burn</th><th>window</th><th>firing</th></tr>"
               + burn_rows + "</table>"
               if burn_rows else "<p>no SLOs reported</p>")
        )
        place_rows = "".join(
            f"<tr><td>{_html.escape(p['member'])}</td>"
            f"<td>{_html.escape(p['mode'])}</td>"
            f"<td>{p['paramBytes']}</td>"
            f"<td>{_html.escape(', '.join(str(sc['name']) for sc in p['scorers']) or '-')}</td></tr>"
            for p in pay["placement"]
        )
        placement = (
            "<h2>Placement</h2>"
            + ("<table><tr><th>member</th><th>mode</th>"
               "<th>param bytes</th><th>scorers</th></tr>"
               + place_rows + "</table>"
               if place_rows else "<p>no serving members reporting</p>")
        )
        return 200, _html_response(
            head + summary + members + lag + slo + placement
            + "<p><a href='/fleet.json'>/fleet.json</a> — the router "
            "contract</p></body></html>"
        )

    # -- training telemetry --------------------------------------
    def training_html(self, req: Request) -> Tuple[int, Any]:
        """Live training view: one scrape of a trainer status sidecar's
        /train.json — run/phase header, step progress with ETA, the
        recent-loss window, and stream/phase breakdowns."""
        self._pageviews.inc(page="training")
        url = (req.params.get("url") or self.train_url).rstrip("/")
        head = (
            "<!doctype html><html><head><title>pio-tpu training</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "table{border-collapse:collapse;margin-bottom:1em}"
            "td,th{border:1px solid #ccc;padding:.4em .8em;"
            "text-align:right}th,td:first-child{text-align:left}"
            ".bar{background:#dfd;display:inline-block;height:1em}"
            "</style></head><body><h1>Training</h1>"
        )
        if not url:
            return 200, _html_response(
                head + "<p>no trainer configured — start "
                "<code>pio train</code> (its status sidecar prints a "
                "loopback port) and pass <code>--train-url</code>, set "
                "<code>PIO_TPU_TRAIN_STATUS_URL</code>, or use "
                "<code>?url=http://127.0.0.1:PORT</code></p></body></html>"
            )
        import urllib.request

        try:
            with urllib.request.urlopen(url + "/train.json", timeout=3.0) as r:
                data = json.loads(r.read().decode("utf-8"))
        except Exception as e:
            return 200, _html_response(
                head + f"<p>scraping <code>{_html.escape(url)}"
                "/train.json</code> (override with ?url=)</p>"
                f"<p>scrape failed: {_html.escape(f'{type(e).__name__}: {e}')}"
                " — no run in flight, or the sidecar exited with its "
                "run</p></body></html>"
            )
        fmt = lambda v, spec="{:.3f}": (
            spec.format(v) if isinstance(v, (int, float)) else "n/a"
        )
        progress = data.get("progress")
        pct = progress * 100 if isinstance(progress, (int, float)) else None
        bar = (
            f"<p><span class='bar' style='width:{pct:.0f}%'>&nbsp;</span>"
            f" {pct:.1f}%</p>" if pct is not None else ""
        )
        summary = (
            f"<p>run <code>{_html.escape(str(data.get('runId') or '?'))}</code>"
            f" &middot; engine <code>"
            f"{_html.escape(str(data.get('engineId') or '?'))}</code>"
            f" &middot; phase <b>{_html.escape(str(data.get('phase') or '?'))}"
            f"</b> &middot; algo "
            f"{_html.escape(str(data.get('algo') or '-'))}</p>" + bar
            + "<table><tr><th>step</th><th>of</th><th>epoch</th>"
            "<th>examples</th><th>examples/s</th><th>loss</th>"
            "<th>eta (s)</th><th>elapsed (s)</th></tr>"
            f"<tr><td>{data.get('step', 0)}</td>"
            f"<td>{data.get('totalSteps', 0)}</td>"
            f"<td>{fmt(data.get('epoch'), '{:.2f}')}</td>"
            f"<td>{data.get('examples', 0)}</td>"
            f"<td>{fmt(data.get('examplesPerSecond'), '{:.0f}')}</td>"
            f"<td>{fmt(data.get('loss'), '{:.5f}')}</td>"
            f"<td>{fmt(data.get('etaSeconds'), '{:.0f}')}</td>"
            f"<td>{fmt(data.get('elapsedSeconds'), '{:.1f}')}</td></tr>"
            "</table>"
        )
        window = data.get("lossWindow") or []
        losses = (
            "<h2>Loss window</h2><pre style='background:#f6f6f6;"
            "padding:1em;overflow-x:auto'>"
            + _html.escape(" ".join(f"{v:.5f}" for v in window))
            + "</pre>" if window else ""
        )
        stream = data.get("stream") or {}
        stream_table = (
            "<h2>Stream feed</h2><table>"
            "<tr><th>streamed</th><th>chunks</th><th>h2d bytes</th>"
            "<th>overlap ratio</th></tr>"
            f"<tr><td>{'yes' if stream.get('streamed') else 'no'}</td>"
            f"<td>{stream.get('chunks', 0)}</td>"
            f"<td>{stream.get('h2dBytes', 0)}</td>"
            f"<td>{fmt(stream.get('overlapRatio'))}</td></tr></table>"
        )
        phases = data.get("phases") or {}
        phase_rows = "".join(
            f"<tr><td>{_html.escape(k)}</td><td>{fmt(v)}</td></tr>"
            for k, v in phases.items()
        )
        phase_table = (
            "<h2>Phases (s)</h2><table><tr><th>phase</th><th>seconds</th>"
            "</tr>" + phase_rows + "</table>" if phase_rows else ""
        )
        return 200, _html_response(
            head + f"<p>scraping <code>{_html.escape(url)}/train.json</code>"
            " (override with ?url=)</p>" + summary + losses + stream_table
            + phase_table + "</body></html>"
        )

    # -- device telemetry -----------------------------------------
    def devices_html(self, req: Request) -> Tuple[int, Any]:
        """Live device view: one scrape of a /device.json surface (query
        server by default, trainer sidecar via ?url=) — per-device memory
        table, compile-site attribution, and the placement ledger."""
        self._pageviews.inc(page="devices")
        url = (req.params.get("url") or self.query_url or self.train_url)
        url = url.rstrip("/") if url else ""
        head = (
            "<!doctype html><html><head><title>pio-tpu devices</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "table{border-collapse:collapse;margin-bottom:1em}"
            "td,th{border:1px solid #ccc;padding:.4em .8em;"
            "text-align:right}th,td:first-child{text-align:left}"
            "</style></head><body><h1>Devices</h1>"
        )
        if not url:
            return 200, _html_response(
                head + "<p>no /device.json source configured — pass "
                "<code>--query-url</code> / <code>--train-url</code> or "
                "use <code>?url=http://127.0.0.1:PORT</code></p>"
                "</body></html>"
            )
        import urllib.request

        try:
            with urllib.request.urlopen(
                url + "/device.json", timeout=3.0
            ) as r:
                data = json.loads(r.read().decode("utf-8"))
        except Exception as e:
            return 200, _html_response(
                head + f"<p>scraping <code>{_html.escape(url)}"
                "/device.json</code> (override with ?url=)</p>"
                f"<p>scrape failed: {_html.escape(f'{type(e).__name__}: {e}')}"
                "</p></body></html>"
            )
        mb = lambda v: (
            f"{v / 1048576.0:,.1f}" if isinstance(v, (int, float)) else "n/a"
        )
        budget = data.get("budgetBytes") or 0
        headroom = data.get("headroomBytes")
        summary = (
            f"<p>mode <b>{_html.escape(str(data.get('mode') or '?'))}</b>"
            f" &middot; generation {data.get('generation', 0)}"
            f" &middot; samples {data.get('samples', 0)}"
            f" &middot; budget {mb(budget) if budget else 'unset'} MiB"
            + (f" &middot; headroom <b>{mb(headroom)}</b> MiB"
               if headroom is not None else "")
            + "</p>"
        )
        dev_rows = "".join(
            f"<tr><td>{d.get('device')}</td>"
            f"<td>{mb(d.get('bytesInUse'))}</td>"
            f"<td>{mb(d.get('peakBytes'))}</td>"
            f"<td>{mb(d.get('limitBytes'))}</td>"
            f"<td>{mb(d.get('ledgerBytes'))}</td>"
            f"<td>{mb(d.get('driftBytes'))}</td>"
            f"<td>{_html.escape(str(d.get('source') or '-'))}</td></tr>"
            for d in data.get("devices") or []
        )
        devices = (
            "<h2>Device memory (MiB)</h2><table><tr><th>device</th><th>in use</th>"
            "<th>peak</th><th>limit</th><th>ledger</th><th>drift</th>"
            "<th>source</th></tr>" + dev_rows + "</table>"
            if dev_rows else "<p>no device samples yet</p>"
        )
        compiles = data.get("compiles") or {}
        site_rows = "".join(
            f"<tr><td>{_html.escape(site)}</td><td>{row.get('count', 0)}</td>"
            f"<td>{row.get('seconds', 0.0):.3f}</td>"
            f"<td>{_html.escape(str(row.get('lastTraceId') or '-'))}</td>"
            "</tr>"
            for site, row in sorted((compiles.get("sites") or {}).items())
        )
        compile_table = (
            f"<h2>Compiles (total {compiles.get('total', 0)})</h2>"
            "<table><tr><th>site</th><th>count</th><th>seconds</th>"
            "<th>last trace</th></tr>" + site_rows + "</table>"
            if site_rows else "<p>no compiles attributed yet</p>"
        )
        ledger = data.get("ledger") or {}
        place_rows = "".join(
            f"<tr><td>{_html.escape(str(p.get('name') or p.get('key')))}</td>"
            f"<td>{_html.escape(str(p.get('category')))}</td>"
            f"<td>{p.get('generation') if p.get('generation') is not None else '-'}</td>"
            f"<td>{mb(p.get('bytes'))}</td></tr>"
            for p in data.get("placements") or []
        )
        placements = (
            f"<h2>Placements (ledger {mb(ledger.get('totalBytes'))} MiB)</h2>"
            "<table><tr><th>name</th><th>category</th><th>gen</th>"
            "<th>MiB</th></tr>" + place_rows + "</table>"
            if place_rows else ""
        )
        return 200, _html_response(
            head + f"<p>scraping <code>{_html.escape(url)}/device.json</code>"
            " (override with ?url=)</p>" + summary + devices + compile_table
            + placements + "</body></html>"
        )

    def serving(self, req: Request) -> Tuple[int, Any]:
        """Live serving view: pool-wide request totals + avg QPS since
        deploy and a per-stage latency table, from one scrape of the
        query server (any pool worker answers with pool-wide sums)."""
        self._pageviews.inc(page="serving")
        url = req.params.get("url") or self.query_url
        if url != self.query_url:
            self.query_url = url.rstrip("/")
        pm, status, err = self._scrape_query_server()
        head = (
            "<!doctype html><html><head><title>pio-tpu serving</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
            "padding:.4em .8em;text-align:right}th,td:first-child"
            "{text-align:left}</style></head><body>"
            "<h1>Serving</h1>"
            f"<p>scraping <code>{_html.escape(self.query_url)}"
            "/metrics</code> (override with ?url=)</p>"
        )
        if pm is None:
            return 200, _html_response(
                head + f"<p>scrape failed: {_html.escape(err)}</p>"
                "</body></html>"
            )
        total = sum(pm.family("pio_tpu_queries_total").values())
        errors = sum(pm.family("pio_tpu_query_errors_total").values())
        qps = None
        if status and status.get("startTime"):
            import datetime as _dt

            try:
                t0 = _dt.datetime.fromisoformat(status["startTime"])
                up = (_dt.datetime.now(_dt.timezone.utc) - t0).total_seconds()
                if up > 0:
                    qps = total / up
            except ValueError:
                pass
        summary = (
            "<table><tr><th>requests</th><th>errors</th>"
            "<th>avg QPS since deploy</th></tr>"
            f"<tr><td>{int(total)}</td><td>{int(errors)}</td>"
            f"<td>{f'{qps:.2f}' if qps is not None else 'n/a'}</td></tr>"
            "</table>"
        )
        # per-stage latency table from the stage histograms (pool-wide)
        stages: dict = {}
        for ls, count in pm.family("pio_tpu_query_stage_seconds_count").items():
            d = dict(ls)
            stage = d.get("stage", "?")
            total_s = pm.value("pio_tpu_query_stage_seconds_sum", **d) or 0.0
            row = {
                "count": int(count),
                "avgMs": (total_s / count * 1e3) if count else None,
            }
            for col, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
                v = pm.histogram_quantile("pio_tpu_query_stage_seconds", q, **d)
                row[col] = v * 1e3 if v is not None else None
            stages[stage] = row
        fmt = lambda v: f"{v:.3f}" if v is not None else "n/a"
        stage_rows = "".join(
            f"<tr><td>{_html.escape(stage)}</td><td>{r['count']}</td>"
            f"<td>{fmt(r['avgMs'])}</td><td>{fmt(r['p50'])}</td>"
            f"<td>{fmt(r['p95'])}</td><td>{fmt(r['p99'])}</td></tr>"
            for stage, r in sorted(stages.items())
        )
        stage_table = (
            "<h2>Per-stage latency (ms)</h2>"
            "<table><tr><th>stage</th><th>count</th><th>avg</th>"
            "<th>p50</th><th>p95</th><th>p99</th></tr>"
            + (stage_rows or "<tr><td colspan='6'>no observations</td></tr>")
            + "</table>"
        )
        return 200, _html_response(
            head + summary + stage_table + self._hotpath_panel()
            + self._slo_panel() + self._qos_panel() + self._log_panel()
            + "</body></html>"
        )


def create_dashboard(
    host: str = "0.0.0.0", port: int = 9000,
    query_url: str = "http://127.0.0.1:8000",
    fleet_targets: Optional[str] = None,
    train_url: Optional[str] = None,
) -> JsonHTTPServer:
    """Build (unstarted) dashboard — reference ``Dashboard.main``. When
    fleet targets are configured the embedded aggregator's scrape loop
    starts here (daemon thread; it dies with the process)."""
    service = DashboardService(
        query_url=query_url, fleet_targets=fleet_targets,
        train_url=train_url,
    )
    server = JsonHTTPServer(
        service.router, host, port, name="pio-tpu-dashboard"
    )
    server.service = service
    if service.fleet is not None:
        service.fleet.start()
    return server
