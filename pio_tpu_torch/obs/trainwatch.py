"""Training telemetry plane — step-stream metrics, live progress, run ledger.

The port's copy of ``pio_tpu/obs/trainwatch.py``:

- **StepRecorder**: the per-run telemetry hub. Training loops report
  step batches into it (loss window, examples, per-step seconds, h2d
  bytes); it feeds the step-stream metric families
  (``pio_tpu_train_steps_total``, ``pio_tpu_train_loss``,
  ``pio_tpu_train_step_seconds``, ``pio_tpu_train_examples_total``) and
  renders the ``/train.json`` progress payload the trainer status
  sidecar serves (``server/train_status.py``).
- **Active-recorder hooks**: training loops call the module-level
  :func:`record_steps` / :func:`set_phase` etc., which do nothing unless
  a run activated a recorder — algorithm code never threads a recorder
  through its signatures, and library callers (tests, benchmarks) pay
  nothing.
- **The lagged loss drain** (:func:`lagged_losses`): a step loop on the
  card hands each step's loss over without waiting for it. Each loss is
  copied to pinned host memory behind the step on the same stream, a
  chunk of steps is sealed with a CUDA event, and a chunk is read only
  once its event says it is done, one chunk or more behind the dispatch
  frontier. So the recorder adds no kernel and no synchronization to a
  step; :meth:`LaggedLosses.close` reads what is left after the loop.
  The reference fetches a ``lax.scan`` chunk's loss array one chunk
  behind instead.
- **Run registry**: every ``run_train`` appends a flat JSON record to
  ``$PIO_TPU_HOME/runs/<engine-id>.jsonl``; ``pio runs`` lists the
  ledger and diffs consecutive runs with the direction-aware regression
  logic of :func:`delta_rows`.

Failpoints: ``trainwatch.record``, ``trainwatch.payload`` and
``trainwatch.append``.
"""

from __future__ import annotations

import collections
import contextlib
import datetime as _dt
import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.obs.metrics import REGISTRY, monotonic_s
from pio_tpu_torch.utils import knobs

#: steps retired by training loops, per algorithm
_STEPS = REGISTRY.counter(
    "pio_tpu_train_steps_total",
    "Optimizer steps retired by training loops",
    ("algo",),
)

#: most recent training loss (ALS has no per-step loss; absent there)
_LOSS = REGISTRY.gauge(
    "pio_tpu_train_loss",
    "Most recent training loss reported by the step stream",
    ("algo",),
)

#: per-step wall seconds — the steps of one recorded batch share its mean,
#: so each observation covers one recorded step batch
_STEP_SECONDS = REGISTRY.histogram(
    "pio_tpu_train_step_seconds",
    "Mean per-step wall seconds over each recorded step batch",
    ("algo",),
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
)

#: training examples consumed (batch rows for SGD loops, rating edges
#: for ALS)
_EXAMPLES = REGISTRY.counter(
    "pio_tpu_train_examples_total",
    "Training examples consumed by training loops",
    ("algo",),
)


class StepRecorder:
    """Per-run telemetry hub behind ``/train.json``.

    Thread-safe: the training loop writes from the training thread while
    the status sidecar's HTTP thread reads payloads, so every mutation
    and snapshot takes the internal lock. One recorder covers one run
    (possibly several algorithms in sequence — each :meth:`begin_algo`
    resets the per-algo window but keeps run totals).
    """

    def __init__(self, run_id: str, engine_id: str = "", *,
                 loss_window: int = 64):
        self._lock = threading.Lock()
        self.run_id = run_id
        self.engine_id = engine_id
        self.started_s = monotonic_s()
        self.phase = "start"
        self.algo = ""
        self.algo_index = -1
        self.algo_started_s: Optional[float] = None
        self.total_steps = 0
        self.steps_done = 0
        self.examples_done = 0
        self.n_batches = 0
        self.streamed = False
        self.n_stream = 0
        self.params_per_device_bytes = 0
        self.h2d_bytes = 0
        self.overlap_ratio: Optional[float] = None
        self.step_seconds = 0.0
        self.last_loss: Optional[float] = None
        self.losses: collections.deque = collections.deque(
            maxlen=max(1, loss_window)
        )
        self.phases: Dict[str, float] = {}

    # -- writes (training loop side) ------------------------------------

    def set_phase(self, name: str) -> None:
        with self._lock:
            self.phase = name

    def set_phase_seconds(self, name: str, dur_s: float) -> None:
        with self._lock:
            self.phases[name] = round(float(dur_s), 3)

    def begin_algo(self, algo: str, *, total_steps: int,
                   n_batches: int = 0, streamed: bool = False,
                   n_stream: int = 0, per_device_bytes: int = 0) -> None:
        """Open one algorithm's training window (resets per-algo
        progress; run-level totals like h2d bytes accumulate across)."""
        with self._lock:
            self.algo = algo
            self.algo_index += 1
            self.algo_started_s = monotonic_s()
            self.total_steps = int(total_steps)
            self.steps_done = 0
            self.examples_done = 0
            self.step_seconds = 0.0
            self.n_batches = int(n_batches)
            self.streamed = bool(streamed)
            self.n_stream = int(n_stream)
            self.params_per_device_bytes = int(per_device_bytes)
            self.last_loss = None
            self.losses.clear()

    def record_steps(self, n: int, *,
                     losses: Optional[Sequence[float]] = None,
                     examples: int = 0,
                     dur_s: Optional[float] = None) -> None:
        """Report ``n`` retired steps (one drained chunk, or ALS's whole
        run with its edges as examples)."""
        failpoint("trainwatch.record")
        with self._lock:
            algo = self.algo or "unknown"
            self.steps_done += int(n)
            self.examples_done += int(examples)
            if n:
                _STEPS.inc(int(n), algo=algo)
            if examples:
                _EXAMPLES.inc(int(examples), algo=algo)
            if losses is not None and len(losses) > 0:
                for v in losses:
                    self.losses.append(float(v))
                self.last_loss = float(losses[-1])
                _LOSS.set(self.last_loss, algo=algo)
            if dur_s is not None and n > 0:
                self.step_seconds += float(dur_s)
                _STEP_SECONDS.observe(float(dur_s) / int(n), algo=algo)

    def record_h2d(self, nbytes: int) -> None:
        with self._lock:
            self.h2d_bytes += int(nbytes)

    def set_stream(self, streamed: bool, n_stream: int = 0) -> None:
        with self._lock:
            self.streamed = bool(streamed)
            self.n_stream = int(n_stream)

    def set_overlap(self, ratio: float) -> None:
        with self._lock:
            self.overlap_ratio = float(ratio)

    # -- reads (sidecar / registry side) --------------------------------

    # pio: endpoint=/train.json
    def payload(self) -> dict:
        """The ``/train.json`` body (the reference's keys)."""
        failpoint("trainwatch.payload")
        with self._lock:
            now = monotonic_s()
            elapsed = now - self.started_s
            algo_elapsed = (
                now - self.algo_started_s
                if self.algo_started_s is not None else None
            )
            progress = (
                self.steps_done / self.total_steps
                if self.total_steps > 0 else None
            )
            eta = None
            if (algo_elapsed and self.steps_done > 0
                    and self.total_steps > self.steps_done):
                rate = self.steps_done / algo_elapsed
                if rate > 0:
                    eta = round(
                        (self.total_steps - self.steps_done) / rate, 1
                    )
            eps = None
            if algo_elapsed and algo_elapsed > 0 and self.examples_done:
                eps = round(self.examples_done / algo_elapsed, 1)
            epoch = (
                round(self.steps_done / self.n_batches, 3)
                if self.n_batches > 0 else None
            )
            return {
                "runId": self.run_id,
                "engineId": self.engine_id,
                "phase": self.phase,
                "algo": self.algo or None,
                "algoIndex": self.algo_index if self.algo_index >= 0
                else None,
                "elapsedSeconds": round(elapsed, 3),
                "step": self.steps_done,
                "totalSteps": self.total_steps,
                "epoch": epoch,
                "progress": round(progress, 4)
                if progress is not None else None,
                "etaSeconds": eta,
                "examples": self.examples_done,
                "examplesPerSecond": eps,
                "loss": self.last_loss,
                "lossWindow": [round(v, 6) for v in self.losses],
                "stream": {
                    "streamed": self.streamed,
                    "chunks": self.n_stream,
                    "h2dBytes": self.h2d_bytes,
                    "overlapRatio": self.overlap_ratio,
                },
                "paramsPerDeviceBytes": self.params_per_device_bytes,
                "phases": dict(self.phases),
            }

    def summary(self) -> dict:
        """Flat step summary for the run-ledger record."""
        with self._lock:
            now = monotonic_s()
            algo_elapsed = (
                now - self.algo_started_s
                if self.algo_started_s is not None else None
            )
            eps = None
            if algo_elapsed and algo_elapsed > 0 and self.examples_done:
                eps = round(self.examples_done / algo_elapsed, 1)
            window_mean = (
                round(sum(self.losses) / len(self.losses), 6)
                if self.losses else None
            )
            return {
                "algo": self.algo or None,
                "steps": self.steps_done,
                "examples": self.examples_done,
                "examples_per_sec": eps,
                "final_loss": round(self.last_loss, 6)
                if self.last_loss is not None else None,
                "loss_window_mean": window_mean,
                "h2d_bytes": self.h2d_bytes,
                "overlap_ratio": self.overlap_ratio,
                "streamed": self.streamed,
                "stream_chunks": self.n_stream,
            }


# ---------------------------------------------------------------------------
# active recorder — module-global (NOT a contextvar: the sidecar HTTP
# thread must see the training thread's recorder)
# ---------------------------------------------------------------------------

_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional[StepRecorder] = None


def activate(rec: StepRecorder) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = rec


def deactivate() -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = None


def active_recorder() -> Optional[StepRecorder]:
    return _ACTIVE


@contextlib.contextmanager
def recording(rec: StepRecorder):
    """Install ``rec`` as the process's active recorder for the block."""
    activate(rec)
    try:
        yield rec
    finally:
        deactivate()


def set_phase(name: str) -> None:
    rec = _ACTIVE
    if rec is not None:
        rec.set_phase(name)


def begin_algo(algo: str, **kw) -> None:
    rec = _ACTIVE
    if rec is not None:
        rec.begin_algo(algo, **kw)


def record_steps(n: int, **kw) -> None:
    rec = _ACTIVE
    if rec is not None:
        rec.record_steps(n, **kw)


def record_h2d(nbytes: int) -> None:
    rec = _ACTIVE
    if rec is not None:
        rec.record_h2d(nbytes)


def set_overlap(ratio: float) -> None:
    rec = _ACTIVE
    if rec is not None:
        rec.set_overlap(ratio)


def set_stream(streamed: bool, n_stream: int = 0) -> None:
    rec = _ACTIVE
    if rec is not None:
        rec.set_stream(streamed, n_stream)


# ---------------------------------------------------------------------------
# the lagged loss drain of the port's step loops
# ---------------------------------------------------------------------------

#: steps a loss chunk holds: one record_steps call (and one CUDA event)
#: a chunk
LOSS_CHUNK_STEPS = 10


class LaggedLosses:
    """Hands a step loop's losses to ``rec`` without waiting for them.

    :meth:`step` enqueues a copy of the step's 0-d loss into the next
    slot of a pinned host buffer allocated once for the loop's
    ``total_steps`` (``non_blocking``, on the current stream, behind the
    step); every :data:`LOSS_CHUNK_STEPS` steps the chunk is sealed with
    an event, and every chunk whose event has completed is recorded
    (``Event.query`` does not wait). A chunk's seconds are the device
    time between its event and the one before. :meth:`close` seals the
    last chunk and waits for what is left: call it after the loop.

    On the CPU a step's loss is already computed when the loop gets it;
    the chunks are the same and their seconds come from the host clock.
    """

    def __init__(self, rec: StepRecorder, device: torch.device,
                 examples_per_step: int, total_steps: int):
        self._rec = rec
        self._cuda = device.type == "cuda"
        self._examples = int(examples_per_step)
        self._pending: collections.deque = collections.deque()
        self._host = self._alloc(total_steps)
        self._lo = self._k = 0  # the open chunk's first slot, next slot
        self._last = self._mark()

    def _alloc(self, n: int) -> torch.Tensor:
        return torch.empty(max(int(n), LOSS_CHUNK_STEPS), dtype=torch.float32,
                           pin_memory=self._cuda)

    def _mark(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return monotonic_s()

    def step(self, loss: torch.Tensor) -> None:
        if self._k == len(self._host):  # more steps than planned
            self._seal()
            self._host, self._lo, self._k = self._alloc(len(self._host)), 0, 0
        self._host[self._k].copy_(loss, non_blocking=self._cuda)
        self._k += 1
        if self._k - self._lo == LOSS_CHUNK_STEPS:
            self._seal()
            self._drain(wait=False)

    def _seal(self) -> None:
        if self._k > self._lo:
            self._pending.append(
                (self._host[self._lo:self._k], self._mark()))
        self._lo = self._k

    def _drain(self, wait: bool) -> None:
        while self._pending:
            losses, mark = self._pending[0]
            if self._cuda:
                if wait:
                    mark.synchronize()
                elif not mark.query():
                    return
                dur_s = self._last.elapsed_time(mark) / 1e3
            else:
                dur_s = mark - self._last
            self._pending.popleft()
            self._last = mark
            n = len(losses)
            self._rec.record_steps(n, losses=losses.tolist(),
                                   examples=n * self._examples, dur_s=dur_s)

    def close(self) -> None:
        """Record every step the loop reported (waits for the last
        chunks: call after the loop)."""
        self._seal()
        self._drain(wait=True)


def lagged_losses(device: torch.device, examples_per_step: int,
                  total_steps: int) -> Optional[LaggedLosses]:
    """A :class:`LaggedLosses` feeding the active recorder, or None when
    no run is recording (the loop then does no telemetry work)."""
    rec = _ACTIVE
    if rec is None:
        return None
    return LaggedLosses(rec, device, examples_per_step, total_steps)


# ---------------------------------------------------------------------------
# direction-aware deltas — the regression core of ``pio runs --diff``
# ---------------------------------------------------------------------------


def delta_rows(prev: dict, cur: dict,
               fields: Sequence[Tuple[str, str]],
               threshold: float) -> Tuple[list, list]:
    """``(rows, regressed_fields)`` comparing two flat records.

    ``fields`` are ``(name, direction)`` pairs, direction ``"up"`` or
    ``"down"`` (the *good* direction). Each row is
    ``(field, prev, cur, delta_str, tag)``; a field moves onto the
    regressed list when it moves AGAINST its direction by more than
    ``threshold`` (fractional). Non-numeric or missing values skip.
    """
    rows: list = []
    regressed: list = []
    for field, direction in fields:
        a, b = prev.get(field), cur.get(field)
        if not isinstance(a, (int, float)) or not isinstance(b, (int, float)):
            continue
        pct = (b - a) / a if a else None
        if pct is None:
            tag = ""
            delta = "n/a"
        else:
            delta = f"{pct * 100:+.1f}%"
            bad = pct < -threshold if direction == "up" else pct > threshold
            good = pct > threshold if direction == "up" else pct < -threshold
            tag = "  REGRESSION" if bad else ("  improved" if good else "")
            if bad:
                regressed.append(field)
        rows.append((field, a, b, delta, tag))
    return rows, regressed


# ---------------------------------------------------------------------------
# run registry — $PIO_TPU_HOME/runs/<engine-id>.jsonl, one flat record
# per run_train (COMPLETED and FAILED both: a crashed run is trend data)
# ---------------------------------------------------------------------------

DEFAULT_RUN_THRESHOLD = 0.05

#: run-ledger trajectory fields and their good direction; ``phase_*``
#: durations join dynamically (direction "down") when diffing
RUN_FIELDS: Tuple[Tuple[str, str], ...] = (
    ("train_seconds", "down"),
    ("examples_per_sec", "up"),
    ("final_loss", "down"),
    ("loss_window_mean", "down"),
    ("overlap_ratio", "up"),
)


def runs_path(engine_id: str) -> str:
    # the home storage/registry.py's pio_home() reads
    home = knobs.knob_str("PIO_TPU_HOME") or os.path.expanduser("~/.pio_tpu")
    return os.path.join(home, "runs", f"{engine_id}.jsonl")


def run_record(*, run_id: str, engine_id: str, status: str,
               train_seconds: float, phases: Dict[str, float],
               params_hash: str, step_summary: Optional[dict] = None,
               num_devices: Optional[int] = None,
               shard_manifest: Optional[str] = None,
               timestamp: Optional[str] = None,
               error: Optional[str] = None) -> dict:
    """One runs.jsonl row. Flat where it matters: the step summary's
    numeric fields are lifted to the top level so :func:`delta_rows`
    can diff two rows directly."""
    if timestamp is None:
        timestamp = _dt.datetime.now(_dt.timezone.utc).isoformat(
            timespec="seconds"
        )
    rec: Dict[str, Any] = {
        "run_id": run_id,
        "engine_id": engine_id,
        "timestamp": timestamp,
        "status": status,
        "params_hash": params_hash,
        "train_seconds": round(float(train_seconds), 3),
        "num_devices": num_devices,
        "shard_manifest": shard_manifest,
    }
    for name, dur in (phases or {}).items():
        rec[f"phase_{name}"] = round(float(dur), 3)
    if step_summary:
        rec["step_summary"] = dict(step_summary)
        for key in ("examples_per_sec", "final_loss", "loss_window_mean",
                    "overlap_ratio", "steps", "examples"):
            if step_summary.get(key) is not None:
                rec[key] = step_summary[key]
    if error:
        rec["error"] = error[-500:]
    return rec


def append_run(record: dict, path: Optional[str] = None) -> str:
    """Append one record to the engine's ledger; returns the path."""
    failpoint("trainwatch.append")
    if path is None:
        path = runs_path(record.get("engine_id") or "unknown")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")
    return path


def read_runs(engine_id: Optional[str] = None,
              path: Optional[str] = None) -> List[dict]:
    """All parseable ledger rows (malformed lines — torn appends — are
    skipped, never fatal)."""
    if path is None:
        if engine_id is None:
            raise ValueError("read_runs needs engine_id or path")
        path = runs_path(engine_id)
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(row, dict):
                    out.append(row)
    except OSError:
        pass
    return out


def run_delta_table(prev: dict, cur: dict,
                    threshold: float = DEFAULT_RUN_THRESHOLD
                    ) -> Tuple[list, list]:
    """``(table_lines, regressed_fields)`` for two run-ledger rows —
    the static :data:`RUN_FIELDS` plus every ``phase_*`` duration both
    rows carry (direction "down": a slower phase is a regression)."""
    fields = list(RUN_FIELDS)
    phase_keys = sorted(
        k for k in cur
        if k.startswith("phase_") and k in prev
    )
    fields.extend((k, "down") for k in phase_keys)
    rows, regressed = delta_rows(prev, cur, fields, threshold)
    lines = [
        f"run delta vs {prev.get('run_id') or '?'} "
        f"({prev.get('timestamp') or '?'}), threshold "
        f"{threshold * 100:.1f}%:",
        f"  {'field':<24} {'prev':>12} {'now':>12} {'delta':>9}",
    ]
    for field, a, b, delta, tag in rows:
        lines.append(f"  {field:<24} {a:>12} {b:>12} {delta:>9}{tag}")
    if not rows:
        lines.append("  (no comparable numeric fields)")
    return lines, regressed
