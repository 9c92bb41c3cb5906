"""The port's training telemetry plane against the JAX package's, on the CPU.

- ``StepRecorder``: the same call sequence gives equal ``payload()`` and
  ``summary()`` in both packages, the clocks masked (elapsed seconds,
  ETA, examples a second).
- The module hooks do nothing without an active recorder and route to it
  inside ``recording``.
- The metric families the plane registers render the reference's
  Prometheus text for the same operations.
- The run ledger: ``run_record``, ``append_run``/``read_runs`` and
  ``run_delta_table`` give equal output on the same rows.
- A small ALS ``run_train`` through both packages: one COMPLETED ledger
  row each with equal ``step_summary`` counts and phase keys; a failed
  run lands as FAILED; ``profile_dir`` writes a parseable trace.
- Two-tower and sequence, 5 steps from the reference's init: the losses
  each package records equal each other within the trainers' 1e-4.
- The port's lagged loss drain on the CPU: one record a chunk of
  ``LOSS_CHUNK_STEPS`` steps, in order, and no drain without a run.
"""

import dataclasses
import datetime as dt
import json
import os

import jax
import numpy as np
import pytest

import pio_tpu.templates  # noqa: F401  (registers the JAX engine factories)
from pio_tpu.data import Event as JaxEvent
from pio_tpu.models import seqrec as RS
from pio_tpu.models import two_tower as RT
from pio_tpu.obs import trainwatch as rtw
from pio_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.storage import App as JaxApp
from pio_tpu.storage import Storage as JaxStorage
from pio_tpu.workflow import WorkflowParams as JaxWorkflowParams
from pio_tpu.workflow import build_engine as jax_build_engine
from pio_tpu.workflow import run_train as jax_run_train
from pio_tpu.workflow import variant_from_dict as jax_variant_from_dict
from pio_tpu_torch.convert import (
    seqrec_params_from_reference,
    twotower_params_from_reference,
)
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.models import seqrec as TS
from pio_tpu_torch.models import two_tower as TT
from pio_tpu_torch.obs import trainwatch as ptw
from pio_tpu_torch.obs.metrics import MetricsRegistry
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.records import App
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.workflow.core_workflow import run_train
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict
from pio_tpu_torch.workflow.params import WorkflowParams

#: the trainers' tolerance against the reference (tests/test_torch_two_tower.py,
#: tests/test_torch_seqrec.py): f32 sums in another order through Adam
LOSS_TOL = 1e-4
#: keys that read a clock
CLOCK_KEYS = ("elapsedSeconds", "etaSeconds", "examplesPerSecond",
              "examples_per_sec")
PACKAGES = [pytest.param(rtw, id="reference"), pytest.param(ptw, id="port")]


def masked(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in CLOCK_KEYS}


# ---------------------------------------------------------------- recorder
SEQUENCES = {
    "two_algos": [
        ("set_phase", ("read",), {}),
        ("set_phase_seconds", ("read", 0.1234), {}),
        ("begin_algo", ("als",), dict(total_steps=10, per_device_bytes=96)),
        ("record_steps", (10,), dict(examples=500)),
        ("begin_algo", ("two_tower",),
         dict(total_steps=8, n_batches=4, per_device_bytes=1024)),
        ("record_steps", (3,), dict(losses=[2.5, 2.25, 2.0], examples=48,
                                    dur_s=0.03)),
        ("record_h2d", (4096,), {}),
        ("set_overlap", (0.5,), {}),
        ("record_steps", (2,), dict(losses=[1.75, 1.5], examples=32,
                                    dur_s=0.02)),
        ("set_phase", ("persist",), {}),
    ],
    "window_overflow": [
        ("begin_algo", ("seqrec",), dict(total_steps=100, n_batches=0)),
        ("record_steps", (70,), dict(losses=[float(i) for i in range(70)],
                                     examples=700, dur_s=0.7)),
        ("set_stream", (True, 3), {}),
    ],
    "untouched": [],
}


@pytest.mark.parametrize("seq", list(SEQUENCES), ids=list(SEQUENCES))
def test_recorder_payload_and_summary_match_reference(seq):
    got = []
    for tw in (rtw, ptw):
        rec = tw.StepRecorder("run-1", "eng-1", loss_window=64)
        for name, args, kw in SEQUENCES[seq]:
            getattr(rec, name)(*args, **kw)
        got.append((masked(rec.payload()), masked(rec.summary()),
                    dict(rec.phases)))
    assert got[0] == got[1]


@pytest.mark.parametrize("tw", PACKAGES)
def test_hooks_route_to_the_active_recorder_only(tw):
    tw.deactivate()
    tw.set_phase("ignored")
    tw.record_steps(5, examples=10)
    assert tw.active_recorder() is None
    rec = tw.StepRecorder("r", "e")
    with tw.recording(rec):
        assert tw.active_recorder() is rec
        tw.set_phase("train")
        tw.begin_algo("als", total_steps=3)
        tw.record_steps(3, examples=30)
        tw.record_h2d(8)
        tw.set_overlap(0.25)
        tw.set_stream(False, 0)
    assert tw.active_recorder() is None
    assert (rec.phase, rec.steps_done, rec.examples_done, rec.h2d_bytes,
            rec.overlap_ratio) == ("train", 3, 30, 8, 0.25)


def test_metric_families_render_the_reference_text():
    """The plane's families on fresh registries, the same operations:
    the same exposition, line for line (buckets, labels, exemplars)."""
    texts = []
    for reg in (JaxRegistry(), MetricsRegistry()):
        c = reg.counter("pio_tpu_train_steps_total",
                        "Optimizer steps retired by training loops", ("algo",))
        g = reg.gauge("pio_tpu_train_loss", "Most recent training loss",
                      ("algo",))
        h = reg.histogram("pio_tpu_xla_compile_seconds",
                          'Wall "seconds"\nof compiles\\', ("site",),
                          buckets=(0.005, 0.02, 0.05, 1.0))
        u = reg.gauge("pio_tpu_device_budget_headroom_bytes", "headroom")
        c.inc(3, algo="als")
        c.labels("two_tower").inc(2.5)
        g.set(0.125, algo='a"b')
        g.set(1e21, algo="big")
        h.observe(0.01, site="train_step")
        h.observe(0.5, exemplar="t-1", site="train_step")
        h.labels("bucket_warmup")
        u.set(-5)
        texts.append(reg.render())
    assert texts[0] == texts[1]


FAMILIES = (
    "pio_tpu_train_steps_total", "pio_tpu_train_loss",
    "pio_tpu_train_step_seconds", "pio_tpu_train_examples_total",
    "pio_tpu_device_bytes_in_use", "pio_tpu_device_peak_bytes",
    "pio_tpu_device_limit_bytes", "pio_tpu_device_budget_headroom_bytes",
    "pio_tpu_device_estimate_drift_bytes", "pio_tpu_xla_compile_total",
    "pio_tpu_xla_compile_seconds",
)


@pytest.mark.parametrize("family", FAMILIES)
def test_global_families_match_reference_help_and_type(family):
    """The HELP and TYPE lines of the two planes' families, as the
    reference registers them on its process-global registry."""
    from pio_tpu.obs import devicewatch  # noqa: F401  (registers them)
    from pio_tpu.obs.metrics import REGISTRY as JAX_REGISTRY
    from pio_tpu_torch.obs.metrics import REGISTRY

    def heads(reg):
        return [line for line in reg.render()
                if line.startswith((f"# HELP {family} ",
                                    f"# TYPE {family} "))]

    assert len(heads(REGISTRY)) == 2
    assert heads(REGISTRY) == heads(JAX_REGISTRY)


# ------------------------------------------------------------- run ledger
ROWS = [
    dict(run_id="a", engine_id="e", status="COMPLETED", train_seconds=10.0,
         phases={"read": 1.0, "train.0_als": 8.0}, params_hash="h",
         step_summary={"algo": "als", "steps": 10, "examples": 100,
                       "examples_per_sec": 50.0, "final_loss": None,
                       "loss_window_mean": None, "h2d_bytes": 0,
                       "overlap_ratio": None, "streamed": False,
                       "stream_chunks": 0},
         num_devices=1, timestamp="2026-10-01T00:00:00+00:00"),
    dict(run_id="b", engine_id="e", status="COMPLETED", train_seconds=12.0,
         phases={"read": 0.5, "train.0_als": 11.0}, params_hash="h",
         step_summary={"algo": "als", "steps": 10, "examples": 100,
                       "examples_per_sec": 40.0, "final_loss": 0.5,
                       "loss_window_mean": 0.6, "h2d_bytes": 0,
                       "overlap_ratio": None, "streamed": False,
                       "stream_chunks": 0},
         num_devices=1, timestamp="2026-10-02T00:00:00+00:00"),
    dict(run_id="c", engine_id="e", status="FAILED", train_seconds=1.5,
         phases={}, params_hash="h", step_summary=None, num_devices=1,
         timestamp="2026-10-03T00:00:00+00:00", error="x" * 900),
]


@pytest.mark.parametrize("threshold", [0.05, 0.5])
def test_run_ledger_matches_reference(tmp_path, threshold):
    got = []
    for name, tw in (("ref", rtw), ("port", ptw)):
        path = str(tmp_path / name / "runs" / "e.jsonl")
        recs = [tw.run_record(**r) for r in ROWS]
        for rec in recs:
            assert tw.append_run(rec, path=path) == path
        with open(path, "a") as f:
            f.write('{"torn": \n')  # a torn append is skipped
        rows = tw.read_runs(path=path)
        table = tw.run_delta_table(rows[0], rows[1], threshold=threshold)
        got.append((recs, rows, table))
    assert got[0] == got[1]
    assert got[1][2][1] == (["train_seconds", "examples_per_sec",
                             "phase_train.0_als"] if threshold == 0.05 else [])


@pytest.mark.parametrize("tw", PACKAGES)
def test_runs_path_is_under_the_home(tw, tmp_home):
    assert tw.runs_path("eng") == os.path.join(str(tmp_home), "runs",
                                               "eng.jsonl")


# ------------------------------------------- run_train through both packages
T0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
VARIANT = {
    "id": "tw-als",
    "engineFactory": "templates.recommendation",
    "datasource": {"params": {"app_name": "tw-app"}},
    "algorithms": [{"name": "als", "params": {
        "rank": 4, "num_iterations": 3, "lambda_": 0.05, "seed": 1}}],
}


@pytest.fixture()
def memory_storage(tmp_home, monkeypatch):
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    Storage.reset()
    JaxStorage.reset()
    yield tmp_home
    Storage.reset()
    JaxStorage.reset()


def _seed(storage, app_cls, event_cls):
    app_id = storage.get_meta_data_apps().insert(app_cls(0, "tw-app"))
    le = storage.get_levents()
    for u in range(6):
        for i in range(5):
            le.insert(event_cls("rate", "user", f"u{u}", "item", f"i{i}",
                                properties={"rating": float(1 + (u + i) % 5)},
                                event_time=T0 + dt.timedelta(minutes=u * 9 + i)),
                      app_id)


def _ledger(home, engine_id):
    with open(os.path.join(str(home), "runs", f"{engine_id}.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_run_train_ledger_rows_match_reference(memory_storage, tmp_path):
    _seed(JaxStorage, JaxApp, JaxEvent)
    _seed(Storage, App, Event)
    v = jax_variant_from_dict(VARIANT)
    engine, ep = jax_build_engine(v)
    jax_run_train(engine, ep, v, JaxWorkflowParams(), ctx=JaxContext.local())
    (ref,) = _ledger(memory_storage, "tw-als")
    os.rename(os.path.join(str(memory_storage), "runs"),
              str(tmp_path / "ref_runs"))
    v = variant_from_dict(VARIANT)
    engine, ep = build_engine(v)
    prof = tmp_path / "trace"
    iid = run_train(engine, ep, v, WorkflowParams(profile_dir=str(prof)),
                    ctx=ComputeContext.create(seed=0, device="cpu"))
    (port,) = _ledger(memory_storage, "tw-als")
    assert port["run_id"] == iid and port["status"] == ref["status"] \
        == "COMPLETED"
    assert sorted(k for k in port if k.startswith("phase_")) == \
        sorted(k for k in ref if k.startswith("phase_"))
    counts = ("algo", "steps", "examples", "streamed", "stream_chunks",
              "h2d_bytes", "final_loss")
    assert {k: port["step_summary"][k] for k in counts} == \
        {k: ref["step_summary"][k] for k in counts}
    assert port["step_summary"]["steps"] == 3
    assert port["step_summary"]["examples"] == 30
    assert set(port) == set(ref)
    assert port["params_hash"] == ref["params_hash"]
    with open(prof / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_failed_run_lands_in_the_ledger(memory_storage):
    v = variant_from_dict({**VARIANT, "datasource": {"params": {
        "app_name": "no-such-app"}}})
    engine, ep = build_engine(v)
    with pytest.raises(Exception, match="no-such-app"):
        run_train(engine, ep, v,
                  ctx=ComputeContext.create(seed=0, device="cpu"))
    (row,) = _ledger(memory_storage, "tw-als")
    assert row["status"] == "FAILED" and "no-such-app" in row["error"]
    assert ptw.active_recorder() is None


# ------------------------------------------------ recorded losses, 5 steps
TT_KW = dict(embed_dim=8, hidden=16, out_dim=8)


def _recorded(tw, fn):
    rec = tw.StepRecorder("r", "e")
    with tw.recording(rec):
        fn()
    return rec


def test_two_tower_recorded_losses_match_reference(monkeypatch):
    rng = np.random.default_rng(0)
    u = rng.integers(0, 12, 400).astype(np.int32)
    i = rng.integers(0, 10, 400).astype(np.int32)
    cfg = dict(TT_KW, steps=5, batch_size=64, seed=0)

    def ref_init(vu, vi, c, generator):
        ku, ki = jax.random.split(jax.random.PRNGKey(c.seed))
        tree = jax.tree.map(np.asarray, {
            "user": RT._init_tower(ku, vu, RT.TwoTowerConfig(**TT_KW)),
            "item": RT._init_tower(ki, vi, RT.TwoTowerConfig(**TT_KW))})
        return twotower_params_from_reference(tree, "cpu")

    monkeypatch.setattr(TT, "init_params", ref_init)
    want = _recorded(rtw, lambda: RT.train_two_tower(
        None, u, i, 12, 10, RT.TwoTowerConfig(**cfg)))
    got = _recorded(ptw, lambda: TT.train_two_tower(
        None, u, i, 12, 10, TT.TwoTowerConfig(**cfg), device="cpu"))
    assert (got.algo, got.steps_done, got.examples_done, got.total_steps) \
        == (want.algo, want.steps_done, want.examples_done, want.total_steps)
    assert len(got.losses) == len(want.losses) == 5
    np.testing.assert_allclose(list(got.losses), list(want.losses),
                               rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("batch_size", [0, 4])
def test_seqrec_recorded_losses_match_reference(monkeypatch, batch_size):
    rng = np.random.default_rng(1)
    seqs = np.zeros((8, 6), np.int32)
    for r in range(8):
        n = rng.integers(3, 7)
        seqs[r, :n] = rng.integers(1, 15, n)
    kw = dict(d_model=16, n_heads=2, n_layers=1, ffn=32, max_len=6,
              steps=5, batch_size=batch_size, seed=0)

    def ref_init(vocab, c, generator):
        ref_cfg = RS.SeqRecConfig(**{f.name: getattr(c, f.name)
                                     for f in dataclasses.fields(c)})
        tree = jax.tree.map(np.asarray, RS.init_params(vocab, ref_cfg))
        return seqrec_params_from_reference(tree, "cpu")

    monkeypatch.setattr(TS, "init_params", ref_init)
    want = _recorded(rtw, lambda: RS.train_seqrec(
        None, seqs, 14, RS.SeqRecConfig(**kw)))
    got = _recorded(ptw, lambda: TS.train_seqrec(
        None, seqs, 14, TS.SeqRecConfig(**kw), device="cpu"))
    assert (got.algo, got.steps_done, got.examples_done) == \
        (want.algo, want.steps_done, want.examples_done)
    assert len(got.losses) == 5
    np.testing.assert_allclose(list(got.losses), list(want.losses),
                               rtol=0, atol=LOSS_TOL)


# ----------------------------------------------------- the lagged drain
@pytest.mark.parametrize("n_steps,planned", [
    (0, 5), (3, 3), (ptw.LOSS_CHUNK_STEPS, 200), (23, 23), (23, 7)],
    ids=["none", "short", "one_chunk", "three_chunks", "more_than_planned"])
def test_lagged_losses_record_each_chunk_in_order(n_steps, planned):
    import torch

    rec = ptw.StepRecorder("r", "e")
    calls = []
    record = rec.record_steps
    rec.record_steps = lambda n, **kw: (calls.append((n, kw)),
                                        record(n, **kw))
    drain = ptw.LaggedLosses(rec, torch.device("cpu"), examples_per_step=4,
                             total_steps=planned)
    for k in range(n_steps):
        drain.step(torch.tensor(float(k)))
    drain.close()
    sizes = [n for n, _ in calls]
    assert sum(sizes) == n_steps
    assert all(0 < n <= ptw.LOSS_CHUNK_STEPS for n in sizes)
    if planned >= n_steps:
        full, rest = divmod(n_steps, ptw.LOSS_CHUNK_STEPS)
        assert sizes == [ptw.LOSS_CHUNK_STEPS] * full + \
            ([rest] if rest else [])
    assert [v for _, kw in calls for v in kw["losses"]] == \
        [float(k) for k in range(n_steps)]
    assert all(kw["examples"] == 4 * n and kw["dur_s"] >= 0
               for n, kw in calls)
    assert rec.steps_done == n_steps


def test_no_drain_without_a_recording_run():
    import torch

    ptw.deactivate()
    assert ptw.lagged_losses(torch.device("cpu"), 4, 10) is None
