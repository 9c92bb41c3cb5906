"""Checkpoint and resume in the port, on the CPU.

The reference's cases (tests/test_checkpoint.py) on
``pio_tpu_torch.workflow.checkpoint``: a snapshot round trip, ``keep``
pruning, one chunk without a manager, chunked equal to unchunked, resume
from a snapshot and past the total, a stale directory purged. The port's
trainers hold to more than the reference's tolerance: on the CPU a run
interrupted and resumed gives the uninterrupted run's bits (the same
ops in the same order from the same state), and so does a chunked run.
``run_train`` with ``WorkflowParams(checkpoint_every=...)`` writes
``<dir>/algo0_<name>/`` and resumes from it. The trainers start from the
reference's init (``convert.py``) where they are compared with it.
"""

import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from pio_tpu.models import seqrec as R_seq
from pio_tpu.models import two_tower as R_tt
from pio_tpu.workflow.checkpoint import state_fingerprint as jax_fingerprint
from pio_tpu_torch.convert import (
    seqrec_params_from_reference,
    twotower_params_from_reference,
)
from pio_tpu_torch.models import seqrec as T_seq
from pio_tpu_torch.models import two_tower as T_tt
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.records import App
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.workflow.checkpoint import (
    CheckpointManager,
    default_checkpoint_dir,
    run_chunked_steps,
    state_fingerprint,
)
from pio_tpu_torch.workflow.core_workflow import (
    load_models_for_instance,
    run_train,
)
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict
from pio_tpu_torch.workflow.params import WorkflowParams

CPU = torch.device("cpu")
LOGGER = "pio_tpu_torch.workflow.checkpoint"


def _toy_chunk(state, n):
    """state = (step, value): the value counts the steps."""
    step0, v = state
    for _ in range(n):
        v = v + 1.0
    return step0 + n, v


def _toy_state():
    return 0, torch.tensor(0.0)


# ------------------------------------------------------- CheckpointManager
def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    state = {"a": torch.arange(4.0), "b": (7, torch.tensor([1, 2], dtype=torch.int32))}
    assert mgr.restore(template=state) is None
    mgr.save(3, state)
    step, got = mgr.restore(template=state)
    assert step == 3
    assert torch.equal(got["a"], state["a"])
    assert got["b"][0] == 7 and torch.equal(got["b"][1], state["b"][1])
    assert got["b"][1].dtype == torch.int32
    # the layout: <dir>/<step>/state.pt, nothing left under a temporary name
    assert sorted(os.listdir(mgr.directory)) == ["3"]
    assert os.listdir(os.path.join(mgr.directory, "3")) == ["state.pt"]


def test_keep_prunes_old_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(mgr.directory)) == ["2", "3"]
    step, got = mgr.restore(template={"x": torch.zeros(2)})
    assert step == 3
    assert got["x"].tolist() == [3.0, 3.0]


def test_restore_refuses_another_shape(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="does not match"):
        mgr.restore(template={"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="keys"):
        mgr.restore(template={"y": torch.zeros(2)})


def test_fingerprint_and_default_dir_match_reference(tmp_path, monkeypatch):
    parts = ("two_tower", (3, 4), 12, 1234)
    assert state_fingerprint(*parts) == jax_fingerprint(*parts)
    monkeypatch.setenv("PIO_TPU_HOME", str(tmp_path))
    assert default_checkpoint_dir("abc") == str(tmp_path / "checkpoints" / "abc")


def test_fingerprint_file_is_the_reference_layout(tmp_path):
    """``fingerprint.json`` holds ``{"fingerprint": ...}``, written once by
    the first save, as the reference's (checkpoint.py l.82-86)."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"x": torch.zeros(1)}, fingerprint="f1")
    mgr.save(2, {"x": torch.zeros(1)}, fingerprint="f2")
    assert json.loads((tmp_path / "ck" / "fingerprint.json").read_text()) \
        == {"fingerprint": "f1"}


# ------------------------------------------------------- run_chunked_steps
def test_no_checkpoint_single_chunk():
    calls = []

    def chunk(state, n):
        calls.append(n)
        return _toy_chunk(state, n)

    step, v = run_chunked_steps(_toy_state(), 10, chunk)
    assert step == 10 and float(v) == 10.0 and calls == [10]


def test_chunked_equals_unchunked(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    step, v = run_chunked_steps(_toy_state(), 10, _toy_chunk,
                                checkpoint=mgr, checkpoint_every=4)
    assert step == 10 and float(v) == 10.0
    assert mgr.latest_step() == 10


def test_resume_from_snapshot(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    run_chunked_steps(_toy_state(), 8, _toy_chunk, checkpoint=mgr,
                      checkpoint_every=4)
    assert mgr.latest_step() == 8
    calls = []

    def counting(state, n):
        calls.append(n)
        return _toy_chunk(state, n)

    step, v = run_chunked_steps(_toy_state(), 10, counting, checkpoint=mgr,
                                checkpoint_every=4)
    assert step == 10 and float(v) == 10.0
    assert calls == [2]


def test_resume_past_total_is_noop(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    run_chunked_steps(_toy_state(), 10, _toy_chunk, checkpoint=mgr,
                      checkpoint_every=5)

    def never(state, n):
        raise AssertionError("ran")

    step, v = run_chunked_steps(_toy_state(), 10, never, checkpoint=mgr,
                                checkpoint_every=5)
    assert step == 10 and float(v) == 10.0


# ------------------------------------------------------ the trainers, resumed
TT_PAIRS = dict(n_users=12, n_items=10)


def _tt_pairs(seed, n=400):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 12, n).astype(np.int32),
            rng.integers(0, 10, n).astype(np.int32))


def _tt_cfg(steps):
    return T_tt.TwoTowerConfig(embed_dim=8, hidden=16, out_dim=8,
                               steps=steps, batch_size=32)


@pytest.fixture()
def reference_tt_init(monkeypatch):
    """The port's two-tower init swapped for the reference's draws."""
    cfg = R_tt.TwoTowerConfig(embed_dim=8, hidden=16, out_dim=8)

    def init(vu, vi, cfg_, generator):
        ku, ki = jax.random.split(jax.random.PRNGKey(cfg_.seed))
        tree = {"user": R_tt._init_tower(ku, vu, cfg),
                "item": R_tt._init_tower(ki, vi, cfg)}
        return twotower_params_from_reference(
            jax.tree.map(np.asarray, tree), "cpu")

    monkeypatch.setattr(T_tt, "init_params", init)


def _tt_train(u, i, steps, **kw):
    return T_tt.train_two_tower(None, u, i, 12, 10, _tt_cfg(steps),
                                device="cpu", **kw)


def test_two_tower_resume_equals_uninterrupted(tmp_path, caplog,
                                               reference_tt_init):
    u, i = _tt_pairs(0)
    base = _tt_train(u, i, 20)
    mgr = CheckpointManager(str(tmp_path / "tt"))
    _tt_train(u, i, 12, checkpoint=mgr, checkpoint_every=6)
    assert mgr.latest_step() == 12
    with caplog.at_level(logging.INFO, logger=LOGGER):
        resumed = _tt_train(u, i, 20, checkpoint=mgr, checkpoint_every=6)
    assert any("restored" in r.message for r in caplog.records)
    assert not any("mismatch" in r.message for r in caplog.records)
    assert mgr.latest_step() == 20
    assert torch.equal(resumed.user_vectors, base.user_vectors)
    assert torch.equal(resumed.item_vectors, base.item_vectors)
    # and the reference's uninterrupted run from the same init
    ref = R_tt.train_two_tower(None, u, i, 12, 10, R_tt.TwoTowerConfig(
        embed_dim=8, hidden=16, out_dim=8, steps=20, batch_size=32))
    np.testing.assert_allclose(resumed.item_vectors.numpy(),
                               ref.item_vectors, rtol=0, atol=1e-4)


def test_two_tower_chunked_equals_unchunked(tmp_path):
    u, i = _tt_pairs(3)
    base = _tt_train(u, i, 10)
    chunked = _tt_train(u, i, 10, checkpoint=CheckpointManager(
        str(tmp_path / "tt")), checkpoint_every=3)
    assert torch.equal(chunked.user_vectors, base.user_vectors)
    assert torch.equal(chunked.item_vectors, base.item_vectors)


SEQ_KW = dict(d_model=16, n_heads=2, n_layers=2, ffn=32, max_len=8)


def _seqs():
    seqs = np.zeros((8, 8), np.int32)
    for r in range(8):
        seqs[r, :6] = [(r + j) % 5 + 1 for j in range(6)]
    return seqs


@pytest.mark.parametrize("batch_size", [0, 3], ids=["full", "minibatch"])
def test_seqrec_resume_equals_uninterrupted(tmp_path, caplog, monkeypatch,
                                            batch_size):
    ref_cfg = R_seq.SeqRecConfig(**SEQ_KW, steps=20, batch_size=batch_size)
    init = jax.tree.map(np.asarray, R_seq.init_params(6, ref_cfg))
    monkeypatch.setattr(T_seq, "init_params",
                        lambda vocab, cfg, g: seqrec_params_from_reference(
                            init, "cpu"))
    seqs = _seqs()

    def train(steps, **kw):
        return T_seq.train_seqrec(
            None, seqs, 5, T_seq.SeqRecConfig(**SEQ_KW, steps=steps,
                                              batch_size=batch_size),
            device="cpu", **kw)

    base = train(20)
    mgr = CheckpointManager(str(tmp_path / "sr"))
    train(10, checkpoint=mgr, checkpoint_every=5)
    assert mgr.latest_step() == 10
    with caplog.at_level(logging.INFO, logger=LOGGER):
        resumed = train(20, checkpoint=mgr, checkpoint_every=5)
    assert any("restored" in r.message for r in caplog.records)
    assert not any("mismatch" in r.message for r in caplog.records)
    for k in ("emb", "pos", "lnf_g"):
        assert torch.equal(resumed.params[k], base.params[k]), k
    for k, v in base.params["blocks"].items():
        assert torch.equal(resumed.params["blocks"][k], v), k
    ref = R_seq.train_seqrec(None, seqs, 5, ref_cfg)
    for k in ("emb", "pos"):
        np.testing.assert_allclose(resumed.params[k].numpy(), ref.params[k],
                                   rtol=0, atol=1e-4)


def test_stale_dir_purged_and_reused(tmp_path, monkeypatch):
    u, i = _tt_pairs(2, 300)
    mgr = CheckpointManager(str(tmp_path / "tt"))
    _tt_train(u, i, 10, checkpoint=mgr, checkpoint_every=5)
    assert mgr.latest_step() == 10
    # "data changed": other pairs, another fingerprint
    u2, i2 = _tt_pairs(5, 300)
    calls = []
    real = T_tt._contrastive_loss

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(T_tt, "_contrastive_loss", counting)
    _tt_train(u2, i2, 10, checkpoint=mgr, checkpoint_every=5)
    monkeypatch.undo()
    assert len(calls) == 10  # not resumed: every step ran
    assert mgr.latest_step() == 10
    with open(mgr._fingerprint_path) as f:
        fp2 = json.load(f)["fingerprint"]
    _tt_train(u, i, 10, checkpoint=mgr, checkpoint_every=5)
    with open(mgr._fingerprint_path) as f:
        assert json.load(f)["fingerprint"] != fp2


# ----------------------------------------------------------- run_train
@pytest.fixture()
def memory_storage(tmp_home, monkeypatch):
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    Storage.reset()
    yield tmp_home
    Storage.reset()


def _twotower_variant(steps):
    return variant_from_dict({
        "id": "tt-ckpt", "engineFactory": "templates.twotower",
        "datasource": {"params": {"app_name": "ck"}},
        "algorithms": [{"name": "twotower", "params": {
            "embed_dim": 8, "hidden": 16, "out_dim": 8, "steps": steps,
            "batch_size": 16}}],
    })


def _seed_rates():
    app_id = Storage.get_meta_data_apps().insert(App(0, "ck"))
    rng = np.random.default_rng(4)
    Storage.get_levents().write([
        Event("rate", "user", f"u{a}", "item", f"i{b}",
              properties={"rating": 4.0})
        for a, b in zip(rng.integers(0, 10, 120), rng.integers(0, 8, 120))
    ], app_id)


@pytest.mark.parametrize("explicit_dir", [False, True], ids=["default", "dir"])
def test_run_train_checkpoints_each_algorithm(memory_storage, explicit_dir):
    _seed_rates()
    ctx = ComputeContext.local(device="cpu")
    ck = str(memory_storage / "ck") if explicit_dir else ""
    v = _twotower_variant(9)
    engine, ep = build_engine(v)
    wp = WorkflowParams(checkpoint_every=4, checkpoint_dir=ck)
    iid = run_train(engine, ep, v, wp, ctx=ctx)
    base = ck
    if not explicit_dir:
        (key,) = os.listdir(memory_storage / "checkpoints")
        base = str(memory_storage / "checkpoints" / key)
    algo_dir = os.path.join(base, "algo0_twotower")
    assert sorted(os.listdir(algo_dir)) == ["4", "8", "9", "fingerprint.json"]
    # a second run with the same config restores step 9 and trains no step
    iid2 = run_train(engine, ep, v, wp, ctx=ctx)
    (m1,), (m2,) = (load_models_for_instance(x, engine, ep, ctx)
                    for x in (iid, iid2))
    assert torch.equal(m1.model.item_vectors, m2.model.item_vectors)
    # the unchunked run without checkpoints gives the same bits
    iid3 = run_train(engine, ep, v, ctx=ctx)
    (m3,) = load_models_for_instance(iid3, engine, ep, ctx)
    assert torch.equal(m3.model.user_vectors, m1.model.user_vectors)
