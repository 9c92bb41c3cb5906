"""The port's two-tower model against the JAX package's, on the CPU.

The same inputs, from numpy seeds, go through both; the port starts from
the reference's ``jax.random`` init, carried across with
``twotower_params_from_reference`` (the two packages draw different
streams). Tolerances:

- the tower forward and the contrastive loss at init: 1e-5 (f32 dots of
  O(1) values in another summation order, ~1e-7);
- vector tables and the loss after 15 and 20 Adam steps: 1e-4 (Adam
  divides by ``sqrt(v) + 1e-8``, so rounding in the gradients moves the
  weights by up to ``lr`` times their relative size; 1.5e-7 seen);
- ``scores`` of a model carried across with
  ``twotower_model_from_reference``: 1e-5.

The streamed epoch feed (``stream="on"``, or ``"auto"`` under a device
budget below the epoch) gives the staged run's bits, and matches the
reference's streamed run within the staged runs' 1e-4; params over the
budget raise. A mesh of one rank
(an in-process gloo group of one, ``tests/torch_ranks.py``) gives the
single-device tables bit for bit; ``tests/test_torch_mesh_neural.py``
holds meshes of 2 and 4 ranks. The card against the CPU is a ``cuda``
test.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.models import two_tower as R
from pio_tpu_torch.convert import (
    twotower_model_from_reference,
    twotower_params_from_reference,
)
from pio_tpu_torch.models import two_tower as T
from pio_tpu_torch.parallel.partition import DeviceBudgetExceeded

sys.path.insert(0, os.path.dirname(__file__))
from torch_ranks import group_of_one  # noqa: E402

KW = dict(embed_dim=8, hidden=16, out_dim=8)
TOWER_KEYS = ("emb", "w1", "b1", "w2", "b2")


def _pairs(seed=0, n_users=12, n_items=10, n=400):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n).astype(np.int32),
            rng.integers(0, n_items, n).astype(np.int32))


def _ref_init(vu, vi, seed=0, **kw):
    cfg = R.TwoTowerConfig(**{**KW, **kw})
    ku, ki = jax.random.split(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, {"user": R._init_tower(ku, vu, cfg),
                                     "item": R._init_tower(ki, vi, cfg)})


@pytest.fixture()
def reference_init(monkeypatch):
    """The port's init swapped for the reference's (its seed, its
    sizes)."""
    def init(vu, vi, cfg, generator):
        tree = _ref_init(vu, vi, cfg.seed, embed_dim=cfg.embed_dim,
                         hidden=cfg.hidden, out_dim=cfg.out_dim)
        return twotower_params_from_reference(tree, "cpu")

    monkeypatch.setattr(T, "init_params", init)


def test_init_scales_and_shapes():
    cfg = T.TwoTowerConfig(embed_dim=64, hidden=128, out_dim=32)
    p = T.init_params(3000, 2000, cfg, torch.Generator().manual_seed(0))
    assert p["user"]["emb"].shape == (3000, 64)
    assert p["item"]["w2"].shape == (128, 32)
    assert p["user"]["emb"].std().item() == pytest.approx(64 ** -0.5, rel=0.05)
    assert p["item"]["w2"].std().item() == pytest.approx(128 ** -0.5, rel=0.1)
    assert not p["user"]["b1"].any() and not p["item"]["b2"].any()
    # explicit generator: the same seed gives the same draws
    q = T.init_params(3000, 2000, cfg, torch.Generator().manual_seed(0))
    assert torch.equal(p["item"]["emb"], q["item"]["emb"])
    assert not torch.equal(p["user"]["emb"][:2000], p["item"]["emb"])


def test_tower_forward_and_loss_at_init_match_reference():
    tree = _ref_init(12, 10)
    port = twotower_params_from_reference(tree, "cpu")
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 12, 32).astype(np.int32)
    iids = rng.integers(0, 10, 32).astype(np.int32)
    want = R._tower_forward(jax.tree.map(jnp.asarray, tree["user"]),
                            jnp.asarray(ids), None)
    got = T._tower_forward(port["user"], torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-5)
    cfg = R.TwoTowerConfig(**KW)
    want = R._contrastive_loss(
        jax.tree.map(jnp.asarray, tree["user"]),
        jax.tree.map(jnp.asarray, tree["item"]),
        jnp.asarray(ids), jnp.asarray(iids), cfg, None, None)
    got = T._contrastive_loss(port["user"], port["item"],
                              torch.from_numpy(ids), torch.from_numpy(iids),
                              T.TwoTowerConfig(**KW))
    assert float(got) == pytest.approx(float(want), abs=1e-5)


def test_loss_gradient_matches_reference():
    """The gradient every Adam step starts from: 1e-5."""
    tree = _ref_init(12, 10)
    ids, iids = (a[:32] for a in _pairs(2))
    cfg = R.TwoTowerConfig(**KW)
    want = jax.grad(lambda p: R._contrastive_loss(
        p["user"], p["item"], jnp.asarray(ids), jnp.asarray(iids), cfg,
        None, None))(jax.tree.map(jnp.asarray, tree))
    port = twotower_params_from_reference(tree, "cpu")
    leaves = [port[t][k].requires_grad_(True) for t in ("user", "item")
              for k in TOWER_KEYS]
    loss = T._contrastive_loss(port["user"], port["item"],
                               torch.from_numpy(ids), torch.from_numpy(iids),
                               T.TwoTowerConfig(**KW))
    grads = torch.autograd.grad(loss, leaves)
    k = 0
    for t in ("user", "item"):
        for name in TOWER_KEYS:
            np.testing.assert_allclose(grads[k].numpy(),
                                       np.asarray(want[t][name]), atol=1e-5)
            k += 1


def _batch_loss(user_vectors, item_vectors, u, i, temperature=20.0):
    """The in-batch loss of trained vector tables (numpy, f64)."""
    uv = np.asarray(user_vectors, np.float64)[u]
    iv = np.asarray(item_vectors, np.float64)[i]
    logits = temperature * uv @ iv.T
    m = logits.max(axis=1, keepdims=True)
    logz = (m + np.log(np.exp(logits - m).sum(axis=1, keepdims=True)))[:, 0]
    return float(np.mean(logz - np.diag(logits)))


@pytest.mark.parametrize("steps,batch,n_pairs", [
    (15, 32, 400),   # 12.5 batches: the wraparound
    (20, 64, 50),    # one batch larger than the data: batch = n_pairs
])
def test_training_matches_reference(reference_init, steps, batch, n_pairs):
    u, i = _pairs(0, n=n_pairs)
    cfg = dict(**KW, steps=steps, batch_size=batch, seed=3)
    want = R.train_two_tower(None, u, i, 12, 10, R.TwoTowerConfig(**cfg))
    got = T.train_two_tower(None, u, i, 12, 10, T.TwoTowerConfig(**cfg),
                            device="cpu")
    assert got.user_vectors.device.type == "cpu"
    np.testing.assert_allclose(got.user_vectors.numpy(), want.user_vectors,
                               atol=1e-4)
    np.testing.assert_allclose(got.item_vectors.numpy(), want.item_vectors,
                               atol=1e-4)
    assert _batch_loss(got.user_vectors, got.item_vectors, u[:32], i[:32]) \
        == pytest.approx(_batch_loss(want.user_vectors, want.item_vectors,
                                     u[:32], i[:32]), abs=1e-4)


def test_bfloat16_table_wire(reference_init):
    """The tables rounded through bf16: the port's f32 tables rounded
    exactly, and within one bf16 step (2^-8 of a unit vector's entries)
    of the reference's bf16 tables."""
    u, i = _pairs(1)
    cfg = dict(**KW, steps=10, batch_size=32)
    f32 = T.train_two_tower(None, u, i, 12, 10, T.TwoTowerConfig(**cfg),
                            device="cpu")
    stats = {}
    bf = T.train_two_tower(None, u, i, 12, 10,
                           T.TwoTowerConfig(**cfg, table_wire="bfloat16"),
                           device="cpu", stats=stats)
    assert torch.equal(bf.item_vectors,
                       f32.item_vectors.to(torch.bfloat16).float())
    assert bf.item_vectors.dtype == torch.float32
    assert stats["table_wire"] == "bfloat16" and stats["n_stream"] == 0
    assert set(stats) >= {"place_s", "steps_s", "tables_d2h_s"}
    want = R.train_two_tower(None, u, i, 12, 10, R.TwoTowerConfig(
        **cfg, table_wire="bfloat16"))
    np.testing.assert_allclose(bf.item_vectors.numpy(), want.item_vectors,
                               atol=2 ** -8)


def test_scores_of_a_converted_model_match_reference():
    u, i = _pairs(4)
    ref = R.train_two_tower(None, u, i, 12, 10,
                            R.TwoTowerConfig(**KW, steps=10, batch_size=32))
    em = twotower_model_from_reference({
        "user_vectors": ref.user_vectors, "item_vectors": ref.item_vectors,
        "config": dataclasses.asdict(ref.config),
        "user_index": {f"u{k}": k for k in range(12)},
        "item_index": {f"i{k}": k for k in range(10)},
    }, device="cpu")
    assert em.model.config == T.TwoTowerConfig(**KW, steps=10, batch_size=32)
    rows = ref.user_vectors[[0, 5, 11]]
    np.testing.assert_allclose(em.model.scores(rows), ref.scores(rows),
                               atol=1e-5)
    np.testing.assert_allclose(em.model.scores(em.model.user_vectors[:3]),
                               ref.scores(ref.user_vectors[:3]), atol=1e-5)


def test_stream_on_and_bad_options_raise():
    """Bad options raise; ``stream="on"`` no longer does: it streams and
    gives the staged bits."""
    u, i = _pairs(0)
    cfg = T.TwoTowerConfig(**KW, steps=6, batch_size=32)
    staged = T.train_two_tower(None, u, i, 12, 10, cfg, device="cpu")
    stats = {}
    streamed = T.train_two_tower(None, u, i, 12, 10,
                                 dataclasses.replace(cfg, stream="on"),
                                 device="cpu", stats=stats)
    assert stats["n_stream"] >= 2
    assert torch.equal(streamed.user_vectors, staged.user_vectors)
    with pytest.raises(ValueError, match="stream"):
        T.train_two_tower(None, u, i, 12, 10,
                          T.TwoTowerConfig(**KW, stream="maybe"), device="cpu")
    with pytest.raises(ValueError, match="table_wire"):
        T.train_two_tower(None, u, i, 12, 10,
                          T.TwoTowerConfig(**KW, table_wire="fp8"),
                          device="cpu")


def test_a_mesh_of_one_rank_is_the_single_device_path():
    """Over a mesh of one rank (its data and model axes gloo groups of
    one) the trainer gives the single-device tables bit for bit."""
    u, i = _pairs(0)
    cfg = T.TwoTowerConfig(**KW, steps=5, batch_size=32)
    want = T.train_two_tower(None, u, i, 12, 10, cfg, device="cpu")
    with group_of_one() as ctx:
        got = T.train_two_tower(ctx.mesh, u, i, 12, 10, cfg, device="cpu")
    assert torch.equal(got.user_vectors, want.user_vectors)
    assert torch.equal(got.item_vectors, want.item_vectors)


def test_device_budget(monkeypatch):
    """Params over the budget raise, as in the reference; ids that do not
    fit beside them stream under "auto" where the reference streams, with
    enough spans for each to fit the headroom, and give the staged bits;
    "off" stages them all the same."""
    u, i = _pairs(0)
    cfg = T.TwoTowerConfig(**KW, steps=14, batch_size=32)
    staged = T.train_two_tower(None, u, i, 12, 10, cfg, device="cpu")
    params = 4 * ((12 + 10) * 8 + 2 * (8 * 16 + 16 + 16 * 8 + 8))
    monkeypatch.setenv("PIO_TPU_DEVICE_BUDGET_BYTES", str(params - 1))
    with pytest.raises(DeviceBudgetExceeded, match="two_tower params"):
        T.train_two_tower(None, u, i, 12, 10, cfg, device="cpu")
    monkeypatch.setenv("PIO_TPU_DEVICE_BUDGET_BYTES", str(params + 800))
    stats = {}
    got = T.train_two_tower(None, u, i, 12, 10, cfg, device="cpu",
                            stats=stats)
    # 416 pairs: 13 batches of 32, 3328 B staged, 800 B of headroom
    assert stats["n_stream"] == 5
    assert torch.equal(got.user_vectors, staged.user_vectors)
    assert torch.equal(got.item_vectors, staged.item_vectors)
    assert stats["h2d_bytes"] == 14 * 32 * 2 * 4
    # the reference streams at this budget, and trains
    R.train_two_tower(None, u, i, 12, 10, R.TwoTowerConfig(
        **KW, steps=2, batch_size=32))
    m = T.train_two_tower(None, u, i, 12, 10,
                          dataclasses.replace(cfg, stream="off"),
                          device="cpu", stats=(off := {}))
    assert off["n_stream"] == 0 and torch.equal(m.item_vectors,
                                                staged.item_vectors)
    monkeypatch.setenv("PIO_TPU_DEVICE_BUDGET_BYTES", "0")
    T.train_two_tower(None, u, i, 12, 10, cfg, device="cpu")


@pytest.mark.parametrize("stream_mb", ["0.0005", "0.002", "64"])
@pytest.mark.parametrize("steps,batch,n_pairs", [
    (15, 32, 400),   # 12.5 batches: the wraparound
    (30, 32, 400),   # more than two epochs
])
def test_streamed_run_is_the_staged_run(monkeypatch, stream_mb, steps,
                                        batch, n_pairs):
    """Streamed in spans of 1, 4 and all 13 batches (``n_stream`` at
    least 2), the run gives the staged bits; the feed's stats count every
    step's ids once."""
    monkeypatch.setenv("PIO_TPU_TRAIN_STREAM_MB", stream_mb)
    u, i = _pairs(5, n=n_pairs)
    cfg = T.TwoTowerConfig(**KW, steps=steps, batch_size=batch, seed=1)
    staged = T.train_two_tower(None, u, i, 12, 10, cfg, device="cpu")
    stats = {}
    streamed = T.train_two_tower(None, u, i, 12, 10,
                                 dataclasses.replace(cfg, stream="on"),
                                 device="cpu", stats=stats)
    assert torch.equal(streamed.user_vectors, staged.user_vectors)
    assert torch.equal(streamed.item_vectors, staged.item_vectors)
    assert stats["n_stream"] >= 2
    assert stats["h2d_bytes"] == steps * batch * 2 * 4
    assert {"h2d_s", "device_s", "encode_s"} <= set(stats)


def test_streamed_run_matches_reference_streamed(reference_init,
                                                 monkeypatch):
    """Both packages streamed (``stream="on"``, spans of 2 batches) from
    the reference's init: the staged runs' 1e-4."""
    monkeypatch.setenv("PIO_TPU_TRAIN_STREAM_MB", "0.0005")
    u, i = _pairs(0, n=400)
    cfg = dict(**KW, steps=15, batch_size=32, seed=3, stream="on")
    want = R.train_two_tower(None, u, i, 12, 10, R.TwoTowerConfig(**cfg),
                             stats=(ref_stats := {}))
    got = T.train_two_tower(None, u, i, 12, 10, T.TwoTowerConfig(**cfg),
                            device="cpu", stats=(stats := {}))
    assert stats["n_stream"] == ref_stats["n_stream"] >= 2
    assert stats["h2d_bytes"] == ref_stats["h2d_bytes"]
    np.testing.assert_allclose(got.user_vectors.numpy(), want.user_vectors,
                               atol=1e-4)
    np.testing.assert_allclose(got.item_vectors.numpy(), want.item_vectors,
                               atol=1e-4)


# ------------------------------------------------------------------- the card
@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_matches_cpu(cuda_device):
    """20 steps on the card against the CPU from one init: f32 dots in
    another order, so the CPU tests' tolerance, 1e-4; the card twice gives
    the same bits."""
    u, i = _pairs(6, 40, 30, 2000)
    cfg = T.TwoTowerConfig(**KW, steps=20, batch_size=128)
    cpu = T.train_two_tower(None, u, i, 40, 30, cfg, device="cpu")
    card = T.train_two_tower(None, u, i, 40, 30, cfg, device=cuda_device)
    again = T.train_two_tower(None, u, i, 40, 30, cfg, device=cuda_device)
    assert card.item_vectors.device.type == "cuda"
    np.testing.assert_allclose(card.item_vectors.cpu().numpy(),
                               cpu.item_vectors.numpy(), atol=1e-4)
    assert torch.equal(card.user_vectors, again.user_vectors)


@pytest.mark.cuda
def test_card_streamed_is_the_card_staged(cuda_device, monkeypatch):
    """On the card the streamed feed (copy stream, pinned ring, events)
    gives the staged run's bits, under ``stream="on"`` and under a budget
    below the epoch."""
    u, i = _pairs(6, 40, 30, 2000)
    cfg = T.TwoTowerConfig(**KW, steps=40, batch_size=128)
    staged = T.train_two_tower(None, u, i, 40, 30, cfg, device=cuda_device)
    monkeypatch.setenv("PIO_TPU_TRAIN_STREAM_MB", "0.002")
    on = T.train_two_tower(None, u, i, 40, 30,
                           dataclasses.replace(cfg, stream="on"),
                           device=cuda_device)
    assert torch.equal(on.user_vectors, staged.user_vectors)
    assert torch.equal(on.item_vectors, staged.item_vectors)
    params = 4 * ((40 + 30) * 8 + 2 * (8 * 16 + 16 + 16 * 8 + 8))
    monkeypatch.setenv("PIO_TPU_DEVICE_BUDGET_BYTES", str(params + 4096))
    auto = T.train_two_tower(None, u, i, 40, 30, cfg, device=cuda_device,
                             stats=(stats := {}))
    assert stats["n_stream"] >= 4
    assert torch.equal(auto.item_vectors, staged.item_vectors)
