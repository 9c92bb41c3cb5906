"""The port's sequence model against the JAX package's, on the CPU.

The same inputs, from numpy seeds, go through both; the port starts from
the reference's ``jax.random`` init, carried across with
``seqrec_params_from_reference``. Tolerances:

- ``ring_attention`` and ``ulysses_attention`` against the reference's
  with ``axis=None``, the layer norm, the trunk and the cross-entropy at
  init: 1e-5 (f32 sums of O(1) terms in another order, ~1e-7);
- parameters and the loss after 15 Adam steps, full-batch and
  minibatch, both attention modes: 1e-4 (1.2e-7 seen);
- ``next_item_scores`` of a model carried across with
  ``seqrec_model_from_reference``: 1e-5 (O(10) scores: 1e-5 absolute is
  1e-6 relative).

With ``batch_size > 0`` the streamed epoch feed (``stream="on"``, or
``"auto"`` under a budget below the epoch) gives the staged run's bits
and matches the reference's streamed run within the staged runs' 1e-4;
``stream="on"`` without minibatches, params over the budget, and a
full-batch epoch over it raise, as in the reference. An axis of one
rank (an in-process gloo group of one, ``tests/torch_ranks.py``) gives
the results without an axis bit for bit, forward and backward, and so
does a mesh of one rank for the trainer; ``tests/test_torch_mesh_*.py``
hold the axes of 2 and 4 ranks. The card against the CPU is a ``cuda``
test.
"""

import dataclasses
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu.models import seqrec as R
from pio_tpu.parallel.partition import (
    DeviceBudgetExceeded as JaxBudgetExceeded,
)
from pio_tpu.parallel.ring import ring_attention as jax_ring
from pio_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from pio_tpu.parallel.vocab import vocab_parallel_lookup as jax_lookup
from pio_tpu.parallel.vocab import vocab_parallel_target_gather as jax_target
from pio_tpu_torch.convert import (
    seqrec_model_from_reference,
    seqrec_params_from_reference,
)
from pio_tpu_torch.models import seqrec as T
from pio_tpu_torch.models.adam import leaves
from pio_tpu_torch.parallel.partition import DeviceBudgetExceeded
from pio_tpu_torch.parallel.ring import ring_attention
from pio_tpu_torch.parallel.ulysses import ulysses_attention
from pio_tpu_torch.parallel.vocab import (
    vocab_parallel_lookup,
    vocab_parallel_target_gather,
)

sys.path.insert(0, os.path.dirname(__file__))
from torch_ranks import group_of_one  # noqa: E402

KW = dict(d_model=16, n_heads=2, n_layers=2, ffn=32, max_len=8)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v.numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
    return out


def _seqs(seed=1, n=8, t=10, n_items=5):
    """Right-padded histories, some longer than max_len (the tail path)."""
    rng = np.random.default_rng(seed)
    seqs = np.zeros((n, t), np.int32)
    for r in range(n):
        k = rng.integers(2, t + 1)
        seqs[r, :k] = rng.integers(1, n_items + 1, k)
    return seqs


@pytest.fixture()
def reference_init(monkeypatch):
    def init(vocab, cfg, generator):
        ref_cfg = R.SeqRecConfig(**{f.name: getattr(cfg, f.name)
                                    for f in dataclasses.fields(cfg)})
        tree = jax.tree.map(np.asarray, R.init_params(vocab, ref_cfg))
        return seqrec_params_from_reference(tree, "cpu")

    monkeypatch.setattr(T, "init_params", init)


# ---------------------------------------------------------- parallel/ pieces
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_attention_matches_reference(name, causal):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 8, 2, 4)).astype(np.float32)
               for _ in range(3))
    jfn, tfn = {"ring": (jax_ring, ring_attention),
                "ulysses": (jax_ulysses, ulysses_attention)}[name]
    want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), axis=None,
               causal=causal)
    got = tfn(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert got.shape == (2, 8, 2, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _piece_runs(name, axis):
    """A parallel piece at ``axis``: its output and the gradients of
    ``Σ <output, cotangent>`` with respect to its float inputs."""
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 7, (2, 5)))

    def inputs(*shapes):
        return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
                .requires_grad_(True) for s in shapes]

    if name in ("ring", "ulysses"):
        fn = ring_attention if name == "ring" else ulysses_attention
        xs = inputs(*[(2, 8, 2, 4)] * 3)
        out = fn(*xs, axis=axis)
    elif name == "lookup":
        xs = inputs((7, 3))
        out = vocab_parallel_lookup(xs[0], ids, axis)
    else:
        xs = inputs((2, 5, 7))
        out = vocab_parallel_target_gather(xs[0], ids, axis)
    cot = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    return [out.detach()] + list(torch.autograd.grad((out * cot).sum(), xs))


@pytest.mark.parametrize("name", ["ring", "ulysses", "lookup", "target"])
def test_parallel_pieces_over_an_axis_of_one(name):
    """An axis of one rank runs its collectives (gloo) and gives the bits
    of no axis, the output and the gradients."""
    want = _piece_runs(name, None)
    with group_of_one() as ctx:
        got = _piece_runs(name, ctx.group)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_vocab_helpers_match_reference():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(7, 3)).astype(np.float32)
    ids = rng.integers(0, 7, (2, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        vocab_parallel_lookup(torch.from_numpy(table), torch.from_numpy(ids)),
        np.asarray(jax_lookup(jnp.asarray(table), jnp.asarray(ids), None)))
    logits = rng.normal(size=(2, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        vocab_parallel_target_gather(torch.from_numpy(logits),
                                     torch.from_numpy(ids)),
        np.asarray(jax_target(jnp.asarray(logits), jnp.asarray(ids), None)))


# ---------------------------------------------------------------- the model
def test_init_scales_and_shapes():
    cfg = T.SeqRecConfig(d_model=64, n_heads=4, n_layers=3, ffn=256,
                         max_len=32)
    p = T.init_params(500, cfg, torch.Generator().manual_seed(0))
    assert p["emb"].shape == (500, 64) and p["pos"].shape == (32, 64)
    assert p["blocks"]["wq"].shape == (3, 64, 64)
    assert p["blocks"]["w2"].shape == (3, 256, 64)
    assert p["emb"].std().item() == pytest.approx(64 ** -0.5, rel=0.05)
    assert p["blocks"]["w2"].std().item() == pytest.approx(256 ** -0.5,
                                                           rel=0.05)
    assert torch.equal(p["blocks"]["ln1_g"], torch.ones(3, 64))
    assert not p["blocks"]["b1"].any()
    ref = R.init_params(500, R.SeqRecConfig(d_model=64, n_heads=4,
                                            n_layers=3, ffn=256, max_len=32))
    assert {k: v.shape for k, v in _flat(p).items()} == \
        {k: v.shape for k, v in _flat(ref).items()}


def test_layer_norm_trunk_and_ce_at_init_match_reference():
    cfg_r, cfg_t = R.SeqRecConfig(**KW), T.SeqRecConfig(**KW)
    tree = jax.tree.map(np.asarray, R.init_params(6, cfg_r))
    port = seqrec_params_from_reference(tree, "cpu")
    x = np.random.default_rng(3).normal(size=(2, 8, 16)).astype(np.float32)
    np.testing.assert_allclose(
        T._ln(torch.from_numpy(x), port["lnf_g"], port["lnf_b"]).numpy(),
        np.asarray(R._ln(jnp.asarray(x), tree["lnf_g"], tree["lnf_b"])),
        atol=1e-5)
    seqs = _seqs(t=8)
    want = jax.jit(lambda p, s_: R._trunk(p, s_, cfg_r, None, None, None))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(seqs))
    got = T._trunk(port, torch.from_numpy(seqs), cfg_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    targets = np.zeros_like(seqs)
    targets[:, :-1] = seqs[:, 1:]
    mask = ((targets > 0) & (seqs > 0)).astype(np.float32)
    ce_r, n_r = R._vocab_parallel_ce(want, jnp.asarray(tree["emb"]),
                                     jnp.asarray(targets), jnp.asarray(mask),
                                     None)
    ce_t, n_t = T._vocab_parallel_ce(got, port["emb"],
                                     torch.from_numpy(targets),
                                     torch.from_numpy(mask))
    assert float(n_t) == float(n_r)
    assert float(ce_t) / float(n_t) == pytest.approx(
        float(ce_r) / float(n_r), abs=1e-5)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
@pytest.mark.parametrize("batch_size", [0, 3], ids=["full", "minibatch"])
def test_training_matches_reference(reference_init, batch_size, attention):
    seqs = _seqs()
    cfg = dict(**KW, steps=15, batch_size=batch_size, attention=attention,
               seed=2)
    want = R.train_seqrec(None, seqs, 5, R.SeqRecConfig(**cfg))
    stats = {}
    got = T.train_seqrec(None, seqs, 5, T.SeqRecConfig(**cfg), device="cpu",
                         stats=stats)
    assert stats["n_stream"] == 0 and {"place_s", "steps_s"} <= set(stats)
    a, b = _flat(want.params), _flat(got.params)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-4, err_msg=k)
    assert got.params["emb"].shape == (6, 16)
    # the loss of the trained parameters over the (tail-truncated) epoch
    tail = np.zeros((8, 8), np.int32)
    for r in range(8):
        codes = seqs[r][seqs[r] > 0][-8:]
        tail[r, :len(codes)] = codes
    targets = np.zeros_like(tail)
    targets[:, :-1] = tail[:, 1:]
    mask = ((targets > 0) & (tail > 0)).astype(np.float32)
    h = R._trunk(jax.tree.map(jnp.asarray, want.params), jnp.asarray(tail),
                 R.SeqRecConfig(**cfg), None, None, None)
    ce, n = R._vocab_parallel_ce(h, jnp.asarray(want.params["emb"]),
                                 jnp.asarray(targets), jnp.asarray(mask), None)
    loss = T._loss(got.params, torch.from_numpy(tail),
                   torch.from_numpy(targets), torch.from_numpy(mask),
                   T.SeqRecConfig(**cfg))
    assert float(loss) == pytest.approx(float(ce) / float(n), abs=1e-4)


def _converted(ref):
    return seqrec_model_from_reference({
        "params": jax.tree.map(np.asarray, ref.params),
        "n_items": ref.n_items, "config": dataclasses.asdict(ref.config),
        "item_index": {f"i{k}": k for k in range(ref.n_items)},
        "user_histories": {"u0": [1, 2, 3]},
    }, device="cpu")


def test_next_item_scores_of_a_converted_model_match_reference():
    ref = R.train_seqrec(None, _seqs(), 5,
                         R.SeqRecConfig(**KW, steps=10))
    em = _converted(ref)
    h = np.zeros((4, 8), np.int32)
    h[0, :3] = [1, 2, 3]
    h[1, :] = [5, 4, 3, 2, 1, 1, 2, 3]
    h[2, :1] = [4]
    # row 3 is empty: both score from position 0
    got = em.model.next_item_scores(h)
    assert got.shape == (4, 6)
    np.testing.assert_allclose(got, ref.next_item_scores(h), atol=1e-5)
    # the serving cache is built once and never pickled
    assert em.model._serve_cache is not None
    copy = pickle.loads(pickle.dumps(em.model))
    assert copy._serve_cache is None
    np.testing.assert_array_equal(copy.next_item_scores(h), got)


def test_converted_model_checks_its_values():
    cfg = R.SeqRecConfig(**KW)
    arrays = {
        "params": jax.tree.map(np.asarray, R.init_params(6, cfg)),
        "n_items": 6, "config": dataclasses.asdict(cfg),
        "item_index": {f"i{k}": k for k in range(6)},
        "user_histories": {},
    }
    with pytest.raises(ValueError, match="emb has 6 rows"):
        seqrec_model_from_reference(arrays, device="cpu")
    arrays.update(n_items=5, item_index={f"i{k}": k for k in range(5)},
                  user_histories={"u": [0]})
    with pytest.raises(ValueError, match="history codes"):
        seqrec_model_from_reference(arrays, device="cpu")


def test_options_that_raise():
    seqs = _seqs()
    for cfg, err, match in (
        (dict(stream="on"), ValueError, "batch_size > 0"),
        (dict(stream="never"), ValueError, "stream"),
        (dict(attention="flash"), ValueError, "attention"),
    ):
        with pytest.raises(err, match=match):
            T.train_seqrec(None, seqs, 5, T.SeqRecConfig(**KW, **cfg),
                           device="cpu")


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_a_mesh_of_one_rank_is_the_single_device_path(attention):
    """Over a mesh of one rank (every axis a gloo group of one) the
    trainer gives the single-device parameters bit for bit."""
    seqs = _seqs()
    cfg = T.SeqRecConfig(**KW, steps=3, batch_size=3, attention=attention)
    want = T.train_seqrec(None, seqs, 5, cfg, device="cpu")
    with group_of_one() as ctx:
        got = T.train_seqrec(ctx.mesh, seqs, 5, cfg, device="cpu")
    a, b = _flat(want.params), _flat(got.params)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.mark.parametrize("batch_size", [0, 2], ids=["full", "minibatch"])
def test_device_budget(monkeypatch, batch_size):
    """Params over the budget raise; an epoch that does not fit beside
    them raises full-batch, as the reference does, and streams with
    minibatches, as the reference does, giving the staged bits; "off"
    stages it all the same."""
    seqs = _seqs()
    cfg = T.SeqRecConfig(**KW, steps=5, batch_size=batch_size)
    staged = T.train_seqrec(None, seqs, 5, cfg, device="cpu")
    D, F, L = 16, 32, 2
    params = 4 * (6 * D + 8 * D + 2 * D
                  + L * (4 * D + 4 * D * D + 2 * D * F + F + D))
    monkeypatch.setenv("PIO_TPU_DEVICE_BUDGET_BYTES", str(params - 1))
    with pytest.raises(DeviceBudgetExceeded, match="seqrec params"):
        T.train_seqrec(None, seqs, 5, cfg, device="cpu")
    monkeypatch.setenv("PIO_TPU_DEVICE_BUDGET_BYTES", str(params + 10))
    ref_cfg = R.SeqRecConfig(**KW, steps=1, batch_size=batch_size)
    if batch_size:
        R.train_seqrec(None, seqs, 5, ref_cfg)  # streams
        stats = {}
        got = T.train_seqrec(None, seqs, 5, cfg, device="cpu", stats=stats)
        # 8 rows x 8 positions x 12 B over 10 B of headroom: a span a batch
        assert stats["n_stream"] == 4
        a, b = _flat(staged.params), _flat(got.params)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    else:
        with pytest.raises(DeviceBudgetExceeded, match="staged epoch"):
            T.train_seqrec(None, seqs, 5, cfg, device="cpu")
        with pytest.raises(JaxBudgetExceeded, match="staged epoch"):
            R.train_seqrec(None, seqs, 5, ref_cfg)
    m = T.train_seqrec(None, seqs, 5, dataclasses.replace(cfg, stream="off"),
                       device="cpu")
    assert sum(t.numel() for t in leaves(m.params)) * 4 == params


@pytest.mark.parametrize("stream_mb", ["0.0005", "64"])
@pytest.mark.parametrize("steps", [3, 11])
def test_streamed_run_is_the_staged_run(monkeypatch, stream_mb, steps):
    """Minibatches streamed in spans of 1 batch and of 2: the staged bits;
    the feed ships 12 bytes a position of every step's batch."""
    monkeypatch.setenv("PIO_TPU_TRAIN_STREAM_MB", stream_mb)
    seqs = _seqs(3, 13, 10, 5)
    cfg = T.SeqRecConfig(**KW, steps=steps, batch_size=3, seed=4)
    staged = T.train_seqrec(None, seqs, 5, cfg, device="cpu")
    stats = {}
    streamed = T.train_seqrec(None, seqs, 5,
                              dataclasses.replace(cfg, stream="on"),
                              device="cpu", stats=stats)
    a, b = _flat(staged.params), _flat(streamed.params)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert stats["n_stream"] >= 2
    assert stats["h2d_bytes"] == steps * 3 * 8 * 12
    assert {"h2d_s", "device_s", "encode_s"} <= set(stats)


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_streamed_run_matches_reference_streamed(reference_init, monkeypatch,
                                                 attention):
    """Both packages streamed from the reference's init: the staged runs'
    1e-4."""
    monkeypatch.setenv("PIO_TPU_TRAIN_STREAM_MB", "0.0005")
    seqs = _seqs()
    cfg = dict(**KW, steps=15, batch_size=3, attention=attention, seed=2,
               stream="on")
    want = R.train_seqrec(None, seqs, 5, R.SeqRecConfig(**cfg),
                          stats=(ref_stats := {}))
    got = T.train_seqrec(None, seqs, 5, T.SeqRecConfig(**cfg), device="cpu",
                         stats=(stats := {}))
    assert stats["n_stream"] == ref_stats["n_stream"] >= 2
    assert stats["h2d_bytes"] == ref_stats["h2d_bytes"]
    a, b = _flat(want.params), _flat(got.params)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-4, err_msg=k)


# ------------------------------------------------------------------- the card
@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_streamed_is_the_card_staged(cuda_device, monkeypatch):
    """On the card the streamed feed gives the staged run's bits."""
    seqs = _seqs(4, 16, 12, 30)
    cfg = T.SeqRecConfig(**KW, steps=15, batch_size=3)
    staged = T.train_seqrec(None, seqs, 30, cfg, device=cuda_device)
    monkeypatch.setenv("PIO_TPU_TRAIN_STREAM_MB", "0.0005")
    got = T.train_seqrec(None, seqs, 30, dataclasses.replace(cfg, stream="on"),
                         device=cuda_device)
    for a, b in zip(leaves(staged.params), leaves(got.params)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("batch_size", [0, 3], ids=["full", "minibatch"])
def test_card_matches_cpu(cuda_device, batch_size):
    """15 steps on the card against the CPU from one init: the CPU tests'
    1e-4; the card twice gives the same bits."""
    seqs = _seqs(4, 16, 12, 30)
    cfg = T.SeqRecConfig(**KW, steps=15, batch_size=batch_size)
    cpu = T.train_seqrec(None, seqs, 30, cfg, device="cpu")
    card = T.train_seqrec(None, seqs, 30, cfg, device=cuda_device)
    again = T.train_seqrec(None, seqs, 30, cfg, device=cuda_device)
    a, b = _flat(cpu.params), {k: v for k, v in zip(
        _flat(cpu.params), (t.cpu().numpy() for t in leaves(card.params)))}
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-4, err_msg=k)
    for x, y in zip(leaves(card.params), leaves(again.params)):
        assert torch.equal(x, y)
    h = seqs[:4, :8]
    np.testing.assert_allclose(card.next_item_scores(h),
                               cpu.next_item_scores(h), atol=1e-4)
