"""The port's bucket ladder (``pio_tpu_torch/server/bucketcache.py``)
against the JAX package's, on the same seeded sequences.

Each case draws a random sequence of ``bucket_for``, ``chunks``, ``pad``,
``note_dispatch``, ``install`` and ``dispatch_bucketed`` calls from its
seed and runs it through both caches: every answer, every padded batch
that reaches ``run_batch`` and every ``on_dispatch`` call are equal, and
so is ``to_dict()`` after each step. ``buckets_from_env`` reads the same
ladders, malformed ones included.
"""

import numpy as np
import pytest

from pio_tpu.server import bucketcache as ref
from pio_tpu_torch.server import bucketcache as port

LADDERS = [None, (1, 2, 4, 8), (2, 4), (1,), (3, 5, 7), (8, 1, 4, 1)]


def run_sequence(mod, ladder, seed, n_ops=200):
    """A seeded op sequence through ``mod``'s cache; returns the trace."""
    rng = np.random.default_rng(seed)
    cache = mod.BucketExecutionCache(buckets=ladder)
    top = cache.max_bucket
    trace = []
    for _ in range(n_ops):
        op = rng.integers(0, 6)
        if op == 0:
            n = int(rng.integers(1, top + 1))
            trace.append(("bucket_for", n, cache.bucket_for(n)))
        elif op == 1:
            n = int(rng.integers(0, 3 * top + 2))
            trace.append(("chunks", n, cache.chunks(n)))
        elif op == 2:
            qs = [f"q{k}" for k in range(int(rng.integers(1, top + 1)))]
            trace.append(("pad", len(qs), cache.pad(qs)))
        elif op == 3:
            b = int(rng.choice(cache.buckets))
            trace.append(("note_dispatch", b, cache.note_dispatch(b)))
        elif op == 4:
            warmed = sorted({int(b) for b in rng.choice(
                cache.buckets, int(rng.integers(0, len(cache.buckets) + 1)))})
            trace.append(("install", warmed, cache.install(warmed)))
        else:
            qs = [f"q{k}" for k in range(int(rng.integers(1, 3 * top + 2)))]
            seen, hooks = [], []
            out = mod.dispatch_bucketed(
                cache, qs, lambda b: (seen.append(list(b)),
                                      [q + "!" for q in b])[1],
                on_dispatch=lambda *a: hooks.append(a))
            trace.append(("dispatch_bucketed", qs, out, seen, hooks))
        trace.append(("state", cache.to_dict(), sorted(cache.warmed)))
    return trace


@pytest.mark.parametrize("ladder", LADDERS, ids=str)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_answers_as_the_reference(ladder, seed):
    assert run_sequence(port, ladder, seed) == run_sequence(ref, ladder, seed)


@pytest.mark.parametrize("raw", [
    "", "8,1,4", "2,zap", "0,2", " 1 , 16 ,4 ", "-3", ",,", "32"])
def test_ladder_from_env(monkeypatch, raw):
    monkeypatch.setenv("PIO_TPU_BATCH_BUCKETS", raw)
    assert port.buckets_from_env() == ref.buckets_from_env()
    assert port.DEFAULT_BUCKETS == ref.DEFAULT_BUCKETS


def test_bad_ladder_raises_in_both():
    for mod in (port, ref):
        with pytest.raises(ValueError, match=">= 1"):
            mod.BucketExecutionCache(buckets=(0, 2))


@pytest.mark.cuda
def test_bucketed_bags_on_the_card_equal_the_cpu():
    """The text model's forward (the embedding-bag kernel on the card)
    through the ladder: each real row equals its CPU twin's within 1e-5,
    and padded rows change nothing."""
    import torch

    from pio_tpu_torch.models.mlp import MLPModel

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(0)
    V, H, C, L = 257, 16, 5, 12
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((V, H), (H,), (H, C), (C,))]
    models = [MLPModel(*arrays, device=d) for d in ("cuda", "cpu")]
    bags = [(rng.integers(0, V, (1, L)).astype(np.int32),
             rng.random((1, L), dtype=np.float32)) for _ in range(11)]

    def run(model):
        return lambda qs: list(model.predict_proba(
            np.concatenate([b[0] for b in qs]),
            np.concatenate([b[1] for b in qs])))

    for n in (1, 3, 5, 11):
        outs = [port.dispatch_bucketed(port.BucketExecutionCache(), bags[:n],
                                       run(m))[0] for m in models]
        np.testing.assert_allclose(np.stack(outs[0]), np.stack(outs[1]),
                                   atol=1e-5)
