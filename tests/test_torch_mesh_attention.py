"""The port's parallel pieces and the sequence model over the seq axis,
against the JAX package's meshes, on the CPU.

The port runs in gloo process groups of 2 and 4 CPU ranks
(``tests/torch_ranks.py``: every check of the file in one spawn a world
size); the JAX package on meshes of 2 and 4 of the host devices that
``tests/conftest.py`` forces. Tolerances, stated per check:

- the pieces (``vocab_parallel_lookup``, ``vocab_parallel_target_gather``,
  ring and all-to-all attention, ``pipeline_apply``): the forward within
  ``1e-5`` of the reference's ``shard_map`` call; the gradients of
  ``Σ <output, cotangent>`` within ``1e-5`` of ``jax.vjp`` of the
  reference's ``axis=None`` function on the whole arrays, sliced to each
  rank (not of its ``shard_map``: its collectives' transposes under
  ``check_vma=False`` are what the port's differentiable collectives
  replace);
- ``train_seqrec`` over seq 2 (ring and ulysses), data 2 × seq 2 and
  seq 2 × pipe 2, 3 Adam steps: the parameters within ``1e-4`` of the
  reference's run on the same mesh (``test_torch_seqrec``'s trainer
  tolerance), and every rank holds the same bits.

The rows (7) are no multiple of the data axis and one run's history
length (7) is none of the seq axis, so the reference's padding is
exercised. A group of one is ``tests/test_torch_seqrec.py``'s.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pio_tpu.models import seqrec as R
from pio_tpu.parallel import pipeline as JP
from pio_tpu.parallel import ring as JR
from pio_tpu.parallel import ulysses as JU
from pio_tpu.parallel import vocab as JV
from pio_tpu.parallel.compat import shard_map
from pio_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from pio_tpu.parallel.mesh import build_mesh

sys.path.insert(0, os.path.dirname(__file__))
from torch_ranks import run_groups  # noqa: E402
from pio_tpu_torch.parallel.pipeline import stage_slice  # noqa: E402

WORLDS = (2, 4)
AXIS = {"lookup": "model", "target": "model", "ring": "seq",
        "ulysses": "seq", "pipeline": "pipe"}
# the dim each input is sliced on over the axis (None: replicated)
INPUT_DIMS = {"lookup": [0], "target": [-1], "ring": [1, 1, 1],
              "ulysses": [1, 1, 1], "pipeline": [0, 0, None]}
OUT_DIM = {"lookup": None, "target": None, "ring": 1, "ulysses": 1,
           "pipeline": None}
KW = dict(d_model=16, n_heads=4, n_layers=2, ffn=32, max_len=8)
SEQ_RUNS = {  # name: (world, mesh spec, history length, config)
    "seq2-ring": (2, dict(data=1, seq=2), 7, dict(attention="ring")),
    "seq2-ulysses": (2, dict(data=1, seq=2), 10,
                     dict(attention="ulysses", batch_size=3)),
    "data2-seq2": (4, dict(data=2, seq=2), 10, dict(batch_size=3)),
    "seq2-pipe2": (4, dict(data=1, seq=2, pipe=2), 10, dict()),
}


def _cases(seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {
        "lookup": dict(table=f(12, 3),
                       ids=rng.integers(0, 12, (2, 5)).astype(np.int64),
                       cot=f(2, 5, 3)),
        "target": dict(logits=f(2, 5, 12),
                       targets=rng.integers(0, 12, (2, 5)).astype(np.int64),
                       cot=f(2, 5)),
        "ring": dict(q=f(2, 8, 4, 3), k=f(2, 8, 4, 3), v=f(2, 8, 4, 3),
                     cot=f(2, 8, 4, 3), causal=True),
        "ulysses": dict(q=f(2, 8, 4, 3), k=f(2, 8, 4, 3), v=f(2, 8, 4, 3),
                        cot=f(2, 8, 4, 3), causal=True),
        "pipeline": dict(w=f(4, 3, 3) * 0.5, b=f(4, 3), x=f(3, 2, 3),
                         cot=f(3, 2, 3)),
    }


def _seqs(t, seed=1, n=7, n_items=5):
    rng = np.random.default_rng(seed)
    seqs = np.zeros((n, t), np.int32)
    for r in range(n):
        k = rng.integers(2, t + 1)
        seqs[r, :k] = rng.integers(1, n_items + 1, k)
    return seqs


def _seq_cfg(extra):
    return dict(KW, steps=3, **extra)


def _ref_init():
    return jax.tree.map(np.asarray, R.init_params(6, R.SeqRecConfig(**KW)))


def _tasks(world):
    cases = _cases()
    tasks = [("torch_ranks:pieces_task",
              dict(spec={"data": 1, AXIS[name]: world}, axis=AXIS[name],
                   cases={name: cases[name]}))
             for name in AXIS]
    for name, (w, spec, t, extra) in SEQ_RUNS.items():
        if w == world:
            tasks.append(("torch_ranks:seqrec_task", dict(
                spec=spec, seqs=_seqs(t), n_items=5, cfg=_seq_cfg(extra),
                init=_ref_init())))
    return tasks


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results at world sizes 2 and 4 (both groups run at
    once)."""
    return run_groups({world: _tasks(world) for world in WORLDS})


def _jax_mesh(spec, n):
    return build_mesh(JaxMeshSpec(**spec), devices=jax.devices()[:n])


def _stage(p, x):
    for layer in range(p["w"].shape[0]):
        x = jnp.tanh(x @ p["w"][layer] + p["b"][layer])
    return x


def _reference_forward(name, c, n):
    """The reference's piece under ``shard_map`` over an axis of ``n``."""
    mesh = _jax_mesh({"data": 1, AXIS[name]: n}, n)
    if name == "ring":
        return JR.ring_attention_sharded(mesh, c["q"], c["k"], c["v"])
    if name == "ulysses":
        return JU.ulysses_attention_sharded(mesh, c["q"], c["k"], c["v"])
    if name == "lookup":
        fn = lambda t, i: JV.vocab_parallel_lookup(t, i, "model")  # noqa
        specs, args = (P("model", None), P()), (c["table"], c["ids"])
    elif name == "target":
        fn = lambda lg, tg: JV.vocab_parallel_target_gather(  # noqa
            lg, tg, "model")
        specs, args = (P(None, None, "model"), P()), (c["logits"],
                                                      c["targets"])
    else:
        fn = lambda w, b, x: JP.pipeline_apply(  # noqa
            {"w": w, "b": b}, x, _stage, axis="pipe")
        specs, args = (P("pipe"), P("pipe"), P()), (c["w"], c["b"], c["x"])
    return shard_map(fn, mesh=mesh, in_specs=specs, out_specs=P(),
                     check_vma=False)(*args)


def _reference_vjp(name, c):
    """The reference's ``axis=None`` piece on the whole arrays: its output
    and the vjp of the cotangent."""
    if name in ("ring", "ulysses"):
        mod = JR.ring_attention if name == "ring" else JU.ulysses_attention
        fn = lambda q, k, v: mod(q, k, v, axis=None)  # noqa: E731
        args = [c[k] for k in "qkv"]
    elif name == "lookup":
        fn = lambda t: JV.vocab_parallel_lookup(t, c["ids"], None)  # noqa
        args = [c["table"]]
    elif name == "target":
        fn = lambda lg: JV.vocab_parallel_target_gather(  # noqa: E731
            lg, c["targets"], None)
        args = [c["logits"]]
    else:
        fn = lambda w, b, x: jax.vmap(  # noqa: E731
            lambda xm: _stage({"w": w, "b": b}, xm))(x)
        args = [c["w"], c["b"], c["x"]]
    out, vjp = jax.vjp(fn, *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(c["cot"]))]


def _slice(a, dim, n, r):
    return a if dim is None else np.split(a, n, dim)[r]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(AXIS))
def test_piece_forward_matches_reference_shard_map(ranks, name, world):
    c = _cases()[name]
    want = np.asarray(_reference_forward(name, c, world))
    slot = list(AXIS).index(name)
    for r in range(world):
        out, _ = ranks[world][r][slot][name]
        np.testing.assert_allclose(
            out, _slice(want, OUT_DIM[name], world, r), rtol=0, atol=1e-5,
            err_msg=f"rank {r}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(AXIS))
def test_piece_gradients_match_reference_whole_arrays(ranks, name, world):
    c = _cases()[name]
    _, want = _reference_vjp(name, c)
    slot = list(AXIS).index(name)
    for r in range(world):
        _, grads = ranks[world][r][slot][name]
        assert len(grads) == len(want)
        for k, (g, w, dim) in enumerate(zip(grads, want, INPUT_DIMS[name])):
            np.testing.assert_allclose(
                g, _slice(w, dim, world, r), rtol=0, atol=1e-5,
                err_msg=f"rank {r} input {k}")


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("run", list(SEQ_RUNS))
def test_seqrec_over_seq_matches_reference_mesh(ranks, run):
    world, spec, t, extra = SEQ_RUNS[run]
    want = _flat(R.train_seqrec(_jax_mesh(spec, world), _seqs(t), 5,
                                R.SeqRecConfig(**_seq_cfg(extra))).params)
    slot = len(AXIS) + [n for n, v in SEQ_RUNS.items()
                        if v[0] == world].index(run)
    got = ranks[world][0][slot]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    for rank in ranks[world][1:]:
        for k in got:
            np.testing.assert_array_equal(rank[slot][k], got[k], err_msg=k)


def test_stage_slice_matches_reference():
    """A stacked tree's one-stage block without its stage dim."""
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(1, 2, 3)).astype(np.float32),
            "blk": {"b": rng.normal(size=(1, 4)).astype(np.float32)}}
    want = JP.stage_slice(jax.tree.map(jnp.asarray, tree))
    got = stage_slice({"w": torch.from_numpy(tree["w"]),
                       "blk": {"b": torch.from_numpy(tree["blk"]["b"])}})
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["blk"]["b"].numpy(),
                                  np.asarray(want["blk"]["b"]))
