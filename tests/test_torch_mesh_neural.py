"""The port's two-tower and sequence trainers over the data, model and
pipe axes, and their templates under a process group, on the CPU.

The port runs in gloo process groups of 2 and 4 CPU ranks
(``tests/torch_ranks.py``: every check of the file in one spawn a world
size); the JAX package on meshes of 2 and 4 of the host devices that
``tests/conftest.py`` forces. Both sides start from the reference's
``jax.random`` init at the padded sizes. Tolerances, stated per check:

- two-tower over data 2, model 2 and data 2 × model 2, 12 Adam steps: the
  vector tables within ``1e-4`` of the reference's run on the same mesh
  (``test_torch_two_tower``'s trainer tolerance);
- the sequence model over data 2 and pipe 2, 3 Adam steps: the
  parameters within ``1e-4`` of the reference's on the same mesh
  (``test_torch_seqrec``'s); over model 2 within ``1e-4`` of the
  reference's single-device run and of its model-2 run;
- one step's gradients over model 2, data 2 × model 2 and model 2 ×
  pipe 2 against the port's single-device gradients: ``1e-5`` (f32 sums
  split over ranks);
- the reference's own model axis: its one-step gradients over model 2
  within ``1e-6`` of its single-device ones, and after one Adam step at
  lr 1e-2 every parameter whose gradient is above ``1e-6`` within
  ``1e-5`` (Adam's first step moves an element by about ``lr·sign(g)``,
  so an element whose gradient is rounding noise can move either way);
- two-tower over data 2 stopped after 8 steps and resumed from each
  rank's snapshot: the uninterrupted run's bits;
- two-tower and the sequence model over data 2 with the streamed epoch
  feed (``stream="on"``, spans of one batch): the staged 2-rank run's
  bits, within ``1e-4`` of the reference's streamed run on a mesh of 2,
  each rank shipping half of every span;
- every rank holds the same bits.

The templates: ``run_train`` of two-tower (``model_parallel`` 2) and the
sequence model (``seq_parallel`` 2) in a 2-rank group on SQLite warns
about neither, and with ``PIO_TPU_SHARDED_PERSIST=1`` the models persist
as two shards each and restore to the bits of the run persisted whole.

The entity counts (13 users, 11 items), the batch (31) and the rows (7)
are no world multiple, so the padding is exercised.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pio_tpu.models import seqrec as RS
from pio_tpu.models import two_tower as RT
from pio_tpu.parallel.compat import shard_map
from pio_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from pio_tpu.parallel.mesh import build_mesh
from pio_tpu_torch.models import seqrec as S
from pio_tpu_torch.models.adam import leaves, rebuild
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.workflow import shard_store
from pio_tpu_torch.workflow.core_workflow import load_models_for_instance
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict

sys.path.insert(0, os.path.dirname(__file__))
from torch_ranks import run_groups  # noqa: E402
from test_torch_recommendation import _seed_port  # noqa: E402

U, I, N_PAIRS = 13, 11, 300
TT_KW = dict(embed_dim=8, hidden=16, out_dim=8)
TT_CFG = dict(TT_KW, steps=12, batch_size=31, seed=3)
TT_RUNS = {"data2": (2, dict(data=2)), "model2": (2, dict(data=1, model=2)),
           "data2-model2": (4, dict(data=2, model=2))}
SEQ_KW = dict(d_model=16, n_heads=2, n_layers=2, ffn=32, max_len=8)
SEQ_RUNS = {  # name: (world, mesh spec, config)
    "data2": (2, dict(data=2), dict(batch_size=3)),
    "pipe2": (2, dict(data=1, pipe=2), dict(batch_size=4)),
    "model2": (2, dict(data=1, model=2), dict()),
}
GRAD_RUNS = {"model2": (2, dict(data=1, model=2)),
             "data2-model2": (4, dict(data=2, model=2)),
             "model2-pipe2": (4, dict(data=1, model=2, pipe=2))}
#: spans of one batch (31 pairs x 8 B; 3 rows x 8 positions x 12 B)
STREAM_ENV = {"PIO_TPU_TRAIN_STREAM_MB": "0.0002"}
APP = "rec-test"
TT_VARIANT = {
    "id": "tt-group", "engineFactory": "templates.twotower",
    "datasource": {"params": {"app_name": APP}},
    "algorithms": [{"name": "twotower", "params": {
        **TT_KW, "steps": 6, "batch_size": 16, "seed": 1,
        "model_parallel": 2}}],
}
SEQ_VARIANT = {
    "id": "seq-group", "engineFactory": "templates.sequence",
    "datasource": {"params": {"app_name": APP}},
    "algorithms": [{"name": "seqrec", "params": {
        **SEQ_KW, "steps": 4, "seed": 2, "seq_parallel": 2}}],
}


def _pairs():
    rng = np.random.default_rng(0)
    return (rng.integers(0, U, N_PAIRS).astype(np.int32),
            rng.integers(0, I, N_PAIRS).astype(np.int32))


def _tt_init(n_model):
    """The reference's towers at the vocabularies padded to the model
    axis (two_tower.py l.368-369, l.241-246)."""
    cfg = RT.TwoTowerConfig(**TT_KW)
    vu, vi = -(-U // n_model) * n_model, -(-I // n_model) * n_model
    ku, ki = jax.random.split(jax.random.PRNGKey(TT_CFG["seed"]))
    return jax.tree.map(np.asarray, {"user": RT._init_tower(ku, vu, cfg),
                                     "item": RT._init_tower(ki, vi, cfg)})


def _seqs(seed=1, n=7, t=10, n_items=5):
    rng = np.random.default_rng(seed)
    seqs = np.zeros((n, t), np.int32)
    for r in range(n):
        k = rng.integers(2, t + 1)
        seqs[r, :k] = rng.integers(1, n_items + 1, k)
    return seqs


def _seq_cfg(extra, **kw):
    return dict(SEQ_KW, steps=3, **extra, **kw)


def _seq_init():
    # n_items 5: the vocabulary (6) divides by the model axis, so every
    # mesh draws the single-device init
    return jax.tree.map(np.array,
                        RS.init_params(6, RS.SeqRecConfig(**SEQ_KW)))


def _grad_batch():
    """A full batch at a shape every mesh splits evenly (8 rows, 8
    positions): histories, next-item targets, mask."""
    seqs = _seqs(n=8, t=8)
    targets = np.zeros_like(seqs)
    targets[:, :-1] = seqs[:, 1:]
    return seqs, targets, ((targets > 0) & (seqs > 0)).astype(np.float32)


def _tasks(world, checkpoints):
    u, i = _pairs()
    tasks = []
    for _, (w, spec) in TT_RUNS.items():
        if w == world:
            tasks.append(("torch_ranks:twotower_task", dict(
                spec=spec, u=u, i=i, U=U, I=I, cfg=TT_CFG,
                init=_tt_init(spec.get("model", 1)))))
    for _, (w, spec, extra) in SEQ_RUNS.items():
        if w == world:
            tasks.append(("torch_ranks:seqrec_task", dict(
                spec=spec, seqs=_seqs(), n_items=5, cfg=_seq_cfg(extra),
                init=_seq_init())))
    seqs, targets, mask = _grad_batch()
    for _, (w, spec) in GRAD_RUNS.items():
        if w == world:
            tasks.append(("torch_ranks:seqrec_grad_task", dict(
                spec=spec, cfg=SEQ_KW, init=_seq_init(), seqs=seqs,
                targets=targets, mask=mask)))
    if world == 2:
        tasks += [("torch_ranks:template_task", TT_VARIANT),
                  ("torch_ranks:template_task", SEQ_VARIANT)]
        # stopped after 8 steps, then run to 12 from the newest snapshot
        for steps in (8, 12):
            tasks.append(("torch_ranks:twotower_task", dict(
                spec=dict(data=2), u=u, i=i, U=U, I=I,
                cfg=dict(TT_CFG, steps=steps), init=_tt_init(1),
                checkpoint=str(checkpoints), every=4)))
        # the streamed feed over the data axis (its env stays set in the
        # rank, so these run last)
        tasks += [
            ("torch_ranks:twotower_task", dict(
                spec=dict(data=2), u=u, i=i, U=U, I=I,
                cfg=dict(TT_CFG, stream="on"), init=_tt_init(1),
                env=STREAM_ENV, stats=True)),
            ("torch_ranks:seqrec_task", dict(
                spec=dict(data=2), seqs=_seqs(), n_items=5,
                cfg=_seq_cfg(SEQ_RUNS["data2"][2], stream="on"),
                init=_seq_init(), env=STREAM_ENV, stats=True)),
        ]
    return tasks


def _slot(world, kind, name):
    """Where a run's result sits in a rank's list (the order of
    :func:`_tasks`)."""
    names = [("tt", n) for n, v in TT_RUNS.items() if v[0] == world]
    names += [("seq", n) for n, v in SEQ_RUNS.items() if v[0] == world]
    names += [("grad", n) for n, v in GRAD_RUNS.items() if v[0] == world]
    names += [("template", "tt"), ("template", "seq"), ("resume", 8),
              ("resume", 12), ("stream", "tt"),
              ("stream", "seq")] if world == 2 else []
    return names.index((kind, name))


@pytest.fixture(scope="module")
def sqlite_home(tmp_path_factory):
    """The recommendation fixture's events in SQLite under a home the
    ranks share."""
    mp = pytest.MonkeyPatch()
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        mp.delenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", raising=False)
    home = tmp_path_factory.mktemp("neural-group-home")
    mp.setenv("PIO_TPU_HOME", str(home))
    Storage.reset()
    _seed_port(APP)
    yield home
    Storage.reset()
    mp.undo()


@pytest.fixture(scope="module")
def ranks(sqlite_home, tmp_path_factory):
    """Every rank's results at world sizes 2 and 4 (both groups run at
    once)."""
    env = {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": None
           for r in ("METADATA", "EVENTDATA", "MODELDATA")}
    env.update(PIO_TPU_HOME=str(sqlite_home))
    checkpoints = tmp_path_factory.mktemp("tt-checkpoints")
    return run_groups({world: _tasks(world, checkpoints)
                       for world in (2, 4)}, env=env)


def _jax_mesh(spec, n):
    return build_mesh(JaxMeshSpec(**spec), devices=jax.devices()[:n])


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v.detach().cpu().numpy() \
                if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _same_on_every_rank(ranks, world, slot):
    first = ranks[world][0][slot]
    for rank in ranks[world][1:]:
        got = rank[slot]
        if isinstance(first, dict):
            for k in first:
                np.testing.assert_array_equal(got[k], first[k], err_msg=k)
        else:
            for a, b in zip(got, first):
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- two-tower
@pytest.mark.parametrize("run", list(TT_RUNS))
def test_two_tower_matches_reference_mesh(ranks, run):
    world, spec = TT_RUNS[run]
    u, i = _pairs()
    want = RT.train_two_tower(_jax_mesh(spec, world), u, i, U, I,
                              RT.TwoTowerConfig(**TT_CFG))
    slot = _slot(world, "tt", run)
    got_u, got_i = ranks[world][0][slot]
    assert got_u.shape == (U, 8) and got_i.shape == (I, 8)
    np.testing.assert_allclose(got_u, want.user_vectors, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_i, want.item_vectors, rtol=0, atol=1e-4)
    _same_on_every_rank(ranks, world, slot)


def test_two_tower_resumes_each_ranks_snapshot(ranks):
    """Over data 2 with a snapshot every 4 steps, each rank under its own
    ``rank<r>`` directory: a run stopped after 8 steps and resumed to 12
    gives the uninterrupted 12 steps' bits."""
    whole = ranks[2][0][_slot(2, "tt", "data2")]
    resumed = ranks[2][0][_slot(2, "resume", 12)]
    for a, b in zip(resumed, whole):
        np.testing.assert_array_equal(a, b)
    _same_on_every_rank(ranks, 2, _slot(2, "resume", 12))


@pytest.mark.parametrize("kind", ["tt", "seq"])
def test_streamed_over_the_data_axis(ranks, monkeypatch, kind):
    """2 gloo ranks over data 2 streamed: the staged 2-rank run's bits;
    within 1e-4 of the reference's streamed run on a JAX mesh of 2; each
    rank ships its own half of every batch."""
    for k, v in STREAM_ENV.items():
        monkeypatch.setenv(k, v)
    mesh = _jax_mesh(dict(data=2), 2)
    slot = _slot(2, "stream", kind)
    if kind == "tt":
        staged = ranks[2][0][_slot(2, "tt", "data2")]
        u, i = _pairs()
        ref_stats = {}
        want = RT.train_two_tower(
            mesh, u, i, U, I, RT.TwoTowerConfig(**TT_CFG, stream="on"),
            stats=ref_stats)
        got_u, got_i, stats = ranks[2][0][slot]
        for a, b in zip((got_u, got_i), staged):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got_u, want.user_vectors, rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got_i, want.item_vectors, rtol=0,
                                   atol=1e-4)
        # 12 steps of 32 rows (31 padded to the data axis), 8 B a row
        assert stats["h2d_bytes"] == 12 * 16 * 8
    else:
        staged = ranks[2][0][_slot(2, "seq", "data2")]
        ref_stats = {}
        want = _flat(RS.train_seqrec(mesh, _seqs(), 5, RS.SeqRecConfig(
            **_seq_cfg(SEQ_RUNS["data2"][2], stream="on")),
            stats=ref_stats).params)
        got, stats = ranks[2][0][slot]
        for k in want:
            np.testing.assert_array_equal(got[k], staged[k], err_msg=k)
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                       err_msg=k)
        # 3 steps of 4 rows (3 padded) x 8 positions, 12 B a position
        assert stats["h2d_bytes"] == 3 * 2 * 8 * 12
    assert stats["n_stream"] == ref_stats["n_stream"] >= 2
    # the reference ships each span replicated; each rank here its half
    assert 2 * stats["h2d_bytes"] == ref_stats["h2d_bytes"]
    other = ranks[2][1][slot]
    for a, b in zip(other[:-1], ranks[2][0][slot][:-1]):
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- the sequence
@pytest.mark.parametrize("run", list(SEQ_RUNS))
def test_seqrec_matches_reference_mesh(ranks, run):
    world, spec, extra = SEQ_RUNS[run]
    want = _flat(RS.train_seqrec(_jax_mesh(spec, world), _seqs(), 5,
                                 RS.SeqRecConfig(**_seq_cfg(extra))).params)
    slot = _slot(world, "seq", run)
    got = ranks[world][0][slot]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    _same_on_every_rank(ranks, world, slot)


def test_seqrec_model_axis_matches_reference_single_device(ranks):
    """The port's tensor-parallel run follows the single-device
    semantics: within 1e-4 of the reference's run without a mesh."""
    _, _, extra = SEQ_RUNS["model2"]
    want = _flat(RS.train_seqrec(None, _seqs(), 5,
                                 RS.SeqRecConfig(**_seq_cfg(extra))).params)
    got = ranks[2][0][_slot(2, "seq", "model2")]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("run", list(GRAD_RUNS))
def test_one_step_gradients_match_single_device(ranks, run):
    world, _ = GRAD_RUNS[run]
    init = jax.tree.map(torch.from_numpy, _seq_init())
    p = [t.requires_grad_(True) for t in leaves(init)]
    batch = [torch.from_numpy(a) for a in _grad_batch()]
    loss = S._loss(rebuild(init, p), *batch, S.SeqRecConfig(**SEQ_KW))
    want = _flat(rebuild(init, torch.autograd.grad(loss, p)))
    loss = loss.detach()
    for rank in ranks[world]:
        got_loss, got = rank[_slot(world, "grad", run)]
        assert got_loss == pytest.approx(loss.item(), abs=1e-6)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)


def test_reference_model_axis_gradients_match_its_single_device_run():
    """The reference's own tensor-parallel gradients (``jax.grad`` through
    its ``shard_map`` at model 2) equal its single-device ones; what
    moves its parameters apart after an Adam step is only elements whose
    gradient is rounding noise."""
    cfg = RS.SeqRecConfig(**SEQ_KW)
    params = jax.tree.map(jnp.asarray, _seq_init())
    seqs, targets, mask = _grad_batch()
    mesh = _jax_mesh(dict(data=1, model=2), 2)

    def loss_none(p):
        h = RS._trunk(p, seqs, cfg, None, None, None)
        ce, d = RS._vocab_parallel_ce(h, p["emb"], targets, mask, None)
        return ce / jnp.maximum(d, 1.0)

    def inner(p, s, t, m):
        h = RS._trunk(p, s, cfg, "model", "seq", None)
        ce, d = RS._vocab_parallel_ce(h, p["emb"], t, m, "model")
        ce = jax.lax.psum(ce, ("data", "seq"))
        d = jax.lax.psum(d, ("data", "seq"))
        return ce / jnp.maximum(d, 1.0)

    def loss_mesh(p):
        ds = P("data", "seq")
        return shard_map(inner, mesh=mesh,
                         in_specs=(RS.param_specs(cfg), ds, ds, ds),
                         out_specs=P(), check_vma=False)(
            p, seqs, targets, mask)

    g0 = _flat(jax.grad(loss_none)(params))
    g1 = _flat(jax.grad(loss_mesh)(params))
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    step = dict(SEQ_KW, steps=1, learning_rate=1e-2)
    one = _flat(RS.train_seqrec(None, seqs, 5,
                                RS.SeqRecConfig(**step)).params)
    two = _flat(RS.train_seqrec(mesh, seqs, 5,
                                RS.SeqRecConfig(**step)).params)
    for k in g0:
        clear = np.abs(g0[k]) > 1e-6
        np.testing.assert_allclose(two[k][clear], one[k][clear], rtol=0,
                                   atol=1e-5, err_msg=k)


# ----------------------------------------------------------- the templates
@pytest.mark.parametrize("variant", [TT_VARIANT, SEQ_VARIANT],
                         ids=["twotower", "sequence"])
def test_run_train_in_a_group_splits_and_persists_sharded(ranks, variant):
    kind = "tt" if variant is TT_VARIANT else "seq"
    runs = [r[_slot(2, "template", kind)] for r in ranks[2]]
    # both ranks return the coordinator's instances; neither warns
    assert runs[0]["iids"] == runs[1]["iids"]
    name = variant["algorithms"][0]["name"]
    for r in runs:
        assert not [w for w in r["warnings"] if name in w], r["warnings"]
    whole, sharded = runs[0]["iids"]
    Storage.reset()
    store = Storage.get_model_data_models()
    manifest = shard_store.read_manifest(store, sharded)
    assert manifest["n_shards"] == 2
    n_arrays = 2 if kind == "tt" else 16
    assert shard_store.verify_manifest(store, sharded) == 2 * n_arrays
    engine, ep = build_engine(variant_from_dict(variant))
    ctx = ComputeContext.local(device="cpu")
    (a,) = load_models_for_instance(whole, engine, ep, ctx)
    (b,) = load_models_for_instance(sharded, engine, ep, ctx)
    fa = {k: v.numpy() for k, v in a.shard_arrays().items()}
    fb = {k: v.numpy() for k, v in b.shard_arrays().items()}
    assert fa.keys() == fb.keys() and len(fa) == n_arrays
    for k in fa:
        np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)
