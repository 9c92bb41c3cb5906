"""Text-classification training in the port against the JAX package's, on
the CPU.

The same seeded numpy bags go through the JAX package's ``train_mlp`` and
the port's ``_fit`` from the same initial parameters (the reference's init,
rebuilt here from ``jax.random.PRNGKey``), and through both packages'
``train_multinomial_nb_bags``. Then both packages run the template end to
end on the same ``$set`` events in memory storage — ``run_train`` →
``load_models_for_instance`` → serve — and give the same answers. On the
CPU the port's embedding bag and its backward run their plain versions.
"""

import pickletools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pio_tpu.templates  # noqa: F401  (registers the JAX engine factories)
from pio_tpu.models.mlp import MLPConfig as JaxMLPConfig
from pio_tpu.models.mlp import train_mlp as jax_train_mlp
from pio_tpu.models.naive_bayes import train_multinomial_nb_bags as jax_train_nb
from pio_tpu.obs import monotonic_s
from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.storage import App as JaxApp
from pio_tpu.storage import Storage as JaxStorage
from pio_tpu.data import Event as JaxEvent
from pio_tpu.templates.textclassification import Query as JaxQuery
from pio_tpu.workflow import build_engine as jax_build_engine
from pio_tpu.workflow import load_models_for_instance as jax_load_models
from pio_tpu.workflow import run_train as jax_run_train
from pio_tpu.workflow import variant_from_dict as jax_variant_from_dict
from pio_tpu_torch.controller.params import ParamsError, params_to_json
from pio_tpu_torch.data.event import Event
from pio_tpu_torch.models import mlp as tmlp
from pio_tpu_torch.models.naive_bayes import train_multinomial_nb_bags
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.records import App, RunStatus
from pio_tpu_torch.storage.localfs import LocalFSModels
from pio_tpu_torch.storage.registry import Storage, StorageConfigError
from pio_tpu_torch.storage.sqlite import SQLiteApps, SQLiteEvents
from pio_tpu_torch.templates.textclassification import Query
from pio_tpu_torch.workflow import core_workflow
from pio_tpu_torch.workflow.core_workflow import (
    deserialize_models,
    load_models_for_instance,
    run_train,
    serialize_models,
)
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict
from pio_tpu_torch.workflow.params import WorkflowParams

V, H, C, N, L = 60, 16, 3, 48, 8


def _bags(seed=0):
    """Seeded bags with repeated ids and padding slots (weight 0, id 0)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, V, size=(N, L), dtype=np.int32)
    w = rng.random((N, L), dtype=np.float32) + 0.05
    n_live = rng.integers(2, L + 1, size=N)
    pad = np.arange(L)[None, :] >= n_live[:, None]
    ids[pad], w[pad] = 0, 0.0
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    y = rng.integers(0, C, size=N).astype(np.int32)
    return ids, w, y


def _reference_init(seed, V=V, H=H, C=C):
    """The reference's init (pio_tpu/models/mlp.py:146-154), as numpy."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {
        "w_in": np.array(jax.random.normal(k1, (V, H), jnp.float32)
                         * (1.0 / np.sqrt(max(V, 1)))),
        "b_in": np.zeros(H, np.float32),
        "w_out": np.array(jax.random.normal(k2, (H, C), jnp.float32)
                          * (1.0 / np.sqrt(H))),
        "b_out": np.zeros(C, np.float32),
    }


def _port_fit(ids, w, y, config, seed=0):
    params0 = {k: torch.from_numpy(v) for k, v in _reference_init(seed).items()}
    fitted, losses = tmlp._fit(
        params0, torch.from_numpy(ids), torch.from_numpy(w),
        torch.from_numpy(y.astype(np.int64)), torch.ones(len(y)), config)
    return {k: v.numpy() for k, v in fitted.items()}, losses.numpy()


def _jax_fit(ids, w, y, config):
    m = jax_train_mlp(JaxContext.local(config.seed), ids, w, y, V, C,
                      JaxMLPConfig(**vars(config)))
    return {"w_in": m.w_in, "b_in": m.b_in, "w_out": m.w_out, "b_out": m.b_out}


def _np_logits(p, ids, w):
    h = np.maximum(np.einsum("bld,bl->bd", p["w_in"][ids], w) + p["b_in"], 0)
    return h @ p["w_out"] + p["b_out"]


def _np_loss(p, ids, w, y):
    z = _np_logits(p, ids, w).astype(np.float64)
    z -= z.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    return float(-logp[np.arange(len(y)), y].mean())


# ------------------------------------------------------------------- _fit
@pytest.mark.parametrize("reg", [0.0, 0.01])
def test_fit_matches_reference_after_five_steps(reg):
    # Adam moves each weight by ~lr·g/(|g| + 1e-8); the f32 gradients of
    # the two packages differ by summation order (~1e-7 relative), so the
    # weights stay within a few 1e-7 where |g| >> 1e-8, but up to
    # lr·|dg|/1e-8 where g is near 0. Measured 3.5e-6; limit 1e-5.
    ids, w, y = _bags(1)
    cfg = tmlp.MLPConfig(hidden=H, iterations=5, learning_rate=0.05, reg=reg)
    got, losses = _port_fit(ids, w, y, cfg)
    want = _jax_fit(ids, w, y, cfg)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)
    assert losses.shape == (5,) and losses[-1] < losses[0]


def test_fit_matches_reference_after_200_steps():
    # 200 steps let the rounding differences grow (weights 3e-4 apart):
    # the final loss agrees to 1e-3 relative (measured 1e-4), and the
    # training-set labels are identical
    ids, w, y = _bags(2)
    cfg = tmlp.MLPConfig(hidden=H, iterations=200, learning_rate=0.05)
    got, losses = _port_fit(ids, w, y, cfg)
    want = _jax_fit(ids, w, y, cfg)
    assert _np_loss(got, ids, w, y) == pytest.approx(
        _np_loss(want, ids, w, y), rel=1e-3)
    np.testing.assert_array_equal(_np_logits(got, ids, w).argmax(1),
                                  _np_logits(want, ids, w).argmax(1))
    # losses[k] is the loss before step k, of the parameters then
    assert losses[0] == pytest.approx(_np_loss(
        {k: v for k, v in _reference_init(0).items()}, ids, w, y), rel=1e-5)


def test_fit_leaves_params0_and_builds_one_plan(monkeypatch):
    ids, w, y = _bags(3)
    params0 = {k: torch.from_numpy(v) for k, v in _reference_init(0).items()}
    before = {k: v.clone() for k, v in params0.items()}
    plans, real = [], tmlp._embedding.bag_plan
    monkeypatch.setattr(tmlp._embedding, "bag_plan",
                        lambda *a: plans.append(a) or real(*a))
    tmlp._fit(params0, torch.from_numpy(ids), torch.from_numpy(w),
              torch.from_numpy(y.astype(np.int64)), torch.ones(N),
              tmlp.MLPConfig(hidden=H, iterations=3))
    assert len(plans) == 1
    assert all(torch.equal(params0[k], before[k]) for k in before)


def test_init_params_scales_and_zero_biases():
    g = ComputeContext.local(0, device="cpu").generator()
    p = tmlp.init_params(4000, 64, 5, g)
    assert p["w_in"].shape == (4000, 64) and p["w_out"].shape == (64, 5)
    assert float(p["w_in"].std()) == pytest.approx(1 / np.sqrt(4000), rel=0.05)
    assert float(p["w_out"].std()) == pytest.approx(1 / 8, rel=0.2)
    assert not p["b_in"].any() and not p["b_out"].any()


def test_train_mlp_is_seeded_and_returns_a_model_on_the_device():
    ids, w, y = _bags(4)
    ctx = ComputeContext.local(0, device="cpu")
    cfg = tmlp.MLPConfig(hidden=H, iterations=4, seed=3)
    a = tmlp.train_mlp(ctx, ids, w, y, V, C, cfg)
    b = tmlp.train_mlp(ctx, ids, w, y, V, C, cfg)
    assert isinstance(a, tmlp.MLPModel) and a.w_in.device.type == "cpu"
    assert torch.equal(a.w_in, b.w_in) and a.n_classes == C


# --------------------------------------------------------------------- NB
@pytest.mark.parametrize("lambda_", [1.0, 0.3])
def test_nb_bags_match_reference(lambda_):
    ids, w, y = _bags(5)
    got = train_multinomial_nb_bags(ids, w, y, V, C, lambda_, device="cpu")
    want = jax_train_nb(ids, w, y, V, C, lambda_)
    np.testing.assert_allclose(got.log_prior, want.log_prior, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.log_theta, want.log_theta, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.scores_bags(ids, w), want.scores_bags(ids, w),
                               rtol=1e-5, atol=1e-5)


def test_nb_rejects_negative_features():
    ids, w, y = _bags(6)
    w[0, 0] = -1.0
    with pytest.raises(ValueError, match="non-negative"):
        train_multinomial_nb_bags(ids, w, y, V, C, device="cpu")


# ------------------------------------------------------------- end to end
DOCS = {
    "sports": [
        "the team won the final match with a late goal",
        "striker scores twice as the league season opens",
        "coach praises the defence after a clean sheet win",
        "fans cheer the home team at the stadium tonight",
        "the match ended in a draw after extra time",
        "player transfers dominate the football league news",
    ],
    "tech": [
        "the new chip doubles matrix multiply throughput",
        "compiler updates speed up the neural network training",
        "a software release adds faster tensor kernels",
        "the datacenter deploys accelerators for machine learning",
        "researchers benchmark the model on new hardware",
        "the framework compiles programs for the accelerator",
    ],
}
QUERIES = [
    ("the team plays a match in the league", "sports"),
    ("the compiler speeds up tensor kernels", "tech"),
    ("fans and the coach at the stadium", "sports"),
    ("new accelerators for the neural network", "tech"),
]
ALGOS = [
    {"name": "mlp", "params": {"hidden": 32, "iterations": 200, "learning_rate": 0.05}},
    {"name": "nb", "params": {"lambda_": 0.5}},
]


@pytest.fixture()
def memory_storage(tmp_home, monkeypatch):
    """Both packages' storage in memory, empty."""
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    Storage.reset()
    JaxStorage.reset()
    yield
    Storage.reset()
    JaxStorage.reset()


def _variant_dict(algo):
    return {
        "id": "text-e2e",
        "engineFactory": "templates.textclassification",
        "datasource": {"params": {"app_name": "text-test"}},
        "algorithms": [algo],
    }


def _events(event_cls):
    return [
        event_cls("$set", "content", f"doc{n}",
                  properties={"text": text, "label": label})
        for n, (label, text) in enumerate(
            (label, t) for label, docs in DOCS.items() for t in docs)
    ]


def _jax_answers(algo):
    app_id = JaxStorage.get_meta_data_apps().insert(JaxApp(0, "text-test"))
    le = JaxStorage.get_levents()
    for e in _events(JaxEvent):
        le.insert(e, app_id)
    v = jax_variant_from_dict(_variant_dict(algo))
    engine, ep = jax_build_engine(v)
    ctx = JaxContext.local(0)
    iid = jax_run_train(engine, ep, v, ctx=ctx)
    pairs = engine.algorithms_with_models(ep, jax_load_models(iid, engine, ep, ctx))
    serving = engine.make_serving(ep)
    return [serving.serve(JaxQuery(text=q), [a.predict(m, JaxQuery(text=q))
                                             for a, m in pairs]) for q, _ in QUERIES]


def _port_train(algo, seed=0, device="cpu"):
    app_id = Storage.get_meta_data_apps().insert(App(0, "text-test"))
    Storage.get_levents().write(_events(Event), app_id)
    v = variant_from_dict(_variant_dict(algo))
    engine, ep = build_engine(v)
    ctx = ComputeContext.create(seed, device=device)
    t0 = monotonic_s()
    iid = run_train(engine, ep, v, ctx=ctx)
    return engine, ep, ctx, iid, monotonic_s() - t0


def _port_answers(engine, ep, ctx, iid):
    pairs = engine.algorithms_with_models(
        ep, load_models_for_instance(iid, engine, ep, ctx))
    serving = engine.make_serving(ep)
    return [serving.serve(Query(text=q), [a.predict(m, Query(text=q))
                                          for a, m in pairs]) for q, _ in QUERIES]


@pytest.mark.parametrize("algo", ALGOS, ids=["mlp", "nb"])
def test_full_lifecycle_answers_like_the_jax_package(memory_storage, monkeypatch, algo):
    # the MLP starts from the reference's init, so both packages train the
    # same model: labels equal, confidences within 1e-4 after 200 steps of
    # f32 rounding in another order; NB is closed-form: 1e-5
    monkeypatch.setattr(tmlp, "init_params", lambda V_, H_, C_, g:
                        {k: torch.from_numpy(a) for k, a in
                         _reference_init(0, V_, H_, C_).items()})
    want = _jax_answers(algo)
    engine, ep, ctx, iid, seconds = _port_train(algo)
    got = _port_answers(engine, ep, ctx, iid)
    tol = 1e-4 if algo["name"] == "mlp" else 1e-5
    for (q, label), g, w_ in zip(QUERIES, got, want):
        assert g.label == w_.label == label, q
        assert g.confidence == pytest.approx(w_.confidence, abs=tol), q
    inst = Storage.get_meta_data_engine_instances().get(iid)
    assert inst.status == RunStatus.COMPLETED
    phases = {k for k in inst.env if k.startswith("phase_")}
    assert phases == {"phase_read", "phase_prepare",
                      f"phase_train:0_{algo['name']}", "phase_persist"}
    # the record keeps milliseconds (f"{train_s:.3f}"): compare at the
    # same rounding, which keeps the order of train_s <= seconds
    assert float(inst.env["train_seconds"]) <= float(f"{seconds:.3f}")


def test_both_algorithms_in_one_run(memory_storage):
    engine, ep, ctx, iid, _ = _port_train({"name": "mlp", "params": {
        "hidden": 16, "iterations": 100, "learning_rate": 0.05}})
    models = load_models_for_instance(iid, engine, ep, ctx)
    assert len(models) == 1
    v = variant_from_dict({**_variant_dict(ALGOS[0]), "algorithms": ALGOS})
    engine, ep = build_engine(v)
    iid = run_train(engine, ep, v, ctx=ctx)
    mlp_model, nb_model = load_models_for_instance(iid, engine, ep, ctx)
    assert type(mlp_model).__name__ == "TextMLPModel"
    assert type(nb_model).__name__ == "TextNBModel"


def test_empty_app_raises_sanity(memory_storage):
    Storage.get_meta_data_apps().insert(App(0, "text-test"))
    v = variant_from_dict(_variant_dict({"name": "nb", "params": {}}))
    engine, ep = build_engine(v)
    with pytest.raises(ValueError, match="empty"):
        run_train(engine, ep, v, ctx=ComputeContext.create(0, device="cpu"))
    (inst,) = Storage.get_meta_data_engine_instances().get_all()
    assert inst.status == RunStatus.FAILED and "empty" in inst.env["error"]


def test_stop_after_prepare_aborts_without_models(memory_storage):
    app_id = Storage.get_meta_data_apps().insert(App(0, "text-test"))
    Storage.get_levents().write(_events(Event), app_id)
    v = variant_from_dict(_variant_dict(ALGOS[1]))
    engine, ep = build_engine(v)
    iid = run_train(engine, ep, v, WorkflowParams(stop_after_prepare=True),
                    ctx=ComputeContext.create(0, device="cpu"))
    assert Storage.get_meta_data_engine_instances().get(iid).status == RunStatus.ABORTED
    assert Storage.get_model_data_models().get(iid) is None


def test_unknown_algorithm_is_a_params_error():
    with pytest.raises(ParamsError, match="unknown algorithm"):
        build_engine(variant_from_dict(_variant_dict({"name": "svm"})))


def test_engine_params_record_as_json(memory_storage):
    _, ep = build_engine(variant_from_dict(_variant_dict(ALGOS[0])))
    assert params_to_json(ep.preparator_params) == (
        '{"max_doc_tokens": 256, "max_features": 65536}')


def test_tampered_blob_fails_its_checksum(memory_storage):
    engine, ep, ctx, iid, _ = _port_train(ALGOS[1])
    store = Storage.get_model_data_models()
    record = store.get(iid)
    store.insert(type(record)(id=iid, models=record.models + b"x"))
    with pytest.raises(RuntimeError, match="checksum"):
        load_models_for_instance(iid, engine, ep, ctx)


# ------------------------------------------------------------ persistence
def _globals(blob: bytes):
    """The (module, name) strings a pickle refers to."""
    return [arg for op, arg, _ in pickletools.genops(blob)
            if op.name in ("SHORT_BINUNICODE", "BINUNICODE", "GLOBAL")
            and isinstance(arg, str)]


def test_blob_holds_host_arrays_only(memory_storage):
    engine, ep, ctx, iid, _ = _port_train({"name": "mlp", "params": {
        "hidden": 8, "iterations": 5}})
    blob = Storage.get_model_data_models().get(iid).models
    names = _globals(blob)
    # no torch storage or tensor rebuild: each tensor went in as numpy
    assert not [n for n in names if n.split(".")[0] == "torch" or "rebuild" in n]
    assert "_tensor_from_host" in names
    (model,) = deserialize_models(blob, "cpu")
    assert model.mlp.w_in.device.type == "cpu"
    assert model.mlp.w_in.dtype == torch.float32


def test_serialize_round_trips_tensors_and_arrays():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    obj = {"t": t, "a": np.ones(3, np.int32), "s": "x"}
    (back,) = deserialize_models(serialize_models([obj]), "cpu")
    assert torch.equal(back["t"], t) and back["t"].device.type == "cpu"
    np.testing.assert_array_equal(back["a"], obj["a"])
    assert back["s"] == "x"


def test_host_pickler_copies_every_tensor_to_the_host(monkeypatch):
    seen = []
    real = core_workflow._to_host
    monkeypatch.setattr(core_workflow, "_to_host",
                        lambda t: seen.append(t.device.type) or real(t))
    model = tmlp.MLPModel(np.ones((4, 2)), np.zeros(2), np.ones((2, 3)),
                          np.zeros(3), device="cpu")
    deserialize_models(serialize_models([model]), "cpu")
    assert sorted(seen) == ["cpu"] * 4


# ----------------------------------------------------------------- storage
@pytest.mark.parametrize("type_", ["searchable", "parquet", "eventlog"])
def test_registry_refuses_backends_not_ported(monkeypatch, tmp_path, type_):
    """No backend of the reference is refused any more: ``partlog``
    builds, beside each of these, with the reference's rules (parquet
    serves the bulk PEvents only)."""
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "DB")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_DB_PATH", str(tmp_path / "pl"))
    Storage.reset()
    try:
        monkeypatch.setenv("PIO_STORAGE_SOURCES_DB_TYPE", "partlog")
        assert type(Storage.get_levents()).__name__ == "PartitionedEventLog"
        Storage.reset()
        monkeypatch.setenv("PIO_STORAGE_SOURCES_DB_PATH",
                           str(tmp_path / ("db" if type_ == "searchable"
                                           else "d")))
        monkeypatch.setenv("PIO_STORAGE_SOURCES_DB_TYPE", type_)
        assert Storage.get_pevents() is not None
        if type_ == "parquet":
            with pytest.raises(StorageConfigError, match="bulk-only"):
                Storage.get_levents()
        else:
            assert Storage.get_levents() is not None
    finally:
        Storage.reset()


def test_registry_unset_defaults_are_sqlite_and_localfs(tmp_home, monkeypatch):
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.delenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE",
                           raising=False)
    Storage.reset()
    try:
        clients = Storage.sqlite_clients()
        assert sorted(clients) == ["EVENTDATA", "METADATA"]
        assert {c.path for c in clients.values()} == {str(tmp_home / "pio.db")}
        assert isinstance(Storage.get_meta_data_apps(), SQLiteApps)
        assert isinstance(Storage.get_levents(), SQLiteEvents)
        models = Storage.get_model_data_models()
        assert isinstance(models, LocalFSModels)
        assert models.root == str(tmp_home / "models")
    finally:
        Storage.reset()


def test_compute_context_create_is_one_device():
    ctx = ComputeContext.create(7, device="cpu")
    assert ctx.num_devices == 1 and ctx.seed == 7
    a = torch.randn(3, generator=ctx.generator())
    b = torch.randn(3, generator=ctx.generator(7))
    c = torch.randn(3, generator=ctx.generator(8))
    assert torch.equal(a, b) and not torch.equal(a, c)


# ------------------------------------------------------------ on the card
@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fit_on_card_matches_the_plain_path(cuda_device):
    # 5 Adam steps through the kernels and through autograd of the plain
    # embedding bag, on the card, from one init: as in the CPU parity test,
    # Adam near g = 0 bounds the difference, limit 1e-5
    from pio_tpu_torch.ops import embedding as temb

    ids, w, y = _bags(7)
    bags = [torch.from_numpy(a).to(cuda_device) for a in (ids, w, y.astype(np.int64))]
    mask = torch.ones(N, device=cuda_device)
    params0 = {k: torch.from_numpy(v).to(cuda_device)
               for k, v in _reference_init(0).items()}
    cfg = tmlp.MLPConfig(hidden=H, iterations=5, learning_rate=0.05)
    before = temb.BACKWARD_TABLE_LAUNCHES
    kern, _ = tmlp._fit(params0, *bags, mask, cfg)
    torch.cuda.synchronize()
    assert temb.BACKWARD_TABLE_LAUNCHES == before + 5
    plain, _ = tmlp._fit(params0, *bags, mask, cfg, bag=lambda t, i, ww, plan:
                         temb.embedding_bag_plain(t, i, ww))
    for k in kern:
        torch.testing.assert_close(kern[k], plain[k], atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ALGOS, ids=["mlp", "nb"])
def test_trained_on_the_card_serves_on_the_cpu(cuda_device, memory_storage, algo):
    # a blob holds host values only: the card's model loads on either
    # device and answers alike (f32 softmax of the same logits, 1e-5)
    engine, ep, ctx, iid, _ = _port_train(algo, device="cuda")
    on_card = _port_answers(engine, ep, ctx, iid)
    on_cpu = _port_answers(engine, ep, ComputeContext.local(0, device="cpu"), iid)
    for (q, label), a, b in zip(QUERIES, on_card, on_cpu):
        assert a.label == b.label == label, q
        assert a.confidence == pytest.approx(b.confidence, abs=1e-5), q
