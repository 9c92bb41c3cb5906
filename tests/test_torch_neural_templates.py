"""The two-tower and sequence templates in the port against the JAX
package's, on the CPU, in memory storage.

The same events go into both packages' stores; both run ``run_train``
(the port from the reference's ``jax.random`` init, carried across with
``convert.py``) and answer the same queries:

- ``predict`` and ``batch_predict``: the same items in the same order,
  scores within 1e-4 (the trainers' parameter tolerance: unit-vector dots
  and O(10) logits after f32 Adam steps in another summation order);
- the sequence template's ``read_eval`` folds: equal;
- the ``pio eval`` sweeps (``twotower_evaluation``,
  ``sequence_evaluation``): the same best params and the same HitRates;
- ``POST /queries.json`` through the port's query server, by user and by
  ``history``, equal to ``predict``; a persisted model loads on the CPU
  and answers as the model that was trained.
"""

import dataclasses
import datetime as dt
import http.client
import json

import jax
import numpy as np
import pytest
import torch

import pio_tpu.templates  # noqa: F401  (registers the JAX engine factories)
from pio_tpu.models import seqrec as R_seq
from pio_tpu.models import two_tower as R_tt
from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.templates import sequence as JS
from pio_tpu.templates import twotower as JT
from pio_tpu.workflow import build_engine as jax_build_engine
from pio_tpu.workflow import load_models_for_instance as jax_load_models
from pio_tpu.workflow import run_evaluation as jax_run_evaluation
from pio_tpu.workflow import run_train as jax_run_train
from pio_tpu.workflow import variant_from_dict as jax_variant_from_dict
from pio_tpu_torch.controller.params import params_from_dict
from pio_tpu_torch.convert import (
    seqrec_params_from_reference,
    twotower_params_from_reference,
)
from pio_tpu_torch.models import seqrec as T_seq
from pio_tpu_torch.models import two_tower as T_tt
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.server.query_server import create_query_server
from pio_tpu_torch.templates import sequence as TS
from pio_tpu_torch.templates import twotower as TT
from pio_tpu_torch.workflow.core_workflow import (
    load_models_for_instance,
    run_evaluation,
    run_train,
)
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict
from test_torch_similarproduct import (  # noqa: F401  (fixture)
    memory_storage,
    seed_events,
)

APP = "neural-app"
T0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
SCORE_TOL = 1e-4


@pytest.fixture()
def reference_init(monkeypatch):
    """Both port trainers start from the reference's draws."""
    def tt_init(vu, vi, cfg, generator):
        rc = R_tt.TwoTowerConfig(embed_dim=cfg.embed_dim, hidden=cfg.hidden,
                                 out_dim=cfg.out_dim)
        ku, ki = jax.random.split(jax.random.PRNGKey(cfg.seed))
        tree = {"user": R_tt._init_tower(ku, vu, rc),
                "item": R_tt._init_tower(ki, vi, rc)}
        return twotower_params_from_reference(jax.tree.map(np.asarray, tree),
                                              "cpu")

    def seq_init(vocab, cfg, generator):
        rc = R_seq.SeqRecConfig(**{f.name: getattr(cfg, f.name)
                                   for f in dataclasses.fields(cfg)})
        tree = jax.tree.map(np.asarray, R_seq.init_params(vocab, rc))
        return seqrec_params_from_reference(tree, "cpu")

    monkeypatch.setattr(T_tt, "init_params", tt_init)
    monkeypatch.setattr(T_seq, "init_params", seq_init)


def rate_rows(n_users=16, n_items=12, per_user=10, seed=0):
    """User u rates items of group u % 3 (four items a group) 5 and one
    random item 1; a few buys."""
    rng = np.random.default_rng(seed)
    rows, k = [], 0
    for u in range(n_users):
        lo = 4 * (u % 3)
        for _ in range(per_user):
            rows.append(("rate", "user", f"u{u}", f"i{lo + rng.integers(4)}",
                         {"rating": 5.0}, T0 + dt.timedelta(minutes=k)))
            k += 1
        rows.append(("rate", "user", f"u{u}", f"i{rng.integers(n_items)}",
                     {"rating": 1.0}, T0 + dt.timedelta(minutes=k)))
        k += 1
    rows += [("buy", "user", f"u{u}", f"i{u % n_items}", {}, T0)
             for u in range(4)]
    return rows


def view_rows(n_users=20, n_items=10, seed=1):
    """Each user walks the items in a cycle (i_k → i_{k+1}) from a random
    start, 4-14 views, with a stray event now and then; in time order."""
    rng = np.random.default_rng(seed)
    rows, k = [], 0
    for u in range(n_users):
        start = int(rng.integers(n_items))
        for j in range(int(rng.integers(4, 15))):
            name = ("view", "buy", "rate")[int(rng.integers(3))]
            item = (start + j) % n_items
            rows.append((name, "user", f"u{u}", f"i{item}",
                         {"rating": 3.0} if name == "rate" else {},
                         T0 + dt.timedelta(minutes=k)))
            k += 1
    rows.append(("like", "user", "u0", "i3", {}, T0))  # not read
    return rows


TT_VARIANT = {
    "id": "tt", "engineFactory": "templates.twotower",
    "datasource": {"params": {"app_name": APP}},
    "algorithms": [{"name": "twotower", "params": {
        "embed_dim": 8, "hidden": 16, "out_dim": 8, "steps": 20,
        "batch_size": 32, "seed": 1}}],
}
SEQ_VARIANT = {
    "id": "seq", "engineFactory": "templates.sequence",
    "datasource": {"params": {"app_name": APP}},
    "algorithms": [{"name": "seqrec", "params": {
        "d_model": 16, "n_heads": 2, "n_layers": 2, "ffn": 32, "max_len": 8,
        "steps": 15, "seed": 2}}],
}


def train_both(variant):
    """(port engine, params, ctx, instance, model), (reference model, engine)."""
    v = variant_from_dict(variant)
    engine, ep = build_engine(v)
    ctx = ComputeContext.local(device="cpu")
    iid = run_train(engine, ep, v, ctx=ctx)
    (model,) = load_models_for_instance(iid, engine, ep, ctx)
    jv = jax_variant_from_dict(variant)
    jengine, jep = jax_build_engine(jv)
    jctx = JaxContext.local()
    jiid = jax_run_train(jengine, jep, jv, ctx=jctx)
    (jmodel,) = jax_load_models(jiid, jengine, jep, jctx)
    return (engine, ep, ctx, iid, model), (jengine, jep, jmodel)


def same_answer(got, want):
    g, w = got.to_dict()["itemScores"], want.to_dict()["itemScores"]
    assert [s["item"] for s in g] == [s["item"] for s in w], (g, w)
    np.testing.assert_allclose([s["score"] for s in g],
                               [s["score"] for s in w], atol=SCORE_TOL)


def answers_match(engine, ep, model, jengine, jep, jmodel, queries, jqueries):
    algo = engine._algorithms(ep)[0]
    jalgo = jengine._algorithms(jep)[0]
    for q, jq in zip(queries, jqueries):
        same_answer(algo.predict(model, q), jalgo.predict(jmodel, jq))
    got = dict(algo.batch_predict(model, list(enumerate(queries))))
    want = dict(jalgo.batch_predict(jmodel, list(enumerate(jqueries))))
    for k in range(len(queries)):
        same_answer(got[k], want[k])
        same_answer(got[k], algo.predict(model, queries[k]))


def serve(engine, ep, models, bodies):
    server = create_query_server(engine, ep, models, host="127.0.0.1", port=0)
    out = []
    with server:
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
        for body in bodies:
            conn.request("POST", "/queries.json", json.dumps(body).encode(),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            out.append((r.status, json.loads(r.read())))
        conn.close()
    return out


# ------------------------------------------------------------ two-tower
def test_twotower_answers_like_the_jax_package(memory_storage, reference_init):
    seed_events(rate_rows(), app=APP)
    (engine, ep, ctx, iid, model), (jengine, jep, jmodel) = \
        train_both(TT_VARIANT)
    assert isinstance(model, TT.TwoTowerEngineModel)
    assert model.model.item_vectors.device.type == "cpu"
    assert model.user_index.to_dict() == jmodel.user_index.to_dict()
    assert model.item_index.to_dict() == jmodel.item_index.to_dict()
    np.testing.assert_allclose(model.model.item_vectors.numpy(),
                               jmodel.model.item_vectors, atol=SCORE_TOL)
    bodies = [dict(user=f"u{u}", num=4) for u in range(0, 16, 3)]
    bodies += [dict(user="u1", num=3, black_list=("i4", "i5")),
               dict(user="u2", item="i9"), dict(user="stranger"),
               dict(user="u3", num=0)]
    answers_match(engine, ep, model, jengine, jep, jmodel,
                  [TT.Query(**b) for b in bodies],
                  [JT.Query(**b) for b in bodies])


def test_twotower_serves_over_http(memory_storage):
    seed_events(rate_rows(), app=APP, reference=False)
    v = variant_from_dict(TT_VARIANT)
    engine, ep = build_engine(v)
    ctx = ComputeContext.local(device="cpu")
    iid = run_train(engine, ep, v, ctx=ctx)
    models = load_models_for_instance(iid, engine, ep, ctx)
    algo = engine._algorithms(ep)[0]
    bodies = [{"user": "u0", "num": 4}, {"user": "u5", "num": 2,
                                         "blackList": ["i4"]},
              {"user": "stranger"}]
    for body, (status, got) in zip(bodies, serve(engine, ep, models, bodies)):
        assert status == 200
        q = params_from_dict(TT.Query, body)
        assert got == algo.predict(models[0], q).to_dict()
    assert algo.warmup_query(models[0]) == TT.Query(user="u0")


# ------------------------------------------------------------- sequence
def test_sequence_read_eval_folds_match_reference(memory_storage):
    seed_events(view_rows(), app=APP)
    got = TS.SequenceDataSource(TS.DataSourceParams(
        app_name=APP, eval_k=3, eval_num=4)).read_eval(
            ComputeContext.local(device="cpu"))
    want = JS.SequenceDataSource(JS.DataSourceParams(
        app_name=APP, eval_k=3, eval_num=4)).read_eval(JaxContext.local())
    assert len(got) == len(want) == 3
    for (td, info, qa), (jtd, jinfo, jqa) in zip(got, want):
        assert info == jinfo
        assert td.histories == jtd.histories
        assert [(q.history, q.num, a) for q, a in qa] == \
            [(q.history, q.num, a) for q, a in jqa]
    assert TS.SequenceDataSource(TS.DataSourceParams(
        app_name=APP)).read_eval(ComputeContext.local(device="cpu")) == []
    with pytest.raises(ValueError, match="eval_k >= 2"):
        TS.SequenceDataSource(TS.DataSourceParams(
            app_name=APP, eval_k=1)).read_eval(None)


def test_sequence_answers_like_the_jax_package(memory_storage, reference_init):
    seed_events(view_rows(), app=APP)
    (engine, ep, ctx, iid, model), (jengine, jep, jmodel) = \
        train_both(SEQ_VARIANT)
    assert isinstance(model, TS.SeqRecEngineModel)
    assert model.user_histories == jmodel.user_histories
    assert model.item_index.to_dict() == jmodel.item_index.to_dict()
    bodies = [dict(user=f"u{u}", num=4) for u in range(0, 20, 4)]
    bodies += [dict(history=("i3", "i4", "i5"), num=3),
               dict(history=("nope", "i1"), num=2),
               dict(history=("nope",)), dict(user="stranger"),
               dict(history=tuple(f"i{k % 10}" for k in range(12)), num=5)]
    answers_match(engine, ep, model, jengine, jep, jmodel,
                  [TS.Query(**b) for b in bodies],
                  [JS.Query(**b) for b in bodies])


def test_sequence_serves_over_http(memory_storage):
    seed_events(view_rows(), app=APP, reference=False)
    v = variant_from_dict(SEQ_VARIANT)
    engine, ep = build_engine(v)
    ctx = ComputeContext.local(device="cpu")
    iid = run_train(engine, ep, v, ctx=ctx)
    models = load_models_for_instance(iid, engine, ep, ctx)
    algo = engine._algorithms(ep)[0]
    bodies = [{"user": "u0", "num": 4}, {"history": ["i2", "i3"], "num": 2},
              {"user": "stranger"}]
    for body, (status, got) in zip(bodies, serve(engine, ep, models, bodies)):
        assert status == 200
        q = params_from_dict(TS.Query, body)
        assert got == algo.predict(models[0], q).to_dict()
    assert params_from_dict(TS.Query, bodies[1]).history == ("i2", "i3")
    assert algo.warmup_query(models[0]) is not None


# --------------------------------------------------------------- sweeps
SWEEPS = {
    "twotower": (
        rate_rows,
        lambda m: m.twotower_evaluation(APP, eval_k=2, eval_num=3,
                                        out_dims=(4, 8), steps=15,
                                        batch_size=32)),
    "sequence": (
        view_rows,
        lambda m: m.sequence_evaluation(APP, eval_k=2, eval_num=3,
                                        layer_grid=(1, 2), steps=10,
                                        d_model=8, max_len=8)),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_matches_reference(memory_storage, reference_init, name):
    rows, factory = SWEEPS[name]
    seed_events(rows(), app=APP)
    port_mod, ref_mod = {"twotower": (TT, JT), "sequence": (TS, JS)}[name]
    ev, jev = factory(port_mod), factory(ref_mod)
    got = run_evaluation(ev, ev.engine_params_generator,
                         ctx=ComputeContext.create(device="cpu"))
    want = jax_run_evaluation(jev, jev.engine_params_generator,
                              ctx=JaxContext.local())
    assert got.best_index == want.best_index
    assert [s.score for s in got.engine_params_scores] == \
        [s.score for s in want.engine_params_scores]
    assert got.metric_header == want.metric_header


@pytest.mark.parametrize("factory,param,field", [
    (TT.twotower_evaluation, "out_dims", "out_dim"),
    (TS.sequence_evaluation, "layer_grid", "n_layers"),
])
def test_evaluation_grids(factory, param, field, monkeypatch):
    ev = factory("some-app", eval_k=4, **{param: (3, 5)})
    grid = ev.engine_params_generator.engine_params_list
    assert [getattr(ep.algorithm_params_list[0][1], field)
            for ep in grid] == [3, 5]
    ds = grid[0].data_source_params
    assert (ds.app_name, ds.eval_k) == ("some-app", 4)
    with pytest.raises(ValueError, match="eval_k >= 2"):
        factory("some-app", eval_k=1)
    monkeypatch.setenv("PIO_TPU_EVAL_APP", "env-app")
    grid = factory().engine_params_generator.engine_params_list
    assert grid[0].data_source_params.app_name == "env-app"


# ------------------------------------------------------------------- the card
@pytest.mark.cuda
@pytest.mark.parametrize("variant", [TT_VARIANT, SEQ_VARIANT],
                         ids=["twotower", "sequence"])
def test_card_answers_like_cpu_copy(memory_storage, variant):
    """Trained on the card, loaded on the card and on the CPU from one
    blob: the same items, scores within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed_events(rate_rows() if variant is TT_VARIANT else view_rows(),
                app=APP, reference=False)
    v = variant_from_dict(variant)
    engine, ep = build_engine(v)
    ctx = ComputeContext.local(device="cuda")
    iid = run_train(engine, ep, v, ctx=ctx)
    (gpu,) = load_models_for_instance(iid, engine, ep, ctx)
    (cpu,) = load_models_for_instance(
        iid, engine, ep, ComputeContext.local(device="cpu"))
    algo = engine._algorithms(ep)[0]
    q = algo.query_class(user="u1", num=4)
    same_answer(algo.predict(gpu, q), algo.predict(cpu, q))
