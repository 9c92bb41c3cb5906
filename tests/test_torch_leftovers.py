"""The small jax-free modules of the port against the JAX package's, on
the CPU.

- ``data/cleaning.py``: the cases of ``tests/test_cleaning.py`` through
  both packages (``parse_duration``, ``clean_events`` under each window
  flag, ``SelfCleaningDataSource`` on a persisted SQLite store): the same
  events come out, field for field.
- ``models/vectorizer.py``: ``BinaryVectorizer`` on seeded property maps,
  the same index, vectors and matrix, bitwise.
- ``server/metrics.py``: the deprecated shim warns on import and exports
  the reference's names with the same outputs.
- ``PersistentModel``: a model whose ``save`` returns True persists
  itself and the blob holds None in its place; one whose ``save`` returns
  False falls back to the blob. Through ``run_train`` and
  ``load_models_for_instance`` of each package.
- The verbs ``template list`` and ``run`` print what the reference's
  print, each in ``cli.verb_scope()``.
"""

import dataclasses
import datetime as dt
import importlib
import sys

import numpy as np
import pytest

import pio_tpu.data as r_data
from pio_tpu.controller import components as r_comp
from pio_tpu.controller import engine as r_engine
from pio_tpu.controller.params import EmptyParams as REmptyParams
from pio_tpu.models import vectorizer as r_vec
from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.storage import App as RApp
from pio_tpu.storage import Storage as RStorage
from pio_tpu.tools import cli as r_cli
from pio_tpu.workflow import core_workflow as r_wf
from pio_tpu.workflow import variant_from_dict as r_variant
import pio_tpu_torch.data as p_data
from pio_tpu_torch.controller import components as p_comp
from pio_tpu_torch.controller import engine as p_engine
from pio_tpu_torch.controller.params import EmptyParams as PEmptyParams
from pio_tpu_torch.models import vectorizer as p_vec
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.storage.records import App as PApp
from pio_tpu_torch.storage.registry import Storage as PStorage
from pio_tpu_torch.tools import cli as p_cli
from pio_tpu_torch.workflow import core_workflow as p_wf
from pio_tpu_torch.workflow.engine_json import variant_from_dict as p_variant

T0 = dt.datetime(2026, 3, 1, tzinfo=dt.timezone.utc)
DATA = {"reference": r_data, "port": p_data}


def _t(minutes):
    return T0 + dt.timedelta(minutes=minutes)


def _fields(events):
    return [(e.event, e.entity_type, e.entity_id, e.target_entity_type,
             e.target_entity_id, e.properties.to_dict(), e.event_time)
            for e in events]


# ------------------------------------------------------------- cleaning
@pytest.mark.parametrize("text,seconds", [
    ("30 days", 30 * 86400), ("12h", 12 * 3600), ("90 minutes", 5400),
    ("1 week", 604800), ("45s", 45)])
def test_parse_duration_matches_reference(text, seconds):
    assert p_data.parse_duration(text) == r_data.parse_duration(text)
    assert p_data.parse_duration(text).total_seconds() == seconds


def test_parse_duration_refuses_like_reference():
    for mod in DATA.values():
        with pytest.raises(ValueError, match="unparseable duration"):
            mod.parse_duration("fortnight")


def _ev(m, event, eid, target=None, props=None, at=0):
    if target is None:
        return m.Event(event, "user", eid, properties=props or {},
                       event_time=_t(at))
    return m.Event(event, "user", eid, "item", target,
                   properties=props or {}, event_time=_t(at))


#: name -> (events, window kwargs, now in minutes or None, what comes out)
CASES = {
    "duration drops old plain events": (
        [("view", "u1", "i1", None, 0), ("view", "u1", "i2", None, 100)],
        dict(duration="30 minutes"), 120, ["i2"]),
    "duration keeps special events": (
        [("$set", "u1", None, {"a": 1}, 0), ("view", "u1", "i1", None, 0)],
        dict(duration="1 minutes"), 120, ["$set"]),
    "compress folds a set chain": (
        [("$set", "u1", None, {"a": 1, "b": 1}, 0),
         ("$set", "u1", None, {"a": 2}, 1),
         ("$unset", "u1", None, {"b": None}, 2)],
        dict(compress_properties=True), None, ["$set"]),
    "compress drops deleted entities": (
        [("$set", "u1", None, {"a": 1}, 0), ("$delete", "u1", None, None, 1)],
        dict(compress_properties=True), None, []),
    "compress keeps the aggregation": (
        [("$set", "u1", None, {"a": 1, "b": 2}, 0),
         ("$unset", "u1", None, {"a": None}, 1),
         ("$set", "u2", None, {"x": "y"}, 2), ("$delete", "u3", None, None, 3)],
        dict(compress_properties=True), None, ["$set", "$set"]),
    "dedupe list properties": (
        [("$set", "i1", None, {"categories": ["a", "b"]}, 0)] * 2,
        dict(remove_duplicates=True), None, ["$set"]),
    "dedupe": (
        [("view", "u1", "i1", None, 0), ("view", "u1", "i1", None, 0),
         ("view", "u1", "i2", None, 0)],
        dict(remove_duplicates=True), None, ["i1", "i2"]),
    "no flags is the identity, time-sorted": (
        [("view", "u1", "i1", None, 1), ("$set", "u1", None, {"a": 1}, 0)],
        dict(), None, ["$set", "i1"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_clean_events_matches_reference(case):
    specs, window, now, want = CASES[case]
    out = {}
    for pkg, m in DATA.items():
        events = [_ev(m, ev, eid, target, props, at)
                  for ev, eid, target, props, at in specs]
        kw = {} if now is None else {"now": _t(now)}
        got = m.clean_events(events, m.EventWindow(**window), **kw)
        out[pkg] = _fields(got)
        if window.get("compress_properties"):
            # compaction is invisible to serving: the same aggregation
            agg = lambda evs: {k: v.to_dict() for k, v  # noqa: E731
                               in m.aggregate_properties(evs).items()}
            assert agg(got) == agg(events)
    assert out["port"] == out["reference"]
    assert [f[4] or f[0] for f in out["port"]] == want


def test_self_cleaning_source_matches_reference(tmp_home):
    """The persisted store compacted by each package: the same count
    removed and the same events left."""
    left = {}
    for pkg, m, storage, app_cls in (
            ("reference", r_data, RStorage, RApp),
            ("port", p_data, PStorage, PApp)):
        storage.reset()
        try:
            app_id = storage.get_meta_data_apps().insert(app_cls(0, pkg))
            le = storage.get_levents()
            for e in (_ev(m, "$set", "u1", props={"a": 1}, at=0),
                      _ev(m, "$set", "u1", props={"a": 2}, at=1),
                      _ev(m, "view", "u1", "i1", at=0),
                      _ev(m, "view", "u1", "i2", at=100)):
                le.insert(e, app_id)
            ds = m.SelfCleaningDataSource()
            assert ds.clean_persisted_events(app_id) == 0  # no window
            ds.event_window = m.EventWindow(duration="30 minutes",
                                            compress_properties=True)
            assert ds.clean_persisted_events(app_id, now=_t(120)) == 2
            pe = storage.get_pevents()
            left[pkg] = sorted(_fields(pe.find(app_id)), key=repr)
            props = pe.aggregate_properties(app_id, entity_type="user")
            assert props["u1"].to_dict() == {"a": 2}
        finally:
            storage.reset()
    assert left["port"] == left["reference"]


# ----------------------------------------------------------- vectorizer
def test_binary_vectorizer_bitwise():
    rng = np.random.default_rng(5)
    fields = ["color", "size", "shape"]
    maps = [{f: f"{f}{int(rng.integers(0, 4))}" for f in fields
             if rng.random() < 0.7} | {"ignored": "x"} for _ in range(40)]
    ref = r_vec.BinaryVectorizer.fit(maps, fields=fields)
    got = p_vec.BinaryVectorizer.fit(maps, fields=fields)
    assert got.index == ref.index and got.fields == ref.fields
    assert got.dim == ref.dim
    probe = maps[:5] + [{"color": "unseen"}, {}]
    for m in probe:
        assert got.to_vector(m) == ref.to_vector(m)
    a, b = got.to_matrix(probe), ref.to_matrix(probe)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


# ----------------------------------------------------------------- shim
def _fresh_import(name):
    sys.modules.pop(name, None)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        return importlib.import_module(name)


def test_metrics_shim_warns_and_matches_reference():
    ref = _fresh_import("pio_tpu.server.metrics")
    got = _fresh_import("pio_tpu_torch.server.metrics")
    assert got.__all__ == ref.__all__
    assert got.CONTENT_TYPE == ref.CONTENT_TYPE
    value = 'a "b" \\ c\nd'
    assert got.escape_label(value) == ref.escape_label(value)
    assert got.escape_help(value) == ref.escape_help(value)
    lines = ["# TYPE x counter", "x 1"]
    a, b = got.render(lines), ref.render(lines)
    assert (a.body, a.content_type) == (b.body, b.content_type)


# ------------------------------------------------------- PersistentModel
#: what the models saved "externally", by instance id, and what their
#: ``save`` answers
SAVED = {}
HANDLES = {"save": True}


def _model_class(comp):
    """A PersistentModel of one package (a module-level class: the blob
    pickles it when ``save`` declines)."""

    @dataclasses.dataclass
    class Model(comp.PersistentModel):
        total: float

        def save(self, instance_id, params, ctx):
            if HANDLES["save"]:
                SAVED[instance_id] = self.total
            return HANDLES["save"]

        @classmethod
        def load(cls, instance_id, params, ctx):
            LOADS.append(instance_id)
            return cls(SAVED[instance_id])

    return Model


LOADS = []
RModel = _model_class(r_comp)
RModel.__qualname__ = "RModel"
PModel = _model_class(p_comp)
PModel.__qualname__ = "PModel"


def _engine(comp, engine_mod, empty, model_cls):
    """An engine whose one algorithm trains ``model_cls``."""

    class Source(comp.DataSource):
        def read_training(self, ctx):
            return [1.0, 2.0, 3.0]

    class Prep(comp.Preparator):
        def prepare(self, ctx, training_data):
            return training_data

    class Algo(comp.Algorithm):
        model_class = model_cls

        def train(self, ctx, prepared_data):
            return model_cls(float(sum(prepared_data)))

        def predict(self, model, query):
            return model.total

    engine = engine_mod.Engine(Source, Prep, {"sum": Algo}, comp.FirstServing)
    ep = engine_mod.EngineParams(algorithm_params_list=(("sum", empty()),))
    return engine, ep


@pytest.mark.parametrize("handles", [True, False])
def test_persistent_model_matches_reference(handles, memory_storage,
                                            monkeypatch):
    monkeypatch.setitem(HANDLES, "save", handles)
    out = {}
    for pkg, comp, engine_mod, empty, wf, variant, ctx, model_cls in (
            ("reference", r_comp, r_engine, REmptyParams, r_wf, r_variant,
             JaxContext.local(0), RModel),
            ("port", p_comp, p_engine, PEmptyParams, p_wf, p_variant,
             ComputeContext.local(device="cpu"), PModel)):
        engine, ep = _engine(comp, engine_mod, empty, model_cls)
        v = variant({"id": f"persist-{pkg}", "engineFactory": "custom"})
        del LOADS[:]
        iid = wf.run_train(engine, ep, v, ctx=ctx)
        assert (iid in SAVED) == handles
        [model] = wf.load_models_for_instance(iid, engine, ep, ctx)
        out[pkg] = (type(model) is model_cls, model.total, list(LOADS))
        assert out[pkg][2] == ([iid] if handles else [])
    assert out["port"][:2] == out["reference"][:2] == (True, 6.0)


@pytest.fixture
def memory_storage(tmp_home, monkeypatch):
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    PStorage.reset()
    RStorage.reset()
    yield
    PStorage.reset()
    RStorage.reset()


# ---------------------------------------------------------------- verbs
def _verb(cli, argv, capsys):
    with p_cli.verb_scope():
        rc = cli.main(argv)
    return rc, capsys.readouterr().out


def test_template_list_matches_reference(capsys, monkeypatch):
    # other tests of this process may have registered factories of their
    # own: each registry holds only the bundled ones while the verbs run
    for mod in (r_engine, p_engine):
        monkeypatch.setattr(mod, "_ENGINE_REGISTRY", {
            k: v for k, v in mod._ENGINE_REGISTRY.items()
            if k.startswith("templates.")})
    ref = _verb(r_cli, ["template", "list"], capsys)
    got = _verb(p_cli, ["template", "list"], capsys)
    assert got == ref and ref[0] == 0
    assert "templates.textclassification" in got[1].split()


def entry(argv):
    """A ``run`` target: echoes its passthrough arguments, exits 3."""
    print("args=" + ",".join(argv))
    return 3


def no_args():
    print("called")


@pytest.mark.parametrize("argv,rc", [
    (["run", "test_torch_leftovers:entry", "--", "a", "-b"], 3),
    (["run", "test_torch_leftovers:entry"], 3),
    (["run", "test_torch_leftovers:no_args"], 0),
    (["run", "test_torch_leftovers:no_args", "x"], 1),
    (["run", "test_torch_leftovers:T0"], 1),
], ids=["passthrough", "no-args", "zero-arity", "zero-arity-refuses",
        "not-callable"])
def test_run_matches_reference(argv, rc, capsys):
    ref = _verb(r_cli, argv, capsys)
    got = _verb(p_cli, argv, capsys)
    assert got == ref and got[0] == rc
