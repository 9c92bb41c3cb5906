"""The port's process group, mesh spec and context against the
reference's contract, on the CPU.

A 2-rank gloo group formed through the env contract (``PIO_TPU_
COORDINATOR``, ``PIO_TPU_NUM_PROCESSES``, ``PIO_TPU_PROCESS_ID``;
``tests/torch_ranks.py``) runs ``all_reduce``, the collectives the
trainers use and the counterpart of ``host_local_to_global`` (each rank's
rows of another length assembled in rank order), as
``tests/test_distributed_multiprocess.py:99`` does with ``psum`` over the
reference's group; the context's ``shard_batch`` and ``shard_params``
give each rank its rows. ``MeshSpec.sizes`` is held to the reference's on
the same cases, errors included, and ``ComputeContext.create()`` without
the env stays one device.
"""

import os
import sys

import numpy as np
import pytest
import torch

from pio_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from pio_tpu_torch.parallel import distributed
from pio_tpu_torch.parallel.context import ComputeContext
from pio_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec, mesh_axis_size
from pio_tpu_torch.storage.records import RunStatus
from pio_tpu_torch.storage.registry import Storage
from pio_tpu_torch.workflow import shard_store
from pio_tpu_torch.workflow.core_workflow import load_models_for_instance
from pio_tpu_torch.workflow.engine_json import build_engine, variant_from_dict

sys.path.insert(0, os.path.dirname(__file__))
from torch_ranks import run_ranks  # noqa: E402
from test_torch_recommendation import VARIANT, _seed_port  # noqa: E402


@pytest.fixture(scope="module")
def sqlite_home(tmp_path_factory):
    """The recommendation fixture's events in SQLite under a home the
    ranks share."""
    mp = pytest.MonkeyPatch()
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        mp.delenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", raising=False)
    home = tmp_path_factory.mktemp("group-home")
    mp.setenv("PIO_TPU_HOME", str(home))
    Storage.reset()
    _seed_port()
    yield home
    Storage.reset()
    mp.undo()


@pytest.fixture(scope="module")
def two_ranks(sqlite_home):
    env = {f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": None
           for r in ("METADATA", "EVENTDATA", "MODELDATA")}
    env.update(PIO_TPU_HOME=str(sqlite_home), PIO_TPU_SHARDED_PERSIST="1")
    return run_ranks(2, [("torch_ranks:group_task", None),
                         ("torch_ranks:run_train_task", VARIANT)], env=env)


def test_group_forms_from_the_env_contract(two_ranks):
    for rank, (got, _) in enumerate(two_ranks):
        assert got["rank"] == rank and got["world"] == 2
        assert got["num_devices"] == 2 and got["coordinator"] == (rank == 0)
        assert got["backend"] == "gloo" and got["device"] == "cpu"
        assert got["mesh_shape"] == [2, 1, 1, 1]
        assert got["data_axis"] == 2 and got["model_axis"] == 1


def test_all_reduce_sums_over_the_ranks(two_ranks):
    # rank 0 ones, rank 1 twos (the reference test's psum)
    for (got, _) in two_ranks:
        assert got["all_reduce"] == 3 * 4 * 1.0 + 3 * 4 * 2.0


def test_collectives_of_the_trainers(two_ranks):
    for rank, (got, _) in enumerate(two_ranks):
        # reduce_scatter: the sum over ranks, this rank's half of the rows
        full = np.arange(8, dtype=np.float32).reshape(4, 2) * 2 + 1
        np.testing.assert_array_equal(got["reduce_scatter"],
                                      full[2 * rank:2 * rank + 2])
        # all_gather over uint16 (no NCCL type): bytes, back in rank order
        np.testing.assert_array_equal(
            got["all_gather"], np.array([[0, 65535], [1, 65534]], np.uint16))


def test_host_local_to_global_assembles_rows_in_rank_order(two_ranks):
    want_x = np.concatenate([np.full((3, 2), 0.0), np.full((5, 2), 1.0)])
    want_y = np.array([0, 1, 2, 100, 101, 102, 103, 104])
    for (got, _) in two_ranks:
        np.testing.assert_array_equal(got["global"][0], want_x)
        np.testing.assert_array_equal(got["global"][1], want_y)


def test_shard_batch_gives_each_rank_its_padded_rows(two_ranks):
    # 5 rows pad to 6: rank 0 rows 0-2, rank 1 rows 3-4 and the pad row
    for rank, (got, _) in enumerate(two_ranks):
        ids, mask = got["shard_batch"]
        want = np.array([0, 1, 2]) if rank == 0 else np.array([3, 4, -1])
        np.testing.assert_array_equal(ids, want)
        np.testing.assert_array_equal(mask, [1, 1, 1] if rank == 0
                                      else [1, 1, 0])


def test_shard_params_gives_each_rank_its_row_slices(two_ranks):
    table = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    padded = np.concatenate([table, np.zeros((1, 2), np.float32)])
    for rank, (got, _) in enumerate(two_ranks):
        placed, spec, bias = got["shard_params"]
        np.testing.assert_array_equal(placed, padded[4 * rank:4 * rank + 4])
        assert spec == ("data", None)
        np.testing.assert_array_equal(bias, np.ones(3))


@pytest.mark.parametrize("spec,n", [
    (dict(), 8), (dict(model=2), 8), (dict(data=2, model=4), 8),
    (dict(data=-1, seq=2, pipe=2), 8), (dict(data=1), 1),
    (dict(model=3), 8), (dict(data=-1, model=-1), 4), (dict(data=2), 8),
    (dict(data=4, model=2), 4), (dict(pipe=-1, data=2), 6),
])
def test_mesh_spec_sizes_match_reference(spec, n):
    outcomes = []
    for cls in (MeshSpec, JaxMeshSpec):
        try:
            outcomes.append(cls(**spec).sizes(n))
        except ValueError as e:
            outcomes.append(("ValueError", str(e)))
    assert outcomes[0] == outcomes[1]


def test_create_without_the_env_is_one_device(monkeypatch):
    for name in ("PIO_TPU_COORDINATOR", "PIO_TPU_NUM_PROCESSES",
                 "PIO_TPU_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    ctx = ComputeContext.create(seed=3, device="cpu")
    assert ctx.group is None and ctx.mesh is None and ctx.rank == 0
    assert ctx.num_devices == 1 and ctx.world_size == 1 and ctx.seed == 3
    assert ctx.device == torch.device("cpu") and ctx.is_coordinator
    assert not distributed.is_initialized()
    assert mesh_axis_size(None, "data") == 1
    assert AXIS_ORDER == ("data", "pipe", "seq", "model")
    out = ctx.shard_batch({"x": np.arange(3)})
    np.testing.assert_array_equal(out["x"].numpy(), [0, 1, 2])
    np.testing.assert_array_equal(out["mask"].numpy(), [1, 1, 1])


def test_incomplete_env_contract_raises(monkeypatch):
    monkeypatch.setenv("PIO_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("PIO_TPU_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("PIO_TPU_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="PIO_TPU_NUM_PROCESSES"):
        ComputeContext.create(device="cpu")
    monkeypatch.setenv("PIO_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("PIO_TPU_PROCESS_ID", "2")
    with pytest.raises(ValueError, match="outside"):
        ComputeContext.create(device="cpu")


def test_run_train_in_a_group_writes_once(two_ranks, sqlite_home):
    """Both ranks train; rank 0 alone writes the instance, the sharded
    models (one shard a rank) and the run ledger row; both return its
    id, and the models load on one device."""
    iids = [r[1] for r in two_ranks]
    assert iids[0] == iids[1]
    Storage.reset()
    instances = Storage.get_meta_data_engine_instances().get_all()
    assert [i.id for i in instances] == [iids[0]]
    assert instances[0].status == RunStatus.COMPLETED
    assert instances[0].env["num_devices"] == "2"
    store = Storage.get_model_data_models()
    manifest = shard_store.read_manifest(store, iids[0])
    assert manifest["n_shards"] == 2 and manifest["mesh_shape"] == [2]
    assert shard_store.verify_manifest(store, iids[0]) == 4
    variant = variant_from_dict(VARIANT)
    engine, ep = build_engine(variant)
    (model,) = load_models_for_instance(
        iids[0], engine, ep, ComputeContext.local(device="cpu"))
    assert model.factors.user_factors.shape == (12, 6)
    runs = list((sqlite_home / "runs").glob("*.jsonl"))
    assert len(runs) == 1 and len(runs[0].read_text().splitlines()) == 1


def test_rows_of_splits_padded_rows_evenly():
    assert [distributed.rows_of(5, r, 2) for r in range(2)] == \
        [(0, 3, 6), (3, 6, 6)]
    assert distributed.rows_of(8, 3, 4) == (6, 8, 8)
    assert distributed.rows_of(0, 0, 2) == (0, 0, 0)


def test_only_the_group_trainers_split_over_a_group():
    """The algorithms whose trainers read ``ctx.group`` (ALS, the text
    MLP, logreg, two-tower, the sequence model) say so; run_train warns
    that naive Bayes trains a whole copy on each rank."""
    import importlib

    from pio_tpu_torch.controller.components import Algorithm

    names = ("classification", "ecommerce", "recommendation", "sequence",
             "similarproduct", "textclassification", "twotower")
    split = {}
    for name in names:
        mod = importlib.import_module(f"pio_tpu_torch.templates.{name}")
        for attr in vars(mod).values():
            if isinstance(attr, type) and issubclass(attr, Algorithm) \
                    and attr is not Algorithm \
                    and attr.__module__ == mod.__name__:
                split[f"{name}.{attr.__name__}"] = attr.splits_over_group
    assert sorted(k for k, v in split.items() if v) == [
        "classification.LogisticRegressionAlgorithm",
        "ecommerce.ECommAlgorithm",
        "recommendation.ALSAlgorithm",
        "sequence.SeqRecAlgorithm",
        "similarproduct.SimilarProductAlgorithm",
        "textclassification.MLPAlgorithm",
        "twotower.TwoTowerAlgorithm",
    ]
    assert {"classification.NaiveBayesAlgorithm",
            "textclassification.NBAlgorithm"} <= set(split)
