"""The port's sharded model persistence against the JAX package's
(``pio_tpu/workflow/shard_store.py``), on the CPU.

Mirrors ``tests/test_partition_rules.py:168-235``: a recommendation
``ALSModel`` saved as row shards over 4 and 2 devices restores on 2 and 1
(a reshard, counted), bitwise; a torn shard and a missing shard manifest
raise; the gate is off by default. The port's shard manifest for the same
arrays is the reference's byte for byte (every field, the sha256s
included), and so are its shard records. Both packages write into a
dict-backed models store.
"""

import json

import numpy as np
import pytest
import torch

from pio_tpu.data.bimap import BiMap as JaxBiMap
from pio_tpu.models.als import ALSFactors as JaxFactors
from pio_tpu.templates.recommendation import ALSModel as JaxALSModel
from pio_tpu.workflow import shard_store as R
from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.models.als import ALSFactors
from pio_tpu_torch.storage.records import Model
from pio_tpu_torch.templates.recommendation import ALSModel
from pio_tpu_torch.workflow import shard_store as T


class DictModels:
    """A models store: ``insert`` and ``get`` of records by id."""

    def __init__(self):
        self.records = {}

    def insert(self, record):
        self.records[record.id] = record
        return record.id

    def get(self, record_id):
        return self.records.get(record_id)


def _arrays(n_users=17, n_items=9, rank=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_users, rank)).astype(np.float32),
            rng.normal(size=(n_items, rank)).astype(np.float32))


def _port_model(seed=0):
    uf, itf = _arrays(seed=seed)
    return ALSModel.from_factors(
        ALSFactors(uf, itf), BiMap({f"u{i}": i for i in range(len(uf))}),
        BiMap({f"i{i}": i for i in range(len(itf))}), device="cpu")


def _jax_model(seed=0):
    uf, itf = _arrays(seed=seed)
    return JaxALSModel(
        JaxFactors(user_factors=uf, item_factors=itf),
        JaxBiMap({f"u{i}": i for i in range(len(uf))}),
        JaxBiMap({f"i{i}": i for i in range(len(itf))}),
    )


@pytest.mark.parametrize("saved,loaded", [(4, 2), (2, 1), (4, 4)])
def test_save_and_restore_reshards_bitwise(saved, loaded):
    store = DictModels()
    model = _port_model()
    stripped = T.save_sharded(store, "inst", [model], n_shards=saved,
                              mesh_shape=[saved])
    assert isinstance(stripped[0].factors.user_factors, T.ShardPlaceholder)
    assert T.is_stripped(stripped[0]) and not T.is_stripped(model)
    before = T._SHARD_RESHARD.value()
    back = T.restore_sharded(store, "inst", list(stripped),
                             n_devices=loaded, device="cpu")
    assert T._SHARD_RESHARD.value() == before + (saved != loaded)
    for got, want in zip(
            (back[0].factors.user_factors, back[0].factors.item_factors),
            (model.factors.user_factors, model.factors.item_factors)):
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert T.verify_manifest(store, "inst") == 2 * saved


def test_manifest_and_shards_equal_the_reference():
    port, ref = DictModels(), DictModels()
    T.save_sharded(port, "inst-m", [_port_model(1), "not shardable"],
                   n_shards=4, mesh_shape=[4])
    R.save_sharded(ref, "inst-m", [_jax_model(1), "not shardable"],
                   n_shards=4, mesh_shape=[4])
    key = "inst-m" + T.SHARD_MANIFEST_SUFFIX
    assert T.SHARD_MANIFEST_SUFFIX == R.SHARD_MANIFEST_SUFFIX
    assert port.records[key].models == ref.records[key].models
    manifest = json.loads(port.records[key].models)
    assert manifest["algos"][1] is None
    assert [a["spec"] for a in manifest["algos"][0]["arrays"]] == \
        [["data", None]] * 2
    assert set(port.records) == set(ref.records)
    for k in port.records:
        assert port.records[k].models == ref.records[k].models, k


def test_torn_shard_detected():
    store = DictModels()
    stripped = T.save_sharded(store, "inst-torn", [_port_model(2)],
                              n_shards=4)
    shard_id = "inst-torn.shard.0.0.3"
    rec = store.get(shard_id)
    store.insert(Model(id=shard_id, models=rec.models[:-1] + b"\x00"))
    with pytest.raises(RuntimeError, match="checksum"):
        T.restore_sharded(store, "inst-torn", list(stripped), n_devices=4)
    with pytest.raises(RuntimeError, match="verify"):
        T.verify_manifest(store, "inst-torn")


def test_missing_shard_and_manifest_are_torn_persists():
    store = DictModels()
    stripped = T.save_sharded(store, "inst-a", [_port_model(3)], n_shards=2)
    with pytest.raises(RuntimeError, match="manifest"):
        T.restore_sharded(store, "inst-MISSING", list(stripped))
    del store.records["inst-a.shard.0.1.0"]
    with pytest.raises(RuntimeError, match="missing shard record"):
        T.restore_sharded(store, "inst-a", list(stripped))


def test_gate_defaults_off(monkeypatch):
    monkeypatch.delenv("PIO_TPU_SHARDED_PERSIST", raising=False)
    assert not T.sharded_persist_enabled()
    monkeypatch.setenv("PIO_TPU_SHARDED_PERSIST", "1")
    assert T.sharded_persist_enabled()
    monkeypatch.setenv("PIO_TPU_SHARDED_PERSIST", "0")
    assert not T.sharded_persist_enabled()


def test_unstripped_models_pass_through():
    store = DictModels()
    models = [_port_model(4), {"plain": 1}]
    assert T.restore_sharded(store, "nothing", models) is models
