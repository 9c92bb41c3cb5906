"""The port's partition rules and placement budget against the JAX
package's (``pio_tpu/parallel/partition.py``), on the CPU.

The same parameter trees — the three templates' real trees (the port's
initial two-tower and sequence parameters, the ALS factors and an
Adam-style state over them) and small hand-made ones — go through both
packages' ``match_partition_rules``; every leaf's spec, its entries
compared as tuples, must be equal, errors included. ``spec_for_mesh`` and
``per_device_nbytes`` are compared on meshes of 1, 2, 4 and 8 of the
forced host devices (``tests/conftest.py``) and the port's axis-size
mappings of the same shapes; the budget raises at the same byte counts.
These mirror ``tests/test_partition_rules.py:54-140``.
"""

import jax
import numpy as np
import pytest
import torch

from pio_tpu.parallel import partition as RP
from pio_tpu_torch.models import seqrec as tseq
from pio_tpu_torch.models import two_tower as ttt
from pio_tpu_torch.parallel import partition as TP
from pio_tpu_torch.parallel.context import ComputeContext


def _jax_mesh(shape, names):
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _norm(spec):
    """Entries as tuples of axis names: jax's ``PartitionSpec`` writes a
    one-axis tuple as the bare name, the port keeps the tuple."""
    return tuple(e if e is None else (e,) if isinstance(e, str) else tuple(e)
                 for e in spec)


def _flat(specs, is_jax):
    if is_jax:
        leaves = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=RP.is_partition_spec)[0]
        return {RP.tree_path_name(p): _norm(s) for p, s in leaves}
    return {TP.tree_path_name(p): _norm(s)
            for p, s in TP.tree_flatten_with_path(specs)}


def _host(tree):
    return TP.tree_map(lambda t: t.numpy() if isinstance(t, torch.Tensor)
                       else np.asarray(t), tree)


def _trees():
    g = torch.Generator().manual_seed(0)
    tt = ttt.init_params(12, 9, ttt.TwoTowerConfig(embed_dim=8, hidden=16,
                                                   out_dim=4), g)
    seq = tseq.init_params(20, tseq.SeqRecConfig(
        d_model=8, n_heads=2, n_layers=2, ffn=16, max_len=6), g)
    als = {"user_factors": np.zeros((16, 4), np.float32),
           "item_factors": np.zeros((8, 4), np.float32)}
    return {
        "als": {"als": als,
                "adam": {"0": {"mu": als, "nu": als,
                               "count": np.zeros((), np.int32)}}},
        "two_tower": {"tt": _host(tt),
                      "serving": {"user_vectors": np.zeros((5, 4)),
                                  "item_vectors": np.zeros((7, 4))}},
        "seqrec": {"seq": _host(seq)},
    }


@pytest.mark.parametrize("template", ["als", "two_tower", "seqrec"])
def test_template_rules_match_reference(template):
    for name, tree in _trees()[template].items():
        got = TP.match_partition_rules(TP.rules_for(template), tree)
        want = RP.match_partition_rules(RP.rules_for(template), tree)
        assert _flat(got, False) == _flat(want, True), name


@pytest.mark.parametrize("rules,tree", [
    ([("factors", ("data", None)), ("factors", ())],
     {"factors": np.zeros((4, 2))}),
    ([(".", ("data",))], {"step": np.float32(3.0), "w": np.zeros(4)}),
    ([], {"mystery": np.zeros((2, 2))}),
    ([("w", (("data", "model"), None))], {"a": [np.zeros((4, 2)),
                                                {"w": np.zeros((4, 2))}]}),
])
def test_rule_matching_matches_reference(rules, tree):
    got = TP.match_partition_rules(
        [(p, TP.P(*s)) for p, s in rules], tree)
    want = RP.match_partition_rules(
        [(p, jax.sharding.PartitionSpec(*s)) for p, s in rules], tree)
    assert _flat(got, False) == _flat(want, True)


def test_unmatched_error_and_unknown_template_match_reference():
    tree = {"mystery": np.zeros((2, 2), np.float32)}
    for mod in (TP, RP):
        with pytest.raises(ValueError, match="mystery"):
            mod.match_partition_rules([], tree, on_unmatched="error")
        with pytest.raises(KeyError, match="no partition rules"):
            mod.rules_for("nonesuch")


@pytest.mark.parametrize("shape,names", [
    ((8,), ("data",)), ((4, 2), ("data", "model")), ((2, 2), ("seq", "pipe")),
])
@pytest.mark.parametrize("spec", [
    ("model", None), ("data", "model"), (("data", "model"),),
    (("pipe", "seq"), None, "model"), (None,),
])
def test_spec_for_mesh_matches_reference(shape, names, spec):
    want = RP.spec_for_mesh(_jax_mesh(shape, names),
                            jax.sharding.PartitionSpec(*spec))
    got = TP.spec_for_mesh(dict(zip(names, shape)), TP.P(*spec))
    assert _norm(got) == _norm(want)


@pytest.mark.parametrize("template", ["als", "two_tower", "seqrec"])
@pytest.mark.parametrize("shape,names", [
    ((1,), ("data",)), ((2,), ("data",)), ((4,), ("data",)),
    ((8,), ("data",)), ((2, 2, 2), ("data", "pipe", "model")),
    ((1, 1, 1, 4), ("data", "pipe", "seq", "model")),
])
def test_per_device_nbytes_matches_reference(template, shape, names):
    for tree in _trees()[template].values():
        got = TP.per_device_nbytes(
            dict(zip(names, shape)), tree,
            TP.match_partition_rules(TP.rules_for(template), tree))
        want = RP.per_device_nbytes(
            _jax_mesh(shape, names), tree,
            RP.match_partition_rules(RP.rules_for(template), tree))
        assert got == want
        assert TP.tree_nbytes(tree) == RP.tree_nbytes(tree)


@pytest.mark.parametrize("nbytes,n_dev,budget", [
    (1000, 1, 999), (1000, 1, 1000), (1000, 4, 249), (1000, 4, 250),
    (1001, 4, 250), (5, 8, 0),
])
def test_budget_raises_where_the_reference_does(nbytes, n_dev, budget,
                                                monkeypatch):
    monkeypatch.setenv("PIO_TPU_DEVICE_BUDGET_BYTES", str(budget))
    outcomes = []
    for mod in (TP, RP):
        try:
            mod.assert_device_budget(nbytes, n_dev, "x")
            outcomes.append(None)
        except mod.DeviceBudgetExceeded as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_shard_params_over_a_device_tuple_and_without_a_group(monkeypatch):
    tree = {"user_factors": np.arange(10 * 3, dtype=np.float32).reshape(10, 3),
            "bias": np.ones(5, np.float32)}
    placed, specs = TP.shard_params(("cpu",) * 4, tree, TP.rules_for("als"))
    pieces = placed["user_factors"]
    assert [p.shape[0] for p in pieces] == [3, 3, 3, 3]  # padded to 12
    np.testing.assert_array_equal(torch.cat(pieces)[:10].numpy(),
                                  tree["user_factors"])
    assert not torch.cat(pieces)[10:].any()
    assert all(np.array_equal(b.numpy(), tree["bias"]) for b in placed["bias"])
    assert tuple(specs["user_factors"]) == ("data", None)
    whole, _ = TP.shard_params(ComputeContext.local(device="cpu"), tree,
                               TP.rules_for("als"))
    np.testing.assert_array_equal(whole["user_factors"].numpy(),
                                  tree["user_factors"])
    # the per-device footprint, by the reference's count (the sharded
    # leaf's bytes over 4, rounded up, + the replicated bias): 30 + 20
    monkeypatch.setenv("PIO_TPU_DEVICE_BUDGET_BYTES", "49")
    with pytest.raises(TP.DeviceBudgetExceeded):
        TP.shard_params(("cpu",) * 4, tree, TP.rules_for("als"))
    monkeypatch.setenv("PIO_TPU_DEVICE_BUDGET_BYTES", "50")
    TP.shard_params(("cpu",) * 4, tree, TP.rules_for("als"))
