"""The multi-device paths on the card, at small sizes (``cuda``-marked:
they skip without a GPU; ``chip_smoke.py`` phase 41 runs them at full
size). No JAX here: the references are the port's single-device paths.

- ALS in a 1-rank NCCL group (a spawned process joining through the env
  contract), both wires: bitwise the single-device factors on the card.
- Data-parallel ``train_mlp`` in the same group: bitwise the
  single-device parameters, through the hand-written kernels.
- ``train_two_tower`` and ``train_seqrec`` (ring and ulysses) over the
  same group's mesh: bitwise the single-device tables and parameters.
- The sharded top-N scorer over ``(cuda,) * 4`` against the unsharded
  one on the card: the same items where scores are more than 1e-5 apart,
  scores within 1e-5.
"""

import os
import sys

import numpy as np
import pytest
import torch

from pio_tpu_torch.models import als, mlp, seqrec, two_tower
from pio_tpu_torch.ops.topn import DeviceTopNScorer
from pio_tpu_torch.parallel.context import ComputeContext

sys.path.insert(0, os.path.dirname(__file__))
from torch_ranks import run_ranks  # noqa: E402

U, I = 301, 157
ALS_CFG = dict(rank=16, iterations=5, reg=0.1, blocks_per_chunk=64)
V, H, C, N, L = 500, 32, 5, 301, 24
MLP_CFG = dict(hidden=H, iterations=20, learning_rate=0.05, reg=0.01)
TT_CFG = dict(embed_dim=16, hidden=32, out_dim=16, steps=20, batch_size=128)
SEQ_CFG = dict(d_model=32, n_heads=4, n_layers=2, ffn=64, max_len=16,
               steps=10)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ratings():
    rng = np.random.default_rng(0)
    u = rng.integers(0, U, 20000).astype(np.int32)
    i = (rng.random(20000) ** 2 * I).astype(np.int32)
    r = (rng.integers(1, 11, 20000) * 0.5).astype(np.float32)
    return u, i, r


def _bags():
    rng = np.random.default_rng(1)
    ids = rng.integers(1, V, size=(N, L), dtype=np.int32)
    w = rng.random((N, L), dtype=np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    return ids, w, rng.integers(0, C, N).astype(np.int32)


@pytest.fixture(scope="module")
def one_rank(cuda_device):
    u, i, r = _ratings()
    ids, w, y = _bags()
    als_task = dict(u=u, i=i, r=r, U=U, I=I, cfg=ALS_CFG, init=None)
    init = {k: v.cpu().numpy() for k, v in mlp.init_params(
        V, H, C, torch.Generator().manual_seed(0)).items()}
    return run_ranks(1, [
        ("torch_ranks:als_task", {**als_task, "wire": "compact"}),
        ("torch_ranks:als_task", {**als_task, "wire": "blocked"}),
        ("torch_ranks:mlp_task", dict(ids=ids, w=w, y=y, V=V, C=C,
                                      cfg=MLP_CFG, init=init)),
        ("torch_ranks:twotower_task", dict(spec={}, u=u, i=i, U=U, I=I,
                                           cfg=TT_CFG)),
    ] + [("torch_ranks:seqrec_task", dict(
        spec={}, seqs=_histories(), n_items=I,
        cfg=dict(SEQ_CFG, attention=a))) for a in ("ring", "ulysses")],
        device="cuda", timeout=300)[0]


def _histories():
    rng = np.random.default_rng(2)
    seqs = np.zeros((40, 20), np.int32)
    for r in range(40):
        k = rng.integers(4, 21)
        seqs[r, :k] = rng.integers(1, I + 1, k)
    return seqs


@pytest.mark.cuda
def test_group_als_is_the_single_device_path_on_the_card(one_rank,
                                                         cuda_device):
    u, i, r = _ratings()
    want = als.train_als(ComputeContext.local(device=cuda_device), u, i, r,
                         U, I, als.ALSConfig(**ALS_CFG))
    for got in one_rank[:2]:
        np.testing.assert_array_equal(got[0], want.user_factors)
        np.testing.assert_array_equal(got[1], want.item_factors)
    assert one_rank[1][2]["encoding"] == "blocked-f32"


@pytest.mark.cuda
def test_data_parallel_mlp_is_the_single_device_path_on_the_card(
        one_rank, cuda_device):
    ids, w, y = _bags()
    params0 = mlp.init_params(V, H, C, torch.Generator().manual_seed(0))
    dev = cuda_device
    fitted, _ = mlp._fit(
        {k: v.to(dev) for k, v in params0.items()},
        torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev),
        torch.from_numpy(y.astype(np.int64)).to(dev),
        torch.ones(N, device=dev), mlp.MLPConfig(**MLP_CFG))
    for k, v in fitted.items():
        np.testing.assert_array_equal(one_rank[2][k], v.cpu().numpy(),
                                      err_msg=k)


@pytest.mark.cuda
def test_sharded_scorer_on_the_card(cuda_device, monkeypatch):
    monkeypatch.setenv("PIO_TPU_SERVE_DEVICE", "device")
    rng = np.random.default_rng(2)
    rows = rng.normal(size=(1001, 16)).astype(np.float32)
    cols = rng.normal(size=(2003, 16)).astype(np.float32)
    plain = DeviceTopNScorer(rows, cols, device=cuda_device)
    sharded = DeviceTopNScorer(rows, cols, device=cuda_device,
                               mesh=(cuda_device,) * 4)
    assert sharded.mesh_sharded
    codes = np.arange(1001, dtype=np.int32)
    ex = rng.integers(0, 2100, (1001, 5)).astype(np.int32)
    for e in (None, ex):
        wi, wv = plain.top_n_batch(codes, 10, e)
        gi, gv = sharded.top_n_batch(codes, 10, e)
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5)
        differs = gi != wi
        # a reordering only between candidates whose scores nearly tie
        assert np.all(np.abs(gv[differs] - wv[differs]) <= 1e-5)
        assert gi.max() < cols.shape[0]


@pytest.mark.cuda
def test_group_two_tower_is_the_single_device_path_on_the_card(one_rank,
                                                               cuda_device):
    u, i, _ = _ratings()
    want = two_tower.train_two_tower(None, u, i, U, I,
                                     two_tower.TwoTowerConfig(**TT_CFG),
                                     device=cuda_device)
    got_u, got_i = one_rank[3]
    np.testing.assert_array_equal(got_u, want.user_vectors.cpu().numpy())
    np.testing.assert_array_equal(got_i, want.item_vectors.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("slot,attention", [(4, "ring"), (5, "ulysses")])
def test_group_seqrec_is_the_single_device_path_on_the_card(
        one_rank, cuda_device, slot, attention):
    want = seqrec.train_seqrec(None, _histories(), I, seqrec.SeqRecConfig(
        **SEQ_CFG, attention=attention), device=cuda_device)
    got = one_rank[slot]
    flat = {}
    for k, v in want.params.items():
        for k2, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            flat[k if k2 is None else f"{k}/{k2}"] = t.cpu().numpy()
    assert got.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
