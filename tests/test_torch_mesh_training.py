"""The port's multi-device trainers against the JAX package's meshes, on
the CPU.

The port's mesh ALS, data-parallel ``train_mlp`` and data-parallel
``train_logreg`` run in gloo process groups of 1, 2 and 4 CPU ranks
(``tests/torch_ranks.py``: every check of the file in one spawn a world
size), formed through the env contract; the JAX package's run on meshes
of 2 and 4 of the host devices that ``tests/conftest.py`` forces. Both
sides start from the reference's initial values (``jax.random``, fed to
the port's trainers). Tolerances, stated per check:

- ALS, 3 iterations: ``atol = 1e-4`` on the factors, ``test_torch_als``'s
  trainer tolerance (the normal equations are summed in another order,
  and across ranks in the port);
- ALS, the compact and blocked wires: bitwise, both sides (the device
  pack is bitwise the host pack);
- world size 1 against the port's single-device path: bitwise (every
  collective is an identity);
- ``train_mlp``, 5 Adam steps: ``atol = 1e-5``, as
  ``test_torch_textclassification_train``;
- ``train_logreg``, 10 steps: ``test_torch_logreg``'s tolerances (f32:
  ``1e-5`` times the largest weight; int8: ``5·lr·2^-8`` a weight).

The entity counts (61 users, 41 items) and the batch (45 rows) are no
world multiple, so the padding is exercised.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pio_tpu.models import als as R
from pio_tpu.models import logreg as RL
from pio_tpu.models.mlp import MLPConfig as JaxMLPConfig
from pio_tpu.models.mlp import train_mlp as jax_train_mlp
from pio_tpu.parallel.context import ComputeContext as JaxContext
from pio_tpu.parallel.context import default_mesh
from pio_tpu_torch.models import als as T
from pio_tpu_torch.models import logreg as TL
from pio_tpu_torch.models import mlp as TM
from pio_tpu_torch.parallel.context import ComputeContext

sys.path.insert(0, os.path.dirname(__file__))
from torch_ranks import run_groups  # noqa: E402

U, I, K = 61, 41, 8
ALS_CFG = dict(rank=K, iterations=3, reg=0.1, blocks_per_chunk=4)
V, H, C, N, L = 60, 16, 3, 45, 8
MLP_CFG = dict(hidden=H, iterations=5, learning_rate=0.05, reg=0.01)
LR_N, LR_D, LR_C = 45, 12, 4
LR_CFG = dict(iterations=10, learning_rate=0.05, reg=0.01, seed=3)
LR = 0.05
WORLDS = (2, 4)


def _ratings():
    rng = np.random.default_rng(0)
    mask = rng.random((U, I)) < 0.6
    u, i = np.nonzero(mask)
    # half-star grid ratings: the u4 rating wire decodes them exactly
    r = (rng.integers(1, 11, len(u)) * 0.5).astype(np.float32)
    return u.astype(np.int32), i.astype(np.int32), r


def _als_init(n_shards, seed=0):
    """The reference's factor init at padded counts (als.py l.473-482)."""
    U_pad = -(-U // n_shards) * n_shards
    I_pad = -(-I // n_shards) * n_shards
    ku, ki = jax.random.split(jax.random.PRNGKey(seed))
    scale = np.float32(K) ** -0.5
    P = np.asarray(jnp.abs(jax.random.normal(ku, (U_pad, K), jnp.float32))
                   * scale)
    Q = np.asarray(jnp.abs(jax.random.normal(ki, (I_pad, K), jnp.float32))
                   * scale)
    return [P, Q]


def _bags():
    rng = np.random.default_rng(1)
    ids = rng.integers(1, V, size=(N, L), dtype=np.int32)
    w = rng.random((N, L), dtype=np.float32) + 0.05
    n_live = rng.integers(2, L + 1, size=N)
    pad = np.arange(L)[None, :] >= n_live[:, None]
    ids[pad], w[pad] = 0, 0.0
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    y = rng.integers(0, C, size=N).astype(np.int32)
    return ids, w, y


def _mlp_init(seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {
        "w_in": np.array(jax.random.normal(k1, (V, H), jnp.float32)
                         * (1.0 / np.sqrt(V))),
        "b_in": np.zeros(H, np.float32),
        "w_out": np.array(jax.random.normal(k2, (H, C), jnp.float32)
                          * (1.0 / np.sqrt(H))),
        "b_out": np.zeros(C, np.float32),
    }


def _logreg_data():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(LR_N, LR_D)).astype(np.float32)
    y = np.argmax(X @ rng.normal(size=(LR_D, LR_C)), axis=1).astype(np.int32)
    w = 0.01 * jax.random.normal(jax.random.PRNGKey(LR_CFG["seed"]),
                                 (LR_D, LR_C), jnp.float32)
    return X, y, {"w": np.array(w), "b": np.zeros(LR_C, np.float32)}


def _tasks(world):
    u, i, r = _ratings()
    ids, w, y = _bags()
    X, yl, p0 = _logreg_data()
    als = dict(u=u, i=i, r=r, U=U, I=I, cfg=ALS_CFG, init=_als_init(world))
    tasks = [
        ("torch_ranks:als_task", {**als, "wire": "compact"}),
        ("torch_ranks:als_task", {**als, "wire": "blocked"}),
        ("torch_ranks:mlp_task", dict(ids=ids, w=w, y=y, V=V, C=C,
                                      cfg=MLP_CFG, init=_mlp_init())),
    ]
    for dtype in ("float32", "int8"):
        tasks.append(("torch_ranks:logreg_task", dict(
            X=X, y=yl, C=LR_C, init=p0,
            cfg={**LR_CFG, "input_dtype": dtype})))
    return tasks


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results at world sizes 1, 2 and 4 (the three groups
    run at once)."""
    return run_groups({world: _tasks(world) for world in (1,) + WORLDS})


def _jax_ctx(world):
    return JaxContext(mesh=default_mesh(devices=jax.devices()[:world]))


# ------------------------------------------------------------------ ALS
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_als_matches_reference_mesh(ranks, world):
    u, i, r = _ratings()
    want = R.train_als(_jax_ctx(world), u, i, r, U, I, R.ALSConfig(
        rank=K, iterations=3, reg=0.1, blocks_per_chunk=4,
        matmul_dtype="float32", solver="cholesky"))
    got_u, got_i, stats = ranks[world][0][0]
    np.testing.assert_allclose(got_u, want.user_factors, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_i, want.item_factors, rtol=0, atol=1e-4)
    assert got_u.shape == (U, K) and got_i.shape == (I, K)
    assert stats["world"] == world and stats["encoding"].startswith("u4")


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_mesh_als_wires_and_ranks_agree_bitwise(ranks, world):
    compact = ranks[world][0][0]
    blocked = ranks[world][0][1]
    assert blocked[2]["encoding"] == "blocked-f32"
    for a, b in zip(compact[:2], blocked[:2]):
        np.testing.assert_array_equal(a, b)
    for rank in ranks[world][1:]:  # every rank holds the same factors
        for a, b in zip(compact[:2], rank[0][:2]):
            np.testing.assert_array_equal(a, b)


def test_mesh_als_world_one_is_the_local_path(ranks):
    u, i, r = _ratings()
    init = iter(_als_init(1))
    orig = T._init_factors
    T._init_factors = lambda n, rank, gen: T.torch.from_numpy(next(init).copy())
    try:
        f = T.train_als(ComputeContext.local(device="cpu"), u, i, r, U, I,
                        T.ALSConfig(**ALS_CFG))
    finally:
        T._init_factors = orig
    got_u, got_i, _ = ranks[1][0][0]
    np.testing.assert_array_equal(got_u, f.user_factors)
    np.testing.assert_array_equal(got_i, f.item_factors)


# ------------------------------------------------------------------ MLP
@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_mlp_matches_reference_mesh(ranks, world):
    ids, w, y = _bags()
    m = jax_train_mlp(_jax_ctx(world), ids, w, y, V, C,
                      JaxMLPConfig(**MLP_CFG))
    got = ranks[world][0][2]
    for k in ("w_in", "b_in", "w_out", "b_out"):
        np.testing.assert_allclose(got[k], getattr(m, k), rtol=0, atol=1e-5,
                                   err_msg=k)
    for rank in ranks[world][1:]:
        for k in got:
            np.testing.assert_array_equal(rank[2][k], got[k])


def test_data_parallel_mlp_world_one_is_the_local_path(ranks):
    import torch

    ids, w, y = _bags()
    fitted, _ = TM._fit(
        {k: torch.from_numpy(v) for k, v in _mlp_init().items()},
        torch.from_numpy(ids), torch.from_numpy(w),
        torch.from_numpy(y.astype(np.int64)), torch.ones(N),
        TM.MLPConfig(**MLP_CFG))
    got = ranks[1][0][2]
    for k, v in fitted.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


# --------------------------------------------------------------- logreg
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dtype,slot", [("float32", 3), ("int8", 4)])
def test_data_parallel_logreg_matches_reference_mesh(ranks, world, dtype,
                                                     slot):
    X, y, _ = _logreg_data()
    want = RL.train_logreg(_jax_ctx(world), X, y, LR_C, RL.LogRegConfig(
        **LR_CFG, input_dtype=dtype))
    got_w, got_b = ranks[world][0][slot]
    if dtype == "float32":
        tol = 1e-5 * max(1.0, float(np.abs(want.weights).max()))
    else:
        tol = 5 * LR * 2 ** -8
    np.testing.assert_allclose(got_w, want.weights, rtol=0, atol=tol)
    np.testing.assert_allclose(got_b, want.bias, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype,slot", [("float32", 3), ("int8", 4)])
def test_data_parallel_logreg_world_one_is_the_local_path(ranks, dtype, slot):
    import torch

    X, y, p0 = _logreg_data()
    orig = TL.init_params
    TL.init_params = lambda d, c, seed: {
        k: torch.from_numpy(v) for k, v in p0.items()}
    try:
        want = TL.train_logreg(ComputeContext.local(device="cpu"), X, y,
                               LR_C, TL.LogRegConfig(**LR_CFG,
                                                     input_dtype=dtype))
    finally:
        TL.init_params = orig
    got_w, got_b = ranks[1][0][slot]
    np.testing.assert_array_equal(got_w, want.weights)
    np.testing.assert_array_equal(got_b, want.bias)
