"""The classification slice's models in the port against the JAX package's,
on the CPU.

- ``_fit`` (full-batch Adam on the softmax regression) against the
  reference's ``_jitted_fit`` from the same initial parameters, on data made
  as the reference's benchmark makes it (labels the argmax of a seeded
  linear map): float32 after 5 and 100 steps, with and without ``reg``;
  bfloat16 and int8 after 5 steps.
- The host wires (bf16, int8) and ``feature_scales`` bitwise against what
  the reference's ``train_logreg`` ships, a constant column included; the
  whole ``train_logreg`` from the reference's init.
- ``train_multinomial_nb`` (dense) within 1e-6 and the same bits twice; the
  categorical NB (host code, copied) bitwise, and its ``predict_batch``
  with out-of-vocabulary values and ties; ``train_markov_chain`` with tied
  counts and empty rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pio_tpu.models.logreg as jlr
from pio_tpu.models import markov_chain as jmc
from pio_tpu.models import naive_bayes as jnb
from pio_tpu_torch.models import logreg as T
from pio_tpu_torch.models import markov_chain as tmc
from pio_tpu_torch.models import naive_bayes as tnb
from pio_tpu_torch.parallel.context import ComputeContext

N, D, C = 256, 16, 4
LR = 0.05  # the reference benchmark's learning rate


def bench_data(seed=0, n=N, d=D, c=C):
    """The reference benchmark's generator (bench.py ``_bench_
    classification``) at a small size: X ~ N(0, 1), y the argmax of X
    times a seeded normal map."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.argmax(X @ rng.normal(size=(d, c)), axis=1).astype(np.int32)
    return X, y


def reference_init(seed, d=D, c=C):
    """The reference's init (pio_tpu/models/logreg.py:181-186), as numpy."""
    w = 0.01 * jax.random.normal(jax.random.PRNGKey(seed), (d, c), jnp.float32)
    return {"w": np.array(w), "b": np.zeros(c, np.float32)}


def reference_fit(p0, wire, y, scales, iterations, reg):
    fit = jlr._jitted_fit(None, "data", 1, iterations, LR, reg)
    out = fit({k: jnp.asarray(v) for k, v in p0.items()},
              (jnp.asarray(wire),), jnp.asarray(y),
              jnp.ones(len(y), jnp.float32),
              None if scales is None else jnp.asarray(scales))
    return {k: np.asarray(v) for k, v in out.items()}


def port_fit(p0, wire, y, scales, iterations, reg):
    out = T._fit({k: torch.from_numpy(v) for k, v in p0.items()}, wire,
                 torch.from_numpy(y).long(), torch.ones(len(y)),
                 None if scales is None else torch.from_numpy(scales),
                 T.LogRegConfig(iterations=iterations, learning_rate=LR,
                                reg=reg))
    return {k: v.numpy() for k, v in out.items()}


def reference_wire(X, input_dtype):
    """The wire the reference's ``train_logreg`` ships (its ``_prep``),
    caught at its fit."""
    shipped = {}

    def fake_jitted_fit(mesh, axis, n_parts, *args):
        def fit(params, X_parts, ys, ms, scales):
            shipped["X"] = [np.asarray(p) for p in X_parts]
            return params
        return fit

    orig = jlr._jitted_fit
    jlr._jitted_fit = fake_jitted_fit
    try:
        model = jlr.train_logreg(None, X, np.zeros(len(X), np.int32), 2,
                                 jlr.LogRegConfig(input_dtype=input_dtype))
    finally:
        jlr._jitted_fit = orig
    (wire,) = shipped["X"]
    return wire, model.feature_scales


def port_wire(X, input_dtype):
    scales = T.feature_scales(X)
    return T.encode_wire(X, input_dtype,
                         scales if input_dtype == "int8" else None), scales


# ------------------------------------------------------------------ _fit
@pytest.mark.parametrize("iterations", [5, 100])
@pytest.mark.parametrize("reg", [0.0, 0.01])
def test_fit_float32_matches_reference(iterations, reg):
    # f32 gradients of the two packages differ by summation order (~1e-7
    # relative); Adam divides each by sqrt(v) + 1e-8, so where a gradient
    # is near 0 the steps drift further apart. Without reg the data are
    # separable and the weights keep growing (|w| ~ 2.2 after 100 steps):
    # measured 1.9e-6 after 5 steps, 9.5e-6 after 100 (4e-6 of the
    # largest weight), 6.7e-7 with reg. Limit: 1e-5 of the largest weight,
    # and at least 1e-5.
    X, y = bench_data()
    p0 = reference_init(0)
    want = reference_fit(p0, X, y, None, iterations, reg)
    got = port_fit(p0, torch.from_numpy(X), y, None, iterations, reg)
    for k in want:
        tol = 1e-5 * max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


#: bf16 and int8 after 5 steps: both packages multiply the same bf16
#: values exactly in f32, but the bf16-rounded weight gradient may round
#: one bf16 step (2^-8 of itself) apart where the two f32 sums straddle a
#: rounding boundary; Adam's step is at most ~lr, so one step apart moves
#: an update by ~lr·2^-8. Limit: 5 steps of that, 5·0.05·2^-8 = 9.8e-4
#: (measured 2.0e-6 to 4.9e-5).
LOW_PRECISION_TOL = 5 * LR * 2 ** -8


@pytest.mark.parametrize("input_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("reg", [0.0, 0.01])
def test_fit_low_precision_matches_reference(input_dtype, reg):
    X, y = bench_data(1)
    X[:, 3] *= 40.0  # a column on another scale than the rest
    wire, scales = reference_wire(X, input_dtype)
    p0 = reference_init(1)
    s = scales if input_dtype == "int8" else None
    want = reference_fit(p0, wire, y, s, 5, reg)
    t_wire, _ = port_wire(X, input_dtype)
    got = port_fit(p0, t_wire, y, s, 5, reg)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=LOW_PRECISION_TOL, err_msg=k)


def test_low_precision_rounds_the_weights_through_bf16():
    """The bf16 path differs from f32 arithmetic on the same values: the
    effective weights (and their gradient) round through bf16."""
    X, y = bench_data(2)
    p0 = reference_init(2)
    wire, _ = port_wire(X, "bfloat16")
    low = port_fit(p0, wire, y, None, 1, 0.0)
    f32 = port_fit(p0, wire.float(), y, None, 1, 0.0)
    assert not np.array_equal(low["w"], f32["w"])


# ----------------------------------------------------------------- wires
@pytest.mark.parametrize("input_dtype", ["bfloat16", "int8", "float32"])
def test_host_wire_bitwise(input_dtype):
    X, _ = bench_data(3, n=40, d=6)
    X[:, 2] = 0.0  # a constant column: its scale is 1
    X[:, 4] = 7.25  # a constant non-zero column
    X[5, 1] = np.float32(1.00390625)  # halfway between two bf16 values
    want, want_scales = reference_wire(X, input_dtype)
    got, scales = port_wire(X, input_dtype)
    np.testing.assert_array_equal(scales.view(np.uint32),
                                  want_scales.view(np.uint32))
    assert scales[2] == 1.0
    if input_dtype == "bfloat16":
        got_bits = got.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got_bits, want.view(np.uint16))
    else:
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_train_logreg_matches_reference(monkeypatch):
    """The whole trainer from the reference's init: the host side, one
    shipment, the fit and the pull; the stats keys."""
    X, y = bench_data(4)
    monkeypatch.setattr(T, "init_params", lambda d, c, seed: {
        k: torch.from_numpy(v) for k, v in reference_init(seed, d, c).items()})
    cfg = dict(iterations=20, learning_rate=LR, seed=3, input_dtype="int8")
    want = jlr.train_logreg(None, X, y, C, jlr.LogRegConfig(**cfg))
    stats = {}
    got = T.train_logreg(ComputeContext.local(device="cpu"), X, y, C,
                         T.LogRegConfig(**cfg), stats=stats)
    # int8 for 20 steps: as LOW_PRECISION_TOL, 20 steps of lr·2^-8
    tol = 20 * LR * 2 ** -8
    np.testing.assert_allclose(got.weights, want.weights, rtol=0, atol=tol)
    np.testing.assert_allclose(got.bias, want.bias, rtol=0, atol=tol)
    np.testing.assert_array_equal(got.feature_scales, want.feature_scales)
    assert got.n_classes == C and got.weights.dtype == np.float32
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
    assert set(stats) == {"pack_s", "h2d_s", "device_s", "d2h_s",
                          "wire_bytes", "n_stream"}
    assert stats["n_stream"] == 1
    assert stats["wire_bytes"] == N * D * 1 + N * 4  # int8 codes + labels


def test_train_logreg_rejects_an_unknown_wire():
    X, y = bench_data(5, n=8)
    with pytest.raises(ValueError, match="input_dtype"):
        T.train_logreg(ComputeContext.local(device="cpu"), X, y, C,
                       T.LogRegConfig(input_dtype="float16"))


def test_model_scoring_matches_reference():
    rng = np.random.default_rng(6)
    w, b = rng.normal(size=(D, C)).astype(np.float32), \
        rng.normal(size=C).astype(np.float32)
    X = rng.normal(size=(10, D)).astype(np.float32)
    got = T.LogRegModel(w, b, C)
    want = jlr.LogRegModel(w, b, C)
    np.testing.assert_array_equal(got.logits(X), want.logits(X))
    np.testing.assert_array_equal(got.predict(X), want.predict(X))
    np.testing.assert_array_equal(got.predict_proba(X), want.predict_proba(X))


@pytest.mark.cuda
def test_train_logreg_card_matches_cpu():
    """The card against the CPU from the same init: f32 products summed in
    another order; as the f32 parity test, 1e-5 of the largest weight."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    X, y = bench_data(7)
    for dtype in ("float32", "bfloat16", "int8"):
        cfg = T.LogRegConfig(iterations=100, learning_rate=LR,
                             input_dtype=dtype)
        card = T.train_logreg(ComputeContext.local(device="cuda"), X, y, C, cfg)
        cpu = T.train_logreg(ComputeContext.local(device="cpu"), X, y, C, cfg)
        tol = 1e-5 if dtype == "float32" else 100 * LOW_PRECISION_TOL
        np.testing.assert_allclose(
            card.weights, cpu.weights, rtol=0,
            atol=tol * max(1.0, float(np.abs(cpu.weights).max())))
        assert (card.predict(X) == cpu.predict(X)).mean() >= 0.98


# ---------------------------------------------------------- multinomial NB
def counts_data(seed=0, n=60, d=12, c=3):
    rng = np.random.default_rng(seed)
    X = rng.poisson(2.0, size=(n, d)).astype(np.float32)
    X[:, 5] = 0.0  # a feature no document has
    y = rng.integers(0, c, size=n).astype(np.int32)
    return X, y


@pytest.mark.parametrize("lambda_", [0.5, 1.0])
def test_train_multinomial_nb_matches_reference(lambda_):
    X, y = counts_data()
    want = jnb.train_multinomial_nb(X, y, 3, lambda_)
    got = tnb.train_multinomial_nb(X, y, 3, lambda_, device="cpu")
    np.testing.assert_allclose(got.log_prior, want.log_prior, atol=1e-6)
    np.testing.assert_allclose(got.log_theta, want.log_theta, atol=1e-6)
    np.testing.assert_array_equal(got.feature_scales, want.feature_scales)
    again = tnb.train_multinomial_nb(X, y, 3, lambda_, device="cpu")
    np.testing.assert_array_equal(again.log_theta.view(np.uint32),
                                  got.log_theta.view(np.uint32))
    np.testing.assert_array_equal(again.log_prior.view(np.uint32),
                                  got.log_prior.view(np.uint32))
    np.testing.assert_array_equal(got.predict(X), want.predict(X))


def test_train_multinomial_nb_rejects_negative_features():
    X, y = counts_data(1)
    X[3, 2] = -1.0
    with pytest.raises(ValueError, match="non-negative"):
        tnb.train_multinomial_nb(X, y, 3, device="cpu")


# ---------------------------------------------------------- categorical NB
def labeled_points(module, seed=0, n=40):
    rng = np.random.default_rng(seed)
    colors, sizes = ["red", "green", "blue"], ["s", "m", "l", "xl"]
    return [module.LabeledPoint(
        label=str(rng.choice(["buy", "skip", "wait"])),
        features=(str(rng.choice(colors)), str(rng.choice(sizes))))
        for _ in range(n)]


def test_categorical_nb_bitwise():
    got = tnb.train_naive_bayes(labeled_points(tnb))
    want = jnb.train_naive_bayes(labeled_points(jnb))
    assert got.labels == want.labels
    assert got.feature_vocabs == want.feature_vocabs
    np.testing.assert_array_equal(got.priors, want.priors)
    for g, w in zip(got.likelihoods, want.likelihoods):
        np.testing.assert_array_equal(g, w)
    for p, q in zip(labeled_points(tnb, 1, 10), labeled_points(jnb, 1, 10)):
        assert got.predict(p.features) == want.predict(q.features)
        assert got.log_score(p, -5.0) == want.log_score(q, -5.0)


def test_categorical_predict_batch_matches_reference():
    got = tnb.train_naive_bayes(labeled_points(tnb))
    want = jnb.train_naive_bayes(labeled_points(jnb))
    queries = [p.features for p in labeled_points(tnb, 2, 30)]
    queries += [("purple", "m"), ("red", "xxl"), ("purple", "xxl")]  # OOV
    assert got.predict_batch(queries, device="cpu") \
        == want.predict_batch(queries)
    assert got.predict_batch([], device="cpu") == []
    with pytest.raises(ValueError, match="positions"):
        got.predict_batch([("red",)], device="cpu")


def test_categorical_predict_batch_ties_go_to_the_lower_label():
    # two labels with equal priors and likelihoods: every score ties
    lik = [np.log(np.full((3, 2), 0.5, np.float32))]
    args = (["b", "a", "c"], [{"x": 0, "y": 1}],
            np.log(np.array([0.25, 0.25, 0.5], np.float32)))
    got = tnb.NaiveBayesModel(*args, [lik[0].copy()])
    want = jnb.NaiveBayesModel(*args, [lik[0].copy()])
    got.priors[2] = got.priors[0]
    want.priors[2] = want.priors[0]
    queries = [("x",), ("y",), ("z",)]
    assert got.predict_batch(queries, device="cpu") \
        == want.predict_batch(queries) == ["b", "b", "b"]


# ----------------------------------------------------------- Markov chain
TRANSITIONS = [
    (0, 1, 2.0), (0, 2, 2.0), (0, 3, 2.0), (0, 4, 1.0),  # a three-way tie
    (1, 0, 1.0), (1, 1, 1.0),  # fewer successors than k
    (2, 5, 3.0), (2, 5, 1.0), (2, 0, 4.0),  # repeated pair, a tie at 4
    # state 3 and 4 have no transitions: empty rows
    (5, 5, 0.5), (5, 4, 0.25), (5, 3, 0.25),
]


@pytest.mark.parametrize("top_k", [1, 3, 10])
def test_markov_chain_matches_reference(top_k):
    want = jmc.train_markov_chain(TRANSITIONS, 6, top_k)
    got = tmc.train_markov_chain(TRANSITIONS, 6, top_k, device="cpu")
    np.testing.assert_array_equal(got.top_indices, want.top_indices)
    np.testing.assert_allclose(got.top_probs, want.top_probs, atol=1e-6)
    assert got.top_indices.dtype == np.int32
    assert got.top_probs.dtype == np.float32
    for s in range(6):
        assert got.transitions_of(s) == pytest.approx(want.transitions_of(s))
    assert got.transitions_of(3) == []


def test_markov_chain_seeded_counts_match_reference():
    rng = np.random.default_rng(8)
    S = 40
    tr = [(int(a), int(b), float(c)) for a, b, c in zip(
        rng.integers(0, S, 600), rng.integers(0, S, 600),
        rng.integers(1, 4, 600))]  # small integer counts: many ties
    want = jmc.train_markov_chain(tr, S, 8)
    got = tmc.train_markov_chain(tr, S, 8, device="cpu")
    np.testing.assert_array_equal(got.top_indices, want.top_indices)
    np.testing.assert_allclose(got.top_probs, want.top_probs, atol=1e-6)


def test_markov_chain_checks_its_input():
    with pytest.raises(ValueError, match="positive"):
        tmc.train_markov_chain([], 0, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        tmc.train_markov_chain([(0, 6, 1.0)], 6, device="cpu")
    empty = tmc.train_markov_chain([], 3, 2, device="cpu")
    assert (empty.top_indices == -1).all() and (empty.top_probs == 0).all()
