"""Sequence recommender on one device: a causal transformer over user
event histories (SASRec-style next-item prediction).

Counterpart of ``pio_tpu/models/seqrec.py`` for ``mesh=None`` (the
reference's single-device path: no ``model``, ``seq`` or ``pipe`` axis,
l.369-371). The reference computes it as one XLA program (gathers, dots,
layer norm, softmax attention, the vocab logits' cross-entropy and
optax's Adam inside ``lax.scan``); no Pallas kernel is on the path, so
the port runs it as PyTorch ops in full f32 (TF32 stays off, as
PyTorch's default has it), a loop over the stacked layers in place of
the scan, and :mod:`pio_tpu_torch.models.adam`. Attention is
:func:`~pio_tpu_torch.parallel.ring.ring_attention` or
:func:`~pio_tpu_torch.parallel.ulysses.ulysses_attention` with no axis,
the reference's arithmetic in plain ops. The dp / sp / tp / ep / pp mesh
paths and the streamed epoch feed come with the multi-device slice
(ROADMAP A7).

Under a recording run (``obs/trainwatch.py``) each step's loss joins the
step stream through the lagged drain (no added kernel or synchronization
in a step), and the first dispatch of each chunk length counts as a
``train_step`` compile (``obs/devicewatch.py``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.models.adam import adam_init, adam_update, leaves, rebuild
from pio_tpu_torch.obs import devicewatch, trainwatch
from pio_tpu_torch.parallel.partition import (
    DeviceBudgetExceeded,
    assert_device_budget,
    device_budget_bytes,
)
from pio_tpu_torch.parallel.ring import ring_attention
from pio_tpu_torch.parallel.ulysses import ulysses_attention
from pio_tpu_torch.parallel.vocab import (
    vocab_parallel_lookup,
    vocab_parallel_target_gather,
)
from pio_tpu_torch.utils.numutil import round_up as _round_up
from pio_tpu_torch.workflow.checkpoint import (
    run_chunked_steps,
    state_fingerprint,
)

_ATTENTION = {"ring": ring_attention, "ulysses": ulysses_attention}


@dataclasses.dataclass(frozen=True)
class SeqRecConfig:
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    ffn: int = 128
    max_len: int = 64
    dropout: float = 0.0  # reserved; deterministic v1
    learning_rate: float = 1e-3
    steps: int = 200
    #: "ring" or "ulysses": on one device both are exact causal attention
    attention: str = "ring"
    seed: int = 0
    #: rows per optimizer step. 0 = full-batch (every step consumes the
    #: whole dataset); > 0 = minibatch steps over wrapped contiguous row
    #: blocks
    batch_size: int = 0
    #: epoch feed: "off" and "auto" stage the epoch on the device; "auto"
    #: raises DeviceBudgetExceeded where the reference would stream, and
    #: "on" (the streamed feed) raises (ROADMAP A7)
    stream: str = "auto"


@dataclasses.dataclass
class SeqRecModel:
    """Trained transformer: the layer-stacked params as tensors on the
    model's device (``load_models_for_instance`` puts a persisted model's
    tensors on its context's device)."""

    params: dict
    n_items: int
    config: SeqRecConfig
    _serve_cache: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_serve_cache"] = None
        state.pop("_serve_lock", None)
        return state

    def _serving(self):
        """(params without autograd history, the output table's
        transpose), built once per deploy lifetime."""
        cache = self._serve_cache
        if cache is None:
            with self.__dict__.setdefault("_serve_lock", threading.Lock()):
                cache = self._serve_cache
                if cache is None:
                    params = rebuild(self.params, [
                        t.detach() for t in leaves(self.params)])
                    cache = (params, params["emb"].T.contiguous())
                    self._serve_cache = cache
        return cache

    def next_item_scores(self, histories: np.ndarray) -> np.ndarray:
        """[B, T] padded histories (0 = pad) → [B, V] next-item scores, on
        the model's device. Scores from each row's last real position
        (position 0 for an empty row, as the reference's
        ``max(len - 1, 0)``)."""
        params, emb_t = self._serving()
        dev = emb_t.device
        seqs = torch.from_numpy(np.asarray(histories, np.int32)).to(dev)
        with torch.inference_mode():
            h = _trunk(params, seqs, self.config)
            lengths = (seqs > 0).sum(dim=1)
            pos = torch.clamp_min(lengths - 1, 0)
            last = h[torch.arange(h.shape[0], device=dev), pos]
            return (last @ emb_t).cpu().numpy()


def init_params(vocab: int, cfg: SeqRecConfig,
                generator: torch.Generator) -> dict:
    """Layer-stacked parameters (leading dim = n_layers) on the
    generator's device, with the reference's scales (l.121-152): N(0, 1)
    draws times ``1/√d_model``, ``1/√ffn`` for ``w2``; layer norms at
    gain 1 and bias 0, zero biases. The draws are torch's, not
    jax.random's."""
    dev = generator.device
    D, F, L = cfg.d_model, cfg.ffn, cfg.n_layers
    s = D ** -0.5

    def nrm(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    def ones(*shape):
        return torch.ones(shape, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    return {
        "emb": nrm((vocab, D), s),
        "pos": nrm((cfg.max_len, D), s),
        "blocks": {
            "ln1_g": ones(L, D),
            "ln1_b": zeros(L, D),
            "wq": nrm((L, D, D), s),
            "wk": nrm((L, D, D), s),
            "wv": nrm((L, D, D), s),
            "wo": nrm((L, D, D), s),
            "ln2_g": ones(L, D),
            "ln2_b": zeros(L, D),
            "w1": nrm((L, D, F), s),
            "b1": zeros(L, F),
            "w2": nrm((L, F, D), F ** -0.5),
            "b2": zeros(L, D),
        },
        "lnf_g": ones(D),
        "lnf_b": zeros(D),
    }


def _ln(x, g, b):
    """Layer norm with the reference's epsilon, 1e-6 on the biased
    variance (l.176-181; ``nn.LayerNorm``'s is 1e-5)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g + b


def _block(blk: dict, h: torch.Tensor, cfg: SeqRecConfig) -> torch.Tensor:
    """One pre-LN transformer block on ``[B, T, D]`` (reference
    l.184-238). ``blk`` leaves have no layer dim. The FFN's ``b2`` is
    added after the residual, as the reference does."""
    mb, t, _ = h.shape
    hd = cfg.d_model // cfg.n_heads
    attn_fn = _ATTENTION.get(cfg.attention)
    if attn_fn is None:
        raise ValueError(
            f"unknown attention mode {cfg.attention!r}; use ring/ulysses"
        )
    x = _ln(h, blk["ln1_g"], blk["ln1_b"])
    q = x @ blk["wq"]
    k = x @ blk["wk"]
    v = x @ blk["wv"]

    def split_heads(a):
        return a.reshape(mb, t, cfg.n_heads, hd)

    attn = attn_fn(split_heads(q), split_heads(k), split_heads(v),
                   axis=None, causal=True).reshape(mb, t, cfg.n_heads * hd)
    h = h + attn @ blk["wo"]
    x = _ln(h, blk["ln2_g"], blk["ln2_b"])
    f = torch.relu(x @ blk["w1"] + blk["b1"])
    return h + f @ blk["w2"] + blk["b2"]


def _embed(params: dict, seqs: torch.Tensor) -> torch.Tensor:
    """Item embedding + position encoding → [B, T, D] (l.241-250)."""
    x = vocab_parallel_lookup(params["emb"], seqs)
    return x + params["pos"][: seqs.shape[1]][None]


def _trunk(params: dict, seqs: torch.Tensor,
           cfg: SeqRecConfig) -> torch.Tensor:
    """Embed + every block + final LN → [B, T, D] (l.253-290): a loop
    over the stacked layers in place of the reference's ``lax.scan``."""
    h = _embed(params, seqs)
    blocks = params["blocks"]
    for layer in range(cfg.n_layers):
        h = _block({k: v[layer] for k, v in blocks.items()}, h, cfg)
    return _ln(h, params["lnf_g"], params["lnf_b"])


def _vocab_parallel_ce(h, emb, targets, mask, m_axis: Optional[str] = None):
    """Masked cross-entropy over the vocab logits (l.293-326, ``m_axis``
    None): ``(sum_ce, sum_mask)``. The ``[B, T, V]`` logits and their
    gradient exist whole on the device."""
    if m_axis is not None:
        raise NotImplementedError(
            f"vocab axis {m_axis!r}: the port runs one device; the "
            f"vocab-parallel cross-entropy is ROADMAP A7"
        )
    logits = torch.einsum("btd,vd->btv", h, emb)
    z = torch.logsumexp(logits, dim=-1)
    tgt = vocab_parallel_target_gather(logits, targets)
    ce = (z - tgt) * mask
    return ce.sum(), mask.sum()


def _loss(params: dict, seqs, targets, mask, cfg: SeqRecConfig):
    h = _trunk(params, seqs, cfg)
    ce, denom = _vocab_parallel_ce(h, params["emb"], targets, mask)
    return ce / torch.clamp_min(denom, 1.0)


def _train_step(params: dict, values, opt: dict, batch,
                cfg: SeqRecConfig):
    """One Adam step on ``batch = (seqs, targets, mask)``: ``values`` are
    the leaves of the tree ``params`` (whose structure alone is read).
    Returns the new leaves, the new optimizer state and the loss."""
    p = [v.detach().requires_grad_(True) for v in values]
    loss = _loss(rebuild(params, p), *batch, cfg)
    grads = torch.autograd.grad(loss, p)
    values, opt = adam_update(values, grads, opt, cfg.learning_rate)
    return values, opt, loss.detach()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_seqrec(
    mesh,
    sequences: np.ndarray,
    n_items: int,
    config: SeqRecConfig = SeqRecConfig(),
    checkpoint=None,
    checkpoint_every: int = 0,
    stats=None,
    device: DeviceLike = None,
) -> SeqRecModel:
    """Next-item training over padded histories, on ``device`` (CUDA
    unless the caller asks for the CPU).

    Args:
        mesh: must be None (one device); a mesh is ROADMAP A7.
        sequences: [n, T] int32, item ids ≥ 1, 0 = pad (right-padded).
        n_items: vocabulary size (ids are 1..n_items; row 0 = pad).
        checkpoint/checkpoint_every: optional
            :class:`~pio_tpu_torch.workflow.checkpoint.CheckpointManager`
            and snapshot interval in steps; resumes from the newest
            snapshot on restart.
        stats: optional dict: ``place_s`` (init and the epoch to the
            device), ``steps_s`` and ``n_stream`` (0), measured by
            synchronizing between phases.

    Raises:
        DeviceBudgetExceeded: the params do not fit
            ``PIO_TPU_DEVICE_BUDGET_BYTES``, or (``stream`` other than
            "off") the staged epoch does not fit beside them: with
            ``batch_size`` 0 as in the reference, and with ``batch_size``
            > 0 where the reference streams row spans.
    """
    cfg = config
    if mesh is not None:
        raise NotImplementedError(
            "train_seqrec over a mesh: the port runs one device; the "
            "dp / sp / tp / ep / pp paths are ROADMAP A7"
        )
    if cfg.stream not in ("auto", "on", "off"):
        raise ValueError(
            f"stream must be auto/on/off, got {cfg.stream!r}"
        )
    if cfg.stream == "on" and cfg.batch_size <= 0:
        raise ValueError(
            "stream='on' needs batch_size > 0 (full-batch steps consume "
            "the whole dataset every step — nothing to stream)"
        )
    if cfg.stream == "on":
        raise ValueError(
            "stream='on': the port has no streamed epoch feed (ROADMAP A7); "
            "use 'auto' or 'off'"
        )
    if cfg.attention not in _ATTENTION:
        raise ValueError(
            f"unknown attention mode {cfg.attention!r}; use ring/ulysses"
        )
    dev = resolve_device(device)

    seqs = np.asarray(sequences, np.int32)
    n, t = seqs.shape
    t_pad = min(t, cfg.max_len)
    buf = np.zeros((n, t_pad), np.int32)
    if t <= t_pad:
        buf[:n, :t] = seqs
    else:
        # keep each row's NEWEST t_pad events: serving scores the tail of
        # the history, so training on the head would skew heavy users
        # onto stale behavior
        for r in range(n):
            codes = seqs[r][seqs[r] > 0][-t_pad:]
            buf[r, : len(codes)] = codes
    seqs = buf

    if cfg.batch_size > 0:
        # minibatch steps: contiguous row blocks with wraparound so every
        # step slices a full batch
        B = min(cfg.batch_size, max(n, 1))
        reps = _round_up(max(n, B), B)
        seqs = np.resize(seqs[:max(n, 1)], (reps, t_pad))
        n_batches = reps // B
    else:
        B, n_batches = seqs.shape[0], 1

    # next-item targets: target[t] = seq[t+1]; last position unsupervised
    targets = np.zeros_like(seqs)
    targets[:, :-1] = seqs[:, 1:]
    mask = ((targets > 0) & (seqs > 0)).astype(np.float32)

    vocab = n_items + 1  # +1 for the pad row

    # placement accounting before anything lands on the device
    D, F, L, T = cfg.d_model, cfg.ffn, cfg.n_layers, cfg.max_len
    params_nbytes = 4 * (
        vocab * D + T * D + 2 * D
        + L * (4 * D + 4 * D * D + 2 * D * F + F + D)
    )
    assert_device_budget(
        params_nbytes, 1, "seqrec params (single-device placement)"
    )
    # seqs + targets (int32) + mask (float32)
    staged_nbytes = 12 * seqs.shape[0] * t_pad
    budget = device_budget_bytes()
    over = budget > 0 and params_nbytes + staged_nbytes > budget
    if over and cfg.stream != "off":
        raise DeviceBudgetExceeded(
            f"seqrec staged epoch ({staged_nbytes} B) does not fit beside "
            f"the params ({params_nbytes} B) under "
            f"PIO_TPU_DEVICE_BUDGET_BYTES={budget}"
            + ("; the reference streams row spans here, and the port's "
               "streamed feed is ROADMAP A7 (stream='off' stages it all "
               "the same)" if cfg.batch_size > 0 else
               "; set batch_size > 0 so the feed can stream row spans "
               "(ROADMAP A7)")
        )
    if stats is not None:
        stats["n_stream"] = 0

    t0 = time.monotonic()
    # drawn on a seeded CPU generator whatever the device, so that the
    # card and the CPU train from the same init
    g = torch.Generator(device="cpu")
    g.manual_seed(cfg.seed)
    init = init_params(vocab, cfg, g)
    params = rebuild(init, [v.to(dev) for v in leaves(init)])
    seqs_d, targets_d, mask_d = (
        torch.from_numpy(a).to(dev) for a in (seqs, targets, mask))
    if stats is not None:
        _sync(dev)
        stats["place_s"] = time.monotonic() - t0
        t0 = time.monotonic()

    trainwatch.begin_algo(
        "seqrec", total_steps=cfg.steps, n_batches=n_batches,
        per_device_bytes=params_nbytes,
    )
    # the lagged loss drain: None (no work) unless a run is recording
    losses = trainwatch.lagged_losses(dev, B, cfg.steps)

    def chunk_fn(state, n_steps):
        step0, params, opt = state
        values = leaves(params)
        # compile attribution: the first dispatch of each chunk length
        key = (("seqrec", "staged", B, int(n_steps)) if cfg.batch_size > 0
               else ("seqrec", "full", int(n_steps)))
        with devicewatch.compile_span("train_step", key=key):
            for i in range(n_steps):
                if cfg.batch_size > 0:
                    start = ((step0 + i) % n_batches) * B
                    batch = tuple(a[start:start + B]
                                  for a in (seqs_d, targets_d, mask_d))
                else:
                    batch = (seqs_d, targets_d, mask_d)
                values, opt, loss = _train_step(params, values, opt, batch,
                                                cfg)
                if losses is not None:
                    losses.step(loss)
        return step0 + n_steps, rebuild(params, values), opt

    # steps excluded: resume with a different total must still match;
    # stream normalized: it does not shape the trained state
    fingerprint = state_fingerprint(
        "seqrec", dataclasses.replace(cfg, steps=0, stream="auto"),
        n_items, seqs.shape, int(seqs.sum()),
    )
    state = (0, params, adam_init(params))
    state = run_chunked_steps(
        state, cfg.steps, chunk_fn,
        checkpoint=checkpoint, checkpoint_every=checkpoint_every,
        fingerprint=fingerprint,
    )
    fitted = state[1]
    if stats is not None:
        _sync(dev)
        stats["steps_s"] = time.monotonic() - t0
    fitted["emb"] = fitted["emb"][: n_items + 1]
    if losses is not None:
        losses.close()
    return SeqRecModel(params=fitted, n_items=n_items, config=cfg)
