"""Sequence recommender: a causal transformer over user event histories
(SASRec-style next-item prediction), over the data, seq, model and pipe
axes.

Counterpart of ``pio_tpu/models/seqrec.py``. The reference computes it
as one XLA program (gathers, dots, layer norm, softmax attention, the
vocab logits' cross-entropy and optax's Adam inside ``lax.scan``, under
``shard_map`` with a mesh); no Pallas kernel is on the path, so the port
runs it as PyTorch ops in full f32 (TF32 stays off, as PyTorch's default
has it), a loop over the stacked layers in place of the scan, and
:mod:`pio_tpu_torch.models.adam`.

Over a mesh (a ``DeviceMesh`` of the process group, one rank a device)
every rank runs the same code with the collectives of
``parallel/collectives.py``:

- **data**: the rows split into contiguous rank-major chunks;
- **seq**: the positions split likewise; attention is
  :func:`~pio_tpu_torch.parallel.ring.ring_attention` or
  :func:`~pio_tpu_torch.parallel.ulysses.ulysses_attention` over the
  axis, and the position table is read at the rank's offset;
- **model**: heads and the FFN hidden shard (Megatron: ``copy_to`` into
  the column-parallel ``wq``/``wk``/``wv``/``w1``, ``psum`` out of the
  row-parallel ``wo``/``w2``), the item table by rows (vocab-parallel
  lookup and cross-entropy);
- **pipe**: the layer stack splits into stages run by
  :func:`~pio_tpu_torch.parallel.pipeline.pipeline_apply`.

The loss's cross-entropy and mask are summed over data and seq, and
the gradients over the same axes after the backward. Every rank draws
the whole init on a seeded CPU generator and keeps its shards, so a
group of one gives the single-device bits. The trained parameters are
gathered whole to every rank.

**The epoch feed.** With ``batch_size > 0`` the epoch's ``(seqs,
targets, mask)`` (12 bytes a position) are staged on the device whole,
or streamed a span of batches at a time through
:func:`~pio_tpu_torch.parallel.stream.stream_feed` (``stream="on"``, or
``"auto"`` where the staged epoch does not fit
``PIO_TPU_DEVICE_BUDGET_BYTES`` beside the params, as the reference
chooses), each rank shipping its own block of rows and positions. The
streamed run replays the staged batch order, so it gives the staged
run's bits. Full-batch steps (``batch_size`` 0) have nothing to stream.

Under a recording run (``obs/trainwatch.py``) each step's loss joins the
step stream through the lagged drain (no added kernel or synchronization
in a step), and the first dispatch of each chunk length counts as a
``train_step`` compile (``obs/devicewatch.py``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.models.adam import adam_init, adam_update, leaves, rebuild
from pio_tpu_torch.obs import devicewatch, trainwatch
from pio_tpu_torch.obs.metrics import monotonic_s
from pio_tpu_torch.parallel.collectives import (
    Axis,
    all_gather,
    all_reduce_flat,
    axis_index,
    axis_size,
    copy_to,
    psum,
)
from pio_tpu_torch.parallel.mesh import mesh_axis_group
from pio_tpu_torch.parallel.partition import (
    DeviceBudgetExceeded,
    assert_device_budget,
    device_budget_bytes,
    gather_shards,
    local_shards,
    match_partition_rules,
    per_device_nbytes,
    rules_for,
)
from pio_tpu_torch.parallel.pipeline import pipeline_apply
from pio_tpu_torch.parallel.stream import (
    epoch_spans,
    n_spans,
    span_bounds,
    stream_feed,
)
from pio_tpu_torch.parallel.ring import ring_attention
from pio_tpu_torch.parallel.ulysses import ulysses_attention
from pio_tpu_torch.parallel.vocab import (
    vocab_parallel_lookup,
    vocab_parallel_target_gather,
)
from pio_tpu_torch.utils.numutil import round_up as _round_up
from pio_tpu_torch.workflow.checkpoint import (
    rank_checkpoint,
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
    #: sequence-parallel attention: "ring" (K/V blocks rotate, O(T/n)
    #: memory) or "ulysses" (two all-to-alls, whole-T scores for H/n
    #: heads; the per-device head count must divide by the seq axis)
    attention: str = "ring"
    seed: int = 0
    #: rows per optimizer step. 0 = full-batch (every step consumes the
    #: whole dataset); > 0 = minibatch steps over wrapped contiguous row
    #: blocks
    batch_size: int = 0
    #: epoch feed: "off" and "auto" stage the epoch on the device; "auto"
    #: raises DeviceBudgetExceeded where the reference would stream, and
    #: "on" (the streamed feed) raises (ROADMAP §A.3)
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


def _block(blk: dict, h: torch.Tensor, cfg: SeqRecConfig,
           m_axis: Axis = None, s_axis: Axis = None) -> torch.Tensor:
    """One pre-LN transformer block on this rank's ``[mb, T_loc, D]``
    (reference l.184-238). ``blk`` leaves have no layer dim and hold this
    rank's heads and FFN hidden over ``m_axis``; attention runs over
    ``s_axis``. The FFN's ``b2`` is added after the residual, as the
    reference does."""
    mb, t_loc, _ = h.shape
    heads_loc = cfg.n_heads // axis_size(m_axis)
    hd = cfg.d_model // cfg.n_heads
    attn_fn = _ATTENTION.get(cfg.attention)
    if attn_fn is None:
        raise ValueError(
            f"unknown attention mode {cfg.attention!r}; use ring/ulysses"
        )
    x = copy_to(_ln(h, blk["ln1_g"], blk["ln1_b"]), m_axis)
    # separate projections: a fused [D, 3D] column shard would split at
    # arbitrary offsets and scramble the q/k/v boundaries across ranks
    q = x @ blk["wq"]
    k = x @ blk["wk"]
    v = x @ blk["wv"]

    def split_heads(a):
        return a.reshape(mb, t_loc, heads_loc, hd)

    attn = attn_fn(split_heads(q), split_heads(k), split_heads(v),
                   axis=s_axis, causal=True).reshape(mb, t_loc,
                                                     heads_loc * hd)
    h = h + psum(attn @ blk["wo"], m_axis)  # close the row-parallel wo
    x = copy_to(_ln(h, blk["ln2_g"], blk["ln2_b"]), m_axis)
    f = torch.relu(x @ blk["w1"] + blk["b1"])
    return h + psum(f @ blk["w2"], m_axis) + blk["b2"]


def _embed(params: dict, seqs: torch.Tensor, m_axis: Axis = None,
           s_axis: Axis = None) -> torch.Tensor:
    """Vocab-parallel item embedding + the position encoding at this
    rank's global positions → ``[mb, T_loc, D]`` (l.241-250)."""
    x = vocab_parallel_lookup(params["emb"], seqs, m_axis)
    t_loc = seqs.shape[1]
    t_off = axis_index(s_axis) * t_loc
    return x + params["pos"][t_off:t_off + t_loc][None]


def _apply_stack(stack: dict, h: torch.Tensor, cfg: SeqRecConfig,
                 m_axis: Axis, s_axis: Axis) -> torch.Tensor:
    """Every layer of a stacked block tree, in order: a loop in place of
    the reference's ``lax.scan``."""
    for layer in range(stack["wq"].shape[0]):
        h = _block({k: v[layer] for k, v in stack.items()}, h, cfg, m_axis,
                   s_axis)
    return h


def _trunk(params: dict, seqs: torch.Tensor, cfg: SeqRecConfig,
           m_axis: Axis = None, s_axis: Axis = None,
           p_axis: Axis = None) -> torch.Tensor:
    """Embed + every block + final LN → ``[mb, T_loc, D]`` (l.253-291).
    With a pipe axis the rank's stage of the stack runs in
    :func:`pipeline_apply`, the local rows cut into ``n_pipe``
    microbatches where they divide (one otherwise)."""
    h = _embed(params, seqs, m_axis, s_axis)
    blocks = params["blocks"]

    def stage(stack, x):
        return _apply_stack(stack, x, cfg, m_axis, s_axis)

    if p_axis is None:
        h = stage(blocks, h)
    else:
        n_pipe = axis_size(p_axis)
        mb = h.shape[0]
        m = n_pipe if mb % n_pipe == 0 else 1
        hm = h.reshape(m, mb // m, *h.shape[1:])
        h = pipeline_apply(blocks, hm, stage, axis=p_axis).reshape(h.shape)
    return _ln(h, params["lnf_g"], params["lnf_b"])


def _vocab_parallel_ce(h, emb, targets, mask, m_axis: Axis = None):
    """Masked cross-entropy over the vocab logits sharded over ``m_axis``
    (l.293-326): ``(sum_ce, sum_mask)`` of this rank's positions. The
    stability shift is the detached max gathered over the axis (it
    cancels in the log-sum-exp), the exps are summed over the axis, and
    the target's logit comes from the one shard that holds it. Without
    an axis the same arithmetic on the whole vocabulary (torch's
    ``logsumexp`` forward: ``log(Σ exp(x - max)) + max``). Each rank's
    ``[B, T_loc, V_local]`` logits and their gradient exist whole on its
    device."""
    h = copy_to(h, m_axis)
    logits = torch.einsum("btd,vd->btv", h, emb)
    gmax = all_gather(logits.detach().amax(dim=-1)[None],
                      m_axis).amax(dim=0)
    sumexp = psum(torch.exp(logits - gmax[..., None]).sum(dim=-1), m_axis)
    z = torch.log(sumexp) + gmax
    tgt = vocab_parallel_target_gather(logits, targets, m_axis)
    ce = (z - tgt) * mask
    return ce.sum(), mask.sum()


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """The process groups of a mesh's four axes (None: no such axis;
    ``pipe`` is None unless it has more than one rank, as the reference's
    ``p_axis``)."""

    data: Axis = None
    seq: Axis = None
    model: Axis = None
    pipe: Axis = None

    @staticmethod
    def of(mesh) -> "MeshAxes":
        if mesh is None:
            return MeshAxes()
        pipe = mesh_axis_group(mesh, "pipe")
        return MeshAxes(
            data=mesh_axis_group(mesh, "data"),
            seq=mesh_axis_group(mesh, "seq"),
            model=mesh_axis_group(mesh, "model"),
            pipe=pipe if axis_size(pipe) > 1 else None,
        )


def _loss(params: dict, seqs, targets, mask, cfg: SeqRecConfig,
          axes: MeshAxes = MeshAxes()):
    """The global masked mean cross-entropy (reference ``global_loss``,
    l.510-535): this rank's sums, summed over data and seq."""
    h = _trunk(params, seqs, cfg, axes.model, axes.seq, axes.pipe)
    ce, denom = _vocab_parallel_ce(h, params["emb"], targets, mask,
                                   axes.model)
    ce = psum(psum(ce, axes.data), axes.seq)
    denom = psum(psum(denom, axes.data), axes.seq)
    return ce / torch.clamp_min(denom, 1.0)


def _train_step(params: dict, values, opt: dict, batch,
                cfg: SeqRecConfig, axes: MeshAxes = MeshAxes()):
    """One Adam step on this rank's ``batch = (seqs, targets, mask)``:
    ``values`` are the leaves of the tree ``params`` (whose structure
    alone is read). The gradients are summed over data and seq (each
    rank's backward gives its rows' and positions' part). Returns the new
    leaves, the new optimizer state and the loss."""
    p = [v.detach().requires_grad_(True) for v in values]
    loss = _loss(rebuild(params, p), *batch, cfg, axes)
    grads = all_reduce_flat(torch.autograd.grad(loss, p),
                            [axes.data, axes.seq])
    values, opt = adam_update(values, grads, opt, cfg.learning_rate)
    return values, opt, loss.detach()


def param_specs(params: dict) -> dict:
    """Partition specs from ``rules_for("seqrec")``: the item table by
    rows over ``model``, heads and FFN hidden over ``model``, the layer
    stack over ``pipe`` (reference ``param_specs``)."""
    return match_partition_rules(rules_for("seqrec"), params,
                                 on_unmatched="error")


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
    unless the caller asks for the CPU; under a mesh, this rank's
    device).

    Args:
        mesh: a ``DeviceMesh`` of the process group (``data``, ``seq``,
            ``model`` and ``pipe`` all honored), or None for one device.
            Every rank of the mesh calls this with the same arguments.
        sequences: [n, T] int32, item ids ≥ 1, 0 = pad (right-padded).
        n_items: vocabulary size (ids are 1..n_items; row 0 = pad).
        checkpoint/checkpoint_every: optional
            :class:`~pio_tpu_torch.workflow.checkpoint.CheckpointManager`
            and snapshot interval in steps; resumes from the newest
            snapshot on restart (each rank under its own ``rank<r>``
            directory when the mesh has more than one).
        stats: optional dict: ``place_s`` (init and the epoch to the
            device), ``steps_s`` and ``n_stream``, measured by
            synchronizing between phases; a streamed run adds the feed's
            phases, serialized to measure them (``h2d_s``, ``device_s``,
            ``h2d_bytes``, ``encode_s``).

    Returns the model with the whole parameters on every rank.

    Raises:
        ValueError: the mesh does not fit the model (reference l.381-407):
            heads or FFN hidden not divisible by the model axis, layers by
            the pipe axis, the per-device heads by the seq axis under
            ulysses, or ``T`` padded to the seq axis past ``max_len``.
        DeviceBudgetExceeded: this rank's params do not fit
            ``PIO_TPU_DEVICE_BUDGET_BYTES``, or with ``batch_size`` 0 (and
            ``stream`` other than "off") the staged epoch does not fit
            beside them, as in the reference (reference l.488-494); with
            ``batch_size`` > 0 such an epoch streams.
    """
    cfg = config
    if cfg.stream not in ("auto", "on", "off"):
        raise ValueError(
            f"stream must be auto/on/off, got {cfg.stream!r}"
        )
    if cfg.stream == "on" and cfg.batch_size <= 0:
        raise ValueError(
            "stream='on' needs batch_size > 0 (full-batch steps consume "
            "the whole dataset every step — nothing to stream)"
        )
    axes = MeshAxes.of(mesh)
    n_data, n_seq = axis_size(axes.data), axis_size(axes.seq)
    n_model, n_pipe = axis_size(axes.model), axis_size(axes.pipe)
    if cfg.n_heads % n_model:
        raise ValueError("n_heads must divide by the model axis")
    if cfg.ffn % n_model:
        raise ValueError("ffn must divide by the model axis")
    if cfg.n_layers % n_pipe:
        raise ValueError("n_layers must divide by the pipe axis")
    if cfg.attention not in _ATTENTION:
        raise ValueError(
            f"unknown attention mode {cfg.attention!r}; use ring/ulysses"
        )
    if cfg.attention == "ulysses" and (cfg.n_heads // n_model) % n_seq:
        raise ValueError(
            "ulysses attention needs the per-device head count "
            f"(n_heads {cfg.n_heads} / model axis {n_model} = "
            f"{cfg.n_heads // n_model}) divisible by the seq axis "
            f"({n_seq}); use ring attention or adjust n_heads"
        )
    dev = resolve_device(device)

    seqs = np.asarray(sequences, np.int32)
    n, t = seqs.shape
    t_pad = _round_up(min(t, cfg.max_len), n_seq)
    if t_pad > cfg.max_len:
        raise ValueError(
            f"max_len {cfg.max_len} not a multiple of seq axis {n_seq}"
        )
    buf = np.zeros((_round_up(n, n_data), t_pad), np.int32)
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
        B = _round_up(min(cfg.batch_size, max(n, 1)), n_data)
        reps = _round_up(max(n, B), B)
        seqs = np.resize(seqs[:max(n, 1)], (reps, t_pad))
        n_batches = reps // B
    else:
        B, n_batches = seqs.shape[0], 1

    # next-item targets: target[t] = seq[t+1]; last position unsupervised
    targets = np.zeros_like(seqs)
    targets[:, :-1] = seqs[:, 1:]
    mask = ((targets > 0) & (seqs > 0)).astype(np.float32)
    # this rank's rows of every batch and its positions
    b_loc, t_loc = B // n_data, t_pad // n_seq
    row0 = axis_index(axes.data) * b_loc
    t0_ = axis_index(axes.seq) * t_loc

    vocab = _round_up(n_items + 1, n_model)  # +1 for the pad row

    t0 = monotonic_s()
    # drawn whole on a seeded CPU generator whatever the device and the
    # rank, so that the card, the CPU and every rank start from one init
    g = torch.Generator(device="cpu")
    g.manual_seed(cfg.seed)
    init = init_params(vocab, cfg, g)
    specs = param_specs(init)

    # placement accounting before anything lands on the device
    params_nbytes = per_device_nbytes(mesh, init, specs)
    assert_device_budget(
        params_nbytes, 1, "seqrec sharded params" if mesh is not None
        else "seqrec params (single-device placement)"
    )
    # seqs + targets (int32) + mask (float32), sharded over data × seq
    staged_nbytes = -(-12 * seqs.shape[0] * t_pad // (n_data * n_seq))
    budget = device_budget_bytes()
    over = budget > 0 and params_nbytes + staged_nbytes > budget
    streamed = cfg.batch_size > 0 and (
        cfg.stream == "on" or (cfg.stream == "auto" and over))
    if over and cfg.batch_size <= 0 and cfg.stream != "off":
        raise DeviceBudgetExceeded(
            f"seqrec staged epoch ({staged_nbytes} B/device) does not fit "
            f"beside the params ({params_nbytes} B/device) under "
            f"PIO_TPU_DEVICE_BUDGET_BYTES={budget}; set batch_size > 0 "
            f"so the feed can stream row spans"
        )
    # the span count from the whole epoch's bytes, its headroom from
    # this device's block, as the reference counts them
    n_stream = (n_spans(12 * seqs.shape[0] * t_pad, staged_nbytes,
                        params_nbytes, n_batches) if streamed else 0)
    if stats is not None:
        stats["n_stream"] = n_stream

    local = local_shards(mesh, init, specs)
    params = rebuild(local, [v.to(dev) for v in leaves(local)])
    if not streamed:
        # full-batch: this rank's rows once; minibatch: every row, sliced
        # to the rank's rows a step
        rows = (slice(row0, row0 + b_loc) if cfg.batch_size <= 0
                else slice(None))
        seqs_d, targets_d, mask_d = (
            torch.from_numpy(np.ascontiguousarray(a[rows, t0_:t0_ + t_loc]))
            .to(dev) for a in (seqs, targets, mask))
    if stats is not None:
        _sync(dev)
        stats["place_s"] = monotonic_s() - t0
        t0 = monotonic_s()

    trainwatch.begin_algo(
        "seqrec", total_steps=cfg.steps, n_batches=n_batches,
        streamed=streamed, n_stream=n_stream,
        per_device_bytes=params_nbytes,
    )
    # the lagged loss drain: None (no work) unless a run is recording
    losses = trainwatch.lagged_losses(dev, B, cfg.steps)

    def run_steps(state, n_steps, batch_of):
        """``n_steps`` steps on ``state`` (``[step0, params, opt]``,
        updated in place: a streamed span must not hold the previous
        span's parameters while it steps); step i trains on this rank's
        block ``batch_of(step0, i)`` of (seqs, targets, mask)."""
        step0, opt = state[0], state[2]
        values = leaves(state[1])
        skeleton = rebuild(state[1], [None] * len(values))
        state[1] = state[2] = None
        for i in range(n_steps):
            values, opt, loss = _train_step(skeleton, values, opt,
                                            batch_of(step0, i), cfg, axes)
            if losses is not None:
                losses.step(loss)
        state[:] = [step0 + n_steps, rebuild(skeleton, values), opt]
        return state

    if streamed:
        bounds = span_bounds(n_batches, n_stream)
        # this rank's block of every batch, as [n_batches, b_loc, t_loc]
        blocks = tuple(
            a.reshape(n_batches, B, t_pad)[:, row0:row0 + b_loc,
                                           t0_:t0_ + t_loc]
            for a in (seqs, targets, mask))
        span_rows = max(b - a for a, b in zip(bounds, bounds[1:]))

        def chunk_fn(state, n_steps):
            work = epoch_spans(state[0], n_steps, n_batches, bounds)
            carry = list(state)
            return tuple(stream_feed(
                work,
                encode=lambda span: tuple(blk[span[0]:span[1]]
                                          for blk in blocks),
                # step j of a span reads the span's batch j
                dispatch=lambda st, d, i: run_steps(
                    st, work[i][1] - work[i][0],
                    lambda _s, j: tuple(a[j] for a in d)),
                init_carry=lambda: carry,
                lookahead=2, stats=stats, device=dev,
                stage_bytes=(span_rows * b_loc * t_loc * 4,) * 3,
            ))
    else:
        def batch_of(step0, i):
            if cfg.batch_size <= 0:
                return seqs_d, targets_d, mask_d
            start = ((step0 + i) % n_batches) * B + row0
            return tuple(a[start:start + b_loc]
                         for a in (seqs_d, targets_d, mask_d))

        def chunk_fn(state, n_steps):
            # compile attribution: the first dispatch of each chunk length
            key = (("seqrec", "staged", B, int(n_steps))
                   if cfg.batch_size > 0 else ("seqrec", "full",
                                               int(n_steps)))
            with devicewatch.compile_span("train_step", key=key):
                return tuple(run_steps(list(state), n_steps, batch_of))

    # steps excluded: resume with a different total must still match;
    # stream normalized: it does not shape the trained state
    fingerprint = state_fingerprint(
        "seqrec", dataclasses.replace(cfg, steps=0, stream="auto"),
        n_items, seqs.shape, int(seqs.sum()),
        None if mesh is None else tuple(mesh.shape),
    )
    state = (0, params, adam_init(params))
    state = run_chunked_steps(
        state, cfg.steps, chunk_fn,
        checkpoint=rank_checkpoint(checkpoint, mesh),
        checkpoint_every=checkpoint_every, fingerprint=fingerprint,
    )
    fitted = state[1]
    if stats is not None:
        _sync(dev)
        stats["steps_s"] = monotonic_s() - t0
    with torch.no_grad():
        fitted = gather_shards(mesh, fitted, specs,
                               rebuild(init, [v.shape for v in leaves(init)]))
    fitted["emb"] = fitted["emb"][: n_items + 1]
    if losses is not None:
        losses.close()
    return SeqRecModel(params=fitted, n_items=n_items, config=cfg)
