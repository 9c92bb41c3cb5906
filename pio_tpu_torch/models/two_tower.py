"""Two-tower retrieval model, in-batch softmax, over the data and model
axes.

Counterpart of ``pio_tpu/models/two_tower.py``: a user tower and an item
tower, each ``embed → relu MLP → L2-normalized vector``; the score is
their dot product; training is the in-batch sampled-softmax contrastive
loss (each row's positive item, the other rows' items as negatives) under
Adam.

The reference computes this as one XLA program (gathers, two dots, a
logsumexp, optax's Adam inside ``lax.scan``, under ``shard_map`` with a
mesh); no Pallas kernel is on the path, so the port runs it as PyTorch
ops: ``F.embedding`` for the gather (its CUDA backward sums in a fixed
order, so a resumed run gives the same bits), ``torch.matmul`` for the
dots in full f32 (TF32 stays off, as PyTorch's default has it), and
:mod:`pio_tpu_torch.models.adam`.

Over a mesh (a ``DeviceMesh`` of the process group, one rank a device)
the same code runs on every rank with the collectives of
``parallel/collectives.py``:

- **data**: a step's batch splits into contiguous rank-major chunks; the
  item vectors are all-gathered for the in-batch negatives (labels
  offset by ``axis_index(data)·b_loc``), the loss is summed over the axis
  and divided by the global batch, and the gradients are summed over the
  axis after the backward;
- **model**: the tables shard by rows (vocab-parallel lookups), ``w1`` by
  columns and ``w2`` by rows (Megatron), under ``rules_for("two_tower")``.

Every rank draws the whole init on a seeded CPU generator and keeps its
shards, so a group of one gives the single-device bits. The vector
tables are computed for each data rank's rows and gathered to every
rank.

**The epoch feed.** The id arrays are staged on the device whole, or
streamed a span of batches at a time through
:func:`~pio_tpu_torch.parallel.stream.stream_feed` (``stream="on"``, or
``"auto"`` where the staged ids do not fit
``PIO_TPU_DEVICE_BUDGET_BYTES`` beside the params, as the reference
chooses): ``n_stream`` spans of ``PIO_TPU_TRAIN_STREAM_MB``, raised to
fit the budget's headroom, shipped two ahead. Each rank ships only its
own ``b_loc`` rows of each batch. The streamed run replays the staged
batch order, so it gives the staged run's bits.

Under a recording run (``obs/trainwatch.py``) each step's loss joins the
step stream through the lagged drain (no added kernel or synchronization
in a step), and the first dispatch of each chunk length counts as a
``train_step`` compile (``obs/devicewatch.py``).
"""

from __future__ import annotations

import dataclasses

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
    assert_device_budget,
    device_budget_bytes,
    local_shards,
    match_partition_rules,
    per_device_nbytes,
    rules_for,
)
from pio_tpu_torch.parallel.stream import (
    epoch_spans,
    n_spans,
    span_bounds,
    stream_feed,
)
from pio_tpu_torch.parallel.vocab import vocab_parallel_lookup
from pio_tpu_torch.utils.numutil import round_up as _round_up
from pio_tpu_torch.workflow.checkpoint import (
    rank_checkpoint,
    run_chunked_steps,
    state_fingerprint,
)


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    embed_dim: int = 64
    hidden: int = 128
    out_dim: int = 64
    temperature: float = 20.0  # logit scale on the unit sphere
    learning_rate: float = 1e-3
    steps: int = 200
    batch_size: int = 256
    seed: int = 0
    #: "bfloat16" rounds the vector tables through bf16 (the reference's
    #: readback wire); the tables stay float32 tensors
    table_wire: str = "float32"
    #: epoch feed: "off" stages the id arrays on the device, "on" streams
    #: them (parallel/stream.py), "auto" streams where the staged ids do
    #: not fit the device budget beside the params
    stream: str = "auto"


@dataclasses.dataclass
class TwoTowerModel:
    """Trained towers: unit vector tables, tensors on the model's device.

    Serving top-N is one ``[B, D] @ [D, V_i]`` product, as for ALS.
    """

    user_vectors: torch.Tensor  # [n_users, D] unit rows
    item_vectors: torch.Tensor  # [n_items, D] unit rows
    config: TwoTowerConfig

    def scores(self, user_rows) -> np.ndarray:
        """``user_rows @ item_vectors.T`` on the model's device, to host."""
        rows = torch.as_tensor(user_rows, dtype=torch.float32,
                               device=self.item_vectors.device)
        return (rows @ self.item_vectors.T).cpu().numpy()


def init_tower(vocab: int, cfg: TwoTowerConfig,
               generator: torch.Generator) -> dict:
    """One tower's parameters on the generator's device, with the
    reference's scales (l.87-100): N(0, 1) draws times ``1/√embed_dim``
    for the table and ``w1``, ``1/√hidden`` for ``w2``; zero biases. The
    draws are torch's, not jax.random's."""
    dev = generator.device

    def nrm(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    return {
        "emb": nrm((vocab, cfg.embed_dim), cfg.embed_dim ** -0.5),
        "w1": nrm((cfg.embed_dim, cfg.hidden), cfg.embed_dim ** -0.5),
        "b1": torch.zeros(cfg.hidden, device=dev),
        "w2": nrm((cfg.hidden, cfg.out_dim), cfg.hidden ** -0.5),
        "b2": torch.zeros(cfg.out_dim, device=dev),
    }


def init_params(vu: int, vi: int, cfg: TwoTowerConfig,
                generator: torch.Generator) -> dict:
    """Both towers, user then item, drawn from ``generator``."""
    return {"user": init_tower(vu, cfg, generator),
            "item": init_tower(vi, cfg, generator)}


def param_specs(params: dict) -> dict:
    """Partition specs of both towers from ``rules_for("two_tower")``:
    the tables by rows over ``model``, ``w1`` and ``b1`` by columns,
    ``w2`` by rows (reference ``_tower_specs``)."""
    return match_partition_rules(rules_for("two_tower"), params,
                                 on_unmatched="error")


def _tower_forward(params: dict, ids: torch.Tensor,
                   axis: Axis = None) -> torch.Tensor:
    """Vocab-parallel embed → tp relu MLP → unit vectors (reference
    l.114-135); ``params`` are this rank's blocks over ``axis``."""
    x = copy_to(vocab_parallel_lookup(params["emb"], ids, axis), axis)
    h = torch.relu(x @ params["w1"] + params["b1"])  # [B, H/m] columns
    out = psum(h @ params["w2"], axis) + params["b2"]  # close the rows
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return out / torch.clamp_min(norm, 1e-6)


def _contrastive_loss(user_p: dict, item_p: dict, uids: torch.Tensor,
                      iids: torch.Tensor, cfg: TwoTowerConfig,
                      d_axis: Axis = None,
                      m_axis: Axis = None) -> torch.Tensor:
    """In-batch softmax cross-entropy at ``cfg.temperature`` (reference
    l.138-168) over this rank's ``b_loc`` rows: the item vectors are
    all-gathered over ``d_axis`` as negatives, row b's label is column
    ``axis_index(d_axis)·b_loc + b``, and the loss is summed over the axis
    and divided by the global batch. The label column is read with
    ``take_along_dim``, whose backward writes one value a row."""
    u = _tower_forward(user_p, uids, m_axis)
    v = _tower_forward(item_p, iids, m_axis)
    b_loc = u.shape[0]
    v_all = all_gather(v, d_axis)
    labels = axis_index(d_axis) * b_loc + torch.arange(b_loc,
                                                       device=u.device)
    logits = cfg.temperature * (u @ v_all.T)
    logz = torch.logsumexp(logits, dim=-1)
    ce = logz - torch.take_along_dim(logits, labels[:, None], dim=1)[:, 0]
    return psum(ce.sum(), d_axis) / (b_loc * axis_size(d_axis))


def _train_step(params: dict, values, opt: dict, ub: torch.Tensor,
                ib: torch.Tensor, cfg: TwoTowerConfig, d_axis: Axis = None,
                m_axis: Axis = None):
    """One Adam step on this rank's rows ``(ub, ib)`` of the batch:
    ``values`` are the leaves of the tree ``params`` (whose structure
    alone is read). The gradients are summed over ``d_axis`` (each rank's
    backward gives its rows' part). Returns the new leaves, the new
    optimizer state and the batch's loss."""
    p = [t.detach().requires_grad_(True) for t in values]
    tree = rebuild(params, p)
    loss = _contrastive_loss(tree["user"], tree["item"], ub, ib, cfg,
                             d_axis, m_axis)
    grads = all_reduce_flat(torch.autograd.grad(loss, p), [d_axis])
    values, opt = adam_update(values, grads, opt, cfg.learning_rate)
    return values, opt, loss.detach()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _vectors(tower: dict, vocab: int, d_axis: Axis, m_axis: Axis,
             dev: torch.device) -> torch.Tensor:
    """The tower's unit vectors of ids ``[0, vocab)``: each data rank
    computes its contiguous span of the ids (padded to a data multiple),
    and the spans are gathered to every rank (reference ``vectors``)."""
    n = axis_size(d_axis)
    per = _round_up(vocab, n) // n
    lo = axis_index(d_axis) * per
    ids = torch.arange(lo, lo + per, device=dev)
    return all_gather(_tower_forward(tower, ids, m_axis), d_axis)


def train_two_tower(
    mesh,
    user_ids: np.ndarray,
    item_ids: np.ndarray,
    n_users: int,
    n_items: int,
    config: TwoTowerConfig = TwoTowerConfig(),
    checkpoint=None,
    checkpoint_every: int = 0,
    stats=None,
    device: DeviceLike = None,
) -> TwoTowerModel:
    """Train on positive (user, item) pairs; returns unit vector tables on
    ``device`` (CUDA unless the caller asks for the CPU; under a mesh,
    this rank's device), the same on every rank.

    Args:
        mesh: a ``DeviceMesh`` of the process group (its ``data`` and
            ``model`` axes are used; ``seq`` and ``pipe`` must be 1), or
            None for one device. Every rank of the mesh calls this with
            the same arguments.
        user_ids/item_ids: [n_pairs] int positive interaction pairs.
        checkpoint/checkpoint_every: optional
            :class:`~pio_tpu_torch.workflow.checkpoint.CheckpointManager`
            and snapshot interval in steps; resumes from the newest
            snapshot on restart (each rank under its own ``rank<r>``
            directory when the mesh has more than one).
        stats: optional dict receiving the phase split, measured by
            synchronizing between phases: ``place_s`` (init and the ids to
            the device), ``steps_s``, ``tables_d2h_s`` (the vector tables
            computed and rounded to ``table_wire``: they stay on the
            device, so no copy to the host is in it) and ``n_stream``.
            A streamed run adds the feed's phases, serialized to measure
            them (``h2d_s``, ``device_s``, ``h2d_bytes``, ``encode_s``).

    Raises:
        DeviceBudgetExceeded: this rank's params do not fit
            ``PIO_TPU_DEVICE_BUDGET_BYTES``. An epoch that does not fit
            beside them streams instead (``stream="auto"``).
    """
    cfg = config
    if cfg.table_wire not in ("float32", "bfloat16"):
        raise ValueError(
            f"table_wire must be float32/bfloat16, got {cfg.table_wire!r}"
        )
    if cfg.stream not in ("auto", "on", "off"):
        raise ValueError(
            f"stream must be auto/on/off, got {cfg.stream!r}"
        )
    dev = resolve_device(device)
    d_axis = mesh_axis_group(mesh, "data")
    m_axis = mesh_axis_group(mesh, "model")
    n_data, n_model = axis_size(d_axis), axis_size(m_axis)

    # vocab rounded up so the tables shard evenly; batch to a data multiple
    vu = _round_up(max(n_users, 1), n_model)
    vi = _round_up(max(n_items, 1), n_model)
    batch = _round_up(min(cfg.batch_size, len(user_ids)), n_data)
    b_loc = batch // n_data
    lo = axis_index(d_axis) * b_loc  # this rank's rows of every batch

    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(len(user_ids))
    uids = np.asarray(user_ids, np.int32)[perm]
    iids = np.asarray(item_ids, np.int32)[perm]
    # wraparound so every step slices a full batch
    n_pairs = len(uids)
    reps = _round_up(max(n_pairs, batch), batch)
    uids = np.resize(uids, reps)
    iids = np.resize(iids, reps)
    n_batches = reps // batch

    t0 = monotonic_s()
    # drawn whole on a seeded CPU generator whatever the device and the
    # rank, so that the card, the CPU and every rank start from one init
    g = torch.Generator(device="cpu")
    g.manual_seed(cfg.seed)
    init = init_params(vu, vi, cfg, g)
    specs = param_specs(init)

    # placement accounting before anything lands on the device
    params_nbytes = per_device_nbytes(mesh, init, specs)
    staged_nbytes = 2 * reps * 4  # uids + iids
    assert_device_budget(
        params_nbytes, 1, "two_tower sharded params" if mesh is not None
        else "two_tower params (single-device placement)"
    )
    budget = device_budget_bytes()
    streamed = cfg.stream == "on" or (
        cfg.stream == "auto" and budget > 0
        and params_nbytes + staged_nbytes > budget)
    n_stream = (n_spans(staged_nbytes, staged_nbytes, params_nbytes,
                        n_batches) if streamed else 0)

    local = local_shards(mesh, init, specs)
    params = rebuild(local, [t.to(dev) for t in leaves(local)])
    if not streamed:
        uids_d = torch.from_numpy(uids).to(dev)
        iids_d = torch.from_numpy(iids).to(dev)
    if stats is not None:
        _sync(dev)
        stats["place_s"] = monotonic_s() - t0
        stats["n_stream"] = n_stream
        t0 = monotonic_s()

    trainwatch.begin_algo(
        "two_tower", total_steps=cfg.steps, n_batches=n_batches,
        streamed=streamed, n_stream=n_stream,
        per_device_bytes=params_nbytes,
    )
    # the lagged loss drain: None (no work) unless a run is recording
    losses = trainwatch.lagged_losses(dev, batch, cfg.steps)

    def run_steps(state, n, rows_of):
        """``n`` steps on ``state`` (``[step0, params, opt]``, updated in
        place: a streamed span must not hold the previous span's
        parameters while it steps); step i trains on this rank's rows
        ``rows_of(step0, i)`` (the user ids, the item ids)."""
        step0, opt = state[0], state[2]
        values = leaves(state[1])
        skeleton = rebuild(state[1], [None] * len(values))
        state[1] = state[2] = None
        for i in range(n):
            ub, ib = rows_of(step0, i)
            values, opt, loss = _train_step(
                skeleton, values, opt, ub, ib, cfg, d_axis, m_axis)
            if losses is not None:
                losses.step(loss)
        state[:] = [step0 + n, rebuild(skeleton, values), opt]
        return state

    if streamed:
        bounds = span_bounds(n_batches, n_stream)
        # this rank's rows of every batch, as [n_batches, b_loc] views
        u_rows = uids.reshape(n_batches, batch)[:, lo:lo + b_loc]
        i_rows = iids.reshape(n_batches, batch)[:, lo:lo + b_loc]
        span_bytes = max(b - a for a, b in zip(bounds, bounds[1:])) \
            * b_loc * 4

        def chunk_fn(state, n):
            work = epoch_spans(state[0], n, n_batches, bounds)
            carry = list(state)
            return tuple(stream_feed(
                work,
                encode=lambda span: (u_rows[span[0]:span[1]],
                                     i_rows[span[0]:span[1]]),
                # step j of a span reads the span's batch j
                dispatch=lambda st, d, i: run_steps(
                    st, work[i][1] - work[i][0],
                    lambda _s, j: (d[0][j], d[1][j])),
                init_carry=lambda: carry,
                lookahead=2, stats=stats, device=dev,
                stage_bytes=(span_bytes, span_bytes),
            ))
    else:
        def staged_rows(step0, i):
            start = ((step0 + i) % n_batches) * batch + lo
            return uids_d[start:start + b_loc], iids_d[start:start + b_loc]

        def chunk_fn(state, n):
            # compile attribution: the first dispatch of each chunk length
            with devicewatch.compile_span(
                "train_step", key=("two_tower", "chunk", batch, int(n))
            ):
                return tuple(run_steps(list(state), n, staged_rows))

    # steps + table_wire + stream excluded: none shapes the trained state,
    # so resuming with another total or wire still matches the identity
    fingerprint = state_fingerprint(
        "two_tower",
        dataclasses.replace(cfg, steps=0, table_wire="float32",
                            stream="auto"),
        n_users, n_items,
        reps, int(uids.sum()), int(iids.sum()),
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
        t0 = monotonic_s()

    with torch.no_grad():
        uv = _vectors(fitted["user"], vu, d_axis, m_axis, dev)
        iv = _vectors(fitted["item"], vi, d_axis, m_axis, dev)
        if cfg.table_wire == "bfloat16":
            uv = uv.to(torch.bfloat16).float()
            iv = iv.to(torch.bfloat16).float()
    if stats is not None:
        _sync(dev)
        stats["tables_d2h_s"] = monotonic_s() - t0
        stats["table_wire"] = cfg.table_wire
    if losses is not None:
        # the last chunks' losses, read once the tables are in flight
        losses.close()
    return TwoTowerModel(
        user_vectors=uv[:n_users].contiguous(),
        item_vectors=iv[:n_items].contiguous(), config=cfg,
    )
