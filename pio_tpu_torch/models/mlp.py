"""Sparse-input MLP classifier — the text-classification model.

Counterpart of ``pio_tpu/models/mlp.py``: hidden activations are
``relu(embedding_bag(W_in, ids, tfidf) + b_in)`` — the hand-written CUDA
embedding-bag kernel on the card — followed by a dense f32 head
(``torch.matmul``; TF32 is left off, as PyTorch's default is).

:func:`train_mlp` is full-batch Adam: a Python loop of steps where the
reference has one compiled ``lax.scan``. Each step's backward through the
embedding bag is the bag-scatter kernel, launched from one
:class:`~pio_tpu_torch.ops.embedding.BagPlan` built before the first
step. In a process group (``ComputeContext.create`` under the env
contract) it is data-parallel, as the reference's mesh path: each rank
runs its rows of the batch through the forward and the bag scatter with
its own plan, and the gradients are summed over the ranks before each
step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.ops import embedding as _embedding
from pio_tpu_torch.ops.embedding import embedding_bag
from pio_tpu_torch.parallel import distributed

#: name → parameter, in the reference's pytree order
Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    hidden: int = 128
    iterations: int = 200
    learning_rate: float = 1e-2
    reg: float = 0.0  # L2 on the dense head
    seed: int = 0


class MLPModel(nn.Module):
    """Trained sparse-input MLP, its parameters resident on ``device``.

    The parameters are copied to the device once, here: the query server
    calls :meth:`logits` per request, and re-shipping the ``[V, H]`` table
    each time would put a multi-MB host→device copy on the hot path (the
    reference keeps a ``_serve_cache`` for the same reason). ``w_in`` and
    the others may be numpy arrays or tensors; the model never aliases
    them. :mod:`pio_tpu_torch.workflow.core_workflow` persists its
    parameters as host numpy arrays, and loads them on the device the
    loading context names.
    """

    def __init__(self, w_in, b_in, w_out, b_out, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        for name, value in (("w_in", w_in), ("b_in", b_in),
                            ("w_out", w_out), ("b_out", b_out)):
            if isinstance(value, torch.Tensor):
                value = value.detach().to(dev, torch.float32, copy=True)
            else:
                value = torch.tensor(np.asarray(value, np.float32), device=dev)
            self.register_buffer(name, value)
        H = self.w_in.shape[-1]
        if self.w_in.dim() != 2 or self.b_in.shape != (H,) \
                or self.w_out.shape[0] != H \
                or self.b_out.shape != (self.w_out.shape[-1],):
            raise ValueError(
                f"inconsistent MLP shapes: w_in {tuple(self.w_in.shape)}, "
                f"b_in {tuple(self.b_in.shape)}, w_out "
                f"{tuple(self.w_out.shape)}, b_out {tuple(self.b_out.shape)}"
            )

    @property
    def n_features(self) -> int:
        return self.w_in.shape[0]

    @property
    def n_classes(self) -> int:
        return self.w_out.shape[1]

    @property
    def device(self) -> torch.device:
        return self.w_in.device

    def forward(self, ids: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """[B, L] int32 ids + f32 weights on the model's device → [B, C]."""
        return _logits(dict(self.named_buffers()), ids, weights)

    def logits(self, ids: np.ndarray, weights: np.ndarray) -> np.ndarray:
        """[B, L] numpy bags → [B, C] numpy logits."""
        ids = np.ascontiguousarray(ids, np.int32)
        weights = np.ascontiguousarray(weights, np.float32)
        # the kernel assumes in-range ids: check on the host, before the copy
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_features):
            raise ValueError(
                f"bag ids must lie in [0, {self.n_features}); got "
                f"[{ids.min()}, {ids.max()}]"
            )
        with torch.inference_mode():
            z = self(
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(weights).to(self.device),
            )
            return z.cpu().numpy()

    def predict(self, ids: np.ndarray, weights: np.ndarray) -> np.ndarray:
        return np.argmax(self.logits(ids, weights), axis=1).astype(np.int32)

    def predict_proba(self, ids: np.ndarray, weights: np.ndarray):
        """Row softmax of :meth:`logits`, on the host in numpy."""
        z = self.logits(ids, weights)
        z = z - z.max(axis=1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=1, keepdims=True)


def _logits(params: Params, ids, weights, plan=None,
            bag=embedding_bag) -> torch.Tensor:
    h = torch.relu(bag(params["w_in"], ids, weights, plan) + params["b_in"])
    return torch.matmul(h, params["w_out"]) + params["b_out"]


def _loss(params: Params, ids, weights, y, mask, reg: float, plan=None,
          bag=embedding_bag, mask_sum=None) -> torch.Tensor:
    """Masked mean cross-entropy plus ``reg · Σ w_out²`` (reference
    l.157-167). ``mask_sum`` is the mean's denominator (``Σ mask`` when
    None); a data-parallel rank passes the global one, and its
    ``reg`` 0 unless it is rank 0, so the ranks' losses sum to the
    reference's."""
    ce = F.cross_entropy(_logits(params, ids, weights, plan, bag), y,
                         reduction="none")
    if mask_sum is None:
        mask_sum = torch.sum(mask)
    data_loss = torch.sum(ce * mask) / mask_sum
    return data_loss + reg * torch.sum(params["w_out"] ** 2)


def init_params(V: int, H: int, C: int, generator: torch.Generator) -> Params:
    """The reference's init (l.146-154): normal draws scaled by ``1/√V``
    (``w_in``) and ``1/√H`` (``w_out``), zero biases, on the generator's
    device. The draws are torch's, not jax.random's."""
    dev = generator.device
    return {
        "w_in": torch.randn(V, H, generator=generator, device=dev)
        * (1.0 / math.sqrt(max(V, 1))),
        "b_in": torch.zeros(H, device=dev),
        "w_out": torch.randn(H, C, generator=generator, device=dev)
        * (1.0 / math.sqrt(H)),
        "b_out": torch.zeros(C, device=dev),
    }


def _fit(
    params0: Params,
    ids: torch.Tensor,
    weights: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    config: MLPConfig,
    bag=embedding_bag,
    group=None,
) -> Tuple[Params, torch.Tensor]:
    """``config.iterations`` full-batch Adam steps from ``params0`` (the
    reference's ``fit``), on the tensors' device; ``params0`` is not
    changed.

    With ``group`` (a process group), the bags are this rank's rows of
    the padded batch: its loss is ``Σ ce·mask`` over them divided by the
    global ``Σ mask`` (one ``all_reduce`` before the first step), the L2
    term rides rank 0's loss, and the gradients are ``all_reduce``d (sum)
    before the one Adam step every rank takes — the reference's
    data-parallel ``jit`` over a sharded batch (l.100-196). The returned
    losses are this rank's shares. At world size 1 every collective is an
    identity and the steps are the single-device ones.

    Adam with optax's defaults (β 0.9 / 0.999, ε 1e-8 added to ``√v̂``):
    torch's and optax's update formulas agree. The bag plan of the
    backward is built once, here. ``bag`` is the embedding bag the loss
    runs, ``(table, ids, weights, plan) → [B, D]``. Returns the fitted
    parameters and the loss before each step (f32 ``[iterations]``, on the
    device; no step waits for the host).
    """
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    plan = _embedding.bag_plan(ids, weights, params["w_in"].shape[0])
    opt = torch.optim.Adam(params.values(), lr=config.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    losses = torch.empty(config.iterations, device=ids.device)
    reg, mask_sum = config.reg, None
    if group is not None:
        mask_sum = distributed.all_reduce_sum(torch.sum(mask), group)
        if torch.distributed.get_rank(group) != 0:
            reg = 0.0
    for step in range(config.iterations):
        opt.zero_grad()
        loss = _loss(params, ids, weights, y, mask, reg, plan, bag,
                     mask_sum)
        loss.backward()
        if group is not None:
            for p in params.values():
                distributed.all_reduce_sum(p.grad, group)
        opt.step()
        losses[step] = loss.detach()
    return {k: v.detach() for k, v in params.items()}, losses


def train_mlp(
    ctx,
    ids: np.ndarray,
    weights: np.ndarray,
    y: np.ndarray,
    n_features: int,
    n_classes: int,
    config: MLPConfig = MLPConfig(),
) -> MLPModel:
    """Full-batch Adam on the sparse-input MLP, on ``ctx.device``.

    Args:
        ctx: ComputeContext (its device; the init draws from
            ``ctx.generator(config.seed)``).
        ids/weights: [N, L] packed bags (``pack_bags`` layout).
        y: [N] int class codes.
        n_features: embedding-table rows V (vectorizer.n_features).
        n_classes: C.
    """
    dev = ctx.device
    # data-parallel: this rank's rows of the batch padded to a world
    # multiple, mask 0 on the padding (every row without a group)
    shard = ctx.shard_batch({
        "ids": np.ascontiguousarray(ids, np.int32),
        "w": np.ascontiguousarray(weights, np.float32),
        "y": np.asarray(y, np.int64),
    })
    ids_t, w_t, y_t, mask = (shard[k] for k in ("ids", "w", "y", "mask"))
    params0 = init_params(n_features, config.hidden, n_classes,
                          ctx.generator(config.seed))
    fitted, _ = _fit(params0, ids_t, w_t, y_t, mask, config,
                     group=ctx.group)
    return MLPModel(fitted["w_in"], fitted["b_in"], fitted["w_out"],
                    fitted["b_out"], device=dev)
