"""Softmax (logistic) regression — the classification template's trainer.

Counterpart of ``pio_tpu/models/logreg.py``. :class:`LogRegModel` scores on
the host in numpy, as the reference's does. :func:`train_logreg` is
full-batch Adam on one device: a Python loop of steps where the reference
has one compiled ``lax.scan`` (as :func:`~pio_tpu_torch.models.mlp.
train_mlp`). The features cross to the device once, in the wire type the
config names:

- ``float32``: the features as they are;
- ``bfloat16``: cast on the host (round to nearest even), 2 B a feature;
- ``int8``: symmetric per-column codes ``clip(rint(x/s), -127, 127)``,
  1 B a feature, whose ``[D]`` scales fold into the weights every step
  (``X@W = X_q@(s⊙W)``), so the learned weights apply to raw features.

The reference's bf16 and int8 logits are f32 sums of exact bf16 products
(``preferred_element_type=float32``), and the gradient of the bf16 weights
is rounded to bf16 on its way back. The port computes the same: both
operands widen to f32 (a product of two bf16 values is exact in f32), the
effective weights round through bf16 in the graph, so autograd rounds their
gradient the same way. The codes widen to f32 once, on the device, after
the wire has crossed.

In a process group (``ComputeContext.create`` under the env contract) the
fit is data-parallel: each rank ships and trains on its rows of the batch
padded to a world multiple, and the gradients are summed over the ranks
before every step. Deliberate deviation: the wire always ships in one
piece (the reference streams it above ``PIO_TPU_LOGREG_STREAM_MB``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pio_tpu_torch.obs.metrics import monotonic_s
from pio_tpu_torch.parallel import distributed

#: name → parameter, in the reference's pytree order
Params = Dict[str, torch.Tensor]

INPUT_DTYPES = ("bfloat16", "float32", "int8")


@dataclasses.dataclass(frozen=True)
class LogRegConfig:
    iterations: int = 100
    learning_rate: float = 0.1
    reg: float = 0.0  # L2 on weights (not bias)
    seed: int = 0
    #: feature wire type: "float32" (exact), "bfloat16" or "int8"
    input_dtype: str = "float32"


@dataclasses.dataclass
class LogRegModel:
    """weights [D, C] float32, bias [C] float32, plus class count.

    ``feature_scales`` [D] float32 are the per-column symmetric
    quantization scales of the training features: the int8 serving wire
    folds them into the resident weights
    (:mod:`pio_tpu_torch.server.residency`).
    """

    weights: np.ndarray
    bias: np.ndarray
    n_classes: int
    feature_scales: Optional[np.ndarray] = None

    def logits(self, X: np.ndarray) -> np.ndarray:
        return X.astype(np.float32) @ self.weights + self.bias

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Argmax class codes for a [B, D] feature matrix."""
        return np.argmax(self.logits(X), axis=1).astype(np.int32)

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        z = self.logits(X)
        z = z - z.max(axis=1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=1, keepdims=True)


def feature_scales(X: np.ndarray) -> np.ndarray:
    """Per-column int8 scales ``max|x|/127`` (1 for an all-zero column)."""
    s = np.abs(X).max(axis=0)
    return np.where(s == 0.0, 1.0, s / 127.0).astype(np.float32)


def encode_wire(X: np.ndarray, input_dtype: str,
                scales: Optional[np.ndarray]) -> torch.Tensor:
    """The host side of the shipment: ``[N, D]`` f32 features → a CPU
    tensor of the wire type (the reference's ``_prep``)."""
    if input_dtype == "bfloat16":
        return torch.from_numpy(X).to(torch.bfloat16)
    if input_dtype == "int8":
        return torch.from_numpy(
            np.clip(np.rint(X / scales), -127, 127).astype(np.int8))
    return torch.from_numpy(X)


def init_params(d: int, n_classes: int, seed: int) -> Params:
    """``0.01·N(0,1)`` weights and a zero bias, on the CPU.

    Drawn from a seeded CPU generator whatever the device, so that the
    card and the CPU start from the same weights. The draws are torch's,
    not jax.random's."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    return {
        "w": 0.01 * torch.randn((d, n_classes), generator=gen),
        "b": torch.zeros(n_classes),
    }


def _loss(params: Params, X: torch.Tensor, y: torch.Tensor,
          mask: torch.Tensor, scales: Optional[torch.Tensor],
          low_precision: bool, reg: float, mask_sum=None) -> torch.Tensor:
    """Masked mean softmax cross-entropy plus ``reg·Σw²`` (reference
    l.49-66). ``X`` is f32; with ``low_precision`` the effective weights
    round through bf16, as the reference's ``w.astype(bf16)``.
    ``mask_sum`` is the mean's denominator (``Σ mask`` when None)."""
    w = params["w"]
    if scales is not None:
        w = w * scales[:, None]
    if low_precision:
        w = w.to(torch.bfloat16).float()
    ce = F.cross_entropy(torch.matmul(X, w) + params["b"], y,
                         reduction="none")
    if mask_sum is None:
        mask_sum = torch.sum(mask)
    data_loss = torch.sum(ce * mask) / mask_sum
    return data_loss + reg * torch.sum(params["w"] ** 2)


def _fit(params0: Params, X: torch.Tensor, y: torch.Tensor,
         mask: torch.Tensor, scales: Optional[torch.Tensor],
         config: LogRegConfig, group=None) -> Params:
    """``config.iterations`` full-batch Adam steps from ``params0`` (the
    reference's ``fit``), on the tensors' device; ``params0`` is not
    changed.

    ``X`` is the shipped wire: f32, bf16 or int8 codes (then ``scales``
    [D] are their column scales). Adam with optax's defaults (β 0.9 /
    0.999, ε 1e-8 added to ``√v̂``), as in :mod:`~pio_tpu_torch.models.mlp`.
    With ``group``, ``X`` is this rank's rows and the step is
    data-parallel as in :func:`~pio_tpu_torch.models.mlp._fit`: the global
    ``Σ mask`` divides, rank 0's loss carries the L2 term, and the
    gradients are summed over the ranks before every step.
    """
    low_precision = X.dtype in (torch.bfloat16, torch.int8)
    Xf = X.float()  # exact for bf16 values and int8 codes
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params0.items()}
    opt = torch.optim.Adam(params.values(), lr=config.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    reg, mask_sum = config.reg, None
    if group is not None:
        mask_sum = distributed.all_reduce_sum(torch.sum(mask), group)
        if torch.distributed.get_rank(group) != 0:
            reg = 0.0
    for _ in range(config.iterations):
        opt.zero_grad()
        _loss(params, Xf, y, mask, scales, low_precision, reg,
              mask_sum).backward()
        if group is not None:
            for p in params.values():
                distributed.all_reduce_sum(p.grad, group)
        opt.step()
    return {k: v.detach() for k, v in params.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_logreg(
    ctx,
    X: np.ndarray,
    y: np.ndarray,
    n_classes: int,
    config: LogRegConfig = LogRegConfig(),
    stats: Optional[dict] = None,
) -> LogRegModel:
    """Full-batch softmax regression with Adam, on ``ctx.device``.

    Args:
        ctx: ComputeContext (its device).
        X: [N, D] features (host numpy).
        y: [N] int class codes.
        n_classes: C.
        stats: optional dict that receives the run's phases, each ended
            by a device synchronise: ``pack_s`` (host encode), ``h2d_s``,
            ``device_s``, ``d2h_s``, plus ``wire_bytes`` and ``n_stream``
            (always 1: one shipment).
    """
    if config.input_dtype not in INPUT_DTYPES:
        raise ValueError(
            f"input_dtype must be bfloat16/float32/int8, "
            f"got {config.input_dtype!r}"
        )
    X = np.ascontiguousarray(X, np.float32)
    y = np.ascontiguousarray(y, np.int32)
    n, d = X.shape
    dev = ctx.device

    scales = feature_scales(X)
    wire_scales = scales if config.input_dtype == "int8" else None
    t0 = monotonic_s()
    wire = encode_wire(X, config.input_dtype, wire_scales)
    if stats is not None:
        stats["pack_s"] = monotonic_s() - t0
    t0 = monotonic_s()
    # one piece a rank: this rank's rows of the batch padded to a world
    # multiple, mask 0 on the padding (every row without a group; the
    # reference streams only off the mesh, l.231)
    lo, hi, n_pad = distributed.rows_of(n, ctx.rank, ctx.world_size)
    if n_pad > n:
        wire = torch.cat([wire, wire.new_zeros((n_pad - n, d))])
    y_pad = np.zeros(n_pad, np.int32)
    y_pad[:n] = y
    X_dev = wire[lo:hi].to(dev)
    y_dev = torch.from_numpy(y_pad[lo:hi]).to(dev).long()
    mask = (torch.arange(lo, hi, device=dev) < n).float()
    s_dev = (torch.from_numpy(wire_scales).to(dev)
             if wire_scales is not None else None)
    params0 = {k: v.to(dev) for k, v in
               init_params(d, n_classes, config.seed).items()}
    if stats is not None:
        _sync(dev)
        stats["h2d_s"] = monotonic_s() - t0
        # what crosses the link: the features and the int32 labels (the
        # mask is made on the device)
        stats["wire_bytes"] = int(wire.numel() * wire.element_size()
                                  + y.nbytes)
        stats["n_stream"] = 1
        t0 = monotonic_s()
    fitted = _fit(params0, X_dev, y_dev, mask, s_dev, config,
                  group=ctx.group)
    if stats is not None:
        _sync(dev)
        stats["device_s"] = monotonic_s() - t0
        t0 = monotonic_s()
    # one pull of both arrays: the bias rides behind the weights
    wb = torch.cat([fitted["w"], fitted["b"][None, :]]).cpu().numpy()
    if stats is not None:
        stats["d2h_s"] = monotonic_s() - t0
    return LogRegModel(
        weights=np.ascontiguousarray(wb[:d]), bias=wb[d].copy(),
        n_classes=n_classes, feature_scales=scales,
    )
