"""Device-resident serving scorers for the linear classifiers.

Counterpart of ``pio_tpu/server/residency.py``. A
:class:`ResidentLinearScorer` places a model's serving parameters on the
device once, when the query server is built; every dispatch reuses them
instead of scoring the host mirror:

* **Resident params** — ``W`` (the training scales folded in on the int8
  wire) and ``b`` cross to the device once. :meth:`~ResidentLinearScorer.
  retire` drops them, and a retired scorer refuses to serve.
* **Standing output tensors** — one preallocated ``[B, C]`` float32
  output tensor per batch size (bucket); a dispatch writes ``x·W + b``
  into it (``torch.addmm(..., out=...)``). The tensor rides in a
  one-shot :class:`OutputBuffer` guard, the counterpart of the reference's
  ``DonatedBuffer``: a dispatch takes it out of the pool under the lock
  and puts it back only once its codes are on the host, so two concurrent
  dispatches of one size never share a tensor (the second is a miss and
  allocates its own). A dispatch that found a standing tensor is a
  **hit**, one that allocated is a **miss**. CUDA has no donation, so
  ``backendReclaims`` stays 0.
* **int8 feature wire** — with ``wire="int8"`` query features are
  quantized on the host with the TRAINING-side per-column scales
  (``x_q = clip(rint(x / s), -127, 127)``) and the scales fold into the
  resident weights (``X @ W = X_q @ (s ⊙ W)``), so a request ships one
  byte per feature.

Knobs (:mod:`pio_tpu_torch.utils.knobs`): ``PIO_TPU_DEVICE_RESIDENT``
(``1`` on, ``0`` off, ``auto``: on when the serving device is CUDA) and
``PIO_TPU_SERVE_WIRE`` (``int8`` / ``float32`` / ``auto``: int8 whenever
the model carries training scales).

A scorer may carry the template's ``query_factory`` (a Query from a
dequantized feature row, so the batch lane's drainer can serve a packed
int8 frame) and ``result_factory`` (a class code straight to the
template's result, so a packed query skips the dequantize, Query and
re-quantize round trip). A packed query answered so skips the template's
``serving.serve`` as well: attach a ``result_factory`` only where that
serving passes results through unchanged (``FirstServing``). The query
server serves packed frames only from a scorer that has both.

**Mesh placement** — with ``mesh`` (a tuple of two or more devices, the
query server's serving mesh) ``W`` row-shards over the tuple on the
contraction dimension D, ``D/n`` rows a device, as the reference's
``P(axis, None)`` placement does (l.226-260). A dispatch slices the
batch's columns to each shard, runs one product a shard on its device,
sums the partial logits on the first device in shard order and adds the
bias there (the reference closes with a ``psum``), then takes the argmax.
A D that does not divide the tuple is placed whole on the first device
and sets ``mesh_fallback``, as the reference does; that is still a
placement on the mesh's first device, not the host. The products are
``torch.mm``/``addmm``: the reference computes them with XLA, outside
any Pallas kernel.

Placement checks ``PIO_TPU_DEVICE_BUDGET_BYTES`` (the params over the
shard count, or whole on one device) and raises
:class:`~pio_tpu_torch.parallel.partition.DeviceBudgetExceeded`.
Failpoints: ``scorer.h2d.ship`` before the batch crosses to the device,
``scorer.donate.dispatch`` before the output tensor is taken.

Each scorer books its parameters (``resident``, one entry a shard on
that shard's device) and its standing output tensors (``donated``, the
reference's category name) in the active device watch's ledger and
releases them when retired, and the first dispatch at each batch size
counts as a ``resident_scorer`` compile (``obs/devicewatch.py``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.obs import devicewatch
from pio_tpu_torch.parallel.partition import assert_device_budget
from pio_tpu_torch.utils import knobs

WIRE_INT8 = "int8"
WIRE_FLOAT32 = "float32"


def enabled(device: DeviceLike = None) -> bool:
    """Is device-resident serving on for a service on ``device``?

    ``PIO_TPU_DEVICE_RESIDENT=1`` forces on, ``=0`` off; ``auto`` is on
    when the serving device is CUDA — the port's default device
    (``None``) is CUDA where there is one."""
    flag = knobs.knob_str("PIO_TPU_DEVICE_RESIDENT").lower()
    if flag in ("0", "off", "false"):
        return False
    if flag in ("1", "on", "true"):
        return True
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def wire_mode(has_scales: bool) -> str:
    """Resolve the serving feature wire: the ``PIO_TPU_SERVE_WIRE``
    override, else int8 whenever training scales exist to fold."""
    raw = knobs.knob_str("PIO_TPU_SERVE_WIRE").lower()
    if raw == WIRE_INT8:
        return WIRE_INT8 if has_scales else WIRE_FLOAT32
    if raw == WIRE_FLOAT32:
        return WIRE_FLOAT32
    return WIRE_INT8 if has_scales else WIRE_FLOAT32


class OutputBuffer:
    """One-shot handle around a bucket's standing output tensor.

    :meth:`take` hands the tensor to one dispatch; a second ``take``
    raises, so a tensor that a dispatch is writing can never be handed out
    twice."""

    __slots__ = ("_buf", "_taken")

    def __init__(self, buf: torch.Tensor):
        self._buf = buf
        self._taken = False

    def take(self) -> torch.Tensor:
        """Hand the tensor to the dispatch that writes it. One shot."""
        if self._taken:
            raise RuntimeError(
                "output buffer re-used: this tensor was already handed to "
                "a dispatch, which may be writing it"
            )
        self._taken = True
        buf, self._buf = self._buf, None
        return buf


class ResidentLinearScorer:
    """Device-resident ``argmax(X @ W + b)`` scorer for the linear
    classifier templates (logreg weights, multinomial-NB log thetas).

    Built by ``Algorithm.resident_scorer`` when the query server loads
    a generation; the server binds its counters, preallocates the
    bucket ladder and retires the scorer once the generation is swapped
    out and its last dispatch has finished, or when it closes.
    """

    def __init__(
        self,
        weights: np.ndarray,
        bias: np.ndarray,
        scales: Optional[np.ndarray] = None,
        name: str = "",
        device: DeviceLike = None,
        query_factory: Optional[Callable[[np.ndarray], object]] = None,
        result_factory: Optional[Callable[[int], object]] = None,
        mesh: Optional[Sequence[DeviceLike]] = None,
    ):
        W = np.asarray(weights, np.float32)  # [D, C]
        b = np.asarray(bias, np.float32)  # [C]
        if W.ndim != 2 or b.shape != (W.shape[1],):
            raise ValueError(
                f"weights [D,C] / bias [C] expected, got {W.shape} {b.shape}"
            )
        self.name = name
        self.in_dim = int(W.shape[0])
        self.n_classes = int(W.shape[1])
        self.scales = (
            np.asarray(scales, np.float32).reshape(self.in_dim)
            if scales is not None else None
        )
        self.wire = wire_mode(self.scales is not None)
        #: mints the template's Query from a dequantized feature row: the
        #: lane drainer turns a packed int8 payload back into a query
        self.query_factory = query_factory
        #: maps one argmax class code to the template's result object;
        #: attaching it declares that a wire-codes dispatch answers as
        #: the template's supplement, predict and serve path would, so
        #: the template's serving must pass results through unchanged
        self.result_factory = result_factory
        # fold the training scales into the resident weights once:
        # X @ W == (X/s·s) @ W == X_q @ (s ⊙ W) up to quantization
        w_eff = self.scales[:, None] * W if self.wire == WIRE_INT8 else W
        # the one-time placement (a copy, on the CPU too): these tensors
        # ARE the serving params. Over a mesh of n devices W row-shards on
        # D; a D that does not divide n sits whole on the first device
        self.mesh_fallback = False
        #: (device, first row, W rows) of each shard; one shard unsharded
        self._shards = []
        devices = (None if mesh is None
                   else tuple(resolve_device(d) for d in mesh))
        self.device = (devices[0] if devices else resolve_device(device))
        if devices is not None and len(devices) > 1:
            n = len(devices)
            if self.in_dim % n == 0:
                assert_device_budget(
                    w_eff.nbytes + b.nbytes, n,
                    f"resident scorer {name!r} mesh placement")
                per = self.in_dim // n
                self._shards = [
                    (dev, s * per, torch.tensor(w_eff[s * per:(s + 1) * per],
                                                device=dev))
                    for s, dev in enumerate(devices)
                ]
            else:
                self.mesh_fallback = True
        if not self._shards:
            assert_device_budget(w_eff.nbytes + b.nbytes, 1,
                                 f"resident scorer {name!r} placement")
            self._shards = [(self.device, 0,
                             torch.tensor(w_eff, device=self.device))]
        self._b_dev = torch.tensor(b, device=self.device)
        #: shards W was placed in (1: unsharded), kept after retire
        self.n_shards = len(self._shards)
        self.placed_bytes = int(w_eff.nbytes + b.nbytes)
        #: per-bucket standing output tensors, keyed by batch size
        self._out_bufs: Dict[int, OutputBuffer] = {}
        self._lock = threading.Lock()
        self.retired = False
        self.h2d_bytes = 0
        self.dispatches = 0
        self.hits = 0
        self.misses = 0
        self._on_h2d: Optional[Callable[[int], None]] = None
        self._on_dispatch: Optional[Callable[[str], None]] = None
        # the device ledger: book the placement with the active watch,
        # one entry a shard on its device (the bias with shard 0);
        # retire() releases them
        self._dw_key = f"{name}#{id(self):x}"
        for s, (dev, _, w) in enumerate(self._shards):
            extra = int(b.nbytes) if s == 0 else 0
            devicewatch.ledger_place(
                "resident", self._ledger_key(s), w.numel() * 4 + extra,
                device=dev.index or 0,
                name=name if not self.sharded else f"{name} shard {s}")

    @property
    def sharded(self) -> bool:
        """Is W row-sharded over a mesh?"""
        return self.n_shards > 1

    @property
    def _w_dev(self) -> Optional[torch.Tensor]:
        """The whole resident W (None when sharded or retired)."""
        return self._shards[0][2] if len(self._shards) == 1 else None

    def _ledger_key(self, s: int) -> str:
        return self._dw_key if not self.sharded else f"{self._dw_key}/{s}"

    # -- service wiring ----------------------------------------------------
    def bind(self, on_h2d=None, on_dispatch=None) -> "ResidentLinearScorer":
        """Attach the query server's counters: ``on_h2d(nbytes)`` and
        ``on_dispatch("hit" | "miss")``, called by every dispatch."""
        self._on_h2d = on_h2d
        self._on_dispatch = on_dispatch
        return self

    def _new_buffer(self, n: int) -> OutputBuffer:
        return OutputBuffer(torch.zeros((n, self.n_classes),
                                        dtype=torch.float32,
                                        device=self.device))

    def prealloc(self, buckets) -> None:
        """Allocate the output tensors of ``buckets`` (batch sizes), so
        that each one's first dispatch is a hit."""
        with self._lock:
            for n in buckets:
                if n not in self._out_bufs:
                    self._out_bufs[int(n)] = self._new_buffer(int(n))
            donated = sum(
                int(b) * self.n_classes * 4 for b in self._out_bufs
            )
        devicewatch.ledger_place(
            "donated", self._dw_key, donated,
            name=f"{self.name} logits buffers",
        )

    def retire(self) -> None:
        """Drop the device params and the output tensors, and refuse
        further dispatches."""
        with self._lock:
            self.retired = True
            self._shards = []
            self._b_dev = None
            self._out_bufs.clear()
        for s in range(self.n_shards):
            devicewatch.ledger_release("resident", self._ledger_key(s))
        devicewatch.ledger_release("donated", self._dw_key)

    # -- wire encode -------------------------------------------------------
    def quantize(self, X: np.ndarray) -> np.ndarray:
        """Host-side int8 wire encode of raw float features with the
        training scales (exact inverse of the fold in the weights)."""
        if self.scales is None:
            raise ValueError(f"scorer {self.name!r} has no feature scales")
        return np.clip(
            np.rint(np.asarray(X, np.float32) / self.scales), -127, 127
        ).astype(np.int8)

    def dequantize(self, codes: np.ndarray) -> np.ndarray:
        """int8 wire codes back to (approximate) float features;
        re-quantizing the result yields the identical codes."""
        if self.scales is None:
            raise ValueError(f"scorer {self.name!r} has no feature scales")
        return codes.astype(np.float32) * self.scales

    def encode(self, X: np.ndarray) -> np.ndarray:
        """Features → wire form (int8 codes or float32 passthrough)."""
        if self.wire == WIRE_INT8:
            return self.quantize(X)
        return np.ascontiguousarray(X, np.float32)

    # -- dispatch ----------------------------------------------------------
    def score_codes(self, X: np.ndarray) -> np.ndarray:
        """Argmax class codes (int32) for a [B, D] float feature batch
        through the resident params: wire encode on the host, one copy to
        the device, one ``addmm`` and argmax there."""
        return self.score_wire(self.encode(X))

    def score_wire(self, wire: np.ndarray) -> np.ndarray:
        """Dispatch an already wire-encoded [B, D] batch."""
        if self.retired:
            raise RuntimeError(
                f"resident scorer {self.name!r} is retired; refusing to "
                f"serve stale weights"
            )
        if wire.ndim != 2 or wire.shape[1] != self.in_dim:
            raise ValueError(
                f"wire batch [B,{self.in_dim}] expected, got {wire.shape}"
            )
        n = wire.shape[0]
        failpoint("scorer.h2d.ship")
        with self._lock:
            shards, b = self._shards, self._b_dev
        # each shard's columns of the batch to the shard's device
        xs = [
            torch.from_numpy(np.ascontiguousarray(
                wire[:, lo:lo + w.shape[0]] if len(shards) > 1 else wire)
            ).to(dev)
            for dev, lo, w in shards
        ]
        nbytes = int(wire.nbytes)
        failpoint("scorer.donate.dispatch")
        with self._lock:
            if self.retired:
                raise RuntimeError(
                    f"resident scorer {self.name!r} retired mid-dispatch"
                )
            guard = self._out_bufs.pop(n, None)
            self.h2d_bytes += nbytes
        outcome = "hit" if guard is not None else "miss"
        if guard is None:
            guard = self._new_buffer(n)
        buf = guard.take()
        # compile attribution: the first dispatch at this program shape
        # (batch n × this model's dims), keyed on the watch, not the
        # scorer: a hot-swapped scorer of the same shape is not recounted
        with devicewatch.compile_span(
            "resident_scorer", key=(n, self.in_dim, self.n_classes)
        ):
            if len(shards) == 1:
                torch.addmm(b, xs[0].float(), shards[0][2], out=buf)
            else:
                # partial logits a shard, summed on the first device in
                # shard order, then the bias (the reference's psum)
                torch.mm(xs[0].float(), shards[0][2], out=buf)
                for x, (_, _, w) in zip(xs[1:], shards[1:]):
                    buf.add_(torch.mm(x.float(), w).to(self.device))
                buf.add_(b)
            codes_dev = torch.argmax(buf, dim=1)
        codes = codes_dev.to(torch.int32).cpu().numpy()
        with self._lock:
            if not self.retired:
                self._out_bufs[n] = OutputBuffer(buf)
            self.dispatches += 1
            if outcome == "hit":
                self.hits += 1
            else:
                self.misses += 1
        if self._on_h2d is not None:
            self._on_h2d(nbytes)
        if self._on_dispatch is not None:
            self._on_dispatch(outcome)
        return codes

    # -- introspection -----------------------------------------------------
    # pio: endpoint=/stats.json
    def to_dict(self) -> dict:
        """The scorer's entry in ``GET /stats.json``'s residency block."""
        with self._lock:
            hits, misses = self.hits, self.misses
            total = hits + misses
            return {
                "name": self.name,
                "wire": self.wire,
                "inDim": self.in_dim,
                "nClasses": self.n_classes,
                "paramBytes": self.placed_bytes,
                "sharded": self.sharded,
                "meshFallback": self.mesh_fallback,
                "retired": self.retired,
                "dispatches": self.dispatches,
                "h2dBytes": self.h2d_bytes,
                "donation": {
                    "hits": hits,
                    "misses": misses,
                    "hitRate": round(hits / total, 4) if total else None,
                    "backendReclaims": 0,
                },
            }
