"""Device-resident factor scoring for serving — the port of ``pio_tpu/ops/topn.py``.

The factor tables go to the device once, when the scorer is built (at
deploy), and each request is one ``[B, K] @ [K, N]`` product and a top-k
there; only integer codes and the top-N results cross the link.

**Routing.** A scorer on CUDA scores every call on the card. The
reference's adaptive routing is kept for a scorer on the CPU and as an
opt-in on the card (``PIO_TPU_SERVE_DEVICE=auto``): what a small request
costs is mostly the host ↔ device round trip, not the math, so the
scorer probes both costs once — a 4-byte round trip to the device and
one host-scored row — and routes each call by batch size: ``B ≥ RTT /
host_row_cost`` goes to the device, smaller batches to the host mirror
of the factors (which exists anyway: it is the persisted model).
``PIO_TPU_SERVE_DEVICE=1|0`` forces the device or the host for every
call.

**Ties.** ``jax.lax.top_k`` puts the lower index first among equal
scores; ``torch.topk`` promises no order. The device path ranks a
composite int64 key — the score's order-preserving bits above the
complemented column index — so the order is pinned: larger score first,
then lower index, as on the reference's device path and the host path
here. NaN scores (diverged factors) rank as ``-inf`` on both paths.

**Exclusions.** A row's exclusion slots are padded with the sentinel
``n_cols``, which JAX drops as out of bounds. The device table here has
one spare zero row at ``n_cols``: the sentinel's score lands in that
column, which is cut off before the top-k.

Batches are cut into chunks of ``_MAX_BATCH_BUCKET`` rows, and the top-k
width rounds up to a power of two (``_bucket``), as in the reference. The
reference pads each chunk to a power of two to bound its compilations;
eager PyTorch compiles nothing, so the chunks run at their own size.

**The host path.** A host batch without exclusions is scored by the
native fused scan-and-select (``pio_tpu_torch/native/topn_host.cpp``,
built with ``g++`` on first use, over a transposed mirror of the item
table made on first use); a batch with exclusions by numpy (a BLAS
product and a partition of composite keys), which is also the native
scorer's plain version. The reference takes the native scorer only up
to 8 rows, keeping BLAS for larger batches; on the host of an NVIDIA
H100 80GB HBM3 machine (``chip_smoke.py`` phase 16, 59047 columns, rank
16) the native scorer took about a quarter to a sixth of numpy's time at 64
and at 512 rows too, so the port takes it at every batch size. Both rank larger score first,
then lower index, and map NaN to ``-inf`` and ``-0.0`` to ``+0.0``.
They give the same score bits only where every product and partial sum
is exact (the tests' quarter-valued factors): the native loop sums each
dot product in rank order with fused multiply-adds, BLAS in its own
order, so on real factors a score may differ in its last bits (phase
16: at most 9.5e-7 from numpy's or the card's) and near-ties may rank
differently.
``PIO_TPU_NO_NATIVE`` keeps every host batch on numpy; a failed build
raises.

**The sharded scorer** (``mesh=``, the reference's ``_place_sharded``,
l.160-300): the serving mesh is a tuple of the devices one process owns
(the reference's mesh worker owns its host's whole mesh), so it needs no
process group. Both tables are split into row shards, one a device,
zero-padded to a shard multiple. A query gathers its user rows from
their shards onto the first device; each shard scores its columns on its
own device, masks its pad columns (and the query's exclusions) to
``-inf`` and takes its pinned top-k; the first device merges the shards'
candidates by the same key (larger score first, then lower index, NaN as
``-inf``), so the answer is the unsharded one, pad columns never among
it. A mesh of one device is the plain path. The tests pass four CPU
devices; on one card the same code runs over ``(cuda:0,) * 4``.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.utils import knobs

#: largest per-dispatch batch; bigger batches loop in chunks of this
_MAX_BATCH_BUCKET = 512

#: rows a score_pairs dispatch takes at most
_PAIRS_CHUNK = 1 << 20

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _bucket(n: int, cap: int) -> int:
    """Smallest power of two ≥ n, capped."""
    b = 1
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


def _ranked(scores: torch.Tensor) -> torch.Tensor:
    """NaN → -inf and -0.0 → +0.0, in place (the host path's contract)."""
    scores.nan_to_num_(nan=float("-inf"), posinf=float("inf"),
                       neginf=float("-inf"))
    return scores.add_(0.0)


def _pinned_keys(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys ranking float32 ``scores`` at column indices ``idx``
    (broadcast against them): larger score first, then lower index."""
    bits = scores.view(torch.int32).to(torch.int64)
    # order-preserving map of the float bits onto signed integers
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return ordered * (1 << 32) + (0xFFFFFFFF - idx)


def _topk_pinned(scores: torch.Tensor, k: int):
    """Top-k of each row of float32 ``scores [B, N]``: larger score first,
    then lower column index. Returns (values, indices int64)."""
    cols = torch.arange(scores.shape[1], device=scores.device)
    # the keys are distinct, so the top-k and its order are unique
    _, idx = torch.topk(_pinned_keys(scores, cols[None, :]), k, dim=1)
    return scores.gather(1, idx), idx


def _topn_fn(rows, cols_ext, codes, k: int, excl=None):
    """[B,K]@[K,N] and the pinned top-k. ``cols_ext`` is ``[N+1, K]`` with
    the spare sentinel row last; ``excl`` is ``[B, E]`` column codes, the
    sentinel ``N`` marking unused slots."""
    scores = rows[codes] @ cols_ext.T  # [B, N+1], float32
    if excl is not None:
        scores.scatter_(1, excl, float("-inf"))
    n_cols = cols_ext.shape[0] - 1
    return _topk_pinned(_ranked(scores[:, :n_cols].contiguous()), k)


def _merge_pinned(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Top-k of candidate ``vals [B, M]`` at global column ``idx [B, M]``
    by :func:`_topk_pinned`'s order (larger score, then lower index)."""
    _, pick = torch.topk(_pinned_keys(vals, idx), k, dim=1)
    return vals.gather(1, pick), idx.gather(1, pick)


def _shard_topk(q, cols, lo: int, n_cols: int, k: int, excl=None):
    """One column shard's pinned top-k on its device: ``q [B, K] @
    cols [n_s, K]ᵀ``, the columns at or past ``n_cols`` (padding) and the
    excluded global codes ``excl [B, E]`` masked to ``-inf``. Returns
    (values, global indices)."""
    n_s = cols.shape[0]
    scores = q @ cols.T
    if excl is not None:
        local = excl - lo
        local = torch.where((local >= 0) & (local < n_s), local, n_s)
        scores = F.pad(scores, (0, 1))
        scores.scatter_(1, local, float("-inf"))
        scores = scores[:, :n_s]
    n_real = min(max(n_cols - lo, 0), n_s)
    if n_real < n_s:
        scores[:, n_real:] = float("-inf")
    vals, idx = _topk_pinned(_ranked(scores.contiguous()), min(k, n_s))
    return vals, idx + lo


def _scores_fn(rows, cols_ext, codes):
    return rows[codes] @ cols_ext[:-1].T


def _pairs_fn(rows, cols_ext, rcodes, ccodes):
    return (rows[rcodes] * cols_ext[ccodes]).sum(-1)


def _env_mode(device: torch.device) -> str:
    """``PIO_TPU_SERVE_DEVICE``'s routing: "device", "host" or "auto";
    unset, "device" on CUDA and "auto" on the CPU."""
    env = knobs.knob_str("PIO_TPU_SERVE_DEVICE").lower()
    if env in ("1", "true", "yes", "device"):
        return "device"
    if env in ("0", "false", "no", "host"):
        return "host"
    if env == "auto" or device.type != "cuda":
        return "auto"
    return "device"


@functools.lru_cache(maxsize=None)
def _probe_link_rtt_s(device: str) -> float:
    """Best of three minimal host → device → host round trips (4 bytes
    each way): the link's cost, not the math's. Measured once per device
    in a process."""
    x = torch.ones(1, dtype=torch.float32)
    x.to(device).cpu()  # warm the path
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        x.to(device).cpu()
        best = min(best, time.perf_counter() - t0)
    return best


class DeviceTopNScorer:
    """Row-factors × col-factors top-N scorer, resident on ``device``.

    ``rows`` is the query-side table (user factors), ``cols`` the scored
    items. Either may be a numpy array or a tensor; the scorer keeps a
    float32 host mirror and a copy on ``device`` (CUDA unless told
    otherwise; a table already there is not copied). Methods take and
    return host numpy: only codes and the results cross the link.

    ``prefer_device``: True/False pins every call to the device/host
    path; None consults ``PIO_TPU_SERVE_DEVICE``, and unset scores on the
    card when ``device`` is CUDA and routes by batch size on the CPU (see
    the module docstring). ``link_rtt_s`` overrides the
    probed round trip (tests inject link speeds). A failed device call
    raises; it never falls back to the host.

    ``mesh``: a tuple of devices to shard both tables over (see the
    module docstring); ``device`` is then its first. The per-device
    footprint is held to ``PIO_TPU_DEVICE_BUDGET_BYTES`` when set.
    """

    def __init__(
        self,
        row_factors,
        col_factors,
        prefer_device: Optional[bool] = None,
        warmup: bool = False,
        link_rtt_s: Optional[float] = None,
        device: DeviceLike = None,
        mesh=None,
    ):
        if mesh is not None:
            mesh = tuple(resolve_device(d) for d in mesh)
            device = mesh[0] if mesh else device
            if len(mesh) <= 1:
                mesh = None  # a one-device mesh is the plain device path
        self._mesh = mesh
        self.device = resolve_device(device)
        rows = _host_f32(row_factors)
        cols = _host_f32(col_factors)
        if rows.shape[1] != cols.shape[1]:
            raise ValueError(
                f"rank mismatch: rows {rows.shape} vs cols {cols.shape}"
            )
        self.n_rows, self.rank = rows.shape
        self.n_cols = cols.shape[0]
        self._rows_np = rows
        self._cols_np = cols
        self._cols_t = None  # [K, N] mirror of the native host path
        self._rows_dev = self._cols_dev = None

        if self.n_rows == 0 or self.n_cols == 0:
            # nothing to probe or score on the device; the public methods
            # handle the empty dimensions on the host
            self.min_device_batch = float("inf")
            self.min_pair_batch = float("inf")
            return

        if prefer_device is True:
            mode = "device"
        elif prefer_device is False:
            mode = "host"
        else:
            mode = _env_mode(self.device)
        if mode == "host":
            self.min_device_batch = float("inf")
            self.min_pair_batch = float("inf")
        else:
            from pio_tpu_torch.parallel.partition import assert_device_budget

            n_dev = len(self._mesh) if self._mesh else 1
            assert_device_budget(rows.nbytes + cols.nbytes, n_dev,
                                 "topn mesh placement" if self._mesh
                                 else "topn device placement")
            if self._mesh is not None:
                self._place_sharded(rows, cols)
            else:
                # the single upload of the deploy lifetime, with the spare
                # sentinel row of the exclusion scatter
                self._rows_dev = _on_device(row_factors, rows, self.device)
                cols_dev = _on_device(col_factors, cols, self.device)
                self._cols_dev = torch.cat(
                    [cols_dev, cols_dev.new_zeros((1, self.rank))]
                )
            if mode == "device":
                self.min_device_batch = 1
                self.min_pair_batch = 1
            else:
                # a pair query is a rank-length dot, ~n_cols× cheaper on
                # the host than a score row, so its break-even batch is
                # that much larger
                rtt = link_rtt_s if link_rtt_s is not None \
                    else _probe_link_rtt_s(str(self.device))
                host_row = self._probe_host_row_s()
                host_pair = max(host_row / self.n_cols, 1e-9)
                self.min_device_batch = max(1, int(np.ceil(rtt / host_row)))
                self.min_pair_batch = max(1, int(np.ceil(rtt / host_pair)))
        if warmup:
            # the first live request must not pay the first-call costs
            # (cuBLAS handles, allocator growth) of its route
            self.top_n_batch(np.zeros(1, np.int32), 16)
            if self.min_pair_batch <= 1:
                self.score_pairs(np.zeros(1, np.int32), np.zeros(1, np.int32))

    def _place_sharded(self, rows: np.ndarray, cols: np.ndarray) -> None:
        """Row-shard both tables over the mesh, zero-padded to a shard
        multiple (the reference's ``_place_sharded``, l.267)."""
        from pio_tpu_torch.parallel.partition import shard_rows

        n = len(self._mesh)
        self._row_shards = [p.to(d) for p, d in
                            zip(shard_rows(rows, n), self._mesh)]
        self._col_shards = [p.to(d) for p, d in
                            zip(shard_rows(cols, n), self._mesh)]
        self._rows_per = self._row_shards[0].shape[0]
        self._cols_per = self._col_shards[0].shape[0]
        self._ncols_pad = self._cols_per * n
        self._rows_dev = self._row_shards  # on_device reads it

    @property
    def mesh_sharded(self) -> bool:
        """True when the factor tables are sharded over a serving mesh."""
        return self._mesh is not None and self.on_device

    def host_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """The float32 host mirrors ``(rows, cols)``."""
        return self._rows_np, self._cols_np

    def shard_bytes(self) -> list:
        """``(device, bytes)`` of each shard pair a sharded scorer placed."""
        return [(d, (r.numel() + c.numel()) * 4) for d, r, c in
                zip(self._mesh, self._row_shards, self._col_shards)]

    def sharding_info(self) -> Optional[dict]:
        """Placement summary for /stats.json; None when unsharded. The
        reference's keys; ``bytesPerDevice`` is what each device holds,
        its padded row shard of both tables."""
        if not self.mesh_sharded:
            return None
        n_dev = len(self._mesh)
        total = self._rows_np.nbytes + self._cols_np.nbytes
        return {
            "meshShape": {"data": n_dev},
            "nDevices": n_dev,
            "rows": [int(self.n_rows), int(self.rank)],
            "cols": [int(self.n_cols), int(self.rank)],
            "colsPadded": int(self._ncols_pad),
            "bytesPerDevice": (self._rows_per + self._cols_per)
            * self.rank * 4,
            "totalBytes": int(total),
        }

    @property
    def on_device(self) -> bool:
        """True when at least some batch sizes route to the device."""
        return self._rows_dev is not None

    def _probe_host_row_s(self) -> float:
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            self._rows_np[0] @ self._cols_np.T
            best = min(best, time.perf_counter() - t0)
        return max(best, 1e-7)

    def _route_to_device(self, batch: int) -> bool:
        return self.on_device and batch >= self.min_device_batch

    def _codes(self, codes: np.ndarray, bound: int) -> torch.Tensor:
        """Host codes as an int64 tensor on the device, checked against
        ``[0, bound)`` on the host first: an out-of-range index on the card
        is a device-side assert, which ends the process's CUDA context."""
        if codes.size and (int(codes.min()) < 0 or int(codes.max()) >= bound):
            raise IndexError(f"code out of range [0, {bound})")
        return torch.from_numpy(
            np.ascontiguousarray(codes, np.int64)
        ).to(self.device)

    # ---------------------------------------------------------- sharded path
    def _gather_sharded(self, shards, per: int, codes: np.ndarray,
                        bound: int) -> torch.Tensor:
        """Rows ``codes`` of a row-sharded table, gathered from their
        shards onto the first device (codes checked on the host first)."""
        if codes.size and (int(codes.min()) < 0 or int(codes.max()) >= bound):
            raise IndexError(f"code out of range [0, {bound})")
        dev0 = self._mesh[0]
        out = torch.empty((len(codes), self.rank), dtype=torch.float32,
                          device=dev0)
        shard = codes // per
        for s in np.unique(shard):
            sel = np.nonzero(shard == s)[0]
            local = torch.from_numpy((codes[sel] - s * per).astype(np.int64))
            out[torch.from_numpy(sel).to(dev0)] = \
                shards[s][local.to(self._mesh[s])].to(dev0)
        return out

    def _top_n_sharded(self, codes, n, exclude):
        B = codes.shape[0]
        k = _bucket(n, self.n_cols) if n < self.n_cols else self.n_cols
        dev0 = self._mesh[0]
        idx_out = np.empty((B, k), np.int64)
        val_out = np.empty((B, k), np.float32)
        for lo in range(0, B, _MAX_BATCH_BUCKET):
            chunk = codes[lo:lo + _MAX_BATCH_BUCKET]
            q = self._gather_sharded(self._row_shards, self._rows_per, chunk,
                                     self.n_rows)
            ex = None
            if exclude is not None:
                ex = np.minimum(exclude[lo:lo + _MAX_BATCH_BUCKET],
                                self.n_cols)  # any code ≥ n_cols: sentinel
                ex = torch.from_numpy(np.ascontiguousarray(ex, np.int64))
            vals, idxs = [], []
            for s, (cols, d) in enumerate(zip(self._col_shards, self._mesh)):
                v, i = _shard_topk(q.to(d), cols, s * self._cols_per,
                                   self.n_cols, k,
                                   None if ex is None else ex.to(d))
                vals.append(v.to(dev0))
                idxs.append(i.to(dev0))
            v, i = _merge_pinned(torch.cat(vals, 1), torch.cat(idxs, 1), k)
            m = chunk.shape[0]
            idx_out[lo:lo + m] = i.cpu().numpy()
            val_out[lo:lo + m] = v.cpu().numpy()
        idx_out = np.where(np.isfinite(val_out), idx_out, 0)
        return idx_out[:, :n], val_out[:, :n]

    # ----------------------------------------------------------- device path
    def _top_n_device(self, codes, n, exclude):
        if self._mesh is not None:
            return self._top_n_sharded(codes, n, exclude)
        B = codes.shape[0]
        k = _bucket(n, self.n_cols) if n < self.n_cols else self.n_cols
        idx_out = np.empty((B, k), np.int64)
        val_out = np.empty((B, k), np.float32)
        for lo in range(0, B, _MAX_BATCH_BUCKET):
            chunk = codes[lo:lo + _MAX_BATCH_BUCKET]
            excl = None
            if exclude is not None:
                ex = np.minimum(exclude[lo:lo + _MAX_BATCH_BUCKET],
                                self.n_cols)  # any code ≥ n_cols: sentinel
                excl = self._codes(ex, self.n_cols + 1)
            vals, idx = _topn_fn(
                self._rows_dev, self._cols_dev,
                self._codes(chunk, self.n_rows), k, excl,
            )
            m = chunk.shape[0]
            idx_out[lo:lo + m] = idx.cpu().numpy()
            val_out[lo:lo + m] = vals.cpu().numpy()
        # an excluded slot surfaces at -inf; pin its index to col 0 so a
        # caller never reads a code from a fully masked row
        idx_out = np.where(np.isfinite(val_out), idx_out, 0)
        return idx_out[:, :n], val_out[:, :n]

    # ------------------------------------------------------------- host path
    def _top_n_host(self, codes, n, exclude):
        if exclude is None and not knobs.knob_str("PIO_TPU_NO_NATIVE"):
            return self._top_n_host_native(codes, n)
        B = codes.shape[0]
        # chunk rows so the [chunk, N] score and key planes stay ~100 MB
        chunk = max(1, (8 << 20) // max(1, self.n_cols))
        idx_out = np.empty((B, n), np.int64)
        val_out = np.empty((B, n), np.float32)
        for lo in range(0, B, chunk):
            hi = min(B, lo + chunk)
            ex = exclude[lo:hi] if exclude is not None else None
            idx_out[lo:hi], val_out[lo:hi] = self._top_n_host_chunk(
                codes[lo:hi], n, ex
            )
        return idx_out, val_out

    def _top_n_host_chunk(self, codes, n, exclude):
        scores = self._rows_np[codes] @ self._cols_np.T  # [B, N]
        if exclude is not None:
            b = np.arange(scores.shape[0])[:, None]
            keep = exclude < self.n_cols  # sentinel slots stay untouched
            scores[
                np.broadcast_to(b, exclude.shape)[keep],
                exclude[keep],
            ] = -np.inf
        # composite u64 keys encode (-score, index): selection and order
        # are deterministic under ties. NaN maps to -inf; `+ 0.0` makes
        # -0.0 +0.0 so the two tie
        scores += np.float32(0.0)
        np.copyto(scores, -np.inf, where=np.isnan(scores))
        bits = scores.view(np.uint32)
        ordered = np.where(
            (bits >> np.uint32(31)).astype(bool),
            ~bits, bits | np.uint32(0x80000000),
        )
        keys = (
            ((np.uint32(0xFFFFFFFF) - ordered).astype(np.uint64)
             << np.uint64(32))
            | np.arange(self.n_cols, dtype=np.uint64)[None, :]
        )
        if n < self.n_cols:
            part = np.argpartition(keys, n - 1, axis=1)[:, :n]
        else:
            part = np.argsort(keys, axis=1)
        pk = np.take_along_axis(keys, part, axis=1)
        order = np.argsort(pk, axis=1)
        idx = np.take_along_axis(part, order, axis=1).astype(np.int64)
        return idx, np.take_along_axis(scores, idx, axis=1)

    def _top_n_host_native(self, codes, n):
        """The fused native scan-and-select (no ``[B, N]`` score array):
        stride-1 multiply-adds over the transposed ``[K, N]`` mirror in
        L1-sized blocks, heap selection while each block is cache-hot."""
        from pio_tpu_torch.native import topn_host_lib

        lib = topn_host_lib()
        if codes.size and (int(codes.min()) < 0
                           or int(codes.max()) >= self.n_rows):
            raise IndexError(f"code out of range [0, {self.n_rows})")
        if self._cols_t is None:
            # built on first use, so scorers that never take this path
            # do not hold a second copy of the table
            self._cols_t = np.ascontiguousarray(self._cols_np.T)
        codes = np.ascontiguousarray(codes, np.int32)
        B = codes.shape[0]
        out_idx = np.empty((B, n), np.int64)
        out_val = np.empty((B, n), np.float32)
        lib.topn_host_f32(
            self._rows_np.ctypes.data_as(_F32P),
            self._cols_t.ctypes.data_as(_F32P),
            self.n_rows, self.n_cols, self.rank,
            codes.ctypes.data_as(_I32P), B, n,
            out_idx.ctypes.data_as(_I64P), out_val.ctypes.data_as(_F32P),
        )
        return out_idx, out_val

    # -------------------------------------------------------------- public
    def top_n_batch(
        self,
        codes: np.ndarray,
        n: int,
        exclude: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-n col indices and scores for each row code.

        ``exclude``: optional ``[B, E]`` int array of col codes to mask out
        per row; pad unused slots with any value ≥ ``n_cols``.
        """
        codes = np.asarray(codes, np.int32)
        if codes.ndim != 1:
            raise ValueError("codes must be 1-D")
        n = max(1, min(n, self.n_cols))
        if exclude is not None:
            exclude = np.asarray(exclude, np.int32)
            if exclude.ndim != 2 or exclude.shape[0] != codes.shape[0]:
                raise ValueError("exclude must be [B, E]")
        if codes.shape[0] == 0 or self.n_cols == 0:
            b = codes.shape[0]
            n = 0 if self.n_cols == 0 else n
            return (np.empty((b, n), np.int64), np.empty((b, n), np.float32))
        if self._route_to_device(codes.shape[0]):
            return self._top_n_device(codes, n, exclude)
        return self._top_n_host(codes, n, exclude)

    def scores_batch(self, codes: np.ndarray) -> np.ndarray:
        """Full ``[B, n_cols]`` score matrix (host numpy out).

        The result is B × n_cols floats back over the link, so the device
        route is taken only when the link probe found it free
        (``min_device_batch == 1``: a local device, or forced).
        """
        codes = np.asarray(codes, np.int32)
        B = codes.shape[0]
        if B == 0 or self.min_device_batch > 1 or not self.on_device:
            return self._rows_np[codes] @ self._cols_np.T
        out = np.empty((B, self.n_cols), np.float32)
        for lo in range(0, B, _MAX_BATCH_BUCKET):
            chunk = codes[lo:lo + _MAX_BATCH_BUCKET]
            if self._mesh is not None:
                q = self._gather_sharded(self._row_shards, self._rows_per,
                                         chunk, self.n_rows)
                s = torch.cat([(q.to(d) @ c.T).to(self._mesh[0])
                               for c, d in zip(self._col_shards, self._mesh)],
                              dim=1)[:, :self.n_cols]
            else:
                s = _scores_fn(self._rows_dev, self._cols_dev,
                               self._codes(chunk, self.n_rows))
            out[lo:lo + chunk.shape[0]] = s.cpu().numpy()
        return out

    def score_pairs(
        self, row_codes: np.ndarray, col_codes: np.ndarray
    ) -> np.ndarray:
        """Per-pair dot products ``rows[rc] · cols[cc]`` → ``[B]``."""
        rc = np.asarray(row_codes, np.int32)
        cc = np.asarray(col_codes, np.int32)
        B = rc.shape[0]
        if B == 0 or B < self.min_pair_batch or not self.on_device:
            return np.einsum(
                "bk,bk->b", self._rows_np[rc], self._cols_np[cc]
            )
        out = np.empty(B, np.float32)
        if self._mesh is not None:
            for lo in range(0, B, _PAIRS_CHUNK):
                q = self._gather_sharded(self._row_shards, self._rows_per,
                                         rc[lo:lo + _PAIRS_CHUNK], self.n_rows)
                c = self._gather_sharded(self._col_shards, self._cols_per,
                                         cc[lo:lo + _PAIRS_CHUNK], self.n_cols)
                out[lo:lo + q.shape[0]] = (q * c).sum(-1).cpu().numpy()
            return out
        for lo in range(0, B, _PAIRS_CHUNK):
            got = _pairs_fn(
                self._rows_dev, self._cols_dev,
                self._codes(rc[lo:lo + _PAIRS_CHUNK], self.n_rows),
                self._codes(cc[lo:lo + _PAIRS_CHUNK], self.n_cols),
            )
            out[lo:lo + got.shape[0]] = got.cpu().numpy()
        return out


def _host_f32(table) -> np.ndarray:
    """A factor table as a C-contiguous float32 host array."""
    if isinstance(table, torch.Tensor):
        table = table.detach().cpu().numpy()
    return np.ascontiguousarray(table, dtype=np.float32)


def _on_device(table, host: np.ndarray, device: torch.device) -> torch.Tensor:
    """``table`` on ``device`` as float32: the tensor itself when it is
    already there, else one copy of the host mirror."""
    if isinstance(table, torch.Tensor) and table.dtype == torch.float32 \
            and table.device.type == device.type \
            and (device.index is None or table.device.index == device.index):
        return table.detach()
    return torch.from_numpy(host).to(device)
