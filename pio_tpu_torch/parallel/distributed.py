"""The process group — the port of ``pio_tpu/parallel/distributed.py``.

The same env contract as the reference (all optional; absent means one
process):

- ``PIO_TPU_COORDINATOR``    — ``host:port`` of rank 0's rendezvous.
- ``PIO_TPU_NUM_PROCESSES``  — world size.
- ``PIO_TPU_PROCESS_ID``     — this process's rank.

:func:`maybe_initialize` forms a ``torch.distributed`` group from them:
``nccl`` when the run's device is CUDA, ``gloo`` on the CPU.

**One rank a device.** The reference runs one process a host over all of
that host's chips (``jax.distributed``). PyTorch's idiom is one rank a
device, so the port's rank ``r`` runs on ``cuda:<r mod local device
count>``: on one host with N cards the user starts N processes, each
with its own ``PIO_TPU_PROCESS_ID``.

The collectives the trainers use are wrapped here (:func:`all_gather_rows`,
:func:`reduce_scatter_rows`, :func:`all_reduce_sum`): each takes its group
from the caller, and without one (``group=None``, one process) each is
the identity, so a trainer has one path for every context.
"""

from __future__ import annotations

import datetime as _dt
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pio_tpu_torch.utils import knobs

#: how long the rendezvous and a collective may wait for a missing rank
TIMEOUT = _dt.timedelta(minutes=10)


def env_configured() -> bool:
    """True when ``PIO_TPU_COORDINATOR`` names a rendezvous."""
    return knobs.knob_raw("PIO_TPU_COORDINATOR") is not None


def rank_device(device: torch.device, process_id: int) -> torch.device:
    """A rank's device: ``cuda:<process_id mod local device count>`` for
    CUDA (one rank a device), the CPU as it is."""
    if device.type != "cuda":
        return device
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("a CUDA process group needs a CUDA device")
    return torch.device("cuda", process_id % n)


def maybe_initialize(
    device: torch.device,
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group if one is configured (arguments, else the
    env contract). Returns True when a group exists afterwards, False for
    one process. Idempotent: a group already formed is kept.

    ``device`` picks the backend unless ``backend`` names one: ``nccl``
    for CUDA, ``gloo`` for the CPU. The rank's CUDA device is made current
    before the group forms, so NCCL binds its communicator to it.
    """
    if dist.is_initialized():
        return True
    coordinator = coordinator or knobs.knob_raw("PIO_TPU_COORDINATOR")
    if coordinator is None:
        return False
    if num_processes is None:
        raw = knobs.knob_raw("PIO_TPU_NUM_PROCESSES")
        num_processes = int(raw) if raw else None
    if process_id is None:
        raw = knobs.knob_raw("PIO_TPU_PROCESS_ID")
        process_id = int(raw) if raw else None
    if num_processes is None or process_id is None:
        raise ValueError(
            "PIO_TPU_COORDINATOR is set: PIO_TPU_NUM_PROCESSES and "
            "PIO_TPU_PROCESS_ID must be set too"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"PIO_TPU_PROCESS_ID={process_id} outside [0, {num_processes})"
        )
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {}
    if device.type == "cuda":
        dev = rank_device(device, process_id)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=TIMEOUT,
        **kw,
    )
    return True


def is_initialized() -> bool:
    return dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (a no-op without a group)."""
    if dist.is_initialized():
        dist.barrier(group=group)


def shutdown() -> None:
    """Leave the group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


# -- collectives --------------------------------------------------------------
def all_gather_rows(local: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's ``local`` along dim 0, in rank order
    (``local`` itself without a group).

    Every rank passes the same shape. The bytes travel as ``uint8``, so
    any dtype crosses any backend (NCCL has no 16-bit integer type)."""
    if group is None:
        return local
    world = dist.get_world_size(group)
    local = local.contiguous()
    flat = local.view(torch.uint8).reshape(-1)
    out = torch.empty(world * flat.numel(), dtype=torch.uint8,
                      device=local.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view(local.dtype).reshape(
        (world * local.shape[0],) + tuple(local.shape[1:]))


def reduce_scatter_rows(full: torch.Tensor, group) -> torch.Tensor:
    """Sum ``full`` over the ranks and keep this rank's slice of dim 0
    (the ``1/world`` rows at its rank); dim 0 divides by the world.
    ``full`` itself without a group."""
    if group is None:
        return full
    world = dist.get_world_size(group)
    if full.shape[0] % world:
        raise ValueError(f"{full.shape[0]} rows do not split over {world}")
    full = full.contiguous()
    out = torch.empty((full.shape[0] // world,) + tuple(full.shape[1:]),
                      dtype=full.dtype, device=full.device)
    dist.reduce_scatter_tensor(out, full, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns it (as it is without
    a group)."""
    if group is None:
        return t
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def rows_of(n: int, rank: int, world: int):
    """``(lo, hi, n_pad)``: the rows of ``rank`` once ``n`` rows are padded
    to a multiple of ``world`` (``n_pad``), each rank taking an equal,
    contiguous span in rank order."""
    n_pad = -(-n // world) * world
    per = n_pad // world
    return rank * per, (rank + 1) * per, n_pad


def host_local_to_global(ctx, host_arrays: Sequence[np.ndarray]):
    """Assemble each rank's own rows into the global arrays, on every rank.

    The counterpart of the reference's ``host_local_to_global``
    (``make_array_from_process_local_data``): each rank passes the rows it
    loaded; a rank's rows are padded with zeros to the longest rank's
    count, gathered, and the padding is dropped, so the result is every
    rank's rows in rank order. Returns host numpy arrays (the port has no
    global sharded array type; the trainers shard their own batches).
    Without a group the arrays come back as they are.
    """
    if ctx.group is None:
        return [np.asarray(a) for a in host_arrays]
    dev = ctx.device
    counts = torch.tensor([len(host_arrays[0])], dtype=torch.int64,
                          device=dev)
    counts = all_gather_rows(counts, ctx.group).cpu().numpy()
    longest = int(counts.max())
    out = []
    for a in host_arrays:
        a = np.ascontiguousarray(a)
        if len(a) != counts[ctx.rank]:
            raise ValueError("a rank's arrays must share their row count")
        pad = np.zeros((longest,) + a.shape[1:], a.dtype)
        pad[:len(a)] = a
        got = all_gather_rows(torch.from_numpy(pad).to(dev), ctx.group)
        got = got.cpu().numpy().reshape((len(counts), longest) + a.shape[1:])
        out.append(np.concatenate(
            [got[r, :int(c)] for r, c in enumerate(counts)]))
    return out
