"""ComputeContext — the device and seed threaded through the components.

Counterpart of ``pio_tpu/parallel/context.py``'s ``ComputeContext``. The
port runs on one device so far, so the context holds no mesh: ``create``
and ``local`` give the same single-device context. Multi-device work (a
``torch.distributed`` process group) comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from pio_tpu_torch import DeviceLike, resolve_device


@dataclasses.dataclass
class ComputeContext:
    """Carries the device and base RNG seed through components.

    Attributes:
        device: where tensors live (``cuda`` unless ``cpu`` was asked for).
        seed: base RNG seed for this run.
        checkpoint: the algorithm's ``CheckpointManager``, set by
            ``Engine.train`` for each algorithm when ``checkpoint_base``
            and ``checkpoint_every`` are set (by ``run_train`` from
            ``WorkflowParams.checkpoint_every``).
        checkpoint_base: the directory of the run's snapshots.
        checkpoint_every: snapshot interval in steps; 0 = none.
    """

    device: torch.device
    seed: int = 0
    checkpoint: Optional[Any] = None
    checkpoint_base: Optional[str] = None
    checkpoint_every: int = 0

    @staticmethod
    def create(seed: int = 0, device: DeviceLike = None) -> "ComputeContext":
        """The context of a run over every device: one device in the port
        so far, so the same as :meth:`local`."""
        return ComputeContext.local(seed, device)

    @staticmethod
    def local(seed: int = 0, device: DeviceLike = None) -> "ComputeContext":
        """Single-device context on ``device`` (CUDA by default)."""
        return ComputeContext(device=resolve_device(device), seed=seed)

    @property
    def num_devices(self) -> int:
        return 1

    def generator(self, seed: Optional[int] = None) -> torch.Generator:
        """A fresh ``torch.Generator`` on this device, seeded with ``seed``
        (the context's own when not given)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed if seed is None else seed)
        return g
