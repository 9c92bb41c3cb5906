"""ComputeContext — the device, seed and process group threaded through the
components.

Counterpart of ``pio_tpu/parallel/context.py``'s ``ComputeContext``.
:meth:`ComputeContext.create` joins the ``torch.distributed`` group when
the env contract names one (``PIO_TPU_COORDINATOR``,
``parallel/distributed.py``): the context then carries the group, its
``DeviceMesh`` (``parallel/mesh.py``), this rank and a ``num_devices``
equal to the world size, and its device is this rank's own (one rank a
device). Without the env, ``create`` is the single-device context of
:meth:`local`. The trainers that split their work over a group (ALS,
``train_mlp``, ``train_logreg``) have one path for every context: without
a group, or at world size 1, every collective is an identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from pio_tpu_torch import DeviceLike, resolve_device
from pio_tpu_torch.parallel import distributed
from pio_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec, build_mesh


@dataclasses.dataclass
class ComputeContext:
    """Carries the device, base RNG seed and process group through
    components.

    Attributes:
        device: where tensors live (``cuda`` unless ``cpu`` was asked for;
            under a group, this rank's device).
        seed: base RNG seed for this run.
        checkpoint: the algorithm's ``CheckpointManager``, set by
            ``Engine.train`` for each algorithm when ``checkpoint_base``
            and ``checkpoint_every`` are set (by ``run_train`` from
            ``WorkflowParams.checkpoint_every``).
        checkpoint_base: the directory of the run's snapshots.
        checkpoint_every: snapshot interval in steps; 0 = none.
        mesh: the ``DeviceMesh`` over the group's ranks; None without one.
        group: the process group of the batch axis (the data-parallel and
            entity-sharded collectives); None without a group.
        rank: this process's rank in ``group`` (0 without one).
        batch_axis: mesh axis training data shards over.
        model_axis: mesh axis model tensors may shard over.
    """

    device: torch.device
    seed: int = 0
    checkpoint: Optional[Any] = None
    checkpoint_base: Optional[str] = None
    checkpoint_every: int = 0
    mesh: Optional[Any] = None
    group: Optional[Any] = None
    rank: int = 0
    batch_axis: str = "data"
    model_axis: str = "model"
    #: the meshes of :meth:`mesh_for`, by axis sizes (shared by the
    #: copies ``dataclasses.replace`` makes)
    meshes: Dict[tuple, Any] = dataclasses.field(default_factory=dict,
                                                  repr=False, compare=False)

    @staticmethod
    def create(seed: int = 0, device: DeviceLike = None,
               spec: MeshSpec = MeshSpec(),
               backend: Optional[str] = None) -> "ComputeContext":
        """The context of a run: the process group's when the env contract
        names one (joined here; this rank's device; ``backend`` overrides
        the device's, nccl or gloo), else :meth:`local`."""
        dev = resolve_device(device)
        if not distributed.maybe_initialize(dev, backend=backend):
            return ComputeContext.local(seed, dev)
        dev = distributed.rank_device(dev, distributed.process_index())
        mesh = build_mesh(dev.type, spec)
        group = mesh.get_group("data")
        return ComputeContext(
            device=dev, seed=seed, mesh=mesh, group=group,
            rank=torch.distributed.get_rank(group),
        )

    def mesh_for(self, spec: MeshSpec):
        """A ``DeviceMesh`` in ``spec``'s shape over this context's ranks
        (None without a group), built once a shape: every rank calls
        this in the same order, since building a mesh forms its axes'
        groups."""
        if self.mesh is None:
            return None
        sizes = spec.sizes(self.num_devices)
        key = tuple(sizes[n] for n in AXIS_ORDER)
        if key == tuple(self.mesh.shape):
            return self.mesh
        if key not in self.meshes:
            self.meshes[key] = build_mesh(self.device.type, spec)
        return self.meshes[key]

    @staticmethod
    def local(seed: int = 0, device: DeviceLike = None) -> "ComputeContext":
        """Single-device context on ``device`` (CUDA by default)."""
        return ComputeContext(device=resolve_device(device), seed=seed)

    @property
    def world_size(self) -> int:
        """Ranks of the batch axis (1 without a group)."""
        if self.group is None:
            return 1
        return torch.distributed.get_world_size(self.group)

    @property
    def num_devices(self) -> int:
        """Devices of the run: the world size (one rank a device)."""
        if self.mesh is None:
            return 1
        return int(self.mesh.size())

    @property
    def is_coordinator(self) -> bool:
        return distributed.is_coordinator()

    def generator(self, seed: Optional[int] = None) -> torch.Generator:
        """A fresh ``torch.Generator`` on this device, seeded with ``seed``
        (the context's own when not given)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed if seed is None else seed)
        return g

    def shard_batch(self, arrays: Dict[str, np.ndarray], pad_value=0):
        """Pad dim 0 to a world multiple and keep this rank's rows, as
        tensors on the device, with a float32 ``mask`` (1 on real rows).

        The reference places the whole padded batch sharded over its mesh;
        here each rank holds its own contiguous span of the padded rows.
        Without a group, every row and a mask of ones."""
        n = len(next(iter(arrays.values())))
        for k, v in arrays.items():
            if len(v) != n:
                raise ValueError(
                    f"all arrays must share dim-0 length; {k!r} has "
                    f"{len(v)} != {n}"
                )
        lo, hi, n_pad = distributed.rows_of(n, self.rank, self.world_size)
        out = {}
        for k, v in arrays.items():
            v = np.asarray(v)
            pv = np.full((n_pad,) + v.shape[1:], pad_value, dtype=v.dtype)
            pv[:n] = v
            out[k] = torch.from_numpy(np.ascontiguousarray(pv[lo:hi])).to(
                self.device)
        mask = np.zeros(n_pad, np.float32)
        mask[:n] = 1.0
        out["mask"] = torch.from_numpy(mask[lo:hi].copy()).to(self.device)
        return out

    def replicate(self, array) -> torch.Tensor:
        """The whole array on this rank's device (every rank holds it)."""
        if isinstance(array, torch.Tensor):
            return array.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def shard_params(self, params, rules=None, template=None,
                     on_unmatched="replicate"):
        """Place a parameter tree under partition rules (``rules``, or the
        ``template``'s registered set): this rank's row slices under a
        group, the whole tensors on the device without one. Returns
        ``(placed, specs)`` (``parallel/partition.py``)."""
        from pio_tpu_torch.parallel import partition as _partition

        if rules is None:
            rules = _partition.rules_for(template) if template else []
        return _partition.shard_params(
            self, params, rules, on_unmatched=on_unmatched
        )
