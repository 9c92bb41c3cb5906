"""Named device meshes — the port of ``pio_tpu/parallel/mesh.py``.

The axis vocabulary is the reference's: ``data`` (the batch, and the
entity rows of ALS factors), ``pipe``, ``seq`` and ``model``, outermost
first. :class:`MeshSpec` is a plain copy. :func:`build_mesh` lays the
spec over the process group's ranks as a
``torch.distributed.device_mesh.DeviceMesh`` named by :data:`AXIS_ORDER`
(one rank a device, so the mesh's size is the world size).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

#: canonical axis order, outermost → innermost
AXIS_ORDER = ("data", "pipe", "seq", "model")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: axis name → size (-1 = absorb remainder).

    Exactly one axis may be -1; it takes every device the named axes leave
    over. Axes not mentioned get size 1 (so shardings over them are no-ops
    and the same program runs on any mesh).
    """

    data: int = -1
    pipe: int = 1
    seq: int = 1
    model: int = 1

    def sizes(self, n_devices: int) -> Dict[str, int]:
        fixed = {
            name: getattr(self, name)
            for name in AXIS_ORDER
            if getattr(self, name) != -1
        }
        free = [n for n in AXIS_ORDER if getattr(self, n) == -1]
        if len(free) > 1:
            raise ValueError(f"at most one -1 axis, got {free}")
        prod = math.prod(fixed.values())
        if free:
            if n_devices % prod:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}"
                )
            fixed[free[0]] = n_devices // prod
        elif prod != n_devices:
            raise ValueError(
                f"mesh spec {fixed} needs {prod} devices, have {n_devices}"
            )
        return {name: fixed[name] for name in AXIS_ORDER}


def build_mesh(device_type: str, spec: MeshSpec = MeshSpec()):
    """A ``DeviceMesh`` over the process group's ranks in the spec's
    shape, its dims named by :data:`AXIS_ORDER` (rank-major order: the
    innermost ``model`` axis spans adjacent ranks). Needs a group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sizes = spec.sizes(dist.get_world_size())
    return init_device_mesh(
        device_type, tuple(sizes[n] for n in AXIS_ORDER),
        mesh_dim_names=AXIS_ORDER,
    )


def mesh_axis_group(mesh, axis: str):
    """The process group of a named axis of ``mesh`` (None without a
    mesh): the axis argument of ``parallel/collectives.py``."""
    if mesh is None:
        return None
    return mesh.get_group(axis)


def mesh_axis_size(mesh, axis: str) -> int:
    """Size of a named axis (1 when the mesh lacks it or is None)."""
    if mesh is None:
        return 1
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        return 1
    return int(mesh.size(names.index(axis)))
