"""LocalFS model-blob store: one file per engine-instance id.

The port's copy of ``pio_tpu/storage/localfs.py`` (the port imports nothing
of ``pio_tpu``), with its durable rename inlined: the temporary file's bytes
are synced before the rename publishes its name, and the directory after
it. Failpoint ``storage.localfs.persist`` sits between the two, as the
reference's does.
"""

from __future__ import annotations

import os
from typing import Optional

from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.storage import base
from pio_tpu_torch.storage.records import Model


class LocalFSModels(base.Models):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, model_id: str) -> str:
        safe = model_id.replace("/", "_")
        return os.path.join(self.root, f"{safe}.bin")

    def insert(self, model: Model) -> None:
        path = self._path(model.id)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(model.models)
            f.flush()
            os.fsync(f.fileno())
        failpoint("storage.localfs.persist")
        os.replace(tmp, path)
        fd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def get(self, model_id: str) -> Optional[Model]:
        p = self._path(model_id)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return Model(model_id, f.read())

    def delete(self, model_id: str) -> bool:
        p = self._path(model_id)
        if os.path.exists(p):
            os.remove(p)
            return True
        return False
