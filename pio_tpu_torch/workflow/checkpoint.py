"""Mid-training checkpoint and resume.

Counterpart of ``pio_tpu/workflow/checkpoint.py`` without orbax: a
snapshot is ``torch.save`` of the train state, a tree of dicts, tuples,
lists, Python numbers and tensors. The state of the port's trainers is
``(step, params, optimizer state)``.

Layout: ``<directory>/<step>/state.pt``, one directory per snapshot,
written under a temporary name and renamed into place, so a crash leaves
either the whole snapshot or none; pruned to the ``keep`` newest. The
directory's ``fingerprint.json`` records the run's identity, and a
directory recorded by another run is purged rather than resumed.
Snapshots are synchronous: :meth:`CheckpointManager.save` returns when
the file is written.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import Any, List, Optional, Tuple

import torch

from pio_tpu_torch.storage.registry import pio_home

log = logging.getLogger("pio_tpu_torch.workflow.checkpoint")

_STATE_FILE = "state.pt"


def default_checkpoint_dir(instance_id: str) -> str:
    """``$PIO_TPU_HOME/checkpoints/<instance_id>`` (reference l.30)."""
    return os.path.join(pio_home(), "checkpoints", instance_id)


def _to_host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _like(template: Any, value: Any, path: str = "state") -> Any:
    """``value`` with the template's structure, each tensor on the device
    of the template's tensor at the same place; a structure, shape or
    dtype that differs raises ``ValueError``."""
    if isinstance(template, torch.Tensor):
        if (not isinstance(value, torch.Tensor)
                or value.shape != template.shape
                or value.dtype != template.dtype):
            raise ValueError(
                f"checkpoint {path}: {_describe(value)} does not match the "
                f"template's {_describe(template)}"
            )
        return value.to(template.device)
    if isinstance(template, dict):
        if not isinstance(value, dict) or set(value) != set(template):
            raise ValueError(f"checkpoint {path}: keys differ from the template's")
        return {k: _like(template[k], value[k], f"{path}/{k}") for k in template}
    if isinstance(template, (tuple, list)):
        if not isinstance(value, (tuple, list)) or len(value) != len(template):
            raise ValueError(f"checkpoint {path}: length differs from the template's")
        return type(template)(
            _like(t, v, f"{path}/{i}")
            for i, (t, v) in enumerate(zip(template, value))
        )
    return value


def _describe(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return f"{x.dtype} {tuple(x.shape)}"
    return type(x).__name__


class CheckpointManager:
    """Snapshots of a train state under one directory:
    ``save(step, state)`` / ``restore(template) -> (step, state) | None`` /
    ``latest_step()``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self._keep = keep
        os.makedirs(self.directory, exist_ok=True)

    @property
    def _fingerprint_path(self) -> str:
        return os.path.join(self.directory, "fingerprint.json")

    def _purge(self) -> None:
        """Wipe the directory: a stale run's snapshots are unusable, and
        leaving them would poison the recorded fingerprint."""
        shutil.rmtree(self.directory, ignore_errors=True)
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> List[int]:
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit()
            and os.path.isfile(os.path.join(self.directory, name, _STATE_FILE))
        )

    def save(
        self, step: int, state: Any, fingerprint: Optional[str] = None
    ) -> None:
        """Snapshot ``state`` as step ``step``, then prune to the newest
        ``keep``. ``fingerprint`` tags the directory with the run identity
        so that another run never resumes it."""
        if fingerprint is not None and not os.path.exists(
            self._fingerprint_path
        ):
            with open(self._fingerprint_path, "w") as f:
                json.dump({"fingerprint": fingerprint}, f)
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, _STATE_FILE)
        with open(path, "wb") as f:
            torch.save(_to_host(state), f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._steps()[:-self._keep] if self._keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)
        log.info("checkpoint saved: %s step %d", self.directory, step)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(
        self, template: Any, fingerprint: Optional[str] = None
    ) -> Optional[Tuple[int, Any]]:
        """The newest snapshot shaped like ``template``, its tensors on the
        template's devices.

        Returns None when no snapshot exists, or when ``fingerprint``
        doesn't match the directory's recorded run identity (the
        directory is then purged: stale snapshots from another config or
        dataset are never resumed).
        """
        step = self.latest_step()
        if step is None:
            return None
        if fingerprint is not None and os.path.exists(
            self._fingerprint_path
        ):
            with open(self._fingerprint_path) as f:
                recorded = json.load(f).get("fingerprint")
            if recorded != fingerprint:
                log.warning(
                    "checkpoint dir %s belongs to a different run "
                    "(fingerprint mismatch) - purging and starting fresh",
                    self.directory,
                )
                self._purge()
                return None
        path = os.path.join(self.directory, str(step), _STATE_FILE)
        state = torch.load(path, map_location="cpu", weights_only=True)
        state = _like(template, state)
        log.info("checkpoint restored: %s step %d", self.directory, step)
        return step, state

    def close(self) -> None:
        """Nothing is in flight: every save has returned."""


def rank_checkpoint(checkpoint: Optional[CheckpointManager],
                    mesh) -> Optional[CheckpointManager]:
    """A rank's own snapshot directory, ``<dir>/rank<r>``, under
    ``checkpoint``'s when ``mesh`` (a ``DeviceMesh``) spans more than one
    rank: each rank snapshots its own shards. The manager itself
    otherwise."""
    if checkpoint is None or mesh is None or mesh.size() <= 1:
        return checkpoint
    import torch.distributed as dist

    return CheckpointManager(os.path.join(checkpoint.directory,
                                          f"rank{dist.get_rank()}"))


def state_fingerprint(*parts: Any) -> str:
    """Cheap run-identity digest from config reprs / shapes / data sums."""
    h = hashlib.sha256()
    for part in parts:
        h.update(repr(part).encode())
        h.update(b"\x00")
    return h.hexdigest()[:32]


def run_chunked_steps(
    state: Any,
    total_steps: int,
    run_chunk,  # (state, n_steps: int) -> state
    checkpoint: Optional[CheckpointManager] = None,
    checkpoint_every: int = 0,
    fingerprint: Optional[str] = None,
) -> Any:
    """Drive a step loop in checkpointable chunks, resuming if possible.

    Without ``checkpoint_every`` the loop is one chunk of all the steps;
    with it, ⌈total/every⌉ chunks with a snapshot after each. On restart
    with the same manager directory, training resumes from the newest
    snapshot instead of step 0.
    """
    start = 0
    if checkpoint is not None:
        restored = checkpoint.restore(template=state, fingerprint=fingerprint)
        if restored is not None:
            start, state = restored
            if start >= total_steps:
                return state
    if checkpoint is None or checkpoint_every <= 0:
        return run_chunk(state, total_steps - start)

    done = start
    while done < total_steps:
        n = min(checkpoint_every, total_steps - done)
        state = run_chunk(state, n)
        done += n
        checkpoint.save(done, state, fingerprint=fingerprint)
    return state
