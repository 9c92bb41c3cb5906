"""What a training driver needs: whole training runs through the port's
trainer, back to back, as its templates call them under ``pio train`` (a
step recorder active), and the check of the window's first run against
the reference.

The trainer returns only the trained model, so the check reads a run's
first steps through two of its own interfaces. The step recorder
(``obs/trainwatch.py``), which ``run_train`` always installs, receives
every step's loss. The snapshot hook (``checkpoint=``, as
``Engine.train`` passes a ``CheckpointManager``) is handed a
:class:`Tap` with ``checkpoint_every=1``: ``run_chunked_steps`` gives it
the initial state and the state after each step; it keeps the start and
the states after steps 1 and 3 by reference, writes nothing and drops
the rest. Adam's first moment after one step is ``(1 − β1)·g``, so the
first gradient's norm is read from it. Only the window's first run, the
one run every window holds, is given the hook; every later run is called
as ``run_train`` calls the trainer, without one.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional, Tuple

import torch

from portbench import compare, counts, gen, peaks
from portbench.reference import flat, tf32_on
from portbench.reference.adam import B1
from portbench.reference.train import Observation, norm

#: steps of a run that the reference follows
CHECK_STEPS = 3
#: the run index of the warm-up run's seed
WARM_RUN = 1 << 30


class Tap:
    """A snapshot sink in the place of ``CheckpointManager``."""

    def __init__(self) -> None:
        self.states: Dict[int, tuple] = {}

    def restore(self, template, fingerprint=None):
        self.states[0] = template
        return None

    def save(self, step, state, fingerprint=None) -> None:
        if step in (1, CHECK_STEPS):
            self.states[step] = state


def observe(tap: Tap, losses: List[float]) -> Observation:
    """The program's first steps, as the reference's are read."""
    p0 = flat(tap.states[0][1])
    mu1 = flat(tap.states[1][2]["mu"])
    p3 = flat(tap.states[CHECK_STEPS][1])
    return Observation(
        losses=list(losses[:CHECK_STEPS]),
        grad_norms={k: norm(v) / (1 - B1) for k, v in mu1.items()},
        change_norms={k: norm(p3[k] - p0[k]) for k in p0},
        start={k: v.detach().cpu() for k, v in p0.items()},
    )


class TrainDriver:
    """A cell of whole training runs. A subclass makes the inputs
    (:meth:`inputs`), calls the trainer (:meth:`train`) and follows a
    run's first steps in the reference (:meth:`reference`)."""

    unit_name = "train"

    def __init__(self, config: dict, mix: dict, seed: int, device) -> None:
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        #: optimizer steps of a run (set by :meth:`inputs`)
        self.steps = 0
        self.peak = (peaks.for_device(torch.cuda.get_device_name(self.device))
                     if self.device.type == "cuda" else None)
        #: (run seed, tap, losses) of the run kept for the check
        self.kept: List[Tuple[int, Tap, List[float]]] = []
        self.observed: List[Tuple[int, Observation]] = []
        self.tf32_seen = False
        #: seconds of each phase of :meth:`setup`
        self.setup_split: Dict[str, float] = {}
        self._recording = None
        self._refs: Dict[int, Observation] = {}

    # -- a subclass's part ----------------------------------------------
    def inputs(self) -> None:
        """Make the inputs from the seed and set :attr:`steps`."""
        raise NotImplementedError

    def train(self, run_seed: int, steps: int, tap: Optional[Tap],
              rows: Optional[int] = None):
        """One run over the first ``rows`` histories (all where None);
        ``tap`` None: no snapshot hook."""
        raise NotImplementedError

    #: the model's head leaves, for ``compare.training``
    head: Tuple[str, ...] = ()

    def reference(self, run_seed: int, tf32: bool = False,
                  half_batch: bool = False) -> Observation:
        raise NotImplementedError

    def step_work(self, step: int) -> Tuple[float, float]:
        """(FLOPs, bytes) of a run's step ``step``."""
        raise NotImplementedError

    # -- the harness's part -----------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        from pio_tpu_torch.obs import trainwatch

        t = time.perf_counter()
        self.inputs()
        self._sync()
        self.setup_split["inputs"] = time.perf_counter() - t
        self.recorder = trainwatch.StepRecorder(
            "portbench", loss_window=max(self.steps, 64))
        self._recording = trainwatch.recording(self.recorder)
        self._recording.__enter__()
        t = time.perf_counter()
        # the same call and chunking as the window's checked run, on a
        # run seed the window does not reach and the first batches alone:
        # the steps' shapes are the window's, the staging is smaller
        self.train(gen.run_seed(self.seed, WARM_RUN), CHECK_STEPS, Tap(),
                   rows=CHECK_STEPS * int(self.mix["batch_size"]))
        self._sync()
        self.setup_split["warm_up"] = time.perf_counter() - t
        t = time.perf_counter()
        work = [self.step_work(s) for s in range(self.steps)]
        self.run_flops = sum(f for f, _ in work)
        self.run_least_s = (
            sum(counts.least_seconds(f, b, self.peak) for f, b in work)
            if self.peak else None)
        self.setup_split["counts"] = time.perf_counter() - t

    def unit(self, k: int, steps: Optional[int] = None) -> dict:
        """The window's ``k``-th run, of ``steps`` steps (a whole run
        where None; the readings take the checked steps alone)."""
        steps = self.steps if steps is None else steps
        rs = gen.run_seed(self.seed, k)
        tap = Tap() if k == 0 else None
        self.train(rs, steps, tap)
        self._sync()
        self.tf32_seen = self.tf32_seen or tf32_on()
        losses = list(self.recorder.losses)
        if tap is not None:
            self.kept.append((rs, tap, losses))
        whole = steps == self.steps
        return {"steps": steps,
                "flops": self.run_flops if whole else 0,
                "least_s": self.run_least_s if whole else None,
                "attempted": steps,
                "failed": sum(1 for v in losses if not math.isfinite(v))
                + max(0, steps - len(losses))}

    def release(self) -> None:
        """After the window: read the checked run's first steps, then let go
        of every tensor of the program."""
        self.observed = [(rs, observe(tap, losses))
                         for rs, tap, losses in self.kept]
        self.kept = []
        if self._recording is not None:
            self._recording.__exit__(None, None, None)
            self._recording = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, variant: str = "program") -> Dict[str, float]:
        """The compared numbers of the checked run. ``variant``:
        ``program``, or in the program's place the reference in TF32
        (``control``), with half of each batch (``half_batch``) or with a
        state that never changes (``unchanged``)."""
        worst: Dict[str, float] = {}
        for rs, obs in self.observed:
            if rs not in self._refs:
                self._refs[rs] = self.reference(rs)
            ref = self._refs[rs]
            if variant == "control":
                obs = self.reference(rs, tf32=True)
            elif variant == "half_batch":
                obs = self.reference(rs, half_batch=True)
            elif variant == "unchanged":
                obs = Observation(
                    losses=ref.losses,
                    grad_norms={k: 0.0 for k in ref.grad_norms},
                    change_norms={k: 0.0 for k in ref.change_norms},
                    start=ref.start)
            elif variant != "program":
                raise ValueError(f"unknown variant {variant!r}")
            for name, v in compare.training(obs, ref, self.head).items():
                worst[name] = max(worst.get(name, 0.0), v)
        if not self.observed:
            worst["runs_checked"] = math.inf
        worst["tf32_allowed"] = float(self.tf32_seen and variant == "program")
        return worst

