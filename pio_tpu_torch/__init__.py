"""pio_tpu_torch — the PyTorch/CUDA port of pio_tpu, for one NVIDIA H100.

The package mirrors ``pio_tpu``'s layout module for module, so each file
here has a counterpart of the same path there. ``pio_tpu`` stays the
reference: this package imports neither ``jax`` nor anything of
``pio_tpu``, and keeps its own copies of the jax-free helpers it needs.

Every entry point places its tensors on :func:`resolve_device`'s answer:
CUDA unless the caller asks for ``device="cpu"`` (as the CPU tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is available — the port never carries on quietly
    on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pio_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


__all__ = ["resolve_device", "__version__"]
