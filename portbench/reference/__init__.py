"""Plain references of what the cells run, in float32 with TF32 off.

Plain PyTorch and NumPy only: nothing here imports ``jax``, the JAX
package or anything of the port, and nothing takes a tensor the program
made. What the program derives from the inputs (its initial parameters,
drawn inside its trainers from the run's seed; its batch order) is
worked out again here from the law the port documents.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch


def flat(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"a/b": leaf}`` of a dict of tensors or of such dicts, in
    insertion order."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products in full float32 (``tf32`` False, the
    configurations' precision) or through TF32 (the control's)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def tf32_on() -> bool:
    """Is any float32 product of this process allowed to run in TF32?"""
    return bool(torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest")
