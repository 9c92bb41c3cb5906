"""The check that nothing of JAX or of the JAX package is loaded.

Names are compared by their top-level part (before the first dot),
whole: ``pio_tpu_torch`` is the port, ``pio_tpu`` the JAX package.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pio_tpu"})


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    names = list(sys.modules) if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
