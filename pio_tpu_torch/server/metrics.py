"""DEPRECATED compatibility shim — import from ``pio_tpu_torch.obs.metrics``
(escaping helpers) and ``pio_tpu_torch.server.http`` (``metrics_response``)
instead.

The port's copy of the reference's shim (``pio_tpu/server/metrics.py``):
the metric types and escaping live in :mod:`pio_tpu_torch.obs.metrics`,
and the HTTP scrape wrapper is
:func:`pio_tpu_torch.server.http.metrics_response`. Nothing in the port
imports this module; it stays for plugins written against the old names,
and importing it warns.
"""

from __future__ import annotations

import warnings

from pio_tpu_torch.obs.metrics import escape_help, escape_label_value
from pio_tpu_torch.server.http import METRICS_CONTENT_TYPE as CONTENT_TYPE
from pio_tpu_torch.server.http import metrics_response

warnings.warn(
    "pio_tpu_torch.server.metrics is deprecated: import escaping helpers "
    "from pio_tpu_torch.obs.metrics and metrics_response from "
    "pio_tpu_torch.server.http",
    DeprecationWarning,
    stacklevel=2,
)


def escape_label(value: str) -> str:
    """Escape a label value per the Prometheus text format
    (compatibility wrapper over :func:`~pio_tpu_torch.obs.metrics.
    escape_label_value`)."""
    return escape_label_value(value)


def render(lines: list) -> "object":
    """Compatibility wrapper over
    :func:`pio_tpu_torch.server.http.metrics_response`."""
    return metrics_response(lines)


__all__ = ["CONTENT_TYPE", "escape_help", "escape_label", "render"]
