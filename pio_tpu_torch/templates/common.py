"""Helpers shared by the templates.

The port's copy of ``resolve_app`` from ``pio_tpu/templates/common.py``
(the port imports nothing of ``pio_tpu``). The device scorer and the
item-scoring rules come with the recommendation slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

from pio_tpu_torch.data.store import resolve_channel
from pio_tpu_torch.storage.registry import Storage


def resolve_app(params) -> Tuple[int, Optional[int]]:
    """(app_id, channel_id) from datasource params.

    ``params`` needs ``app_name``/``app_id`` and optionally ``channel``
    attributes (every bundled DataSourceParams has them).
    """
    app_id = params.app_id
    if params.app_name:
        app = Storage.get_meta_data_apps().get_by_name(params.app_name)
        if app is None:
            raise ValueError(f"app {params.app_name!r} not found")
        app_id = app.id
    if not app_id:
        raise ValueError("datasource params need app_name or app_id")
    return app_id, resolve_channel(app_id, getattr(params, "channel", ""))
