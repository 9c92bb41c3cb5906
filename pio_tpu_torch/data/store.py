"""Event-store name lookups.

The port's copy of ``resolve_channel`` from ``pio_tpu/data/store.py`` (the
port imports nothing of ``pio_tpu``). The ``PEventStore`` / ``LEventStore``
facades come with the storage slice.
"""

from __future__ import annotations

from typing import Optional


def resolve_channel(app_id: int, channel_name: Optional[str]) -> Optional[int]:
    """channel_id from its name within an app; None = default channel."""
    if not channel_name:
        return None
    # deferred: pio_tpu_torch.storage imports pio_tpu_torch.data at load
    from pio_tpu_torch.storage.registry import Storage

    chans = Storage.get_meta_data_channels().get_by_app_id(app_id)
    match = [c for c in chans if c.name == channel_name]
    if not match:
        raise ValueError(f"channel {channel_name!r} not found")
    return match[0].id
