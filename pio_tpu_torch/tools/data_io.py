"""Event import/export as JSON-lines files.

Rebuild of the reference's ``tools/.../tools/export/EventsToFile.scala`` and
``tools/.../tools/imprt/FileToEvents.scala`` (UNVERIFIED paths; see
SURVEY.md). Lines use the Event wire format (camelCase), so exports from the
reference's SDKs import unchanged. The port's copy of
``pio_tpu/tools/data_io.py`` (the port imports nothing of ``pio_tpu``).
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

from pio_tpu_torch.data.event import Event, EventValidationError
from pio_tpu_torch.storage.registry import Storage


def import_events(
    path: str, app_id: int, channel_id: Optional[int] = None,
    batch_size: int = 5000,
) -> Tuple[int, int]:
    """Returns (imported, failed). Bad lines are skipped, not fatal."""
    pevents = Storage.get_pevents()
    imported = failed = 0
    batch = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                batch.append(Event.from_api_dict(json.loads(line)))
            except (json.JSONDecodeError, EventValidationError):
                failed += 1
                continue
            if len(batch) >= batch_size:
                pevents.write(batch, app_id, channel_id)
                imported += len(batch)
                batch = []
    if batch:
        pevents.write(batch, app_id, channel_id)
        imported += len(batch)
    return imported, failed


def export_events(
    path: str, app_id: int, channel_id: Optional[int] = None
) -> int:
    events = Storage.get_pevents().find(app_id, channel_id=channel_id)
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e.to_api_dict()) + "\n")
    return len(events)
