"""Event data model: Event, DataMap, PropertyMap, BiMap, aggregation,
compaction and the event-store facades (the port's copy of
``pio_tpu/data``, exported as the reference's ``pio_tpu/data/__init__.py``
exports it)."""

from pio_tpu_torch.data.datamap import DataMap, PropertyMap
from pio_tpu_torch.data.event import Event, EventValidationError, validate_event
from pio_tpu_torch.data.bimap import BiMap
from pio_tpu_torch.data.aggregation import aggregate_properties, fold_properties
from pio_tpu_torch.data.cleaning import (
    EventWindow,
    SelfCleaningDataSource,
    clean_events,
    parse_duration,
)
from pio_tpu_torch.data.store import LEventStore, PEventStore

__all__ = [
    "DataMap",
    "PropertyMap",
    "Event",
    "EventValidationError",
    "validate_event",
    "BiMap",
    "aggregate_properties",
    "fold_properties",
    "EventWindow",
    "SelfCleaningDataSource",
    "clean_events",
    "parse_duration",
    "LEventStore",
    "PEventStore",
]
