"""engine.json variant loading (reference ``WorkflowUtils.getEngine`` +
``Engine.jValueToEngineParams``, UNVERIFIED paths; see SURVEY.md).

Format (parity with the reference's engine.json):

    {
      "id": "default",
      "version": "1",
      "description": "...",
      "engineFactory": "org.example.RecommendationEngine",
      "datasource": {"params": {...}},
      "preparator": {"params": {...}},
      "algorithms": [{"name": "als", "params": {...}}],
      "serving": {"params": {...}},
      "jaxConf": {"mesh_axes": ["data"], ...}
    }

``engineFactory`` resolves through the engine registry (or a
``module:attr`` path) instead of JVM reflection. The port's copy of
``pio_tpu/workflow/engine_json.py`` (the port imports nothing of
``pio_tpu``); the ``jaxConf`` section is kept as the reference stores it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

from pio_tpu_torch.controller.engine import Engine, EngineParams, get_engine_factory


class EngineJsonError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class EngineVariant:
    """Parsed engine.json metadata + raw variant dict."""

    engine_id: str
    engine_version: str
    engine_factory: str
    variant: Dict[str, Any]
    path: str = ""

    @property
    def variant_json(self) -> str:
        return json.dumps(self.variant, sort_keys=True)

    @property
    def jax_conf(self) -> Dict[str, Any]:
        return self.variant.get("jaxConf", {})


def load_variant(path: str) -> EngineVariant:
    if not os.path.exists(path):
        raise EngineJsonError(f"engine variant file not found: {path}")
    with open(path) as f:
        try:
            variant = json.load(f)
        except json.JSONDecodeError as e:
            raise EngineJsonError(f"{path}: invalid JSON: {e}") from None
    return variant_from_dict(variant, path=path)


def variant_from_dict(variant: Dict[str, Any], path: str = "") -> EngineVariant:
    if "engineFactory" not in variant:
        raise EngineJsonError("engine.json must declare 'engineFactory'")
    return EngineVariant(
        engine_id=str(variant.get("id", "default")),
        engine_version=str(variant.get("version", "1")),
        engine_factory=variant["engineFactory"],
        variant=variant,
        path=path,
    )


def build_engine(variant: EngineVariant) -> Tuple[Engine, EngineParams]:
    """Factory lookup + params binding — the ``pio train`` front half."""
    factory = get_engine_factory(variant.engine_factory)
    engine = factory()
    engine_params = engine.params_from_variant(variant.variant)
    return engine, engine_params
