"""Server plugin framework — ingest- and query-path hooks.

The port's copy of ``pio_tpu/server/plugins.py`` (the port imports
nothing of ``pio_tpu``).

Rebuild of the reference's ServiceLoader-discovered plugins
(``data/.../api/EventServerPlugin.scala`` and
``core/.../workflow/EngineServerPlugin.scala`` + their PluginContext/Actors —
UNVERIFIED paths; SURVEY.md §2.1/§2.2): *input blockers* can reject an event
before it is persisted, *input sniffers* observe accepted events, *output
blockers* veto/transform query responses, *output sniffers* observe them.

Java ServiceLoader discovery becomes Python module discovery: set
``PIO_TPU_PLUGINS=my_mod,other_mod`` and each module is imported at server
start; modules call :func:`register_plugin` at import time. Both servers
expose ``GET /plugins.json`` listing what's installed. A plugin module
registers with the package whose servers it hooks: a module written for
the reference registers there, one for the port here.
"""

from __future__ import annotations

import abc
import importlib
import logging
from typing import Any, Dict, List, Optional

from pio_tpu_torch.utils import knobs

log = logging.getLogger("pio_tpu_torch.plugins")

# plugin_type values (reference constants on both plugin traits)
INPUT_BLOCKER = "inputblocker"
INPUT_SNIFFER = "inputsniffer"
OUTPUT_BLOCKER = "outputblocker"
OUTPUT_SNIFFER = "outputsniffer"


class EventServerPlugin(abc.ABC):
    """Ingest-path hook (reference ``EventServerPlugin``).

    ``plugin_type`` is :data:`INPUT_BLOCKER` (``process`` may raise
    ``ValueError`` to reject the event with a 400) or :data:`INPUT_SNIFFER`
    (exceptions are logged and swallowed).
    """

    plugin_name: str = "unnamed"
    plugin_description: str = ""
    plugin_type: str = INPUT_SNIFFER

    @abc.abstractmethod
    def process(
        self, event: Dict[str, Any], app_id: int, channel_id: Optional[int]
    ) -> None: ...


class EngineServerPlugin(abc.ABC):
    """Query-path hook (reference ``EngineServerPlugin``).

    ``plugin_type`` is :data:`OUTPUT_BLOCKER` (``process`` may raise
    ``ValueError`` to fail the query) or :data:`OUTPUT_SNIFFER`.
    """

    plugin_name: str = "unnamed"
    plugin_description: str = ""
    plugin_type: str = OUTPUT_SNIFFER

    @abc.abstractmethod
    def process(self, query: Any, prediction: Any) -> None: ...


_event_plugins: List[EventServerPlugin] = []
_engine_plugins: List[EngineServerPlugin] = []


def register_plugin(plugin) -> None:
    """Install a plugin instance into the matching server hook list.

    Rejects unknown ``plugin_type`` values — a typo'd blocker silently
    installed as a sniffer would stop blocking.
    """
    from pio_tpu_torch.server import event_server, query_server

    if isinstance(plugin, EventServerPlugin):
        if plugin.plugin_type not in (INPUT_BLOCKER, INPUT_SNIFFER):
            raise ValueError(
                f"EventServerPlugin.plugin_type must be {INPUT_BLOCKER!r} "
                f"or {INPUT_SNIFFER!r}, got {plugin.plugin_type!r}"
            )
        _event_plugins.append(plugin)
        hook = lambda app_id, channel_id, d: plugin.process(d, app_id, channel_id)
        if plugin.plugin_type == INPUT_BLOCKER:
            event_server.INPUT_BLOCKERS.append(hook)
        else:
            event_server.INPUT_SNIFFERS.append(hook)
    elif isinstance(plugin, EngineServerPlugin):
        if plugin.plugin_type not in (OUTPUT_BLOCKER, OUTPUT_SNIFFER):
            raise ValueError(
                f"EngineServerPlugin.plugin_type must be {OUTPUT_BLOCKER!r} "
                f"or {OUTPUT_SNIFFER!r}, got {plugin.plugin_type!r}"
            )
        _engine_plugins.append(plugin)
        hook = lambda body, out: plugin.process(body, out)
        if plugin.plugin_type == OUTPUT_BLOCKER:
            query_server.QUERY_BLOCKERS.append(hook)
        else:
            query_server.QUERY_SNIFFERS.append(hook)
    else:
        raise TypeError(
            "plugin must be an EventServerPlugin or EngineServerPlugin"
        )


def clear_plugins() -> None:
    """Uninstall everything (tests)."""
    from pio_tpu_torch.server import event_server, query_server

    _event_plugins.clear()
    _engine_plugins.clear()
    event_server.INPUT_BLOCKERS.clear()
    event_server.INPUT_SNIFFERS.clear()
    query_server.QUERY_BLOCKERS.clear()
    query_server.QUERY_SNIFFERS.clear()


# pio: endpoint=/plugins.json
def installed_plugins() -> Dict[str, List[dict]]:
    """Listing for ``GET /plugins.json`` (reference plugins route)."""

    def entry(p):
        return {
            "name": p.plugin_name,
            "description": p.plugin_description,
            "type": p.plugin_type,
        }

    return {
        "eventServerPlugins": [entry(p) for p in _event_plugins],
        "engineServerPlugins": [entry(p) for p in _engine_plugins],
    }


def load_plugins_from_env(env_var: str = "PIO_TPU_PLUGINS") -> List[str]:
    """Import each module named in ``$PIO_TPU_PLUGINS`` (comma-separated).

    Modules self-register via :func:`register_plugin` at import time — the
    Python analog of META-INF/services discovery. Returns the modules loaded.
    """
    import sys

    loaded = []
    for name in filter(None, knobs.knob_str(env_var).split(",")):
        name = name.strip()
        try:
            if name in sys.modules:
                # a cached import would skip the module's register_plugin
                # calls (e.g. after clear_plugins() on redeploy) — re-run it
                importlib.reload(sys.modules[name])
            else:
                importlib.import_module(name)
            loaded.append(name)
        except Exception:
            log.exception("failed to load plugin module %s", name)
    return loaded
