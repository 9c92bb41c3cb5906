"""Webhook connectors — third-party payloads → Events.

The port's copy of ``pio_tpu/server/webhooks.py`` (the port imports
nothing of ``pio_tpu``).

Rebuild of the reference's ``data/.../data/api/webhooks/`` +
``data/webhooks/{segmentio,mailchimp}`` (UNVERIFIED paths; see SURVEY.md):
a connector turns a JSON or form payload into the Event wire format. The
Event Server exposes ``POST /webhooks/<name>.json`` (JSON connectors) and
``POST /webhooks/<name>.form`` (form connectors).
"""

from __future__ import annotations

import abc
from typing import Any, Dict

from urllib.parse import parse_qs


class ConnectorError(ValueError):
    pass


class JsonConnector(abc.ABC):
    """JSON payload → Event wire dict (reference ``JsonConnector``)."""

    @abc.abstractmethod
    def to_event_dict(self, payload: Dict[str, Any]) -> Dict[str, Any]: ...


class FormConnector(abc.ABC):
    """Form payload → Event wire dict (reference ``FormConnector``)."""

    @abc.abstractmethod
    def to_event_dict(self, form: Dict[str, str]) -> Dict[str, Any]: ...


class SegmentIOConnector(JsonConnector):
    """segment.com track/identify/page/screen payloads
    (reference ``SegmentIOConnector``)."""

    SUPPORTED = {"track", "identify", "page", "screen", "group", "alias"}

    def to_event_dict(self, payload):
        typ = payload.get("type")
        if typ not in self.SUPPORTED:
            raise ConnectorError(f"unsupported segment.io type {typ!r}")
        user = payload.get("userId") or payload.get("anonymousId")
        if not user:
            raise ConnectorError("payload needs userId or anonymousId")
        out = {
            "event": (
                payload.get("event") if typ == "track" and payload.get("event")
                else typ
            ),
            "entityType": "user",
            "entityId": str(user),
            "properties": payload.get("properties")
            or payload.get("traits")
            or {},
        }
        if payload.get("timestamp"):
            out["eventTime"] = payload["timestamp"]
        return out


class MailChimpConnector(FormConnector):
    """MailChimp webhook form posts (reference ``MailChimpConnector``)."""

    SUPPORTED = {"subscribe", "unsubscribe", "profile", "upemail", "cleaned",
                 "campaign"}

    def to_event_dict(self, form):
        typ = form.get("type")
        if typ not in self.SUPPORTED:
            raise ConnectorError(f"unsupported mailchimp type {typ!r}")
        email = form.get("data[email]") or form.get("data[new_email]")
        if not email:
            raise ConnectorError("mailchimp payload needs data[email]")
        props = {
            k[len("data["):-1]: v
            for k, v in form.items()
            if k.startswith("data[") and k.endswith("]")
        }
        out = {
            "event": typ,
            "entityType": "user",
            "entityId": email,
            "properties": props,
        }
        if form.get("fired_at"):
            out["eventTime"] = form["fired_at"].replace(" ", "T") + "Z"
        return out


class ExampleJsonConnector(JsonConnector):
    """Identity-ish connector used by tests (reference
    ``webhooks/exampleJson``)."""

    def to_event_dict(self, payload):
        if "event" not in payload:
            raise ConnectorError("payload needs 'event'")
        return payload


def parse_form(raw: str) -> Dict[str, str]:
    return {k: v[0] for k, v in parse_qs(raw, keep_blank_values=True).items()}


#: name → connector registry (reference wires connectors statically too)
JSON_CONNECTORS: Dict[str, JsonConnector] = {
    "segmentio": SegmentIOConnector(),
    "example": ExampleJsonConnector(),
}
FORM_CONNECTORS: Dict[str, FormConnector] = {
    "mailchimp": MailChimpConnector(),
}
