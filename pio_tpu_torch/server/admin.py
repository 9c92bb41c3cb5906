"""Admin API server — REST app/key management.

The port's copy of ``pio_tpu/server/admin.py`` (PredictionIO's
experimental admin API), over the port's stores. Routes:

- ``GET /``                      — server alive info;
- ``GET /cmd/status``            — storage backend self-check
  (≙ ``Storage.verifyAllDataObjects`` behind ``pio status``);
- ``GET /cmd/app``               — list apps with their access keys;
- ``POST /cmd/app``              — create app ``{"name": ...}`` (+ access key);
- ``DELETE /cmd/app/<name>``     — delete app, its keys, channels, events;
- ``DELETE /cmd/app/<name>/data``— delete the app's event data only.
"""

from __future__ import annotations

from typing import Any, Tuple

from pio_tpu_torch.server.http import (
    HTTPError, JsonHTTPServer, Request, Router, keys_equal,
)
from pio_tpu_torch.storage import AccessKey, App, Storage


class AdminService:
    """≙ reference ``AdminServiceActor`` + ``CommandClient``.

    Mutating routes follow the query server's admin-guard convention:
    loopback-only unless an ``admin_key`` is configured and presented.
    """

    def __init__(self, admin_key=None):
        self.admin_key = admin_key
        self.router = Router()
        self.router.add("GET", "/", self.index)
        self.router.add("GET", "/cmd/status", self.status)
        self.router.add("GET", "/cmd/app", self.list_apps)
        self.router.add("POST", "/cmd/app", self.new_app)
        self.router.add("DELETE", "/cmd/app/([^/]+)", self.delete_app)
        self.router.add(
            "DELETE", "/cmd/app/([^/]+)/data", self.delete_app_data
        )

    def _check_admin(self, req: Request):
        if self.admin_key is not None:
            if not keys_equal(req.bearer_key(), self.admin_key):
                raise HTTPError(401, "invalid admin accessKey")
        elif req.client_addr not in ("127.0.0.1", "::1"):
            raise HTTPError(
                403, "mutating admin routes are loopback-only without an "
                     "admin key"
            )

    def index(self, req: Request) -> Tuple[int, Any]:
        return 200, {
            "status": "alive",
            "description": "pio-tpu Admin API",
        }

    def status(self, req: Request) -> Tuple[int, Any]:
        try:
            Storage.verify_all_data_objects()
        except Exception as e:  # surface, don't 500 — it's a health check
            return 200, {"status": "error", "message": str(e)}
        return 200, {"status": "ok"}

    def _app_dict(self, app: App) -> dict:
        keys = Storage.get_meta_data_access_keys().get_by_app_id(app.id)
        return {
            "name": app.name,
            "id": app.id,
            "accessKeys": [k.key for k in keys],
        }

    def list_apps(self, req: Request) -> Tuple[int, Any]:
        apps = Storage.get_meta_data_apps().get_all()
        return 200, {"apps": [self._app_dict(a) for a in apps]}

    def new_app(self, req: Request) -> Tuple[int, Any]:
        self._check_admin(req)
        if not isinstance(req.body, dict) or not req.body.get("name"):
            return 400, {"message": "body must be {\"name\": ...}"}
        name = str(req.body["name"])
        try:
            requested_id = int(req.body.get("id") or 0)
        except (TypeError, ValueError):
            return 400, {"message": "\"id\" must be an integer"}
        apps = Storage.get_meta_data_apps()
        if apps.get_by_name(name) is not None:
            return 409, {"message": f"app {name!r} already exists"}
        app_id = apps.insert(App(requested_id, name))
        key = AccessKey(key="", app_id=app_id, events=())
        key_str = Storage.get_meta_data_access_keys().insert(key)
        return 201, {"name": name, "id": app_id, "accessKeys": [key_str]}

    def _resolve(self, name: str):
        return Storage.get_meta_data_apps().get_by_name(name)

    def delete_app(self, req: Request) -> Tuple[int, Any]:
        self._check_admin(req)
        app = self._resolve(req.path_args[0])
        if app is None:
            return 404, {"message": "app not found"}
        keys = Storage.get_meta_data_access_keys()
        for k in keys.get_by_app_id(app.id):
            keys.delete(k.key)
        chans = Storage.get_meta_data_channels()
        for c in chans.get_by_app_id(app.id):
            Storage.get_levents().remove(app.id, channel_id=c.id)
            chans.delete(c.id)
        Storage.get_levents().remove(app.id)
        Storage.get_meta_data_apps().delete(app.id)
        return 200, {"message": f"deleted app {app.name!r}"}

    def delete_app_data(self, req: Request) -> Tuple[int, Any]:
        self._check_admin(req)
        app = self._resolve(req.path_args[0])
        if app is None:
            return 404, {"message": "app not found"}
        for c in Storage.get_meta_data_channels().get_by_app_id(app.id):
            Storage.get_levents().remove(app.id, channel_id=c.id)
        Storage.get_levents().remove(app.id)
        return 200, {"message": f"deleted data of app {app.name!r}"}


def create_admin_server(
    host: str = "0.0.0.0", port: int = 7071, admin_key=None
) -> JsonHTTPServer:
    """Build (unstarted) admin server — reference ``AdminAPI.main``."""
    service = AdminService(admin_key=admin_key)
    return JsonHTTPServer(service.router, host, port, name="pio-tpu-admin")
