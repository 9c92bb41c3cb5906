"""Blob daemon — the remote Models endpoint behind ``http://`` blob URIs.

The port's copy of ``pio_tpu/server/blob_server.py`` (the port imports
nothing of ``pio_tpu``), on the port's ``server/http.py``: a flat key →
bytes store served over HTTP from a local root, consumed by the
``http://`` scheme registered in ``pio_tpu_torch.storage.blobstore`` — so
a training host can persist models to a storage host and a serving host
can load them, with nothing shared but a socket. Content addressing,
digest verification, dedupe, and ref-count GC all live in the client
(:class:`~pio_tpu_torch.storage.blobstore.BlobModels`); the daemon stays a
plain byte store.

Routes (keys are percent-encoded path remainders; bodies are raw bytes):

    GET    /blobs/<key>      blob bytes | 404
    HEAD   /blobs/<key>      existence probe
    PUT    /blobs/<key>      store body bytes (201)
    DELETE /blobs/<key>      200 | 404
    GET    /keys?prefix=p    JSON list of keys under a prefix
    GET    /                 health/info

Auth: optional shared key — ``create_blob_server(..., access_key=...)``
requires ``Authorization: Bearer <key>`` (or ``?accessKey=``) on every
route, checked before a body is read. TLS from ``PIO_TPU_SSL_CERTFILE`` /
``PIO_TPU_SSL_KEYFILE``, as on every threaded server of the port.

Start one with the CLI: ``python -m pio_tpu_torch blobserver --root DIR``.
"""

from __future__ import annotations

from typing import Optional
from urllib.parse import unquote

from pio_tpu_torch.server.http import (
    FileResponse, HTTPError, JsonHTTPServer, Request, Router, keys_equal,
)
from pio_tpu_torch.storage.blobstore import FileBlobBackend


class BlobServerService:
    """Route handlers over a :class:`FileBlobBackend` root."""

    def __init__(self, root: str, access_key: Optional[str] = None):
        self.backend = FileBlobBackend(root)
        self.access_key = access_key
        self.router = Router()
        r = self.router
        r.add("GET", "/", self.info)
        r.add("GET", "/blobs/(.+)", self.get_blob)
        r.add("HEAD", "/blobs/(.+)", self.head_blob)
        r.add("PUT", "/blobs/(.+)", self.put_blob)
        r.add("DELETE", "/blobs/(.+)", self.delete_blob)
        r.add("GET", "/keys", self.list_keys)

    def _auth(self, req: Request) -> None:
        if self.access_key is not None and not keys_equal(
            req.bearer_key(), self.access_key
        ):
            raise HTTPError(401, "invalid accessKey")

    @staticmethod
    def _key(req: Request) -> str:
        key = unquote(req.path_args[0])
        if not key or key.startswith("/") or ".." in key.split("/"):
            raise HTTPError(400, f"invalid blob key {key!r}")
        return key

    def info(self, req: Request):
        self._auth(req)
        return 200, {"status": "alive", "service": "pio-tpu-blobserver"}

    def get_blob(self, req: Request):
        self._auth(req)
        path = self.backend.local_path(self._key(req))
        if path is None:
            raise HTTPError(404, "no such blob")
        # streamed in constant memory — concurrent GETs of a multi-GB
        # model must not each buffer the whole artifact
        return 200, FileResponse(path)

    def head_blob(self, req: Request):
        self._auth(req)
        if not self.backend.exists(self._key(req)):
            raise HTTPError(404, "no such blob")
        return 200, None

    def put_blob(self, req: Request):
        self._auth(req)
        if req.body_file is not None:
            # large uploads arrive spooled — stream to disk, never buffer
            n = self.backend.put_file(self._key(req), req.body_file)
        else:
            n = len(req.raw_body)
            self.backend.put(self._key(req), req.raw_body)
        return 201, {"stored": n}

    def delete_blob(self, req: Request):
        self._auth(req)
        if not self.backend.delete(self._key(req)):
            raise HTTPError(404, "no such blob")
        return 200, {"deleted": True}

    def list_keys(self, req: Request):
        self._auth(req)
        return 200, {"keys": self.backend.list(req.params.get("prefix", ""))}


def create_blob_server(
    root: str,
    host: str = "0.0.0.0",
    port: int = 7088,
    access_key: Optional[str] = None,
) -> JsonHTTPServer:
    """Build an (unstarted) blob daemon serving ``root`` over HTTP."""
    service = BlobServerService(root, access_key=access_key)
    return JsonHTTPServer(
        service.router, host, port, name="pio-tpu-blobserver",
        # reject bad keys BEFORE the body is spooled off the socket —
        # an unauthenticated PUT must not burn disk up to the body limit
        pre_body=service._auth,
        # the blob daemon is the ONE server allowed multi-GB
        # octet-stream bodies (pre-body-authenticated); every other
        # server keeps the tight structured-body cap for raw uploads too
        large_uploads=True,
    )
