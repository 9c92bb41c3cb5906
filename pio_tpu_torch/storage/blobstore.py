"""Content-addressed blob Models store — the HDFS/S3 slot.

The port's copy of ``pio_tpu/storage/blobstore.py`` (the port imports
nothing of ``pio_tpu``), with the same layout, so a blob root written by
either package is read by the other:

- A tiny **BlobBackend SPI** (put/get/delete/exists/list on flat keys)
  keyed by URI scheme. ``file://`` and a network scheme ship in-tree:
  ``http(s)://`` talks to the blob daemon
  (:mod:`pio_tpu_torch.server.blob_server`, ``python -m pio_tpu_torch
  blobserver``), so model bytes cross a socket. ``gs://``/``s3://``/
  ``hdfs://`` plug in by registering a backend for their scheme
  (:func:`register_blob_scheme`) — the Models trait above them does not
  change.
- **Content addressing**: blobs live at ``objects/<aa>/<sha256>`` and a
  mutable ``refs/<model-id>`` pointer names the current blob. Identical
  models dedupe, every read is digest-verified end to end (a corrupt or
  torn remote object is an error, not a silently wrong model), and
  overwrites and deletes garbage-collect unreferenced objects.

A ``file://`` write is a durable rename under ``PIO_TPU_DURABILITY``, with
the failpoint ``storage.blobstore.persist`` between the synced temporary
file and the rename, as in the reference.

Select it with::

    PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE=BLOB
    PIO_STORAGE_SOURCES_BLOB_TYPE=blob
    PIO_STORAGE_SOURCES_BLOB_PATH=file:///var/pio/models   # or http://host:7088
"""

from __future__ import annotations

import abc
import hashlib
import io
import os
import tempfile
from typing import Callable, Dict, List, Optional
from urllib.parse import quote, urlparse

from pio_tpu_torch.utils import knobs
from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.storage import base
from pio_tpu_torch.storage.durability import fsync_fileobj, replace_durable
from pio_tpu_torch.storage.records import Model

#: reserved suffix for in-flight atomic-write staging files; list() hides
#: exactly this suffix, so ordinary keys (even ones ending ".tmp") are
#: never masked. Don't name blobs with it.
_STAGING_SUFFIX = ".pio-staging"


class BlobBackend(abc.ABC):
    """Flat key → bytes store (the part a gs://, s3://, or hdfs:// client
    must implement; keys use '/' separators and are safe path segments)."""

    @abc.abstractmethod
    def put(self, key: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[bytes]: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...

    @abc.abstractmethod
    def exists(self, key: str) -> bool: ...

    @abc.abstractmethod
    def list(self, prefix: str) -> List[str]:
        """Keys under a prefix (used by ref-count garbage collection)."""


class FileBlobBackend(BlobBackend):
    """file:// — atomic single-file objects under a root directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.normpath(os.path.join(self.root, key))
        if not p.startswith(os.path.normpath(self.root) + os.sep):
            raise base.StorageError(f"blob key escapes the root: {key!r}")
        return p

    def put(self, key: str, data: bytes) -> None:
        self.put_file(key, io.BytesIO(data))

    def put_file(self, key: str, src, chunk_size: int = 1 << 20) -> int:
        """Stream an open binary file into the store in constant memory
        (the blob daemon's PUT path). Returns the byte count stored.

        The temp file is uniquely named per call (mkstemp) — the daemon
        is threaded, and two concurrent PUTs to one key must each write
        their own staging file; last os.replace wins atomically."""
        p = self._path(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            prefix=os.path.basename(p) + ".", suffix=_STAGING_SUFFIX,
            dir=os.path.dirname(p),
        )
        n = 0
        try:
            with os.fdopen(fd, "wb") as f:
                while chunk := src.read(chunk_size):
                    f.write(chunk)
                    n += len(chunk)
                # durable rename (durability knob): bytes on disk before
                # the rename publishes them, dir entry fsynced after
                fsync_fileobj(f)
            failpoint("storage.blobstore.persist")
            replace_durable(tmp, p)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return n

    def get(self, key: str) -> Optional[bytes]:
        p = self._path(key)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            return f.read()

    def delete(self, key: str) -> bool:
        p = self._path(key)
        if os.path.exists(p):
            os.remove(p)
            return True
        return False

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def local_path(self, key: str) -> Optional[str]:
        """Filesystem path of a stored blob (None if absent) — lets the
        blob daemon stream GETs instead of buffering whole artifacts."""
        p = self._path(key)
        return p if os.path.exists(p) else None

    def list(self, prefix: str) -> List[str]:
        base_dir = self._path(prefix) if prefix else self.root
        out = []
        for dirpath, _dirs, files in os.walk(base_dir):
            for f in files:
                if f.endswith(_STAGING_SUFFIX):
                    continue  # in-flight put_file staging, not a blob
                full = os.path.join(dirpath, f)
                out.append(os.path.relpath(full, self.root).replace(
                    os.sep, "/"
                ))
        return out


class HTTPBlobBackend(BlobBackend):
    """``http(s)://`` — client of the blob daemon
    (:mod:`pio_tpu_torch.server.blob_server`), i.e. the in-tree REMOTE Models
    backend: model bytes cross a socket, nothing is shared with the
    server but the URL. stdlib urllib only; keys percent-encode into the
    URL path; an optional access key rides the Authorization header
    (``PIO_TPU_BLOB_ACCESS_KEY`` or ``http://host:port/prefix?accessKey=…``).
    """

    def __init__(self, base_url: str, access_key: Optional[str] = None):
        from urllib.parse import parse_qs, urlsplit, urlunsplit

        parts = urlsplit(base_url)
        if access_key is None:
            qs = parse_qs(parts.query)
            access_key = (qs.get("accessKey") or [None])[0]
            if access_key is None:
                access_key = knobs.knob_raw("PIO_TPU_BLOB_ACCESS_KEY")
        self._key_hdr = access_key
        self.base = urlunsplit(
            (parts.scheme, parts.netloc, parts.path.rstrip("/"), "", "")
        )

    def _request(self, method: str, url: str, data: Optional[bytes] = None):
        import urllib.error
        import urllib.request

        req = urllib.request.Request(url, data=data, method=method)
        if data is not None:
            req.add_header("Content-Type", "application/octet-stream")
        if self._key_hdr:
            req.add_header("Authorization", f"Bearer {self._key_hdr}")
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return 404, b""
            raise base.StorageError(
                f"blob server {method} {url}: HTTP {e.code} "
                f"{e.read()[:200]!r}"
            )
        except urllib.error.URLError as e:
            raise base.StorageError(f"blob server unreachable: {e}")

    def _url(self, key: str) -> str:
        return f"{self.base}/blobs/{quote(key, safe='/')}"

    def put(self, key: str, data: bytes) -> None:
        status, _ = self._request("PUT", self._url(key), data)
        if status not in (200, 201):
            raise base.StorageError(f"blob put failed: HTTP {status}")

    def get(self, key: str) -> Optional[bytes]:
        status, data = self._request("GET", self._url(key))
        return None if status == 404 else data

    def delete(self, key: str) -> bool:
        status, _ = self._request("DELETE", self._url(key))
        return status != 404

    def exists(self, key: str) -> bool:
        status, _ = self._request("HEAD", self._url(key))
        return status != 404

    def list(self, prefix: str) -> List[str]:
        import json as _json
        from urllib.parse import quote as _q

        status, data = self._request(
            "GET", f"{self.base}/keys?prefix={_q(prefix, safe='')}"
        )
        if status == 404:
            return []
        return _json.loads(data.decode("utf-8"))["keys"]


#: scheme → factory(netloc_and_path) (the gs://, s3://, hdfs:// plug point)
_SCHEMES: Dict[str, Callable[[str], BlobBackend]] = {}


def register_blob_scheme(
    scheme: str, factory: Callable[[str], BlobBackend]
) -> None:
    _SCHEMES[scheme.lower()] = factory


register_blob_scheme("file", FileBlobBackend)
register_blob_scheme("http", lambda loc: HTTPBlobBackend(f"http://{loc}"))
register_blob_scheme("https", lambda loc: HTTPBlobBackend(f"https://{loc}"))


def open_blob_backend(uri: str) -> BlobBackend:
    """URI → backend. ``file:///path`` and bare paths ship today; other
    schemes resolve through the registry so a gs/s3/hdfs client can be
    plugged in without touching the Models trait."""
    parsed = urlparse(uri)
    scheme = (parsed.scheme or "file").lower()
    factory = _SCHEMES.get(scheme)
    if factory is None:
        raise base.StorageError(
            f"no blob backend registered for scheme {scheme!r} "
            f"(register one with pio_tpu_torch.storage.blobstore."
            f"register_blob_scheme)"
        )
    if scheme == "file":
        # file://HOST/path has no meaning here; accept file:///abs and bare
        location = parsed.path or uri
    else:
        location = (parsed.netloc + parsed.path).rstrip("/")
        if parsed.query:  # e.g. http://host:port/prefix?accessKey=…
            location += f"?{parsed.query}"
    return factory(location)


class BlobModels(base.Models):
    """Models trait over content-addressed blobs.

    ``objects/<aa>/<sha256>`` immutable blob; ``refs/<model-id>`` names
    the current digest (percent-encoded, so distinct ids can't collide).
    Reads verify the digest end-to-end; overwrites and deletes ref-count
    garbage-collect unreferenced objects.

    Concurrency: writes are safe per-key (atomic replace), and insert
    heals the dedupe/gc race by re-verifying its object after the ref
    write. A delete() on one process racing an insert() of the SAME bytes
    on another still has a tiny window to orphan the new ref — the same
    no-coordination contract the reference's HDFS/S3 stores have; get()
    then fails loudly ("referenced blob is missing") and a re-insert
    heals it.
    """

    def __init__(self, backend: BlobBackend):
        self._b = backend

    @staticmethod
    def _obj_key(digest: str) -> str:
        return f"objects/{digest[:2]}/{digest}"

    @staticmethod
    def _ref_key(model_id: str) -> str:
        # percent-encoding is injective — 'a/b' and 'a_b' must not share a
        # ref (a '/'-collapsing scheme would silently serve wrong bytes)
        return f"refs/{quote(model_id, safe='')}"

    def insert(self, model: Model) -> None:
        digest = hashlib.sha256(model.models).hexdigest()
        obj = self._obj_key(digest)
        old_ref = self._b.get(self._ref_key(model.id))
        # unconditional put (objects are immutable, re-put is an atomic
        # replace of identical bytes) narrows the window against a
        # concurrent delete()'s gc; see class docstring for the residual
        # cross-process caveat
        self._b.put(obj, model.models)
        self._b.put(self._ref_key(model.id), digest.encode("ascii"))
        if not self._b.exists(obj):  # gc raced us: heal the dangling ref
            self._b.put(obj, model.models)
        if old_ref is not None:
            old_digest = old_ref.decode("ascii").strip()
            if old_digest != digest:  # overwrite must not leak v1's blob
                self._gc_if_unreferenced(old_digest)

    def get(self, model_id: str) -> Optional[Model]:
        ref = self._b.get(self._ref_key(model_id))
        if ref is None:
            return None
        digest = ref.decode("ascii").strip()
        data = self._b.get(self._obj_key(digest))
        if data is None:
            raise base.StorageError(
                f"model {model_id!r}: referenced blob {digest} is missing"
            )
        actual = hashlib.sha256(data).hexdigest()
        if actual != digest:
            raise base.StorageError(
                f"model {model_id!r}: blob digest mismatch "
                f"(expected {digest}, got {actual}) — corrupt object store"
            )
        return Model(model_id, data)

    def _gc_if_unreferenced(self, digest: str) -> None:
        """Drop an object no ref names anymore (ref-count scan)."""
        still_referenced = any(
            (r := self._b.get(k)) is not None
            and r.decode("ascii").strip() == digest
            for k in self._b.list("refs")
        )
        if not still_referenced:
            self._b.delete(self._obj_key(digest))

    def delete(self, model_id: str) -> bool:
        ref_key = self._ref_key(model_id)
        ref = self._b.get(ref_key)
        if ref is None:
            return False
        digest = ref.decode("ascii").strip()
        self._b.delete(ref_key)
        self._gc_if_unreferenced(digest)
        return True
