"""Manifest-verified instance distribution.

The port's copy of ``pio_tpu/router/deploy.py`` (the port imports nothing of
``pio_tpu``).

A deploy through the router is a two-sided handshake over the
sharded-persist manifest (:mod:`pio_tpu_torch.workflow.shard_store`):

- **router side** (:func:`push_deploy`) reads the manifest for the
  target instance out of the models store and POSTs it to every
  member's ``/deploy.json`` admin route;
- **member side** (:func:`verify_instance`, called from the query
  server's handler) re-hashes every shard record in its *own* store
  against the pushed manifest — sha256 and size, before a single byte
  is interpreted — and only then hot-swaps to the new generation.

A member that cannot verify answers 409 and keeps serving its current
generation; the router records the outcome and only flips verified
members' generation into rotation.  The invariant the chaos suite
leans on: **no member ever takes traffic on an instance whose shard
checksums failed**.
"""

from __future__ import annotations

import hashlib
import json
import urllib.error
import urllib.request
from typing import Dict, Optional, Tuple

from pio_tpu_torch.faults import failpoint
from pio_tpu_torch.workflow.shard_store import SHARD_MANIFEST_SUFFIX

__all__ = [
    "DeployVerifyError",
    "load_manifest",
    "manifest_digests",
    "push_deploy",
    "verify_instance",
]


class DeployVerifyError(RuntimeError):
    """Shard verification failed — the member must NOT swap."""


def load_manifest(models_store, instance_id: str) -> Optional[dict]:
    """The instance's shard manifest, or None for unsharded blobs."""
    record = models_store.get(instance_id + SHARD_MANIFEST_SUFFIX)
    if record is None:
        return None
    try:
        return json.loads(record.models.decode("utf-8"))
    except Exception as e:
        raise DeployVerifyError(
            f"unreadable shard manifest for instance {instance_id!r}: {e}"
        ) from e


def manifest_digests(manifest: dict) -> Dict[str, Tuple[str, int]]:
    """shard record id -> (sha256, size) across every algo/array."""
    out: Dict[str, Tuple[str, int]] = {}
    for algo in manifest.get("algos", []):
        if not algo:
            continue
        for entry in algo.get("arrays", []):
            for shard in entry.get("shards", []):
                out[str(shard["id"])] = (
                    str(shard["sha256"]), int(shard["size"])
                )
    return out


def verify_instance(
    models_store,
    instance_id: str,
    expected: Optional[dict] = None,
) -> dict:
    """Member-side verification gate, run BEFORE any swap.

    ``expected`` is the manifest the router pushed; when given, the
    member's own manifest must agree digest-for-digest (a diverged
    store — torn replication, wrong backend — is a rejection, not a
    surprise at restore time).  Every shard is then re-hashed from the
    member's store.  Raises :class:`DeployVerifyError` on any mismatch;
    returns a verification summary for the 200 body.
    """
    failpoint("router.verify")
    manifest = load_manifest(models_store, instance_id)
    if manifest is None:
        if expected is not None and manifest_digests(expected):
            raise DeployVerifyError(
                f"router pushed a shard manifest for {instance_id!r} "
                f"but this member's store has none"
            )
        # unsharded instance: nothing to checksum here — the blob
        # loader's own digest check guards the load — but the record
        # must at least exist so the swap cannot land on a 404.
        record = models_store.get(instance_id)
        if record is None:
            raise DeployVerifyError(
                f"instance {instance_id!r} absent from this member's store"
            )
        return {
            "instanceId": instance_id,
            "sharded": False,
            "shards": 0,
            "bytes": len(record.models),
        }
    digests = manifest_digests(manifest)
    if expected is not None:
        want = manifest_digests(expected)
        if want != digests:
            raise DeployVerifyError(
                f"member manifest for {instance_id!r} disagrees with the "
                f"pushed one ({len(digests)} vs {len(want)} shards or "
                f"differing digests)"
            )
    total = 0
    for shard_id, (sha, size) in sorted(digests.items()):
        record = models_store.get(shard_id)
        if record is None:
            raise DeployVerifyError(
                f"missing shard record {shard_id!r} for "
                f"instance {instance_id!r}"
            )
        got = hashlib.sha256(record.models).hexdigest()
        if got != sha or len(record.models) != size:
            raise DeployVerifyError(
                f"shard {shard_id!r} failed checksum verification "
                f"(manifest {sha}/{size}B, got {got}/"
                f"{len(record.models)}B)"
            )
        total += size
    return {
        "instanceId": instance_id,
        "sharded": True,
        "shards": len(digests),
        "bytes": total,
    }


def push_deploy(
    base_url: str,
    instance_id: str,
    manifest: Optional[dict],
    timeout_s: float = 60.0,
    admin_key: Optional[str] = None,
) -> Tuple[str, dict]:
    """POST the manifest to one member's ``/deploy.json``.

    Returns ``(outcome, detail)`` where outcome is ``verified`` (member
    swapped), ``rejected`` (member refused — verification failed, 4xx)
    or ``error`` (transport/5xx; member state unknown, generation NOT
    flipped).
    """
    body = json.dumps(
        {"engineInstanceId": instance_id, "manifest": manifest}
    ).encode("utf-8")
    headers = {"Content-Type": "application/json; charset=utf-8"}
    if admin_key:
        headers["Authorization"] = f"Bearer {admin_key}"
    req = urllib.request.Request(
        base_url.rstrip("/") + "/deploy.json",
        data=body, headers=headers, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            detail = json.loads(resp.read().decode("utf-8"))
        return "verified", detail
    except urllib.error.HTTPError as e:
        try:
            detail = json.loads(e.read().decode("utf-8"))
        except Exception:
            detail = {"error": f"HTTP {e.code}"}
        return ("rejected" if 400 <= e.code < 500 else "error"), detail
    except Exception as e:
        return "error", {"error": f"{type(e).__name__}: {e}"}
