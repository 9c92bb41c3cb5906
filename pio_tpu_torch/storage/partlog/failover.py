"""Leader failover: elect the longest verified prefix, promote it.

When a partition leader dies mid-commit, the surviving follower mirrors
(``replication.FollowerServer`` roots) disagree only in how far each
got. Because every stream is CRC-framed, "how far" is measurable
offline: :func:`elect` scores each candidate by its longest VERIFIED
prefix (torn bytes past the last intact frame never count), and
:func:`promote` assembles a new leader root from the per-partition
winners — each partition's stream becomes the first segment of a fresh
:class:`~pio_tpu_torch.storage.partlog.partitioned.PartitionedEventLog`
chain, torn tails truncated loudly on the way in.

Zero-acked-write-loss argument (the chaos test's invariant): at
``commit`` durability a 201 is sent only after ``min_acks`` followers
fsynced the record (``Replicator.wait_acked`` runs INSIDE the partition
flush), so every acked record is inside at least one candidate's
verified prefix — and the election winner's prefix is at least as long.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

from pio_tpu_torch.storage import base
from pio_tpu_torch.storage.durability import fsync_fileobj, replace_durable
from pio_tpu_torch.storage.partlog import framing
from pio_tpu_torch.storage.partlog.partitioned import MANIFEST_NAME

log = logging.getLogger("pio_tpu_torch.partlog")


def follower_path(root: str, partition: int) -> str:
    return os.path.join(root, f"p{partition:03d}.repl")


def follower_position(root: str, partition: int) -> int:
    """Verified byte position of one partition mirror (0 if absent)."""
    return framing.verified_prefix(follower_path(root, partition))


def partitions_of(root: str) -> Optional[int]:
    """Partition count from a root's MANIFEST.json (leader or follower
    roots both carry one); None when unreadable."""
    try:
        with open(os.path.join(root, MANIFEST_NAME)) as f:
            return int(json.load(f)["partitions"])
    except (OSError, ValueError, KeyError):
        return None


def elect(candidate_roots: List[str],
          partitions: Optional[int] = None) -> Dict[int, dict]:
    """Per-partition election over follower roots: the candidate with
    the longest verified prefix wins (ties → first candidate, so the
    caller's ordering is the tiebreak)."""
    if partitions is None:
        for root in candidate_roots:
            partitions = partitions_of(root)
            if partitions:
                break
    if not partitions:
        raise base.StorageError(
            "failover election needs a partition count and no candidate "
            "root carries a readable MANIFEST.json"
        )
    out: Dict[int, dict] = {}
    for k in range(partitions):
        scores = {
            root: follower_position(root, k) for root in candidate_roots
        }
        winner = max(candidate_roots, key=lambda r: scores[r])
        out[k] = {
            "partition": k,
            "winner": winner,
            "position": scores[winner],
            "candidates": scores,
        }
    return out


def promote(candidate_roots: List[str], dest_root: str,
            partitions: Optional[int] = None) -> dict:
    """Assemble a promoted leader root at ``dest_root`` from the
    election winners. Each partition's verified stream becomes
    ``pNNN/seg-00000001.log`` (positions are stream offsets, so one
    segment holding the whole prefix is a valid chain). ``dest_root``
    must be absent or empty: a prior incarnation's higher-numbered
    segments or snapshot files would mix into the promoted chain and
    replay rewritten/duplicated history. Returns the election result
    plus the manifest written."""
    election = elect(candidate_roots, partitions)
    n = len(election)
    os.makedirs(dest_root, exist_ok=True)
    stale = sorted(os.listdir(dest_root))
    if stale:
        raise base.StorageError(
            f"failover promote: dest root {dest_root} is not empty "
            f"(found {', '.join(stale[:5])}): stale segments or "
            "snapshots would mix into the promoted chain — promote "
            "into a fresh directory"
        )
    for k, res in election.items():
        pdir = os.path.join(dest_root, f"p{k:03d}")
        os.makedirs(pdir, exist_ok=True)
        src = follower_path(res["winner"], k)
        pos = res["position"]
        data = b""
        if pos > 0:
            with open(src, "rb") as f:
                raw = f.read()
            if len(raw) > pos:
                # torn tail on the winning mirror: never copied forward,
                # and never silently — the operator must see the loss
                log.warning(
                    "partlog promote: dropping %d torn bytes past the "
                    "verified prefix of %s", len(raw) - pos, src,
                )
            data = raw[:pos]
        seg = os.path.join(pdir, "seg-00000001.log")
        tmp = seg + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            fsync_fileobj(f)
        replace_durable(tmp, seg)
        log.info(
            "partlog promote: partition %d ← %s (%d verified bytes)",
            k, res["winner"], pos,
        )
    manifest = os.path.join(dest_root, MANIFEST_NAME)
    tmp = manifest + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "partitions": n, "promoted": True}, f)
        fsync_fileobj(f)
    replace_durable(tmp, manifest)
    return {"partitions": n, "election": election, "root": dest_root}
