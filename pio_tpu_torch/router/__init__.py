"""Serving fabric front tier: entity-affine routing across N members.

The port's copy of ``pio_tpu/router/__init__.py`` (the port imports nothing of
``pio_tpu``).

The pieces, in request order:

- :mod:`ring` — partition-affine slots (mirroring partlog's
  ``crc32(entity_id) % N``) composed with rendezvous hashing, so a
  user's events and serving replica co-locate and membership churn
  remaps only the failed member's keyspace;
- :mod:`core` — :class:`~pio_tpu_torch.router.core.ServingRouter`: health
  gating (scrape status + passive forced-down), SLO-aware spreading
  (worst-burn + device-headroom demotion, priority-floor shedding with
  the QoS vocabulary), keep-alive forwarding with a single ring-order
  retry (optionally hedged for interactive tails), and the
  ``pio_tpu_router_*`` metric families;
- :mod:`deploy` — manifest-verified instance distribution: members
  sha256-verify every shard from their own store before the router
  flips their generation into rotation;
- :mod:`rollout` — progressive delivery: shadow mirroring, canary
  keyspace diversion, SLO-burn judging, auto-promote/rollback with a
  durable decision trail on ``/rollout.json``.

The daemon wiring (HTTP front, embedded fleet scraper, ``/router.json``)
lives in :mod:`pio_tpu_torch.server.routerd`; ``pio route`` / ``pio rollout``
are the CLI verbs.
"""

from pio_tpu_torch.router.core import (
    BURN_LIMIT_ENV,
    DEFAULT_BURN_LIMIT,
    HEDGE_ENV,
    MemberState,
    ServingRouter,
    Shed,
)
from pio_tpu_torch.router.deploy import (
    DeployVerifyError,
    load_manifest,
    manifest_digests,
    push_deploy,
    verify_instance,
)
from pio_tpu_torch.router.ring import Ring, hrw_score, slot_of
from pio_tpu_torch.router.rollout import (
    STAGES,
    RolloutConfig,
    RolloutController,
    RolloutMetrics,
    diff_answers,
)

__all__ = [
    "BURN_LIMIT_ENV",
    "DEFAULT_BURN_LIMIT",
    "DeployVerifyError",
    "HEDGE_ENV",
    "MemberState",
    "Ring",
    "RolloutConfig",
    "RolloutController",
    "RolloutMetrics",
    "STAGES",
    "ServingRouter",
    "Shed",
    "diff_answers",
    "hrw_score",
    "load_manifest",
    "manifest_digests",
    "push_deploy",
    "slot_of",
    "verify_instance",
]
