"""Partitioned, replicated event log with failover and compaction.

The port's copy of ``pio_tpu/storage/partlog`` (the port imports nothing
of ``pio_tpu``): the same frames, segment files, snapshots and
replication wire, so either package opens the other's directories and
replicates to the other's followers.

Package layout:

- ``framing``     — CRC frame codec + verified-prefix / torn-tail repair
- ``segments``    — one partition's append-only segment chain
- ``partitioned`` — the LEvents backend: router, group commit, views
- ``replication`` — length-prefixed follower streaming + ack gating
- ``compaction``  — snapshot folding with verify-and-fallback reads
- ``failover``    — longest-verified-prefix election and promotion
"""

from pio_tpu_torch.storage.partlog.partitioned import (  # noqa: F401
    DEFAULT_PARTITIONS,
    PARTITIONS_VAR,
    PartitionedEventLog,
    partition_of,
)
