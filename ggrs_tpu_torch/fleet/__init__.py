"""``ggrs_tpu_torch.fleet``: sharded pool serving above ``HostSessionPool``,
in process (the port's copy of the in-process half of ``ggrs_tpu/fleet``).

The layer that survives losing a shard: a :class:`ShardSupervisor` owns N
:class:`PoolShard` shards behind a consistent-hash, capacity-aware
placement front (:class:`HashRing`), and treats a running match as a
portable object: **live migration** between shards through the harvest
seam, **graceful drain** (admission off, migrate everything, retire), and
**crash failover** from the durable match journals when a shard dies.
The ``rpc`` framing is here whole; the process fleet that uses it
(``ProcShard`` runners, the fleet link, ingress and the placement
service) is not ported yet, and a supervisor asked for a process-backed
shard raises :class:`FleetError`.
"""

from .placement import HashRing
from .rpc import (
    FrameError,
    RpcClosed,
    RpcConn,
    RpcError,
    RpcRemoteError,
    RpcTimeout,
)
from .shard import (
    AdoptedMatch,
    PoolShard,
    SHARD_ACTIVE,
    SHARD_DEAD,
    SHARD_DRAINING,
    SHARD_RETIRED,
)
from .supervisor import FleetError, MatchRecord, ShardSupervisor
from .tuning import FleetTuning

__all__ = [
    "AdoptedMatch",
    "FleetError",
    "FleetTuning",
    "FrameError",
    "HashRing",
    "MatchRecord",
    "PoolShard",
    "RpcClosed",
    "RpcConn",
    "RpcError",
    "RpcRemoteError",
    "RpcTimeout",
    "SHARD_ACTIVE",
    "SHARD_DEAD",
    "SHARD_DRAINING",
    "SHARD_RETIRED",
    "ShardSupervisor",
]
