"""``ggrs_tpu_torch.fleet``: sharded pool serving above ``HostSessionPool``
(the port's copy of ``ggrs_tpu/fleet``).

The layer that survives losing a shard: a :class:`ShardSupervisor` owns N
:class:`PoolShard` shards behind a consistent-hash, capacity-aware
placement front (:class:`HashRing`), and treats a running match as a
portable object: **live migration** between shards through the harvest
seam, **graceful drain** (admission off, migrate everything, retire), and
**crash failover** from the durable match journals when a shard dies.
Shards run in process (:class:`PoolShard`) or as runner subprocesses
(:class:`ProcShard`, ``scripts/port_shard_runner.py``), over a socketpair
or the authenticated TCP fleet link; :class:`PlacementService` places
matches across supervisors behind an :class:`IngressNode`'s virtual
endpoints.
"""

from .ingress import (
    IngressHandle,
    IngressNode,
    IngressRunner,
    VirtualEndpointSocket,
    virtual_endpoint_socket,
)
from .placement import HashRing
from .placement_service import PlacementService
from .proc import ProcShard, ShardRunner, proc_match_builder, runner_clock
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
from .transport import HandshakeError, RunnerLink, ShardLink
from .tuning import FleetTuning

__all__ = [
    "AdoptedMatch",
    "FleetError",
    "FleetTuning",
    "FrameError",
    "HandshakeError",
    "HashRing",
    "IngressHandle",
    "IngressNode",
    "IngressRunner",
    "MatchRecord",
    "PlacementService",
    "PoolShard",
    "ProcShard",
    "RpcClosed",
    "RpcConn",
    "RpcError",
    "RpcRemoteError",
    "RpcTimeout",
    "RunnerLink",
    "SHARD_ACTIVE",
    "SHARD_DEAD",
    "SHARD_DRAINING",
    "SHARD_RETIRED",
    "ShardLink",
    "ShardRunner",
    "ShardSupervisor",
    "VirtualEndpointSocket",
    "proc_match_builder",
    "runner_clock",
    "virtual_endpoint_socket",
]
