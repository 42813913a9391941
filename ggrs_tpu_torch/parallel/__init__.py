from .batch import (
    HOST_AXIS,
    SESSION_AXIS,
    BatchedSessions,
    Mesh,
    make_distributed_mesh,
    make_mesh,
    make_mesh2d,
)
from .host_bank import HostSessionPool, RequestPlan
from .session_pool import BatchedRequestExecutor, HostedPool
from .spec_rollback import SpeculativeRollback
from .speculation import SpeculativeBranches, build_speculation_programs

__all__ = [
    "HOST_AXIS",
    "SESSION_AXIS",
    "BatchedRequestExecutor",
    "BatchedSessions",
    "HostSessionPool",
    "HostedPool",
    "Mesh",
    "RequestPlan",
    "SpeculativeBranches",
    "SpeculativeRollback",
    "build_speculation_programs",
    "make_distributed_mesh",
    "make_mesh",
    "make_mesh2d",
]
