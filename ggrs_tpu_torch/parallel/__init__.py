from .batch import (
    HOST_AXIS,
    SESSION_AXIS,
    BatchedSessions,
    Mesh,
    make_distributed_mesh,
    make_mesh,
    make_mesh2d,
)
from .session_pool import BatchedRequestExecutor
from .spec_rollback import SpeculativeRollback
from .speculation import SpeculativeBranches, build_speculation_programs

__all__ = [
    "HOST_AXIS",
    "SESSION_AXIS",
    "BatchedRequestExecutor",
    "BatchedSessions",
    "Mesh",
    "SpeculativeBranches",
    "SpeculativeRollback",
    "build_speculation_programs",
    "make_distributed_mesh",
    "make_mesh",
    "make_mesh2d",
]
