from .batch import BatchedSessions
from .session_pool import BatchedRequestExecutor
from .spec_rollback import SpeculativeRollback
from .speculation import SpeculativeBranches, build_speculation_programs

__all__ = [
    "BatchedRequestExecutor",
    "BatchedSessions",
    "SpeculativeBranches",
    "SpeculativeRollback",
    "build_speculation_programs",
]
