"""ggrs_tpu_torch: the PyTorch / CUDA port of ggrs_tpu's device rollback path.

Beside ``ggrs_tpu`` (JAX on a TPU, the reference), this package runs on an
NVIDIA H100:

- the device rollback replay: the batched SyncTest tick, the state ring,
  ``DeviceSyncTestSession`` and ``BatchedSessions``, with durable
  checkpoints in the JAX package's file format;
- the request-list path: ``SessionBuilder`` starts a host
  ``SyncTestSession``, and ``DeviceRequestExecutor`` fulfils each request
  list it returns with the game state on the card;
- the 4-lane state digest as a hand-written CUDA kernel (``csrc/digest.cu``)
  that digests a whole batch of states from their leaves in one launch.

It imports torch and numpy only; entry points take ``device=None``, meaning
the CUDA card.
"""

from .convert import from_numpy, to_numpy
from .core import (
    AdvanceFrame,
    Config,
    GameStateCell,
    GgrsError,
    InputStatus,
    InvalidRequest,
    LoadGameState,
    MismatchedChecksum,
    SaveGameState,
    resolve_device,
)
from .games import BoxGame, ChipVM, boxgame_config
from .ops import (
    CHECKSUM_LANES,
    DeviceChecksum,
    DeviceRequestExecutor,
    DeviceStateRing,
    ExecutorPrograms,
    ReplayPrograms,
    build_replay_programs,
    checksum_device,
    checksum_to_u128,
    lane_sums_rows,
    pytree_checksum,
)
from .parallel import BatchedSessions
from .sessions import DeviceSyncTestSession, SessionBuilder, SyncTestSession

__all__ = [
    "AdvanceFrame",
    "BatchedSessions",
    "BoxGame",
    "CHECKSUM_LANES",
    "ChipVM",
    "Config",
    "DeviceChecksum",
    "DeviceRequestExecutor",
    "DeviceStateRing",
    "DeviceSyncTestSession",
    "ExecutorPrograms",
    "GameStateCell",
    "GgrsError",
    "InputStatus",
    "InvalidRequest",
    "LoadGameState",
    "MismatchedChecksum",
    "ReplayPrograms",
    "SaveGameState",
    "SessionBuilder",
    "SyncTestSession",
    "boxgame_config",
    "build_replay_programs",
    "checksum_device",
    "checksum_to_u128",
    "from_numpy",
    "lane_sums_rows",
    "pytree_checksum",
    "resolve_device",
    "to_numpy",
]
