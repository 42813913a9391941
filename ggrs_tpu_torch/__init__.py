"""ggrs_tpu_torch: the PyTorch / CUDA port of ggrs_tpu's device rollback path.

Beside ``ggrs_tpu`` (JAX on a TPU, the reference), this package runs on an
NVIDIA H100:

- the device rollback replay: the batched SyncTest tick, the state ring,
  ``DeviceSyncTestSession`` and ``BatchedSessions``, with durable
  checkpoints in the JAX package's file format;
- the request-list path: ``SessionBuilder`` starts a host
  ``SyncTestSession``, ``P2PSession`` or ``SpectatorSession``, and
  ``DeviceRequestExecutor`` fulfils each request list it returns with the
  game state on the card;
- the P2P wire (``net``): the endpoint protocol, its messages and input
  codec byte for byte the JAX package's, UDP and in-memory sockets, so a
  port peer plays a JAX peer;
- the 4-lane state digest as a hand-written CUDA kernel (``csrc/digest.cu``)
  that digests a whole batch of states from their leaves in one launch.

It imports torch and numpy only; entry points take ``device=None``, meaning
the CUDA card.
"""

from . import obs
from .convert import from_numpy, to_numpy
from .core import (
    AdvanceFrame,
    Config,
    DesyncDetected,
    DesyncDetection,
    Disconnected,
    GameStateCell,
    GgrsError,
    InputStatus,
    InvalidRequest,
    LoadGameState,
    Local,
    MismatchedChecksum,
    NotSynchronized,
    PredictionThreshold,
    Remote,
    SaveGameState,
    Spectator,
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
from .net import FakeSocket, InMemoryNetwork, Message, NetworkStats, NonBlockingSocket, UdpNonBlockingSocket
from .parallel import BatchedSessions
from .sessions import (
    DeviceSyncTestSession,
    P2PSession,
    SessionBuilder,
    SpectatorSession,
    SyncTestSession,
)

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
    "DesyncDetected",
    "DesyncDetection",
    "DeviceSyncTestSession",
    "Disconnected",
    "ExecutorPrograms",
    "FakeSocket",
    "GameStateCell",
    "GgrsError",
    "InMemoryNetwork",
    "InputStatus",
    "InvalidRequest",
    "LoadGameState",
    "Local",
    "Message",
    "MismatchedChecksum",
    "NetworkStats",
    "NonBlockingSocket",
    "NotSynchronized",
    "P2PSession",
    "PredictionThreshold",
    "Remote",
    "ReplayPrograms",
    "SaveGameState",
    "SessionBuilder",
    "Spectator",
    "SpectatorSession",
    "SyncTestSession",
    "UdpNonBlockingSocket",
    "boxgame_config",
    "build_replay_programs",
    "checksum_device",
    "checksum_to_u128",
    "from_numpy",
    "lane_sums_rows",
    "obs",
    "pytree_checksum",
    "resolve_device",
    "to_numpy",
]
