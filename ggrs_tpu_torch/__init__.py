"""ggrs_tpu_torch: the PyTorch / CUDA port of ggrs_tpu's device rollback path.

Beside ``ggrs_tpu`` (JAX on a TPU, the reference), this package runs on an
NVIDIA H100:

- the device rollback replay: the batched SyncTest tick, the state ring,
  ``DeviceSyncTestSession`` and ``BatchedSessions``, with durable
  checkpoints in the JAX package's file format;
- the request-list path: ``SessionBuilder`` starts a host
  ``SyncTestSession``, ``P2PSession`` or ``SpectatorSession``, and
  ``DeviceRequestExecutor`` fulfils each request list it returns with the
  game state on the card, optionally answering rollbacks from K speculative
  branches (``SpeculativeRollback``); ``BatchedRequestExecutor`` fulfils
  many sessions' lists as one batched tick;
- the P2P wire (``net``): the endpoint protocol, its messages and input
  codec byte for byte the JAX package's, UDP and in-memory sockets, so a
  port peer plays a JAX peer;
- the games: BoxGame (fixed-point and float), ChipVM, EcsWorld (an entity
  component world) and RtsCmd (command streams in varrec envelopes);
- match journals (``broadcast``): a ``JournalTap`` records a live
  ``P2PSession`` into a ``MatchJournal``, and ``ReplaySession`` plays it back
  frame by frame or fast-forwards it on the card (``build_scrub_program``);
- the 4-lane state digest as a hand-written CUDA kernel (``csrc/digest.cu``)
  that digests a whole batch of states from their leaves in one launch.

It imports torch and numpy only; entry points take ``device=None``, meaning
the CUDA card.
"""

from . import broadcast, obs
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
from .broadcast import JournalExhausted, JournalTap, MatchJournal, read_journal
from .games import (
    BoxGame,
    ChipVM,
    EcsWorld,
    RtsCmd,
    RtsCmdGame,
    boxgame_config,
    decode_commands,
    encode_commands,
)
from .ops import (
    CHECKSUM_LANES,
    DeviceChecksum,
    DeviceRequestExecutor,
    DeviceStateRing,
    ExecutorPrograms,
    ReplayPrograms,
    build_replay_programs,
    build_scrub_program,
    checksum_device,
    checksum_to_u128,
    lane_sums_rows,
    pytree_checksum,
)
from .net import FakeSocket, InMemoryNetwork, Message, NetworkStats, NonBlockingSocket, UdpNonBlockingSocket
from .parallel import (
    BatchedRequestExecutor,
    BatchedSessions,
    SpeculativeBranches,
    SpeculativeRollback,
    build_speculation_programs,
)
from .sessions import (
    DeviceSyncTestSession,
    P2PSession,
    ReplaySession,
    SessionBuilder,
    SpectatorSession,
    SyncTestSession,
)

__all__ = [
    "AdvanceFrame",
    "BatchedRequestExecutor",
    "BatchedSessions",
    "BoxGame",
    "CHECKSUM_LANES",
    "ChipVM",
    "Config",
    "DesyncDetected",
    "DesyncDetection",
    "DeviceChecksum",
    "DeviceRequestExecutor",
    "DeviceStateRing",
    "DeviceSyncTestSession",
    "Disconnected",
    "EcsWorld",
    "ExecutorPrograms",
    "FakeSocket",
    "GameStateCell",
    "GgrsError",
    "InMemoryNetwork",
    "InputStatus",
    "InvalidRequest",
    "JournalExhausted",
    "JournalTap",
    "LoadGameState",
    "Local",
    "MatchJournal",
    "Message",
    "MismatchedChecksum",
    "NetworkStats",
    "NonBlockingSocket",
    "NotSynchronized",
    "P2PSession",
    "PredictionThreshold",
    "Remote",
    "ReplayPrograms",
    "ReplaySession",
    "RtsCmd",
    "RtsCmdGame",
    "SaveGameState",
    "SessionBuilder",
    "Spectator",
    "SpectatorSession",
    "SpeculativeBranches",
    "SpeculativeRollback",
    "SyncTestSession",
    "UdpNonBlockingSocket",
    "boxgame_config",
    "broadcast",
    "build_replay_programs",
    "build_scrub_program",
    "build_speculation_programs",
    "checksum_device",
    "checksum_to_u128",
    "decode_commands",
    "encode_commands",
    "from_numpy",
    "lane_sums_rows",
    "obs",
    "pytree_checksum",
    "read_journal",
    "resolve_device",
    "to_numpy",
]
