"""ggrs_tpu_torch: the PyTorch / CUDA port of ggrs_tpu's device rollback path.

Beside ``ggrs_tpu`` (JAX on a TPU, the reference), this package runs on an
NVIDIA H100:

- the device rollback replay: the batched SyncTest tick (on the card a
  CUDA graph replay a steady tick), the state ring,
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
- the native host cores, the port's own copy of those the JAX package runs:
  the C++ input codec and message framing, endpoint datapath and sync core
  of ``csrc/host/``, built by
  ``g++`` at first use and bound with ctypes (``net/_native.py``), on by
  default for eligible configs;
- device-batched input prediction (``predict``): a ``DevicePredictionPlane``
  predicts every pooled session's missing inputs in one device call;
- mesh batching: ``BatchedSessions`` and ``BatchedRequestExecutor`` shard
  their sessions over a ``Mesh`` of devices (``make_mesh``,
  ``make_mesh2d``, ``make_distributed_mesh``), with the health reduction
  through ``torch.distributed`` across processes;
- the games: BoxGame (fixed-point and float), ChipVM, EcsWorld (an entity
  component world) and RtsCmd (command streams in varrec envelopes);
- match journals (``broadcast``): a ``JournalTap`` records a live
  ``P2PSession`` into a ``MatchJournal``, and ``ReplaySession`` plays it back
  frame by frame or fast-forwards it on the card (``build_scrub_program``);
- the in-process fleet (``fleet``): a ``ShardSupervisor`` serving matches
  on ``PoolShard``s (host session banks) with placement, live migration,
  drain and crash failover from the match journals, observed through
  ``obs``'s exporters, timelines and SLO burn rates;
- the 4-lane state digest as a hand-written CUDA kernel (``csrc/digest.cu``)
  that digests a whole batch of states from their leaves in one launch.

It imports torch and numpy only; entry points take ``device=None``, meaning
the CUDA card.  The top level re-exports the core's names, as the JAX
package's does.
"""

from . import broadcast, fleet, obs, predict
from .convert import from_numpy, to_numpy
from .core import *  # noqa: F401,F403
from .core import __all__ as _core_all
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
    HostedPool,
    HostSessionPool,
    Mesh,
    RequestPlan,
    SpeculativeBranches,
    SpeculativeRollback,
    build_speculation_programs,
    make_distributed_mesh,
    make_mesh,
    make_mesh2d,
)
from .predict import BatchedDefault, BatchedRepeatLast, DevicePredictionPlane
from .sessions import (
    DeviceSyncTestSession,
    P2PSession,
    ReplaySession,
    SessionBuilder,
    SpectatorSession,
    SyncTestSession,
)

__all__ = list(_core_all) + [
    "BatchedDefault",
    "BatchedRepeatLast",
    "BatchedRequestExecutor",
    "BatchedSessions",
    "BoxGame",
    "CHECKSUM_LANES",
    "ChipVM",
    "DeviceChecksum",
    "DevicePredictionPlane",
    "DeviceRequestExecutor",
    "DeviceStateRing",
    "DeviceSyncTestSession",
    "EcsWorld",
    "ExecutorPrograms",
    "FakeSocket",
    "HostSessionPool",
    "HostedPool",
    "InMemoryNetwork",
    "JournalExhausted",
    "JournalTap",
    "MatchJournal",
    "Mesh",
    "Message",
    "NetworkStats",
    "NonBlockingSocket",
    "P2PSession",
    "ReplayPrograms",
    "ReplaySession",
    "RequestPlan",
    "RtsCmd",
    "RtsCmdGame",
    "SessionBuilder",
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
    "fleet",
    "from_numpy",
    "lane_sums_rows",
    "make_distributed_mesh",
    "make_mesh",
    "make_mesh2d",
    "obs",
    "predict",
    "pytree_checksum",
    "read_journal",
    "to_numpy",
]
