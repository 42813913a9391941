"""ggrs_tpu_torch: the PyTorch / CUDA port of ggrs_tpu's device rollback path.

Beside ``ggrs_tpu`` (JAX on a TPU, the reference), this package runs the
device rollback replay on an NVIDIA H100: the batched SyncTest tick, the
state ring, batched sessions, and the 4-lane state digest as a hand-written
CUDA kernel (``csrc/digest.cu``) that digests a whole batch of states from
their leaves in one launch.  It imports torch and numpy only; entry
points take ``device=None``, meaning the CUDA card.
"""

from .convert import from_numpy, to_numpy
from .core import GgrsError, InvalidRequest, MismatchedChecksum, resolve_device
from .games import BoxGame, ChipVM
from .ops import (
    CHECKSUM_LANES,
    DeviceChecksum,
    DeviceStateRing,
    ReplayPrograms,
    build_replay_programs,
    checksum_device,
    checksum_to_u128,
    lane_sums_rows,
    pytree_checksum,
)
from .parallel import BatchedSessions
from .sessions import DeviceSyncTestSession

__all__ = [
    "BatchedSessions",
    "BoxGame",
    "CHECKSUM_LANES",
    "ChipVM",
    "DeviceChecksum",
    "DeviceStateRing",
    "DeviceSyncTestSession",
    "GgrsError",
    "InvalidRequest",
    "MismatchedChecksum",
    "ReplayPrograms",
    "build_replay_programs",
    "checksum_device",
    "checksum_to_u128",
    "from_numpy",
    "lane_sums_rows",
    "pytree_checksum",
    "resolve_device",
    "to_numpy",
]
