from .checksum import (
    CHECKSUM_LANES,
    DeviceChecksum,
    checksum_device,
    checksum_device_plain,
    checksum_to_u128,
    lane_sums,
    pytree_checksum,
)
from .executor import DeviceRequestExecutor, ExecutorPrograms
from .digest import lane_sums_rows, lane_sums_rows_plain, state_digest, state_digest_plain
from .replay import ReplayPrograms, build_replay_programs
from .ring import DeviceStateRing

__all__ = [
    "CHECKSUM_LANES",
    "DeviceChecksum",
    "DeviceRequestExecutor",
    "DeviceStateRing",
    "ExecutorPrograms",
    "ReplayPrograms",
    "build_replay_programs",
    "checksum_device",
    "checksum_device_plain",
    "checksum_to_u128",
    "lane_sums",
    "lane_sums_rows",
    "lane_sums_rows_plain",
    "pytree_checksum",
    "state_digest",
    "state_digest_plain",
]
