from .builder import SessionBuilder
from .device_synctest import DeviceSyncTestSession
from .p2p import P2PSession, PlayerRegistry
from .replay import ReplaySession
from .spectator import SPECTATOR_BUFFER_SIZE, SpectatorSession
from .synctest import SyncTestSession

__all__ = [
    "DeviceSyncTestSession",
    "P2PSession",
    "PlayerRegistry",
    "ReplaySession",
    "SPECTATOR_BUFFER_SIZE",
    "SessionBuilder",
    "SpectatorSession",
    "SyncTestSession",
]
