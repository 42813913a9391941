from .builder import SessionBuilder
from .device_synctest import DeviceSyncTestSession
from .p2p import P2PSession, PlayerRegistry
from .spectator import SPECTATOR_BUFFER_SIZE, SpectatorSession
from .synctest import SyncTestSession

__all__ = [
    "DeviceSyncTestSession",
    "P2PSession",
    "PlayerRegistry",
    "SPECTATOR_BUFFER_SIZE",
    "SessionBuilder",
    "SpectatorSession",
    "SyncTestSession",
]
