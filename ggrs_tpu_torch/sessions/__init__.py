from .builder import SessionBuilder
from .device_synctest import DeviceSyncTestSession
from .synctest import SyncTestSession

__all__ = ["DeviceSyncTestSession", "SessionBuilder", "SyncTestSession"]
