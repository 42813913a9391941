from .device_synctest import DeviceSyncTestSession

__all__ = ["DeviceSyncTestSession"]
