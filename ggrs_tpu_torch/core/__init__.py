from .device import resolve_device
from .errors import GgrsError, InvalidRequest, MismatchedChecksum

__all__ = ["GgrsError", "InvalidRequest", "MismatchedChecksum", "resolve_device"]
