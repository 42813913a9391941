from .messages import ConnectionStatus

__all__ = ["ConnectionStatus"]
