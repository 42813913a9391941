from .batch import BatchedSessions

__all__ = ["BatchedSessions"]
