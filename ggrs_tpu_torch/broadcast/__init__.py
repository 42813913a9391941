"""Durable match journals (the port's copy of part of ``ggrs_tpu/broadcast``).

- :class:`MatchJournal`: the per-match confirmed-input stream on disk,
  crc32-chained append-only records with embedded state checkpoints, in the
  JAX package's file format;
- :class:`JournalTap`: the spectator-shaped endpoint that feeds a journal
  from a live ``P2PSession`` (``adopt_spectator_endpoint``);
- :func:`read_journal`: the crc-checked parse, recovering the intact prefix.

``sessions.replay.ReplaySession`` plays a journal back.  The JAX package's
``SpectatorHub`` fans out over its session pool, which the port does not
have yet.
"""

from .journal import (
    JournalError,
    JournalExhausted,
    JournalTap,
    MatchJournal,
    read_journal,
)

__all__ = [
    "JournalError",
    "JournalExhausted",
    "JournalTap",
    "MatchJournal",
    "read_journal",
]
