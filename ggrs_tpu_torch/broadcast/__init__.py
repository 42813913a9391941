"""Broadcast and replay (the port's copy of ``ggrs_tpu/broadcast``): pool-scale
spectator fan-out, durable match journals and their crash recovery, over one
data model, the per-match confirmed-input stream.

- :class:`SpectatorHub` (``hub.py``): fan-out policy over the session bank;
  with a hub attached, spectator matches are bank-eligible and the bank
  relays confirmed inputs to every viewer inside the single tick crossing.
- :class:`MatchJournal` (``journal.py``): the stream on disk, crc32-chained
  append-only records with embedded state checkpoints, in the JAX package's
  file format, and an in-memory tail window that is the crash-recovery seam
  (:func:`resume_from_file` recovers from the file alone);
  :class:`JournalTap` feeds a journal from a live ``P2PSession``.
- ``sessions.replay.ReplaySession`` plays a journal back.
"""

from .hub import SpectatorHub, graft_spectator_endpoints
from .journal import (
    JournalError,
    JournalExhausted,
    JournalTap,
    MatchJournal,
    read_journal,
    resume_from_file,
)

__all__ = [
    "JournalError",
    "JournalExhausted",
    "JournalTap",
    "MatchJournal",
    "SpectatorHub",
    "graft_spectator_endpoints",
    "read_journal",
    "resume_from_file",
]
