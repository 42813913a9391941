"""Wire message vocabulary: the port has ``ConnectionStatus`` so far, which
``SyncTestSession`` needs (the port's copy of ``ggrs_tpu/net/messages.py:
21-27``; reference: GGRS src/network/messages.rs:5-18).  The wire messages
come with the P2P host layer."""

from __future__ import annotations

from dataclasses import dataclass

from ..core.types import NULL_FRAME, Frame


@dataclass(slots=True)
class ConnectionStatus:
    """Per-player connection knowledge piggybacked on every Input message."""

    disconnected: bool = False
    last_frame: Frame = NULL_FRAME
