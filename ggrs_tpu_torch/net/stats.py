"""Connection quality statistics per remote endpoint (the port's copy of
``ggrs_tpu/net/stats.py``; reference: GGRS src/network/network_stats.rs)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class NetworkStats:
    """send_queue_len — unacked outbound inputs (rough RTT/loss indicator);
    ping — round-trip ms; kbps_sent — estimated bandwidth;
    local/remote_frames_behind — frame advantage from each perspective
    (reference: network_stats.rs:2-21, computed in protocol.rs:271-293);
    send_errors — transient OS-level send failures swallowed at the socket
    (ENETUNREACH/ECONNREFUSED and friends on Linux UDP) instead of crashing
    the session tick — the datagram counts as lost, which the protocol's
    redundant sends already cover."""

    send_queue_len: int = 0
    ping: int = 0
    kbps_sent: int = 0
    local_frames_behind: int = 0
    remote_frames_behind: int = 0
    send_errors: int = 0
