"""SpectatorHub: pool-scale fan-out policy over the session bank (the port's
copy of ``ggrs_tpu/broadcast/hub.py``).

The reference ships spectating as a per-session capability (a host relays
confirmed inputs; spectators advance without rolling back,
GGRS src/sessions/p2p_spectator_session.rs).  At pool scale the workload
inverts: few players, many viewers.  The hub makes that shape bank-eligible:
with a hub attached, ``HostSessionPool`` admits matches with spectators onto
the native bank, where each slot assembles its confirmed-input broadcast
payload once per tick and fans it to every registered viewer INSIDE the
single tick crossing (csrc/host/session_bank.cpp's spectator tables; fan-out
adds no crossing).

The hub owns everything that is policy, mirroring the P2P split:

- **registration / handshake**: ``attach(index, viewer_addr)`` wires a
  viewer to a match before frame 0 is confirmed (the handshake itself,
  sync-request/reply probing, runs natively; viewers built
  ``with_sync_handshake(True)`` come up exactly as against a Python host).
- **disconnect consensus**: native spectator events (interrupted /
  resumed / disconnected, including the stuck-viewer 128-unacked rule)
  surface through ``events(index)``; the hub answers a Disconnected by
  detaching the viewer via next tick's ctrl op, the same one-tick-late
  application remote disconnects get.
- **supervision fallback**: QUARANTINED slots freeze (no confirmed frames,
  nothing to relay); EVICTED slots keep their viewers: the pool grafts each
  fan-out window onto the resumed Python session
  (``P2PSession.adopt_spectator_endpoint``), whose own spectator path is the
  semantic reference.  Journals keep appending through a
  :class:`~ggrs_tpu_torch.broadcast.journal.JournalTap`.
- **journal wiring**: ``attach_journal`` taps the slot's confirmed stream
  from the tick crossing and registers the journal's crash-recovery seam.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

from ..core.errors import InvalidRequest
from ..core.types import (
    Disconnected,
    GgrsEvent,
    NetworkInterrupted,
    NetworkResumed,
    NULL_FRAME,
)
from ..net.protocol import draw_magic
from ..net.wire import encode_uvarint
from ..obs.registry import Registry
from .journal import JournalTap, MatchJournal

# native spectator event kinds (session_bank.cpp EvKind)
_EV_INTERRUPTED = 1
_EV_RESUMED = 2
_EV_DISCONNECTED = 3

MAX_EVENT_QUEUE_SIZE = 100


def graft_spectator_endpoints(session, builder, specs) -> None:
    """Graft fan-out endpoints onto a resumed Python session: the shared
    spectator carry-over of eviction (same pool,
    ``HostSessionPool._adopt_spectators``) and of migration
    (``parallel.host_bank.adopt_resume_bundle`` on a destination pool).  Each viewer resumes its harvested send window (ack base +
    unacked pending), so it sees a retransmission hiccup, not a reset
    stream.

    ``specs``: one dict per viewer — the identity (``addr``, ``magic``,
    ``handles``, ``running``) plus the harvested window (``state``: a
    harvest spectator record with ``last_acked_frame`` / ``send_base`` /
    ``pending``, or None for a viewer with no harvested window, which
    restarts its delta base from the default-input frame)."""
    config = builder._config
    players = builder._num_players
    default_blob = config.input_encode(config.input_default())
    default_base = b"".join(
        encode_uvarint(len(default_blob)) + default_blob
        for _ in range(players)
    )
    for spec in specs:
        addr = spec["addr"]
        hs = spec.get("state")
        ep = session._player_reg.spectators.get(addr)
        if ep is None:
            ep = builder._create_endpoint(
                list(spec.get("handles") or []), addr, players
            )
            session.adopt_spectator_endpoint(addr, ep)
        base = hs["send_base"] if hs and hs["send_base"] else default_base
        ep.adopt_endpoint_state(
            magic=spec["magic"],
            running=(
                hs["state"] == 0 if hs else bool(spec.get("running", True))
            ),
            peer_connect_status=[(False, NULL_FRAME)] * players,
            last_recv_frame=NULL_FRAME,
            recv_entries=(),
            last_acked_frame=hs["last_acked_frame"] if hs else NULL_FRAME,
            send_base=base,
            pending=hs["pending"] if hs else (),
        )


class SpectatorHub:
    """Fan-out policy for one ``HostSessionPool``.

    Construct the hub right after the pool, BEFORE the first tick (the
    pool finalizes lazily; hub-aware admission is decided at
    finalization)::

        pool = HostSessionPool()
        hub = SpectatorHub(pool)
        pool.add_session(builder_with_spectators, socket)   # bank-eligible
        hub.attach(0, viewer_addr)                          # dynamic join
        hub.attach_journal(0, MatchJournal(path, players, isize))

    Builder-declared ``Spectator`` players are attached automatically at
    pool finalization; ``attach`` adds dynamic viewers (before the match
    confirms frame 0 — late joiners catch up from the journal instead).
    """

    def __init__(self, pool, metrics: Optional[Registry] = None,
                 rng: Optional[random.Random] = None) -> None:
        if getattr(pool, "_spectator_hub", None) is not None:
            raise InvalidRequest("pool already has a spectator hub")
        self.pool = pool
        pool._spectator_hub = self
        self.metrics = metrics if metrics is not None else pool.metrics
        self._rng = rng if rng is not None else random.Random()
        self._events: Dict[int, List[GgrsEvent]] = {}

    # ------------------------------------------------------------------
    # registration
    # ------------------------------------------------------------------

    def _draw_magic(self) -> int:
        return draw_magic(self._rng)

    def _check_slot_attachable(self, index: int) -> None:
        """A quarantined/dead slot has no relay to attach to — refuse with
        the policy's words, not ``pool.session()``'s internal error."""
        state = self.pool.slot_state(index)
        if state in ("quarantined", "dead"):
            raise InvalidRequest(
                f"slot {index} is {state}: nothing is relaying for this "
                "match"
            )

    def attach(self, index: int, addr) -> None:
        """Register viewer ``addr`` on match ``index``.  Native slots get a
        bank fan-out endpoint (relaying stays inside the tick crossing);
        fallback / evicted slots get a real ``PeerProtocol`` grafted onto
        the Python session.  Refused once the match has confirmed frame 0:
        the inputs a late joiner needs are already discarded — replay the
        match journal to the live tip instead."""
        pool = self.pool
        if pool.native_active:
            self._check_slot_attachable(index)
        if pool.native_active and pool.slot_state(index) == "native":
            pool._attach_spectator(index, addr, self._draw_magic())
            return
        # Python-session path (fallback pool, or an evicted slot).  The
        # same late-join rule as the native table: the fan-out must still
        # be able to start at frame 0 (a session that ran frames without
        # spectators keeps _next_spectator_frame at 0 while the watermark
        # discard eats the early inputs — grafting then would break it).
        session = pool.session(index)
        if (getattr(session, "_next_spectator_frame", 0) > 0
                or session.current_frame > 0):
            raise InvalidRequest(
                "match already past frame 0; late joiners replay the "
                "journal instead"
            )
        builder = pool._builders[index][0]
        endpoint = builder._create_endpoint([], addr, builder._num_players)
        endpoint.magic = self._draw_magic()
        session.adopt_spectator_endpoint(addr, endpoint)

    def detach(self, index: int, addr) -> None:
        """Drop viewer ``addr`` from match ``index`` (immediate: no
        disconnect linger)."""
        pool = self.pool
        if pool.native_active:
            pool._detach_spectator(index, addr)
            return
        session = pool.session(index)
        ep = session._player_reg.spectators.get(addr)
        if ep is None:
            raise InvalidRequest(f"no spectator at address {addr!r}")
        ep.disconnect()

    def attach_journal(self, index: int, journal: MatchJournal) -> None:
        """Journal match ``index``: native slots stream newly-confirmed
        frames out of the tick crossing (zero extra crossings) and register
        the journal's crash-recovery seam; fallback pools graft a
        :class:`JournalTap` onto the Python session."""
        pool = self.pool
        # one timeline per pool: the journal's fsync spans join the pool
        # trace, and the journal tail feeds the slot's DesyncReports
        tracer = getattr(pool, "tracer", None)
        if tracer is not None and tracer.enabled:
            if not journal._tracer.enabled:
                journal._tracer = tracer
        if pool.native_active:
            self._check_slot_attachable(index)
        if pool.native_active and pool.slot_state(index) == "native":
            pool.set_confirmed_stream(
                index, journal,
                recovery=lambda: journal.recovery_harvest(pool, index),
            )
            return
        session = pool.session(index)
        if (getattr(session, "_next_spectator_frame", 0) == 0
                and session.current_frame > 0):
            raise InvalidRequest(
                "match already past frame 0 with no running fan-out; the "
                "frames a journal must start from are gone"
            )
        builder = pool._builders[index][0]
        session.adopt_spectator_endpoint(
            JournalTap.ADDR, JournalTap(journal, builder._config)
        )
        pool._journal_sinks[index] = journal

    # ------------------------------------------------------------------
    # events + state (the policy surface)
    # ------------------------------------------------------------------

    def _push_event(self, index: int, event: GgrsEvent) -> None:
        q = self._events.setdefault(index, [])
        q.append(event)
        del q[:-MAX_EVENT_QUEUE_SIZE]

    def _on_native_event(self, index: int, sp_idx: int, kind: int,
                         payload) -> None:
        """Pool callback: one native spectator-endpoint event.  Lifecycle
        events surface through :meth:`events`; a Disconnected additionally
        detaches the viewer via next tick's ctrl op (the same one-tick-late
        policy application remote disconnects get)."""
        m = self.pool._mirrors[index]
        addr = m.spectators[sp_idx].addr
        if kind == _EV_INTERRUPTED:
            self._push_event(index, NetworkInterrupted(
                addr=addr, disconnect_timeout=payload
            ))
        elif kind == _EV_RESUMED:
            self._push_event(index, NetworkResumed(addr=addr))
        elif kind == _EV_DISCONNECTED:
            if m.spectators[sp_idx].running:
                self.pool._disconnect_spectator(index, sp_idx)
                self._push_event(index, Disconnected(addr=addr))

    def events(self, index: int) -> List[GgrsEvent]:
        """Drain match ``index``'s spectator lifecycle events
        (NetworkInterrupted / NetworkResumed / Disconnected, with the
        viewer's address) — the hub-side analog of ``P2PSession.events``
        for hub-owned endpoints."""
        out = self._events.get(index) or []
        self._events[index] = []
        return out

    def spectators(self, index: int) -> List[Dict[str, Any]]:
        """Live view of match ``index``'s viewers: address, liveness, ack
        watermark, catchup lag (frames broadcast but unacked)."""
        return self.pool.spectator_states(index)

    def desync_report(self, index: int):
        """The pool's forensic report for match ``index`` (built when a
        desync-class fault quarantined the slot; its journal-tail section
        comes from this hub's attached journal), or None."""
        return self.pool.desync_report(index)

    def metrics_digest(self) -> str:
        """One-paragraph summary for chaos scenarios and operators: per-
        slot viewer counts and lag, fan-out volume, journal counters."""
        pool = self.pool
        lines = []
        total_viewers = 0
        # incremental walk: only slots that actually have
        # fan-out endpoints are visited — a 256-slot pool with 3 spectated
        # matches does 3 state reads, not 256
        mirrors = getattr(pool, "_mirrors", None)
        if mirrors and pool.native_active:
            candidates = [
                i for i, m in enumerate(mirrors)
                if m.spectators or i in pool._evicted
            ]
        else:
            candidates = range(len(pool))
        for i in candidates:
            states = pool.spectator_states(i)
            if not states:
                continue
            total_viewers += sum(1 for s in states if s["running"])
            lag = max((s["catchup_lag"] for s in states), default=0)
            lines.append(
                f"  slot {i}: {sum(1 for s in states if s['running'])}"
                f"/{len(states)} viewers live, max catchup lag {lag}"
            )
        reg = self.metrics
        fanout_d = fanout_b = 0.0
        fam = {f.name: f for f in reg.families()}
        for name, acc in (("ggrs_fanout_datagrams_total", "d"),
                          ("ggrs_fanout_bytes_total", "b")):
            family = fam.get(name)
            if family is None:
                continue
            total = sum(child.value for _, child in family.samples())
            if acc == "d":
                fanout_d = total
            else:
                fanout_b = total
        lines.append(
            f"  fan-out: {int(fanout_d)} datagrams, {int(fanout_b)} bytes "
            f"across {total_viewers} live viewers"
        )
        lines.append(
            "  journal: frames={} bytes={} checkpoints={} gaps={} "
            "fsyncs={}".format(
                int(reg.value("ggrs_journal_frames_total") or 0),
                int(reg.value("ggrs_journal_bytes_total") or 0),
                int(reg.value("ggrs_journal_checkpoints_total") or 0),
                int(reg.value("ggrs_journal_gaps_total") or 0),
                int(reg.value("ggrs_journal_fsync_seconds") or 0),
            )
        )
        return "\n".join(lines)
