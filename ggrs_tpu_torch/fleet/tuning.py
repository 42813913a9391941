"""FleetTuning: every fleet-layer timeout/backoff/jitter knob in one
dataclass (DESIGN.md §17).

The port's copy of ``ggrs_tpu/fleet/tuning.py``.

Before this existed the knobs were scattered module constants
(``supervisor.READMIT_*``, ``host_bank.EVICT_MAX_PER_TICK``) plus ad-hoc
literals in the process backend.  One dataclass means:

- chaos runs can RECORD the knobs they ran with (``as_dict`` rides every
  ``scripts/chaos.py`` JSON artifact, and ``from_dict`` round-trips it);
- deployments override via environment (``GGRS_FLEET_<FIELD>``, e.g.
  ``GGRS_FLEET_HEARTBEAT_DEADLINE_S=5``) without code changes;
- tests shrink the real-time deadlines (heartbeat, drain, restart
  backoff) to keep the watchdog scenarios fast.

The module constants the defaults mirror stay where they were — they are
the documented defaults and existing imports keep working — but every
``ShardSupervisor``/``ProcShard`` instance reads its *own* ``FleetTuning``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

ENV_PREFIX = "GGRS_FLEET_"


@dataclass
class FleetTuning:
    """The fleet's timing/backoff policy, in one place.

    Tick-denominated knobs (``*_ticks``) ride the supervisor's logical
    tick; seconds-denominated knobs (``*_s``) are wall-clock — the process
    backend's liveness story cannot be tick-based, because a hung
    supervisor loop is exactly one of the failures it must survive.
    """

    # --- process backend: liveness + watchdog (DESIGN.md §17) ---
    # runner → supervisor heartbeat cadence while idle
    heartbeat_interval_s: float = 0.25
    # no frame of any kind from the runner for this long = hang suspect
    heartbeat_deadline_s: float = 2.0
    # per-RPC reply deadline; a tick call exceeding it marks the shard
    # hung (wedged ≠ dead: escalation, not immediate failover)
    rpc_timeout_s: float = 10.0
    # spawn → hello→ready deadline (covers the child's interpreter+jax
    # import; generous because a cold page cache is not a failure)
    spawn_timeout_s: float = 30.0
    # SIGTERM (graceful drain) → SIGKILL escalation window
    drain_deadline_s: float = 2.0

    # --- process backend: restart policy ---
    # base of the jittered exponential respawn backoff
    restart_backoff_s: float = 0.5
    # restart-storm budget: at most this many restarts of one shard
    # within restart_window_s; past it the shard stays dead (a crash
    # loop must not melt the host with respawn work)
    restart_max: int = 3
    restart_window_s: float = 60.0

    # --- RPC framing ---
    # max frame the transport accepts, either direction (oversized
    # frames are rejected loudly; resume bundles with embedded
    # checkpoints are the big payloads)
    max_frame_bytes: int = 64 << 20

    # --- fleet observability plane (DESIGN.md §18) ---
    # 1 = runners piggyback delta-encoded registry snapshots (plus span
    # rings and ferried forensics) on heartbeat/tick replies; 0 compiles
    # the runner-side harvest out entirely (the harvest-off leg of the
    # <5% p99 overhead acceptance)
    obs_harvest: int = 1
    # at most this many trace spans ship per tick reply (bounds the
    # frame size; the runner's ring keeps the rest for the next reply)
    obs_max_spans_per_reply: int = 512
    # runner-side pool.scrape() cadence in runner ticks (refreshes the
    # ggrs_io_* / per-slot gauges the snapshot then exports); 0 = off
    obs_scrape_every: int = 0

    # --- admission retry (mirrors supervisor.READMIT_*) ---
    readmit_backoff_ticks: int = 8
    readmit_max_attempts: int = 6

    # --- bank eviction storm clamp (mirrors host_bank.EVICT_MAX_PER_TICK) ---
    evict_max_per_tick: int = 4

    # --- multi-host TCP fleet link (DESIGN.md §25) ---
    # shared HMAC secret for the challenge-response handshake; empty
    # means "local trust" (fine for socketpair/uds and loopback tests,
    # wrong for anything that crosses a host boundary)
    link_auth_token: str = ""
    # a severed link may reconnect+resume for this long; past it the
    # shard is confirmed dead and §16 journal failover runs
    link_reconnect_window_s: float = 3.0
    # base of the runner's jittered exponential re-dial backoff
    link_backoff_s: float = 0.05
    # per-connection handshake deadline, both sides (slowloris bound)
    link_handshake_timeout_s: float = 2.0
    # TCP keepalive probe idle time; 0 disables SO_KEEPALIVE
    link_keepalive_s: float = 5.0
    # frames retained per direction for sequence-numbered resumption;
    # a reconnect whose gap exceeds the ring forces epoch bump+re-adopt
    link_retain_frames: int = 256
    # how long §16 failover keeps retrying a match whose wire port is
    # still bound (EADDRINUSE) — a fenced-but-alive incarnation is not
    # ours to kill, but it releases its sockets when the handshake
    # refusal lands, so the port frees within a handshake round trip
    failover_retry_s: float = 2.0

    # --- ingress & placement plane (DESIGN.md §26) ---
    # max dataplane idle before the ingress runner's serving loop runs a
    # forwarding pump cycle anyway (select() already wakes on traffic;
    # this bounds how stale the obs mirrors can get while idle)
    ingress_select_timeout_s: float = 0.05
    # placement refuses a host whose merged fleet-obs p99 tick latency
    # exceeds this budget, in milliseconds; 0 disables the p99 gate
    placement_p99_budget_ms: float = 0.0

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(f.default, str):
                if not isinstance(v, str):
                    raise ValueError(
                        f"FleetTuning.{f.name}: non-string {v!r}")
                continue
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise ValueError(f"FleetTuning.{f.name}: non-numeric {v!r}")
            if v < 0:
                raise ValueError(f"FleetTuning.{f.name}: negative {v!r}")

    # ------------------------------------------------------------------
    # env overrides + artifact round trip
    # ------------------------------------------------------------------

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None,
                 **overrides: Any) -> "FleetTuning":
        """Defaults, overridden by ``GGRS_FLEET_<FIELD>`` environment
        entries, overridden by explicit kwargs.  A malformed env value
        raises ``ValueError`` naming the variable — silently ignoring a
        typo'd production override would be worse than failing."""
        env = os.environ if env is None else env
        kw: Dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            key = ENV_PREFIX + f.name.upper()
            if key not in env:
                continue
            if isinstance(f.default, str):
                kw[f.name] = env[key]
                continue
            cast = int if isinstance(f.default, int) else float
            try:
                kw[f.name] = cast(env[key])
            except ValueError:
                raise ValueError(
                    f"{key}={env[key]!r}: not a valid {cast.__name__}"
                ) from None
        kw.update(overrides)
        return cls(**kw)

    def as_dict(self) -> Dict[str, Any]:
        """JSON-safe dict — embedded in every chaos artifact so a run
        records the knobs it ran with (``from_dict`` round-trips it)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FleetTuning":
        return cls(**dict(d))
