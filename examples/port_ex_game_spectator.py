"""Spectator example of the PyTorch / CUDA port: follow a host's confirmed
inputs, never rolling back, state on the card.

The twin of ``examples/ex_game_spectator.py``.  The host must list this
process as a spectator (a host of either package will do: the wire is the
same):

  python examples/port_ex_game_p2p.py --local-port 7777 --players local 127.0.0.1:8888 \
      --spectators 127.0.0.1:9999
  python examples/port_ex_game_spectator.py --local-port 9999 --host 127.0.0.1:7777

This client is host-implementation agnostic: a pool-scale host
(``ggrs_tpu_torch.broadcast.SpectatorHub`` on a ``HostSessionPool``) fans the
same confirmed-input stream to it, and matches journaled there replay
offline through ``ggrs_tpu_torch.sessions.ReplaySession``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def run_spectator(local_port: int = 9999, host: str = "127.0.0.1:7777", num_players: int = 2,
                  frames: int = 600, render: bool = False, device=None, ready=None):
    """Follow the host to ``frames`` frames; returns ``(game, session,
    frame, events)``.  ``ready``, if given, is called once the socket is
    bound (the ``listening`` line is printed then too)."""
    from port_ex_game import FPS, FrameClock, Game, box_config
    from ggrs_tpu_torch.core import Disconnected
    from ggrs_tpu_torch.core.errors import (
        NotSynchronized,
        PredictionThreshold,
        SpectatorTooFarBehind,
    )
    from ggrs_tpu_torch.net import UdpNonBlockingSocket
    from ggrs_tpu_torch.sessions import SessionBuilder

    host_name, _, port = host.rpartition(":")
    # build (and warm up) the game BEFORE the session: the disconnect timer
    # runs from session creation.  Spectators never roll back, so skip the
    # burst warmups entirely.
    game = Game(num_players, render=render, rollbacks=False, device=device)
    sess = (
        SessionBuilder(box_config())
        .with_num_players(num_players)
        .with_fps(FPS)
        # handshake before following: the disconnect timers pause until the
        # host actually appears (it may spend seconds importing and warming
        # up before sending frame 0), then catch a real exit
        .with_sync_handshake(True)
        .with_disconnect_timeout(5_000)
        .with_disconnect_notify_delay(2_000)
        # recover quickly when the host briefly runs ahead of real time
        .with_max_frames_behind(15)
        .with_catchup_speed(4)
        .start_spectator_session(
            (host_name or "127.0.0.1", int(port)),
            UdpNonBlockingSocket.bind_to_port(local_port),
        )
    )
    clock = FrameClock(FPS)
    # ready line: scripts (and the smoke test) wait for this before starting
    # the host, so the no-handshake stream never races our socket bind
    print(f"[spectator] listening on :{local_port}", flush=True)
    if ready is not None:
        ready()

    frame, events = 0, []
    while frame < frames:
        sess.poll_remote_clients()
        for ev in sess.events():
            events.append(ev)
            print(f"[spectator] event: {ev}")
            if isinstance(ev, Disconnected):
                # the host is gone -- no more confirmed inputs will ever come
                print(f"[spectator] host disconnected at frame {frame}; exiting")
                return game, sess, frame, events
        for _ in range(clock.ready_frames()):
            try:
                game.handle_requests(sess.advance_frame())
                frame = sess.current_frame
                game.draw()
            except NotSynchronized:
                pass  # handshake still completing
            except PredictionThreshold:
                pass  # host inputs not here yet
            except SpectatorTooFarBehind:
                print("[spectator] lapped by host; exiting")
                return game, sess, frame, events
        time.sleep(0.0005)
    print(f"[spectator] done: {frame} frames")
    return game, sess, frame, events


def main() -> None:
    from port_ex_game import add_device_flag

    ap = argparse.ArgumentParser()
    ap.add_argument("--local-port", type=int, default=9999)
    ap.add_argument("--host", default="127.0.0.1:7777")
    ap.add_argument("--num-players", type=int, default=2)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--render", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args()

    run_spectator(args.local_port, args.host, args.num_players, args.frames, args.render,
                  args.device)


if __name__ == "__main__":
    main()
