"""P2P example of the PyTorch / CUDA port: one local player vs remote peers
over UDP, state on the card.

The twin of ``examples/ex_game_p2p.py``: one process drives ONE session and
you start the peers separately (or use --both to run both sides in-process,
handy for a quick look):

  python examples/port_ex_game_p2p.py --local-port 7777 --players local 127.0.0.1:8888 &
  python examples/port_ex_game_p2p.py --local-port 8888 --players 127.0.0.1:7777 local

Honors WaitRecommendation by skipping frames (the reference's slow-down),
prints network stats periodically, reports desync/disconnect events.  A peer
of this example plays a peer of the JAX one: the wire and the checksums are
the same.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_addr(s: str):
    host, _, port = s.rpartition(":")
    return (host or "127.0.0.1", int(port))


def run_session(local_port: int, players, spectators, frames: int, render: bool,
                device=None):
    """Play one session to ``frames`` frames; returns ``(game, session,
    frames_run, events)``, ``events`` being every event the session raised."""
    from port_ex_game import FPS, FrameClock, Game, box_config
    from ggrs_tpu_torch.core import DesyncDetection, Local, Remote, Spectator
    from ggrs_tpu_torch.core.errors import NotSynchronized, PredictionThreshold
    from ggrs_tpu_torch.net import UdpNonBlockingSocket
    from ggrs_tpu_torch.sessions import SessionBuilder

    builder = (
        SessionBuilder(box_config())
        .with_num_players(len(players))
        .with_desync_detection_mode(DesyncDetection.on(60))
        .with_fps(FPS)
        # handshake before streaming: peers may start seconds apart (torch
        # import + warmup), and without it the disconnect timers cannot tell
        # "not started yet" from "gone" (disconnect timers are paused until
        # the handshake completes)
        .with_sync_handshake(True)
        # share-a-machine CI tolerance for mid-run scheduling hiccups
        .with_disconnect_timeout(5_000)
        .with_disconnect_notify_delay(2_000)
    )
    local_handles = []
    for handle, spec in enumerate(players):
        if spec == "local":
            builder = builder.add_player(Local(), handle)
            local_handles.append(handle)
        else:
            builder = builder.add_player(Remote(parse_addr(spec)), handle)
    for i, spec in enumerate(spectators):
        builder = builder.add_player(Spectator(parse_addr(spec)), len(players) + i)

    # build (and warm up) the game BEFORE the session: endpoint disconnect
    # timers start at session creation
    game = Game(len(players), render=render, device=device)
    sess = builder.start_p2p_session(UdpNonBlockingSocket.bind_to_port(local_port))
    clock = FrameClock(FPS)

    frame, events = 0, []
    while frame < frames:
        sess.poll_remote_clients()
        for ev in sess.events():
            events.append(ev)
            if type(ev).__name__ == "WaitRecommendation":
                clock.skip(ev.skip_frames)
            print(f"[:{local_port}] event: {ev}")
        # a late loop may find several frames ready: run no more than the
        # frames left, so the session stops at its budget
        for _ in range(min(clock.ready_frames(), frames - frame)):
            for h in local_handles:
                sess.add_local_input(h, game.bot_input(h, frame))
            try:
                requests = sess.advance_frame()
            except NotSynchronized:
                continue  # handshake still completing
            except PredictionThreshold:
                continue  # waiting on remote inputs
            game.handle_requests(requests)
            game.draw()
            frame += 1
            if frame % 300 == 0:
                for h in sess.remote_player_handles():
                    try:
                        print(f"[:{local_port}] stats p{h}: {sess.network_stats(h)}")
                    except Exception:
                        pass
        time.sleep(0.0005)
    # drain: keep pumping retransmissions/acks briefly so peers and
    # spectators that are still behind receive the tail of our inputs
    # (the reference's protocol lingers on shutdown for the same reason,
    # protocol.rs:311-319)
    deadline = time.perf_counter() + 1.0
    while time.perf_counter() < deadline:
        sess.poll_remote_clients()
        time.sleep(0.005)
    events.extend(sess.events())
    print(f"[:{local_port}] done: {frame} frames")
    return game, sess, frame, events


def run_both(frames: int, render: bool = False, ports=(7777, 8888), device=None):
    """Both peers in-process, each on its own thread and UDP port; returns
    their ``run_session`` results in port order."""
    a, b = ports
    legs = ((a, ["local", f"127.0.0.1:{b}"], render), (b, [f"127.0.0.1:{a}", "local"], False))
    results, errors = [None, None], []

    def leg(i, port, players, draw):
        try:
            results[i] = run_session(port, players, [], frames, draw, device)
        except BaseException as e:  # re-raised on the caller's thread below
            errors.append(e)

    threads = [threading.Thread(target=leg, args=(i, *spec)) for i, spec in enumerate(legs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def main() -> None:
    from port_ex_game import add_device_flag

    ap = argparse.ArgumentParser()
    ap.add_argument("--local-port", type=int, default=7777)
    ap.add_argument(
        "--players",
        nargs="+",
        default=["local", "127.0.0.1:8888"],
        help="per-handle: 'local' or host:port of the remote peer",
    )
    ap.add_argument("--spectators", nargs="*", default=[])
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--render", action="store_true")
    ap.add_argument("--both", action="store_true", help="run both peers in-process")
    add_device_flag(ap)
    args = ap.parse_args()

    if args.both:
        run_both(args.frames, args.render, device=args.device)
        return
    run_session(args.local_port, args.players, args.spectators, args.frames, args.render,
                args.device)


if __name__ == "__main__":
    main()
