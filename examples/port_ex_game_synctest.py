"""SyncTest example of the PyTorch / CUDA port: forced rollback + checksum
verification every frame, state on the card.

The twin of ``examples/ex_game_synctest.py``: builds a SyncTestSession, feeds
bot inputs for all players, executes requests on the card.  Use
--device-session to run the same thing through the fused
DeviceSyncTestSession instead (states never leave device memory), and
--device cpu to run on the CPU.

  python examples/port_ex_game_synctest.py --num-players 2 --check-distance 7 --frames 600
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def run_synctest(num_players: int = 2, check_distance: int = 7, input_delay: int = 0,
                 frames: int = 600, render: bool = False, device_session: bool = False,
                 device=None):
    """Run the example; returns ``(game, session)``: the ``Game`` (its
    executor holds the host session's live state) and the host
    ``SyncTestSession`` or the ``DeviceSyncTestSession``."""
    from port_ex_game import FPS, Game, box_config
    from ggrs_tpu_torch.sessions import SessionBuilder

    game = Game(num_players, render=render, device=device)

    if device_session:
        from ggrs_tpu_torch.sessions import DeviceSyncTestSession

        sess = DeviceSyncTestSession(
            game.box.advance,
            game.box.init_state_np(),
            np.zeros((num_players,), np.uint8),
            check_distance=max(check_distance, 1),
            device=game.device,
        )
        inputs = np.asarray(
            [[game.bot_input(p, f) for p in range(num_players)] for f in range(frames)],
            np.uint8,
        )
        sess.run_ticks(inputs)
        return game, sess

    sess = (
        SessionBuilder(box_config())
        .with_num_players(num_players)
        .with_check_distance(check_distance)
        .with_input_delay(input_delay)
        .with_fps(FPS)
        .start_synctest_session()
    )
    for frame in range(frames):
        for p in range(num_players):
            sess.add_local_input(p, game.bot_input(p, frame))
        game.handle_requests(sess.advance_frame())
        game.draw()
    return game, sess


def main() -> None:
    from port_ex_game import add_device_flag

    ap = argparse.ArgumentParser()
    ap.add_argument("--num-players", type=int, default=2)
    ap.add_argument("--check-distance", type=int, default=7)
    ap.add_argument("--input-delay", type=int, default=0)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--render", action="store_true")
    ap.add_argument("--device-session", action="store_true")
    add_device_flag(ap)
    args = ap.parse_args()

    run_synctest(args.num_players, args.check_distance, args.input_delay, args.frames,
                 args.render, args.device_session, args.device)
    if args.device_session:
        print(f"device synctest: {args.frames} frames, no desyncs")
    else:
        print(f"synctest: {args.frames} frames, no desyncs (state on device)")


if __name__ == "__main__":
    main()
