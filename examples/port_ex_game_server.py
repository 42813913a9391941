"""Massed-hosting example of the PyTorch / CUDA port: N live P2P BoxGame
matches on one card.

The twin of ``examples/ex_game_server.py``: ONE process drives N matches (2
peers each, in-memory transport -- the shape of a game server simulating
authoritatively for its clients) and fulfills all 2N sessions' per-tick
request lists with a single batched tick on the card
(``parallel.BatchedRequestExecutor``).  Per-session rollback depths differ
every tick; the pool normalizes them into one predicated tick.

  python examples/port_ex_game_server.py --matches 16 --frames 300
"""

from __future__ import annotations

import argparse
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def run_server(matches: int = 8, frames: int = 240, max_prediction: int = 8, device=None):
    """Run the example; returns ``(pool, sessions, desyncs, rate)``: the
    ``BatchedRequestExecutor``, the 2 x ``matches`` sessions (match m's peers
    are 2m and 2m + 1), the matches whose two live states differ, and
    session-ticks per second."""
    import numpy as np

    from port_ex_game import box_config, inputs_to_array
    from ggrs_tpu_torch.core import Local, Remote
    from ggrs_tpu_torch.games import BoxGame
    from ggrs_tpu_torch.net import InMemoryNetwork
    from ggrs_tpu_torch.parallel import BatchedRequestExecutor
    from ggrs_tpu_torch.sessions import SessionBuilder

    game = BoxGame(2)
    n_sessions = 2 * matches

    # warm the pool up BEFORE any session exists (see the executor's warmup)
    pool = BatchedRequestExecutor(
        game.advance,
        game.init_state_np(),
        inputs_to_array,
        batch_size=n_sessions,
        ring_length=max_prediction + 2,
        max_burst=max_prediction + 1,
        device=device,
    )
    pool.warmup(np.zeros((2,), np.uint8))

    net = InMemoryNetwork()
    sessions, schedules = [], []
    for m in range(matches):
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            b = (
                SessionBuilder(box_config())
                .with_rng(random.Random(1000 + 3 * m + me))
                .with_max_prediction_window(max_prediction)
                .add_player(Local(), me)
                .add_player(Remote(names[1 - me]), 1 - me)
            )
            sessions.append(b.start_p2p_session(net.socket(names[me])))
            schedules.append(
                lambda i, m=m, me=me: ((i + 2 * m + me) // (2 + m % 3)) % 16
            )

    # inputs hold constant over the final frames so repeat-last predictions
    # become correct and every peer's live state converges to the true
    # simulation (predicted tails otherwise legitimately differ at the
    # moment we stop and compare)
    drain_from = max(0, frames - 3 * max_prediction)

    t0 = time.perf_counter()
    for i in range(frames):
        for s in sessions:
            s.poll_remote_clients()
        reqs = []
        for h, (s, sched) in enumerate(zip(sessions, schedules)):
            s.add_local_input(h % 2, sched(min(i, drain_from)))
            reqs.append(s.advance_frame())
        pool.run(reqs)  # ONE batched tick for all matches
    pool.block_until_ready()
    dt = time.perf_counter() - t0

    # verify every match's two peers agree bit-exactly
    desyncs = 0
    for m in range(matches):
        a, b = pool.live_state(2 * m), pool.live_state(2 * m + 1)
        if any(not np.array_equal(a[k], b[k]) for k in a):
            desyncs += 1
    return pool, sessions, desyncs, n_sessions * frames / dt


def main() -> int:
    from port_ex_game import add_device_flag

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--matches", type=int, default=8)
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--max-prediction", type=int, default=8)
    add_device_flag(ap)
    args = ap.parse_args()

    _, sessions, desyncs, rate = run_server(args.matches, args.frames, args.max_prediction,
                                            args.device)
    print(
        f"hosted {args.matches} matches ({len(sessions)} sessions) for "
        f"{args.frames} frames: {rate:,.0f} session-ticks/sec, "
        f"{desyncs} desynced matches"
    )
    print("SERVER-EXAMPLE-OK" if desyncs == 0 else "SERVER-EXAMPLE-DESYNC")
    return 0 if desyncs == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
