#!/usr/bin/env python3
"""The port's soak tier: the long-horizon P2P and pooled runs of the PyTorch /
CUDA port (``ggrs_tpu_torch``).

The twin of ``bench.py``'s soak harnesses: ``_match_population``,
``_build_matches`` and ``_pooled_matches_setup`` (``bench.py:914-970``), and
``p2p_soak`` / ``pool_soak`` (``bench.py:1025-1171``), with the same seeds,
fault rates, 16 ms clock step, inputs, checks and return dicts.  The
failures they hunt (ring and watermark drift, queue growth under asymmetric
loss, checksum-history aliasing after the frame wraps, and on the card
leaks in the CUDA graphs' static buffers and pools) only show at long
horizons.

One addition, ``device=``, the card unless told otherwise:

- ``"cpu"`` runs the JAX harnesses' route: two peers whose states are
  ``BoxGame.advance_np`` numpy trees, compared bit for bit at every settled
  frame; the pool is the eager ``BatchedRequestExecutor`` on the CPU.
- ``"cuda"`` (the default) runs the card's graph routes: each P2P peer is
  fulfilled by a ``DeviceRequestExecutor`` (every advance and burst one
  replay of its ``ExecutorGraphs``), the pool by its ``_ShardGraphs`` (one
  replay a tick).  The P2P run ends by holding the last frame both peers
  settled against a numpy ``advance_np`` replay of the confirmed inputs,
  bitwise, and its card checksum against the plain digest of that state;
  its digest launches against ``chaos.predicted_digest_launches``.

The pool run ends, on either device, by holding each match's newest frame
that both its sessions confirmed: their ring slots bitwise equal to each
other and to ``advance_np`` replayed over the inputs the schedules added.

Both routes sample the process at 25, 50, 75 and 100 % of the horizon (RSS;
on the card the CUDA caching allocator's reserved and allocated bytes and
the graphs' captures and replays) and check the sessions' queue bounds
there.

    python3 scripts/port_soak.py                       # the card, full horizons
    python3 scripts/port_soak.py --device cpu --frames 20000 --ticks 2048
"""

from __future__ import annotations

import argparse
import json
import os
import random
import resource
import sys
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ggrs_tpu_torch.chaos import predicted_digest_launches  # noqa: E402
from ggrs_tpu_torch.convert import from_numpy, to_numpy  # noqa: E402
from ggrs_tpu_torch.core import Local, Remote  # noqa: E402
from ggrs_tpu_torch.core.input_queue import INPUT_QUEUE_LENGTH  # noqa: E402
from ggrs_tpu_torch.core.device import resolve_device  # noqa: E402
from ggrs_tpu_torch.core.types import (  # noqa: E402
    AdvanceFrame,
    DesyncDetection,
    LoadGameState,
    SaveGameState,
)
from ggrs_tpu_torch.games import BoxGame, boxgame_config  # noqa: E402
from ggrs_tpu_torch.net import InMemoryNetwork  # noqa: E402
from ggrs_tpu_torch.ops import DeviceRequestExecutor  # noqa: E402
from ggrs_tpu_torch.ops.checksum import checksum_device_plain, checksum_to_u128  # noqa: E402
from ggrs_tpu_torch.ops.digest import lane_sums_rows, state_digest  # noqa: E402
from ggrs_tpu_torch.parallel import BatchedRequestExecutor  # noqa: E402
from ggrs_tpu_torch.sessions import SessionBuilder  # noqa: E402

P2P_FRAMES = 100_000     # the JAX soak test's horizon
POOL_TICKS = 20_000
TICK_MS = 16             # the injected clock's step a frame
DESYNC_INTERVAL = 100
SAMPLES = (0.25, 0.5, 0.75, 1.0)
# the queue bounds the soak holds the sessions to (tests/test_soak.py:36-46)
SEND_QUEUE_MAX = 128 + 16
CHECKSUM_HISTORY_MAX = 32
EVENT_QUEUE_MAX = 100
DIGEST_BACKLOG_MAX = 1200
# the P2P leg's fulfilment off the card: the JAX harness's numpy peers
# ("host"); "executor" runs the card's route on CPU executors, which is how
# the CPU tests rehearse it
CPU_P2P_ROUTE = "host"


def rss_mb() -> float:
    """The CURRENT resident set in MiB (``ru_maxrss`` is a lifetime
    high-water mark, so a drift measured from it would read 0)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def bounded_growth_violations(sessions, digests=()) -> list:
    """The bounds a long run must keep: each endpoint's send queue and
    checksum history, each session's event queue, the harness's digest
    backlog.  Returns what exceeded them."""
    out = []
    for n, s in enumerate(sessions):
        for ep in s._remote_endpoints:
            if ep._core.pending_len() > SEND_QUEUE_MAX:
                out.append(f"session {n}: send queue {ep._core.pending_len()}")
            if len(ep.pending_checksums) > CHECKSUM_HISTORY_MAX:
                out.append(f"session {n}: checksum history {len(ep.pending_checksums)}")
        if len(s._event_queue) > EVENT_QUEUE_MAX:
            out.append(f"session {n}: event queue {len(s._event_queue)}")
    for n, d in enumerate(digests):
        if len(d) >= DIGEST_BACKLOG_MAX:
            out.append(f"peer {n}: digest backlog {len(d)}")
    return out


def sample_points(horizon: int) -> dict:
    """Loop index -> fraction of the horizon, for the samples."""
    return {max(0, int(horizon * q) - 1): q for q in SAMPLES}


def take_sample(q: float, step: int, sessions, digests, device, graphs, probe) -> dict:
    out = {"at": q, "step": step, "rss_mb": rss_mb(),
           "violations": bounded_growth_violations(sessions, digests)}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        out["reserved"] = torch.cuda.memory_reserved(device)
        out["allocated"] = torch.cuda.memory_allocated(device)
    out["captures"], out["replays"] = graphs()
    if probe is not None:
        out["probe"] = probe()
    return out


def percentiles(ms: list) -> dict:
    a = np.asarray(ms)
    return {"p50": float(np.percentile(a, 50)), "p99": float(np.percentile(a, 99))}


# ---- the match population (bench.py:914-949) ----


def match_population(n_matches: int):
    """THE definition of the hosting soak's match population: yields
    ``(builder, socket, schedule)`` per session, with bench's names, rng
    seeds and input schedules."""
    net = InMemoryNetwork()
    for m in range(n_matches):
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            b = (
                SessionBuilder(boxgame_config())
                .with_clock(lambda: 0)
                .with_rng(random.Random(3 + 5 * m + me))
                .add_player(Local(), me)
                .add_player(Remote(names[1 - me]), 1 - me)
            )
            yield (
                b,
                net.socket(names[me]),
                lambda i, m=m, me=me: ((i + 2 * m + me) // (2 + m % 3)) % 16,
            )


def build_matches(n_matches: int):
    """The per-session form of ``match_population``: started P2PSessions."""
    sessions, schedules = [], []
    for b, sock, sched in match_population(n_matches):
        sessions.append(b.start_p2p_session(sock))
        schedules.append(sched)
    return sessions, schedules


def u8_inputs(pairs) -> np.ndarray:
    return np.asarray([p[0] for p in pairs], np.uint8)


def pooled_matches_setup(n_matches: int, device=None):
    """n_matches 2-peer BoxGame matches over one in-memory net with ONE
    BatchedRequestExecutor on ``device`` fulfilling all 2·n sessions.
    Returns (sessions, schedules, pool)."""
    game = BoxGame(2)
    sessions, schedules = build_matches(n_matches)
    pool = BatchedRequestExecutor(
        game.advance, game.init_state_np(), u8_inputs,
        batch_size=len(sessions), ring_length=10, max_burst=9,
        with_checksums=False, device=device,
    )
    pool.warmup(np.zeros((2,), np.uint8))
    return sessions, schedules, pool


# ---- the P2P soak (bench.py:1025-1139) ----


def p2p_sessions(net, clock_now):
    sessions = []
    for me in (0, 1):
        b = (
            SessionBuilder(boxgame_config())
            .with_desync_detection_mode(DesyncDetection.on(interval=DESYNC_INTERVAL))
            .with_clock(lambda: clock_now[0])
            .with_rng(random.Random(77 + me))
            .add_player(Local(), me)
            .add_player(Remote(("peer", 1 - me)), 1 - me)
        )
        sessions.append(b.start_p2p_session(net.socket(("peer", me))))
    return sessions


def p2p_input(i: int, me: int) -> int:
    return (i * 7 + me * 3) % 16


def p2p_soak(frames: int, periodic=None, device=None, probe=None) -> dict:
    """THE long-horizon two-peer harness: 2 peers over the seeded fault net
    (loss 0.08, duplication 0.04, reordering 0.04), desync detection on at
    interval 100, a 16 ms injected clock.

    On the CPU, a rolling bit-exact comparison of every settled frame, as
    ``bench.p2p_soak`` makes it: a frame's first save may be speculative, so
    the LAST save wins, compared once both peers are max_prediction+1 past
    it, then forgotten so memory stays bounded.  On the card the peers
    compare through the sessions' own checksum reports, and the run ends
    with the settled frame's checks (the module docstring).

    On the CPU the peers take ``CPU_P2P_ROUTE``.  ``periodic(sessions, digests)`` runs every 10k frames (the test asserts
    queue bounds there); ``probe()``'s value rides each sample.  Returns
    ``{"fps", "compared", "desyncs", "rss_drift_mb"}`` after asserting
    convergence itself, plus ``samples`` and host ms a frame, and on the
    executor route the settled frame's checks and the digest launches."""
    device = resolve_device(device)
    card = device.type == "cuda"
    on_executors = card or CPU_P2P_ROUTE == "executor"
    game = BoxGame(2)
    net = InMemoryNetwork(seed=1234, loss=0.08, duplicate=0.04, reorder=0.04)
    clock_now = [0]
    sessions = p2p_sessions(net, clock_now)

    # settled = both peers advanced past the frame by the whole prediction
    # window, so no speculative save can still be pending for it
    horizon_slack = sessions[0]._max_prediction + 1
    states = [game.init_state_np(), game.init_state_np()]
    digests: list = [{}, {}]
    compared = [0]

    def digest(st) -> int:
        return zlib.crc32(
            b"".join(np.ascontiguousarray(v).tobytes() for v in st.values())
        )

    def compare_settled() -> None:
        horizon = min(s.current_frame for s in sessions) - horizon_slack
        for f in [f for f in digests[0] if f <= horizon]:
            if f in digests[1]:
                assert digests[0][f] == digests[1][f], (
                    f"state divergence at frame {f}"
                )
                del digests[1][f]
                compared[0] += 1
            del digests[0][f]

    def fulfil_host(me: int, reqs) -> None:
        for r in reqs:
            if isinstance(r, SaveGameState):
                snap = {k: v.copy() for k, v in states[me].items()}
                d = digest(snap)
                r.cell.save(r.frame, snap, d)
                digests[me][r.frame] = d  # last save wins
            elif isinstance(r, LoadGameState):
                states[me] = {k: v.copy() for k, v in r.cell.data().items()}
            elif isinstance(r, AdvanceFrame):
                states[me] = game.advance_np(states[me], u8_inputs(r.inputs))

    executors, inputs, local = [], [], []
    if on_executors:
        for _ in sessions:
            ex = DeviceRequestExecutor(game.advance, game.init_state_np(), u8_inputs,
                                       device=device)
            ex.warmup(np.zeros(2, np.uint8), burst_depths=range(2, horizon_slack + 1))
            executors.append(ex)
            inputs.append(np.zeros((frames + horizon_slack + 2, 2), np.uint8))
            local.append(np.zeros(frames + horizon_slack + 2, np.uint8))
        state_digest.launches = lane_sums_rows.launches = 0

    def fulfil_card(me: int, reqs, frame: int) -> None:
        record_inputs(inputs[me], reqs, frame)
        if not card:
            executors[me].run(reqs)
            return
        torch.cuda.set_sync_debug_mode("error")
        try:
            executors[me].run(reqs)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def graphs():
        sets = [ex._programs.graphs(device) for ex in executors]
        sets = [g for g in sets if g is not None]
        return sum(g.captures for g in sets), sum(g.replays for g in sets)

    warm_captures = graphs()[0]
    points = sample_points(frames)
    samples, host_ms = [], []
    desyncs = predicted = 0
    rss_half = 0.0
    t0 = time.perf_counter()
    for i in range(frames):
        t_frame = time.perf_counter()
        clock_now[0] += TICK_MS
        for me, s in enumerate(sessions):
            frame = s.current_frame
            if on_executors:
                local[me][frame] = p2p_input(i, me)
            s.add_local_input(me, p2p_input(i, me))
            reqs = s.advance_frame()
            if on_executors:
                predicted += predicted_digest_launches(reqs)
                fulfil_card(me, reqs, frame)
            else:
                fulfil_host(me, reqs)
            desyncs += sum(
                1 for e in s.events()
                if type(e).__name__ == "DesyncDetected"
            )
        host_ms.append((time.perf_counter() - t_frame) * 1e3)
        if i % 500 == 0:
            compare_settled()
        if i == frames // 2:
            rss_half = rss_mb()
        if periodic is not None and i % 10_000 == 0:
            periodic(sessions, digests)
        if i in points:
            samples.append(take_sample(points[i], i + 1, sessions, digests, device,
                                       graphs, probe))
    compare_settled()
    if card:
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    assert desyncs == 0, f"{desyncs} desync events over the soak"
    assert all(s.current_frame >= frames - 64 for s in sessions), (
        "a peer stalled short of the horizon"
    )
    out = {
        "fps": frames / dt,
        "compared": compared[0],
        "desyncs": desyncs,
        "rss_drift_mb": rss_mb() - rss_half,
        "host_ms": percentiles(host_ms),
        "samples": samples,
    }
    if not on_executors:
        assert compared[0] > frames // 2, f"only {compared[0]} frames compared"
        return out
    out.update(settled_checks(game, sessions, inputs, local, device))
    # reports each peer compared (its window of the other's reports holds
    # them all below its capacity) and reports each peer sent; a report is
    # sent once, so the net's loss takes its share
    reports = [len(h.frames()) for s in sessions for h in s._remote_checksum_history.values()]
    sent = [s._last_sent_checksum_frame // DESYNC_INTERVAL for s in sessions]
    out.update(
        compared=sum(reports), checksum_reports=reports, checksum_reports_sent=sent,
        digest_launches=state_digest.launches, digest_predicted=predicted,
        digest_around=lane_sums_rows.launches,
        captures_after_warmup=graphs()[0] - warm_captures,
    )
    assert state_digest.launches == predicted and lane_sums_rows.launches == 0, (
        f"{state_digest.launches} digest launches, {predicted} predicted"
    )
    assert min(sent) >= frames // DESYNC_INTERVAL - 5 and all(
        r >= 0.8 * min(n, 256) for r, n in zip(reports, sent[::-1])), (
        f"checksum reports compared {reports} of {sent[::-1]} sent"
    )
    return out


def record_inputs(table: np.ndarray, reqs, frame: int) -> None:
    """Write each ``AdvanceFrame``'s inputs into ``table`` at the frame it
    advances, counting from the session's ``frame`` before the tick: a
    rollback's resimulation rewrites a frame, so the last advance wins."""
    for r in reqs:
        if isinstance(r, LoadGameState):
            frame = r.frame
        elif isinstance(r, AdvanceFrame):
            table[frame] = u8_inputs(r.inputs)
            frame += 1


def settled_cells(sessions) -> tuple:
    """The newest frame all ``sessions`` confirmed whose saved state each of
    them still holds, and those cells."""
    frame = min(s.confirmed_frame() for s in sessions)
    floor = min(s.current_frame for s in sessions) - 2 * sessions[0]._max_prediction
    while True:
        cells = [s._sync_layer.saved_state_by_frame(frame) for s in sessions]
        if all(c is not None and c.data() is not None for c in cells):
            return frame, cells
        frame -= 1
        assert frame >= floor, "no settled frame left in the peers' saved states"


def cell_state(cell) -> dict:
    """A saved state on the host: a pool's slot reference reads its ring
    slot, a tensor tree is copied over."""
    data = cell.data()
    return data.materialize() if hasattr(data, "materialize") else to_numpy(data)


def hold_to_oracle(game, frame: int, cells, inputs, local) -> dict:
    """One match at its settled ``frame``: both peers advanced through the
    same inputs below it, those are the inputs the schedules added
    (``local[p]`` is player p's, by frame), and each peer's saved state is
    bitwise ``advance_np`` replayed over them.  Returns the oracle state."""
    confirmed = inputs[0][:frame]
    assert all(np.array_equal(confirmed, other[:frame]) for other in inputs[1:]), (
        "the peers advanced through different confirmed inputs"
    )
    added = np.stack([lo[:frame] for lo in local], axis=1)
    bad = np.flatnonzero((confirmed != added).any(axis=1))
    assert not bad.size, f"frame {int(bad[0])}: confirmed inputs differ from the schedules'"
    oracle = game.init_state_np()
    for f in range(frame):
        oracle = game.advance_np(oracle, confirmed[f])
    for n, cell in enumerate(cells):
        st = cell_state(cell)
        bad = [k for k in oracle if not np.array_equal(st[k], oracle[k])]
        assert not bad, f"peer {n}: frame {frame} differs from the oracle in {bad}"
    return oracle


def settled_checks(game, sessions, inputs, local, device) -> dict:
    """The P2P run's end: the newest frame both peers confirmed held to the
    oracle (``hold_to_oracle``), and both checksums (the card digest, in
    the graphs) equal to the plain digest of that state."""
    frame, cells = settled_cells(sessions)
    oracle = hold_to_oracle(game, frame, cells, inputs, local)
    one_row = {k: v[None] for k, v in oracle.items()}
    plain = checksum_to_u128(checksum_device_plain(from_numpy(one_row, device))[0])
    sums = [int(c.checksum) for c in cells]
    assert sums == [plain, plain], (
        f"frame {frame}: checksums {sums}, plain digest of the oracle {plain}"
    )
    return {"settled_frame": frame, "settled_checksum": f"{plain:#034x}"}


# ---- the pool soak (bench.py:1142-1171) ----


def pool_soak(ticks: int, n_matches: int = 4, device=None, probe=None,
              warm_ticks: int = 0) -> dict:
    """Long-horizon pooled hosting: one BatchedRequestExecutor fulfilling
    2·n_matches sessions for ``ticks`` ticks (periodic fences), asserting
    every session reaches the horizon and each match's settled frame holds
    to the oracle (``hold_to_oracle``).  ``warm_ticks`` ticks run (untimed)
    before ``captures_after_warmup`` starts counting, so each graph key
    the population meets has its first tick there.  Returns
    ``{"session_ticks_per_sec", "sessions", "ring_wraps"}`` plus
    ``samples``, host ms a tick and the settled frames.  ``ring_wraps``
    is computed from the sessions' frames (their input queues advance one
    slot a frame), not read from the queues."""
    device = resolve_device(device)
    sessions, schedules, pool = pooled_matches_setup(n_matches, device)
    n_sessions = len(sessions)
    game = BoxGame(2)
    end = warm_ticks + ticks
    rows = end + sessions[0]._max_prediction + 2
    inputs = [np.zeros((rows, 2), np.uint8) for _ in sessions]
    local = [np.zeros(rows, np.uint8) for _ in sessions]

    def tick(i: int) -> None:
        reqs = []
        for h, (s, sched) in enumerate(zip(sessions, schedules)):
            frame = s.current_frame
            local[h][frame] = sched(i)
            s.add_local_input(h % 2, sched(i))
            reqs.append(s.advance_frame())
            record_inputs(inputs[h], reqs[-1], frame)
        pool.run(reqs)

    for i in range(warm_ticks):
        tick(i)
    pool.block_until_ready()
    warm_captures = pool.captures
    points = sample_points(ticks)
    samples, host_ms = [], []
    t0 = time.perf_counter()
    for i in range(warm_ticks, warm_ticks + ticks):
        t_tick = time.perf_counter()
        tick(i)
        host_ms.append((time.perf_counter() - t_tick) * 1e3)
        if i % 2_000 == 0:
            pool.block_until_ready()
        if i - warm_ticks in points:
            samples.append(take_sample(points[i - warm_ticks], i - warm_ticks + 1, sessions,
                                       (), device, lambda: (pool.captures, pool.replays),
                                       probe))
    pool.block_until_ready()
    dt = time.perf_counter() - t0
    assert all(s.current_frame >= end - 64 for s in sessions), (
        "a pooled session stalled short of the horizon"
    )
    for m in range(n_matches):
        fa = sessions[2 * m].current_frame
        fb = sessions[2 * m + 1].current_frame
        assert abs(fa - fb) <= sessions[0]._max_prediction
    settled = []
    for m in range(n_matches):
        pair = slice(2 * m, 2 * m + 2)
        frame, cells = settled_cells(sessions[pair])
        try:
            hold_to_oracle(game, frame, cells, inputs[pair], local[pair])
        except AssertionError as e:
            raise AssertionError(f"match {m}: {e}") from None
        settled.append(frame)
    return {
        "session_ticks_per_sec": n_sessions * ticks / dt,
        "sessions": n_sessions,
        "ring_wraps": min(s.current_frame for s in sessions) // INPUT_QUEUE_LENGTH,
        "host_ms": percentiles(host_ms),
        "samples": samples,
        "frames": [s.current_frame for s in sessions],
        "settled_frames": settled,
        "captures_after_warmup": pool.captures - warm_captures,
        "replays": pool.replays,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=P2P_FRAMES)
    ap.add_argument("--ticks", type=int, default=POOL_TICKS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    p2p = p2p_soak(args.frames, device=args.device)
    print(json.dumps({"soak": "p2p", "frames": args.frames, **p2p}), flush=True)
    pool = pool_soak(args.ticks, device=args.device)
    print(json.dumps({"soak": "pool", "ticks": args.ticks, **pool}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
