#!/usr/bin/env python
"""One-shot, flamegraph-style phase breakdown of a host-bank pool tick of the
PyTorch / CUDA port.

The twin of ``scripts/profile_tick.py`` over ``ggrs_tpu_torch``: the same
flags, the same ``GGRS_TPU_NO_FASTPATH`` toggle and the same lines.  Builds a
B-match pool (the bench's standard 2-peer match population over an
in-memory network) on the port's ``HostSessionPool``, drives it with the
trace ring armed -- Python spans plus the native in-crossing phase timers,
zero extra crossings -- and prints a text flamegraph: where a pool tick's
time goes, top-down, from ``pool.tick`` through ``bank.crossing`` into the
eight native phases, with the per-slot Python remainder attributed
explicitly.  It is host only (the bank's requests are answered by a dummy
save), as the JAX script is; ``scripts/port_tick_profile.py`` profiles the
other half, the replay and the executor on the card, and the two share no
code.  With ``--fulfil DEVICE`` it appends the device half of the same
population's tick, untraced by the bank: the requests fulfilled by a
``BatchedRequestExecutor`` on DEVICE (on a card, one CUDA graph replay a
tick), with the host ms of ``run`` a tick and, on a card, the host's launch
calls a tick inside ``run``, the device's busy ms and idle share a tick
(``torch.profiler``) and the pool's graph captures and replays.

    python scripts/port_profile_tick.py                   # B=64, 200 ticks
    python scripts/port_profile_tick.py --matches 256 --ticks 100
    python scripts/port_profile_tick.py --legacy          # force the legacy
                                                          # per-slot parse
    python scripts/port_profile_tick.py --trace tick.perfetto.json
                                                          # + full Perfetto dump
    python scripts/port_profile_tick.py --fulfil cuda     # + the device half

Notes: a TRACED pool uses the legacy sequential decode by design (per-slot
spans are the point of tracing), so the Python-side numbers here price the
reference decoder; pass ``--fast-sample`` to append an untraced
vectorized-vs-legacy host-tick A/B measured with plain perf_counter.
(DESIGN.md §19.)
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402


def build_pool(n_matches: int, tracer=None, fastpath=True, udp=False):
    from ggrs_tpu_torch.core import Local, Remote
    from ggrs_tpu_torch.games import boxgame_config
    from ggrs_tpu_torch.net import InMemoryNetwork
    from ggrs_tpu_torch.parallel.host_bank import HostSessionPool
    from ggrs_tpu_torch.sessions import SessionBuilder

    prev = os.environ.pop("GGRS_TPU_NO_FASTPATH", None)
    if not fastpath:
        os.environ["GGRS_TPU_NO_FASTPATH"] = "1"
    try:
        pool = HostSessionPool(tracer=tracer)
        schedules = []
        if udp:
            # real loopback UDP, both sides pooled: every fd is drained
            # by the gen-2 one-crossing recv table (DESIGN.md §23a), so
            # the pool.drain split below is live
            from ggrs_tpu_torch.net.sockets import UdpNonBlockingSocket

            net = _UdpNet()
            for m in range(n_matches):
                socks = [UdpNonBlockingSocket(0) for _ in (0, 1)]
                addrs = [
                    ("127.0.0.1", s.local_port()) for s in socks
                ]
                for me in (0, 1):
                    b = (
                        SessionBuilder(boxgame_config())
                        .with_clock(lambda: 0)
                        .with_rng(random.Random(3 + 5 * m + me))
                        .add_player(Local(), me)
                        .add_player(Remote(addrs[1 - me]), 1 - me)
                    )
                    pool.add_session(b, socks[me])
                    schedules.append(
                        lambda i, m=m, me=me:
                        ((i + 2 * m + me) // (2 + m % 3)) % 16
                    )
        else:
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
                    pool.add_session(b, net.socket(names[me]))
                    schedules.append(
                        lambda i, m=m, me=me:
                        ((i + 2 * m + me) // (2 + m % 3)) % 16
                    )
        if not pool.native_active:
            raise SystemExit("native bank did not engage (no toolchain?)")
    finally:
        os.environ.pop("GGRS_TPU_NO_FASTPATH", None)
        if prev is not None:
            os.environ["GGRS_TPU_NO_FASTPATH"] = prev
    return pool, schedules, net


class _UdpNet:
    """Drop-in for InMemoryNetwork's ``tick()`` when the population runs
    over real loopback sockets (the kernel delivers; nothing to pump)."""

    def tick(self) -> None:
        pass


def drive(pool, schedules, net, ticks, base=0, staged=True, split=None):
    """``staged``: route inputs through the batched ``stage_inputs``
    crossing (descriptor plane, §21) when the pool offers it; ``split``
    (a list) collects per-tick (staging_ms, decode_ms) host sub-phases —
    the §21 staging/decode attribution."""
    n = len(pool)
    times = np.empty(ticks)
    stage = getattr(pool, "stage_inputs", None) if staged else None
    for i in range(ticks):
        t0 = time.perf_counter()
        if stage is not None:
            stage([(h, h % 2, schedules[h](base + i)) for h in range(n)])
        else:
            for h in range(n):
                pool.add_local_input(h, h % 2, schedules[h](base + i))
        ts = time.perf_counter()
        for reqs in pool.advance_all():
            for r in reqs:
                if type(r).__name__ == "SaveGameState":
                    r.cell.save(r.frame, None, None)
        t1 = time.perf_counter()
        if split is not None:
            split.append(((ts - t0) * 1e3, (t1 - ts) * 1e3))
        times[i] = (t1 - t0) * 1e3
        net.tick()
    return times


# the host's CUDA calls the profiler names that launch work on the card
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
                "cuMemcpy", "cudaMemset", "cuMemset")


def fulfil_leg(n_matches: int, ticks: int, device: str, profiled: int = 8) -> None:
    """The population's tick with its requests fulfilled on ``device`` by a
    ``BatchedRequestExecutor`` (the RequestPlan's columns into the masked
    tick): host ms of ``run`` a tick over ``ticks`` ticks, then, on a card,
    ``profiled`` more ticks under ``torch.profiler``."""
    import torch

    from ggrs_tpu_torch.games import BoxGame
    from ggrs_tpu_torch.parallel import BatchedRequestExecutor

    pool, schedules, net = build_pool(n_matches)
    game = BoxGame(2)
    ex = BatchedRequestExecutor(
        game.advance, game.init_state_np(),
        lambda pairs: np.asarray([v for v, _ in pairs], np.uint8),
        batch_size=len(pool), ring_length=10, max_burst=9, device=device,
        raw_inputs_to_array=lambda blobs, statuses: blobs[:, :, 0])
    ex.warmup(np.zeros(2, np.uint8))
    card = ex.device.type == "cuda"
    n = len(pool)
    run_s = 0.0

    def tick(i: int, span: bool = False) -> float:
        pool.stage_inputs([(h, h % 2, schedules[h](i)) for h in range(n)])
        plan = pool.advance_all()
        t0 = time.perf_counter()
        if span:
            with torch.profiler.record_function("fulfil:run"):
                ex.run(plan)
        else:
            ex.run(plan)
        dt = time.perf_counter() - t0
        net.tick()
        return dt

    for i in range(16):
        tick(i)
    ex.block_until_ready()
    t0 = time.perf_counter()
    for i in range(16, 16 + ticks):
        run_s += tick(i)
    ex.block_until_ready()
    wall_ms = (time.perf_counter() - t0) / ticks * 1e3
    print(f"\n# device fulfilment on {ex.device}: B={n_matches} matches, {ticks} ticks")
    print(f"  run                    {run_s / ticks * 1e6:9.0f} us/tick   "
          f"(whole tick {wall_ms:.2f} ms)")
    if not card:
        return
    from torch.profiler import ProfilerActivity, profile

    captures = ex.captures
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(16 + ticks, 16 + ticks + profiled):
            tick(i, span=True)
        ex.block_until_ready()
        traced_ms = (time.perf_counter() - t0) / profiled * 1e3
    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()
    spans = [e.time_range for e in events if e.name == "fulfil:run" and e.device_type == cpu]
    calls = {}
    for e in events:
        if (e.device_type == cpu and e.name.startswith(LAUNCH_CALLS)
                and any(r.start <= e.time_range.start <= r.end for r in spans)):
            calls[e.name] = calls.get(e.name, 0) + 1 / profiled
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("fulfil:")) / profiled
    launches = " ".join(f"{k} {v:.2f}" for k, v in sorted(calls.items()))
    print(f"  launch calls in run    {launches or 'none'} per tick"
          f"   ({'a capture in the window' if ex.captures != captures else 'replays only'})")
    if busy_us:
        print(f"  device busy            {busy_us:9.0f} us/tick   "
              f"idle share {1 - busy_us / 1e3 / traced_ms:.3f} of the traced tick")
    else:
        print("  device busy            not measured")
    print(f"  graphs                 {ex.captures} captures, {ex.replays} replays")


def bar(us, full_us, width=42):
    n = 0 if full_us <= 0 else int(round(width * us / full_us))
    return "█" * max(0, min(width, n))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--matches", type=int, default=64, metavar="B",
                    help="matches (2 sessions each; default 64)")
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--legacy", action="store_true",
                    help="(documentational; traced pools already use the "
                         "legacy parse)")
    ap.add_argument("--fast-sample", action="store_true",
                    help="append an untraced vectorized-vs-legacy host "
                         "tick A/B")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="also write the full Perfetto export")
    ap.add_argument("--udp", action="store_true",
                    help="run the population over real loopback UDP so "
                         "the gen-2 one-crossing inbound drain (§23a) "
                         "engages; adds the pool.drain split line")
    ap.add_argument("--decode", action="store_true",
                    help="append the §24 decode-plane A/B: serial vs "
                         "parallel slow-slot decode (untraced, fast path "
                         "off so every slot is slow), with per-worker "
                         "utilization and GRO segments-per-datagram")
    ap.add_argument("--fulfil", default=None, metavar="DEVICE",
                    help="append the device half: the requests fulfilled by a "
                         "BatchedRequestExecutor on DEVICE (cuda or cpu)")
    ap.add_argument("--decode-backend", default="thread",
                    metavar="B", help="parallel leg backend for --decode "
                                      "(default thread)")
    args = ap.parse_args()

    from ggrs_tpu_torch.obs import Tracer

    tracer = Tracer(capacity=1 << 16)
    pool, schedules, net = build_pool(args.matches, tracer=tracer,
                                      udp=args.udp)
    drive(pool, schedules, net, 16)  # warm
    tracer.clear()
    d0_ns = pool.drain_ns
    d0_cross = pool.drain_crossings
    split: list = []
    times = drive(pool, schedules, net, args.ticks, base=16, split=split)
    drain_us = (pool.drain_ns - d0_ns) / 1000.0 / args.ticks
    drain_crossings = pool.drain_crossings - d0_cross
    pool.scrape()

    T = args.ticks
    summary = tracer.summary()
    totals = pool.native_phase_totals()
    tick_us = summary.get("pool.tick", {}).get("total_us", 0.0) / T
    cross_us = summary.get("bank.crossing", {}).get("total_us", 0.0) / T
    slot = summary.get("pool.slot", {})
    slot_us = slot.get("total_us", 0.0) / T

    print(f"# host-bank tick profile: B={args.matches} matches "
          f"({2 * args.matches} sessions), {T} ticks, traced "
          f"(legacy decode)")
    print(f"# wall: p50 {np.percentile(times, 50):.2f} ms  "
          f"p99 {np.percentile(times, 99):.2f} ms per tick\n")
    print(f"pool.tick                {tick_us:9.0f} us/tick  "
          f"{bar(tick_us, tick_us)}")
    print(f"  bank.crossing          {cross_us:9.0f} us/tick  "
          f"{bar(cross_us, tick_us)}")
    if totals:
        timed_ticks, phases = totals
        for name, ns in sorted(phases.items(), key=lambda kv: -kv[1]):
            us = ns / max(1, timed_ticks) / 1000.0
            print(f"    bank.{name:<18} {us:9.0f} us/tick  "
                  f"{bar(us, tick_us)}")
    print(f"  pool.slot (decode+send){slot_us:9.0f} us/tick  "
          f"{bar(slot_us, tick_us)}"
          f"   ({slot.get('count', 0) / T:.0f} slots/tick)")
    if drain_crossings:
        # the gen-2 inbound split (§23a): the recv-table crossing + the
        # routed record walk, measured at the advance_all call site —
        # it runs BEFORE bank.crossing, inside pool.tick
        print(f"  pool.drain (recv tbl)  {drain_us:9.0f} us/tick  "
              f"{bar(drain_us, tick_us)}"
              f"   ({drain_crossings / T:.1f} drains/tick)")
        dio = pool.io_stats()["drain"]
        print(f"    (batched inbound totals: {dio['datagrams']} datagrams"
              f" over {dio['recv_calls']} recvmmsg calls, "
              f"{dio['backpressure_stops']} backpressure stops)")
    other = tick_us - cross_us - slot_us
    print(f"  other (staging, superv){max(0.0, other):9.0f} us/tick  "
          f"{bar(max(0.0, other), tick_us)}")
    if split:
        arr = np.asarray(split)
        stage_us = float(arr[:, 0].mean()) * 1e3
        decode_us = float(arr[:, 1].mean()) * 1e3
        print(f"\n# §21 staging/decode split (wall, batched staging): "
              f"staging {stage_us:.0f} us/tick, "
              f"advance_all (crossing+decode) {decode_us:.0f} us/tick")

    if args.fulfil:
        fulfil_leg(args.matches, args.ticks, args.fulfil)

    if args.trace:
        path = tracer.write(args.trace)
        print(f"\nPerfetto export: {path} (load in chrome://tracing)")

    if args.fast_sample:
        print("\n# untraced A/B (plain perf_counter, same population):")
        for fast in (False, True):
            p, s, n2 = build_pool(args.matches, fastpath=fast)
            drive(p, s, n2, 16)
            xs = drive(p, s, n2, args.ticks, base=16)
            cov = p.fast_slot_ticks
            print(f"  {'vectorized' if fast else 'legacy    '}: "
                  f"p50 {np.percentile(xs, 50):6.2f} ms  "
                  f"p99 {np.percentile(xs, 99):6.2f} ms  "
                  f"(fast-path slot ticks {cov})")
            del p, s, n2

    if args.decode:
        # §24: the parallel slow-slot decode plane.  Untraced (a traced
        # pool keeps the interleaved reference decoder) and fast path
        # OFF, so every slot routes through the slow decoder and the
        # plane fans out every tick.  The serial leg is the kill-switch
        # posture; the wall delta between the legs IS the plane's win
        # (or, on a GIL build, its honest non-win).
        print(f"\n# §24 decode plane A/B: B={args.matches} matches, "
              f"fast path off (every slot slow), untraced")
        legs = (
            ("serial", {"GGRS_TPU_NO_PARALLEL_DECODE": "1"}),
            (args.decode_backend,
             {"GGRS_TPU_DECODE_BACKEND": args.decode_backend}),
        )
        for label, env in legs:
            saved = {k: os.environ.pop(k, None)
                     for k in ("GGRS_TPU_NO_PARALLEL_DECODE",
                               "GGRS_TPU_DECODE_BACKEND")}
            os.environ.update(env)
            try:
                p, s, n2 = build_pool(args.matches, fastpath=False,
                                      udp=args.udp)
                drive(p, s, n2, 16)
                dec0 = p.io_stats()["decode"]
                ns0, jobs0 = dec0["decode_ns"], dec0["jobs"]
                xs = drive(p, s, n2, args.ticks, base=16)
            finally:
                for k, v in saved.items():
                    os.environ.pop(k, None)
                    if v is not None:
                        os.environ[k] = v
            dec = p.io_stats()["decode"]
            print(f"  {label:<8}: p50 {np.percentile(xs, 50):6.2f} ms  "
                  f"p99 {np.percentile(xs, 99):6.2f} ms  "
                  f"(backend {dec['backend']}, "
                  f"{dec['parallel_ticks']} fanned ticks)")
            if dec["parallel_ticks"]:
                jobs = dec["jobs"] - jobs0
                in_pool_us = (dec["decode_ns"] - ns0) / 1000.0 / args.ticks
                print(f"            slow slots/tick "
                      f"{jobs / args.ticks:.1f}, in-pool decode "
                      f"{in_pool_us:.0f} us/tick over "
                      f"{dec['workers']} workers")
                total = sum(dec["worker_jobs"].values()) or 1
                spread = ", ".join(
                    f"{100 * v / total:.0f}%"
                    for v in sorted(dec["worker_jobs"].values(),
                                    reverse=True)
                )
                print(f"            worker utilization (jobs): {spread}")
            dio = p.io_stats()["drain"]
            if dio.get("gro_datagrams"):
                print(f"            gro: {dio['gro_segments']} segments "
                      f"from {dio['gro_datagrams']} trains "
                      f"({dio['gro_segments'] / dio['gro_datagrams']:.1f} "
                      f"segs/datagram)")
            del p, s, n2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
