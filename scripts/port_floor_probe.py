"""Floor probe of the PyTorch / CUDA port: what does a BARE advance loop cost
on the card?

The twin of ``scripts/floor_probe.py`` over ``ggrs_tpu_torch``.  Measures, on
one card, with ``torch.cuda.synchronize()`` as the completion fence:
  1. bare      -- ``advance`` alone, step after step: no ring, no digest
  2. +digest   -- bare plus the 4-lane checksum per step, XORed into an
                  accumulator
  3. +ring     -- bare plus digest plus the state-ring save per step
  4. flagship  -- the full steady replay (the DeviceSyncTestSession path)

The JAX variants are jitted ``lax.scan`` loops; here the first three bodies
run as eager loops, one kernel launch after another, so the per-step deltas
show what each extra costs in launches.  The flagship runs as the session
does: on the card each steady tick is one replay of its phase's CUDA graph
(``ops.replay.TickGraphs``).  All variants run the same number of
``advance`` steps per dispatch and the same number of dispatches.

    python3 scripts/port_floor_probe.py              # the card, the JAX sizes
    python3 scripts/port_floor_probe.py --device cpu

``main`` takes ``ticks_per_dispatch``, ``dispatches`` and ``repeats`` (the
JAX constants by default) so a caller can run it cut.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ggrs_tpu_torch.core.device import resolve_device  # noqa: E402
from ggrs_tpu_torch.games import BoxGame  # noqa: E402
from ggrs_tpu_torch.ops.checksum import CHECKSUM_LANES, checksum_device  # noqa: E402
from ggrs_tpu_torch.ops.ring import DeviceStateRing  # noqa: E402
from ggrs_tpu_torch.sessions import DeviceSyncTestSession  # noqa: E402
from ggrs_tpu_torch.utils.tree import tree_map  # noqa: E402

D = 8                    # flagship check distance
TICKS_PER_DISPATCH = 1024
DISPATCHES = 8
REPEATS = 3              # timed passes per variant; the best one counts
PLAYERS = 2
VARIANTS = ("bare", "digest", "ring", "flagship")

# flagship steady tick = d resim advances + 1 live advance; count d "resim
# frames" per tick.  Bare variants run the same TOTAL advance steps per
# dispatch as the flagship's (d+1)*ticks, credited at the same d-per-tick
# rate, so per-step work is identical and only the extras differ.


# ---- variant bodies: one session (B = 1), eager, one step per input row ----


def bare_loop(game, st, inps):
    """``advance`` over every row of ``inps`` ((n, 1, P) u8)."""
    for inp in inps:
        st = game.advance(st, inp)
    return st


def digest_loop(game, carry, inps):
    """``(state, acc)`` with each new state's ``(1, 4)`` int32 checksum XORed
    into ``acc`` (the JAX body's uint32 XOR, bit for bit)."""
    st, acc = carry
    for inp in inps:
        st = game.advance(st, inp)
        acc = acc ^ checksum_device(st)
    return st, acc


def ring_loop(game, ring, carry, inps, first_frame=0):
    """``(state, ring buffers)`` with each new state and its checksum saved
    into the slot of its frame (``first_frame`` + step), in place."""
    st, rbufs = carry
    for f, inp in enumerate(inps, start=first_frame):
        st = game.advance(st, inp)
        ring.save(rbufs, f, st, checksum_device(st))
    return st, rbufs


def fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(ticks_per_dispatch: int = TICKS_PER_DISPATCH, dispatches: int = DISPATCHES,
         repeats: int = REPEATS, device=None) -> dict:
    """Print the four rows and the gate line; returns the best seconds of
    each variant (``dispatches`` dispatches of ``(D + 1) * ticks_per_dispatch``
    advance steps, or of ``ticks_per_dispatch`` flagship ticks)."""
    dev = resolve_device(device)
    steps = (D + 1) * ticks_per_dispatch
    game = BoxGame(PLAYERS)
    init = game.init_state_np()
    rng = np.random.default_rng(7)

    def staged_inputs(n):
        return torch.from_numpy(rng.integers(0, 16, size=(n, PLAYERS), dtype=np.uint8)).to(dev)

    ring = DeviceStateRing(D + 2)
    inps = staged_inputs(steps).unsqueeze(1)
    st0 = tree_map(lambda a: torch.from_numpy(a[None]).to(dev), init)
    acc0 = torch.zeros((1, CHECKSUM_LANES), dtype=torch.int32, device=dev)
    rbufs0 = ring.init(st0)

    # the flagship program via the session, as bench.py drives it
    sess = DeviceSyncTestSession(
        game.advance, init, np.zeros((PLAYERS,), np.uint8),
        check_distance=D, max_prediction=D, device=dev,
    )
    tick_inps = staged_inputs(ticks_per_dispatch)

    passes = {
        "bare": lambda: bare_loop(game, st0, inps),
        "digest": lambda: digest_loop(game, (st0, acc0), inps),
        "ring": lambda: ring_loop(game, ring, (st0, rbufs0), inps),
        "flagship": lambda: sess.run_ticks(tick_inps, check=False),
    }
    # warm up with real fences: builds the digest kernel and fills the
    # allocator before any timed pass
    for name in VARIANTS:
        passes[name]()
    passes["flagship"]()
    fence(dev)

    results = {}
    for name in VARIANTS:
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(dispatches):
                passes[name]()
            fence(dev)
            best = min(best, time.perf_counter() - t0)
        results[name] = best

    total_steps = dispatches * steps
    resim_credit = dispatches * ticks_per_dispatch * D  # what bench.py counts
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"backend={dev.type} device={kind}")
    for name, dt in results.items():
        steps_ps = total_steps / dt
        resim_ps = resim_credit / dt
        us = dt / total_steps * 1e6
        print(
            f"{name:10s} {dt*1e3:9.1f} ms  {us:7.3f} us/advance-step  "
            f"{steps_ps:10.0f} steps/s  -> {resim_ps:10.0f} resim-credit f/s"
        )
    print(f"verdict: bare loop resim-credit {resim_credit / results['bare']:.0f} f/s")
    sess.verify()
    print("desync gate green")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    main(device=ap.parse_args().device)
