#!/usr/bin/env python3
"""Count, on the CPU, the device operations a port call would launch on the card.

    python3 scripts/port_op_count.py [--spec-ticks 160] [--pool-ticks 40]

Runs ``chip_smoke.py``'s phase 11 drive (BASELINE config 3, speculation on
and off) and phase 12 drive (the pool at 64 and 512 sessions) with
``device="cpu"``, and counts under a ``TorchDispatchMode`` every ATen op that
is not a view: on the card each is one kernel or copy.  A digest call counts
as the launches its card route makes (one per group of ``MAX_LEAVES``
leaves), not as the plain version's ops.  Prints one JSON line per workload:
ops per peer-0 rollback tick and plain tick, and per pooled tick, past the
first ticks.

The speculation counts are of the eager route (``chip_smoke.py``'s
``EagerSpec`` twin on the card); on the graph route the same ops run inside
one replay a tick, counted below.

Then the CUDA graphs: phase 5's executor drive (BoxGame(2) and ChipVM(2),
SyncTest d = 7), phase 12's pool at 64 sessions and phase 11's speculating
peer run their graph route on the CPU, each capture replaced by a stand-in
that runs the captured body at every replay, and the ops of one body are
counted: the kernels a replay launches on the card, by graph key.  It is a
count, not a measurement: the card's numbers come from ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402
import ggrs_tpu_torch.ops.checksum as checksum_mod  # noqa: E402
import ggrs_tpu_torch.ops.executor as executor_mod  # noqa: E402
import ggrs_tpu_torch.ops.graphs as graphs_mod  # noqa: E402
import ggrs_tpu_torch.parallel.session_pool as pool_mod  # noqa: E402
import ggrs_tpu_torch.parallel.spec_rollback as spec_mod  # noqa: E402
from ggrs_tpu_torch.ops.digest import MAX_LEAVES  # noqa: E402

VIEWS = {
    "view", "_unsafe_view", "slice", "select", "unsqueeze", "squeeze", "expand", "as_strided",
    "reshape", "transpose", "t", "alias", "permute", "detach", "lift_fresh", "split", "unbind",
    "_reshape_alias", "flatten", "view_as", "narrow",
}


class OpCount(TorchDispatchMode):
    """Non-view ATen ops while active; ``paused`` stops the count."""

    def __init__(self) -> None:
        super().__init__()
        self.n = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused and func.overloadpacket.__name__ not in VIEWS:
            self.n += 1
        return func(*args, **(kwargs or {}))


ACTIVE: list = []


def _digest_as_launches(real):
    def state_digest(leaves, salt_mix, batch_dims=1):
        mode = ACTIVE[-1] if ACTIVE else None
        if mode is None:
            return real(leaves, salt_mix, batch_dims)
        mode.paused = True
        try:
            out = real(leaves, salt_mix, batch_dims)
        finally:
            mode.paused = False
        mode.n += -(-sum(1 for l in leaves if l[0].numel()) // MAX_LEAVES)
        return out
    return state_digest


def counted(fn, *args):
    mode = OpCount()
    ACTIVE.append(mode)
    try:
        with mode:
            fn(*args)
    finally:
        ACTIVE.pop()
    return mode.n


def summary(values, skip):
    v = values[skip:] or values
    return {"calls": len(v), "mean": sum(v) / len(v), "min": min(v), "max": max(v)} if v else None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec-ticks", type=int, default=160)
    ap.add_argument("--pool-ticks", type=int, default=40)
    args = ap.parse_args()
    checksum_mod.state_digest = _digest_as_launches(checksum_mod.state_digest)

    # phase 11: peer 0's run, by rollback and plain ticks
    chip_smoke.SPEC_TICKS = args.spec_ticks
    real_init, real_run = executor_mod.DeviceRequestExecutor.__init__, \
        executor_mod.DeviceRequestExecutor.run
    for speculate in (False, True):
        made, rows = [], {"rollback": [], "plain": []}

        def init(self, *a, **k):
            real_init(self, *a, **k)
            made.append(self)

        def run(self, reqs):
            if self is not made[0]:
                return real_run(self, reqs)
            kind = "rollback" if any(type(r).__name__ == "LoadGameState" for r in reqs) else "plain"
            rows[kind].append(counted(real_run, self, reqs))

        executor_mod.DeviceRequestExecutor.__init__ = init
        executor_mod.DeviceRequestExecutor.run = run
        try:
            chip_smoke.drive_spec(speculate, "cpu")
        finally:
            executor_mod.DeviceRequestExecutor.__init__ = real_init
            executor_mod.DeviceRequestExecutor.run = real_run
        print(json.dumps({"workload": "speculation peer 0", "speculation": speculate,
                          "ticks": args.spec_ticks,
                          "ops_per_rollback_tick": summary(rows["rollback"], 20),
                          "ops_per_plain_tick": summary(rows["plain"], 2)}), flush=True)

    # phase 12: one pooled tick, by pool size
    real_tick = pool_mod.BatchedRequestExecutor._tick
    for matches, ticks in ((chip_smoke.POOL_MATCHES, args.pool_ticks),
                           (chip_smoke.POOL_BIG_MATCHES, chip_smoke.POOL_BIG_TICKS)):
        rows = []
        pool_mod.BatchedRequestExecutor._tick = lambda self, desc: rows.append(
            counted(real_tick, self, desc))
        try:
            chip_smoke.drive_pool(matches, ticks, "cpu", True)
        finally:
            pool_mod.BatchedRequestExecutor._tick = real_tick
        print(json.dumps({"workload": "pool", "sessions": 2 * matches, "ticks": ticks,
                          "ops_per_tick": summary(rows, 16)}), flush=True)
    graph_counts()


class _CountedGraph:
    """A capture's stand-in on the CPU: each replay runs the captured body
    again, its ops counted in ``ops``."""

    def __init__(self, body) -> None:
        self.body = body
        self.ops: list = []

    def replay(self) -> None:
        self.ops.append(counted(self.body))


def graph_counts() -> None:
    """Ops a replay of each request-path and speculation graph runs, on the
    CPU."""
    made: list = []

    def record(graphs, body):
        made.append(_CountedGraph(body))
        return made[-1]

    real_record = graphs_mod._record
    graphs_mod._record = record
    try:
        for name, game, high in (("BoxGame(2)", chip_smoke.BoxGame(2), 16),
                                 ("ChipVM(2)", chip_smoke.ChipVM(2), 256)):
            made.clear()
            programs = executor_mod.ExecutorPrograms(game.advance)
            cpu = torch.device("cpu")
            programs._graphs[cpu] = executor_mod.ExecutorGraphs(programs, cpu)
            inputs = chip_smoke.np.random.default_rng(17).integers(
                0, high, size=(40, 2)).astype(chip_smoke.np.uint8)
            chip_smoke.drive_executor(game, inputs, "cpu", programs)
            keys = list(programs._graphs[cpu]._entries)
            print(json.dumps({"workload": "executor graphs", "game": name,
                              "graphs": [{"key": k[0] + ("" if k[0] == "advance" else
                                                         f" n={k[2][0][0][0]} digest={k[3]}"),
                                          "replays": len(g.ops),
                                          "ops_per_replay": summary(g.ops, 0)}
                                         for k, g in zip(keys, made)]}), flush=True)

        made.clear()
        real_warmup = pool_mod.BatchedRequestExecutor.warmup

        def warmup(self, example_inputs):
            real_warmup(self, example_inputs)
            for shard in self._shards:
                shard["graphs"] = pool_mod._ShardGraphs(self, shard)
                shard["graphs"].warm()

        pool_mod.BatchedRequestExecutor.warmup = warmup
        try:
            chip_smoke.drive_pool(chip_smoke.POOL_MATCHES, 40, "cpu", True)
        finally:
            pool_mod.BatchedRequestExecutor.warmup = real_warmup
        replayed = [g for g in made if g.ops]
        print(json.dumps({"workload": "pool graphs", "sessions": chip_smoke.POOL_SESSIONS,
                          "ticks": 40, "captures": len(made),
                          "ops_per_replay": summary([n for g in replayed for n in g.ops], 0),
                          "by_graph": [{"replays": len(g.ops), "ops": g.ops[0]}
                                       for g in replayed]}), flush=True)

        made.clear()
        specs: list = []
        real_graphs = spec_mod.SpeculativeRollback.graphs

        def spec_graphs(self):
            if self._graphs is None:
                self._graphs = spec_mod.SpecGraphs(self)
                specs.append(self._graphs)
            return self._graphs

        spec_mod.SpeculativeRollback.graphs = spec_graphs
        try:
            chip_smoke.drive_spec(True, "cpu")
        finally:
            spec_mod.SpeculativeRollback.graphs = real_graphs
        keys = list(specs[0]._entries)
        name = lambda k: (k[0] if k[0] in ("extend", "advance_and_extend")
                          else f"{k[0]} n={k[1]} digest={k[2]} live={k[3]}")
        print(json.dumps({"workload": "speculation graphs", "ticks": chip_smoke.SPEC_TICKS,
                          "captures": len(made),
                          "graphs": [{"key": name(k), "replays": len(g.ops),
                                      "ops_per_replay": summary(g.ops, 0)}
                                     for k, g in zip(keys, made)]}), flush=True)
    finally:
        graphs_mod._record = real_record


if __name__ == "__main__":
    main()
