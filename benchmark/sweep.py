"""A sweep of a batched cell's session count on the card, from which a
traffic mix's ``sessions`` is derived (its ``sessions_from``).  Not part of
any benchmark run.

    python3 benchmark/sweep.py --workload <cell> --seed 7 --seconds 20 \
        --sessions 131072,163840,196608

For each B in turn: the cell's set-up and warm-up as a run makes them, then
``--seconds`` of closed-loop calls, with no trace and no check.  Prints one
JSON line per B: the calls, the mean, p50 and p95 ms a call, the
resimulated frames a second, and the peak of device memory.  ``--device
cpu`` runs the same loop on the CPU, at a small B, to try it.
"""

import argparse
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sessions", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness, spec

    cell = spec.load_cell(args.workload)
    card = args.device != "cpu"
    for b in (int(s) for s in args.sessions.split(",")):
        if card:
            torch.cuda.reset_peak_memory_stats()
        run = harness.Run(cell, args.seed, args.device, b, None, [])
        run.warm()
        times, window_s = run.window(args.seconds)
        if card:
            torch.cuda.synchronize()
        ordered = sorted(times)
        print(json.dumps({"workload": cell.name, "sessions": b, "calls": len(times),
                          "mean_ms": sum(times) / len(times),
                          "p50_ms": ordered[len(ordered) // 2], "p95_ms": harness.p95(times),
                          "resim_frames_per_s": run.program.resim_frames(len(times)) / window_s,
                          "memory_peak_bytes": torch.cuda.max_memory_allocated() if card else 0}),
              flush=True)
        run.program.close()
        del run
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
