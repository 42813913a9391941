"""The control and the faults of ``variants.py``, on the card at a cell's own
size, over several seeds in one process; and the program itself beside
them for comparison.  Not part of any benchmark run.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 3 \
        --variants program,control

prints one JSON line per variant and seed: ``correct`` and each number
compared.  A variant is sound when every run of ``program`` reads correct
and every run of the others does not.
"""

import argparse
from contextlib import nullcontext
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--variants", default="program,control")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))

    from benchmark import harness, spec, variants

    cell = spec.load_cell(args.workload)
    bad = 0
    for name in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            with variants.variant(name, cell) if name != "program" else nullcontext() as step:
                line, _ = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                           time.perf_counter(), advance=step)
            values = {k: v["value"] for k, v in line["checks"].items()}
            print(json.dumps({"workload": cell.name, "variant": name, "seed": seed,
                              "correct": line["correct"], "calls": line["attempted"],
                              **values}), flush=True)
            bad += line["correct"] != (name == "program")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
