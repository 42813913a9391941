"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (``BENCHMARK.json``).  It builds the cell's configuration on
the card from the seed, warms it up, measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one
JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``checks`` comes last, each number compared beside its
limit, as the last lines of standard error also give them.

``setup_s`` is timed from the end of ``import torch``: the framework's import
is the installation's, which no change to the program moves, and it swings
by seconds from run to run; its time is printed on standard error beside
set-up's phases.

Without the cards it exits with 2 and prints no result; where JAX or the
JAX package was loaded, with 3.  The program's build cache
(``ggrs_tpu_torch/_build/``) and any kernel cache stay inside the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "benchmark" / "_cache" / sub)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))

    import torch

    t0 = time.perf_counter()
    from benchmark import harness, spec

    marks = [("imports", time.perf_counter())]
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {cell.name} needs {cell.chips} CUDA card(s), found {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.zeros(1, device="cuda")  # the CUDA context, inside set-up
    marks.append(("cuda_context", time.perf_counter()))
    line, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0,
                                    marks=marks)
    checks.insert(0, f"setup import_torch {t0 - T0:.3f} s, before setup_s's clock")
    found = harness.forbidden_modules()
    if found:
        print(f"bench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(checks) + "\n")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
