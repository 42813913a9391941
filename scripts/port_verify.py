#!/usr/bin/env python
"""port-verify: run the static-analysis plane over the port's tree
(``ggrs_tpu_torch/``), the twin of ``scripts/ggrs_verify.py``.

Five gates, all source-level (DESIGN.md §20, §22):

  layout       cross-language ABI/layout checker: native constants vs
               the Python decoders (header stride/fields, flag bits,
               error-code mirrors, RPC framing, jump offsets, the digest
               kernel's limits and primes), plus the runtime probes of
               the port's built libraries when they are on disk: the
               host library's ggrs_bank_hdr_stride() and stride probes,
               the digest library's ggrs_digest_limits()
  determinism  AST lint over rollback-visible code (wall clock, RNG,
               set iteration, salted hash, jit float reductions,
               unpinned pickles), baseline-aware
  ownership    ThreadOwned declaration lint (_DRIVING_METHODS closed
               both ways; no Thread/Timer/submit hand-off of a driving
               method)
  transitions  ggrs-model conformance: every fleet-layer state-setter
               site performs an edge of the declared SLOT_/PROC_/
               SHARD_TRANSITIONS tables
  hygiene      no generated artifacts (__pycache__, *.pyc, *.so,
               bench_out, the port's _build/) tracked by git; .gitignore
               keeps covering them

plus, with --model, the exploration leg: the §9/§16/§17 protocol
models from analysis/machines.py are explored breadth-first under a
state/time budget — HEAD models must be invariant-clean, known-broken
fixture models (the old checkpoint ordering) must keep their
pinned shortest counterexamples.

Usage:
  python scripts/port_verify.py                 # verify, exit 1 on new
  python scripts/port_verify.py --quick         # pre-commit: no runtime
                                                # probe, no models
  python scripts/port_verify.py --model         # + model exploration
  python scripts/port_verify.py --model --model-budget 500000,60
  python scripts/port_verify.py --baseline-update
  python scripts/port_verify.py --json out.json # embeds model traces

Exit codes: 0 = clean (modulo baseline), 1 = new violations, 2 = the
tool itself could not run.  Never imports the modules it judges, nor
the port's package (whose __init__ imports torch): the analysis
package and the build module are loaded by file, so the front runs on
a machine without jax or torch and on a tree broken enough not to
import.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = "ggrs_tpu_torch"
BASELINE = REPO / PKG / "analysis/determinism_baseline.json"


def _load_analysis():
    """Load ggrs_tpu_torch.analysis WITHOUT executing
    ggrs_tpu_torch/__init__ (which pulls torch and the whole session
    surface): the verifier must run fast and must run on trees whose
    runtime packages do not import."""
    spec = importlib.util.spec_from_file_location(
        "port_analysis",
        REPO / PKG / "analysis/__init__.py",
        submodule_search_locations=[str(REPO / PKG / "analysis")],
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["port_analysis"] = mod
    spec.loader.exec_module(mod)
    return mod


def _load_build():
    """The port's build module, by file: it imports the standard library
    only, and names the built libraries by the hash of their sources."""
    spec = importlib.util.spec_from_file_location(
        "port_build", REPO / PKG / "_build.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_hygiene(analysis) -> list:
    """Generated artifacts must never be tracked, and the ignore rules
    that keep them out must stay in place — the analysis plane scans
    sources, and a tracked .so/.pyc makes runs irreproducible."""
    Finding = analysis.Finding
    findings = []
    try:
        tracked = subprocess.run(
            ["git", "ls-files"], cwd=REPO, capture_output=True,
            text=True, check=True,
        ).stdout.splitlines()
    except (subprocess.SubprocessError, OSError):
        return []  # not a git checkout: nothing to police
    for path in tracked:
        if (
            "__pycache__" in path
            or path.endswith((".pyc", ".so"))
            or path.startswith(("bench_out/", f"{PKG}/_build/"))
        ):
            findings.append(Finding(
                "hygiene/tracked-artifact", path, 0,
                "generated artifact is tracked by git",
            ))
    gitignore = (REPO / ".gitignore")
    rules = gitignore.read_text().splitlines() if gitignore.exists() else []
    for needed in ("__pycache__/", "*.pyc", "*.so", "bench_out/",
                   f"{PKG}/_build/"):
        if needed not in rules:
            findings.append(Finding(
                "hygiene/gitignore", ".gitignore", 0,
                f"missing ignore rule {needed!r}",
            ))
    return findings


def _probe(lib, sym: str) -> int:
    fn = getattr(lib, sym)
    fn.restype = ctypes.c_int
    return int(fn())


def check_runtime_probes(analysis, probed: dict) -> list:
    """Pin the static layout table to the runtime probes of the port's
    built libraries that are on disk: the host library (the header and
    record strides, the stat-table widths) and the digest kernel's
    library (its limits against csrc/digest.cu's constants).  Loaded via
    ctypes straight from the .so — no package import — and skipped when
    nothing is built (the static checks already ran).  ``probed`` gets
    each probed library's repo-relative path, or None when absent."""
    Finding = analysis.Finding
    layout = analysis.layout
    findings = []
    build = _load_build()
    # production libraries only, whatever GGRS_NATIVE_SANITIZE says: a
    # sanitized variant aborts any process that dlopens it without its
    # runtime preloaded
    host_path = build.host_library_path(sanitize="")
    digest_path = build.library_path("digest")
    probed["host"] = probed["digest"] = None
    if host_path.exists():
        rel = host_path.relative_to(REPO).as_posix()
        probed["host"] = rel
        try:
            lib = ctypes.CDLL(str(host_path))
        except OSError:
            findings.append(Finding(
                "layout/runtime-probe", rel, 0,
                "library exists but does not load (stale build?)",
            ))
        else:
            for sym, want in (
                ("ggrs_bank_hdr_stride",
                 analysis.static_bank_header()["stride"]),
                # descriptor plane (§21) + datapath gen 2 (§23): record
                # strides straight from the built library
                ("ggrs_bank_req_stride", layout.LAYOUT_REQ_STRIDE),
                ("ggrs_bank_stage_stride", layout.LAYOUT_STAGE_STRIDE),
                ("ggrs_net_recv_stride", layout.LAYOUT_RECV_STRIDE),
                ("ggrs_net_route_stride", layout.LAYOUT_ROUTE_STRIDE),
                ("ggrs_net_fd_stride", layout.LAYOUT_FD_STRIDE),
            ):
                got = _probe(lib, sym)
                if got != want:
                    findings.append(Finding(
                        "layout/runtime-probe", rel, 0,
                        f"{sym}() = {got} != static contract {want}",
                    ))
            # stat-table widths against the Python tables' constants
            consts = analysis.parse_py_constants(
                REPO / PKG / "net/_native.py"
            )
            for sym, name in (
                ("ggrs_net_send_stats_len", "NET_SEND_STATS"),
                ("ggrs_net_recv_stats_len", "NET_RECV_TABLE_STATS"),
            ):
                got, want = _probe(lib, sym), consts.get(name)
                if got != want:
                    findings.append(Finding(
                        "layout/runtime-probe", rel, 0,
                        f"{sym}() = {got} != {PKG}/net/_native.py:"
                        f"{name} = {want}",
                    ))
    if digest_path.exists():
        rel = digest_path.relative_to(REPO).as_posix()
        probed["digest"] = rel
        try:
            lib = ctypes.CDLL(str(digest_path))
        except OSError:
            findings.append(Finding(
                "layout/runtime-probe", rel, 0,
                "library exists but does not load (stale build?)",
            ))
        else:
            limits = (ctypes.c_longlong * 3)()
            lib.ggrs_digest_limits.argtypes = [ctypes.c_void_p]
            lib.ggrs_digest_limits.restype = None
            lib.ggrs_digest_limits(limits)
            static = analysis.parse_cpp_constants(
                REPO / PKG / "csrc/digest.cu"
            )
            for i, name in enumerate(
                ("kMaxLeaves", "kGroupMaxWords", "kSegWords")
            ):
                if limits[i] != static.get(name):
                    findings.append(Finding(
                        "layout/runtime-probe", rel, 0,
                        f"ggrs_digest_limits()[{i}] = {limits[i]} != "
                        f"csrc/digest.cu:{name} = {static.get(name)}",
                    ))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baseline", type=Path, default=BASELINE)
    ap.add_argument(
        "--baseline-update", action="store_true",
        help="rewrite the baseline from the current tree and exit 0",
    )
    ap.add_argument(
        "--json", type=Path, default=None, metavar="PATH",
        help="write a machine-readable verdict artifact",
    )
    ap.add_argument(
        "--no-runtime", action="store_true",
        help="skip the runtime-probe cross-check even if a .so exists",
    )
    ap.add_argument(
        "--quick", action="store_true",
        help="pre-commit mode: layout + lints only (no runtime probe, "
             "no model exploration)",
    )
    ap.add_argument(
        "--model", action="store_true",
        help="also explore the §9/§16/§17 protocol models "
             "(analysis/machines.py catalog)",
    )
    ap.add_argument(
        "--model-budget", default="200000,30", metavar="STATES[,SECONDS]",
        help="per-model exploration budget (default: %(default)s)",
    )
    args = ap.parse_args(argv)

    try:
        budget = args.model_budget.split(",")
        model_states = int(budget[0])
        model_seconds = float(budget[1]) if len(budget) > 1 else 30.0
    except (ValueError, IndexError):
        print(f"port-verify: bad --model-budget {args.model_budget!r} "
              "(want STATES[,SECONDS])", file=sys.stderr)
        return 2

    try:
        analysis = _load_analysis()
    except Exception as e:  # the tool must fail distinguishably
        print(f"port-verify: cannot load the analysis package: {e}",
              file=sys.stderr)
        return 2

    sections = {
        "layout": list(analysis.check_layout(REPO)),
        "determinism": list(analysis.lint_determinism(REPO)),
        "ownership": list(analysis.lint_ownership(REPO)),
        "transitions": list(analysis.lint_transitions(REPO)),
        "hygiene": check_hygiene(analysis),
    }
    probed = None
    if not args.no_runtime and not args.quick:
        probed = {}
        sections["layout"] += check_runtime_probes(analysis, probed)
        for name, rel in probed.items():
            print(f"runtime probe: {name} library "
                  + (rel if rel else "not built (skipped)"))

    model_results = None
    if args.model and not args.quick:
        model_findings, model_results = analysis.check_models(
            REPO, max_states=model_states, max_seconds=model_seconds,
        )
        sections["model"] = model_findings
        for r in model_results:
            # "ok" here means MET EXPECTATION: fixture models are
            # supposed to produce their pinned counterexample, and a
            # fixture that explores clean is as broken as a HEAD model
            # that does not (check_models emits the finding either way)
            met = (r["kind"] == "clean") == (r["expect"] == "clean")
            kind = r["kind"]
            if kind != "clean" and r["expect"] == "counterexample":
                kind += "(expected)"
            print(
                f"model {'ok  ' if met else 'FAIL'} "
                f"{r['model']:<30s} ({r['section']}) "
                f"{kind:<21s} {r['states']:>6d} states  "
                f"depth {r['depth']:>2d}  {r['elapsed_s']*1000:7.1f} ms"
            )
        print(
            f"model leg: {len(model_results)} models, "
            f"{sum(r['states'] for r in model_results)} states, "
            f"{sum(r['elapsed_s'] for r in model_results):.2f}s elapsed "
            f"(budget: {model_states} states / {model_seconds:g}s "
            "per model)"
        )

    # only the determinism lint is baseline-eligible: layout/ownership/
    # transitions/hygiene/model drift is always a hard failure (there is
    # no "legacy" ABI skew or phantom transition to burn down — skew IS
    # the bug)
    det = sections["determinism"]
    hard = [
        f for k, v in sections.items() if k != "determinism" for f in v
    ]
    if args.baseline_update:
        analysis.write_baseline(
            args.baseline, analysis.Baseline.from_findings(det)
        )
        print(f"baseline updated: {args.baseline} "
              f"({len(det)} entries)")
        # hard findings are never baseline-eligible: blessing the
        # determinism set must not hide ABI/ownership/hygiene drift
        for f in hard:
            print(f"FAIL {f.render()}")
        if hard:
            print(f"port-verify: FAIL ({len(hard)} non-baselineable "
                  "findings remain)")
        return 1 if hard else 0
    baseline = analysis.load_baseline(args.baseline)
    new_det, legacy_det = baseline.split(det)

    for f in hard + new_det:
        print(f"FAIL {f.render()}")
    for f in legacy_det:
        print(f"legacy {f.render()}")

    verdict = "PASS" if not hard and not new_det else "FAIL"
    counts = {k: len(v) for k, v in sections.items()}
    summary = (
        f"{counts['layout']} layout, {len(new_det)} new + "
        f"{len(legacy_det)} legacy determinism, "
        f"{counts['ownership']} ownership, "
        f"{counts['transitions']} transitions, "
        f"{counts['hygiene']} hygiene"
    )
    if model_results is not None:
        summary += f", {counts['model']} model"
    print(f"port-verify: {verdict} ({summary})")
    if args.json is not None:
        artifact = {
            "verdict": verdict,
            "counts": counts,
            "new": [f._asdict() for f in hard + new_det],
            "legacy": [f._asdict() for f in legacy_det],
        }
        if probed is not None:
            # which built libraries the runtime probes read (None: absent)
            artifact["probes"] = probed
        if model_results is not None:
            # per-model verdicts WITH counterexample traces: the JSON
            # artifact is the replayable record of what exploration saw
            artifact["models"] = model_results
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(artifact, indent=2) + "\n")
    return 0 if verdict == "PASS" else 1


if __name__ == "__main__":
    raise SystemExit(main())
