#!/usr/bin/env bash
# Static analysis + sanitized native legs for the port (ggrs_tpu_torch/):
# the twin of scripts/build_sanitized.sh, which builds and runs the JAX
# package's library and stays as it is.
#
# 1. port-verify: the static-analysis plane over the port's tree
#    (cross-language layout checker with the digest kernel's mirrors,
#    determinism lint vs its committed baseline, ownership lint,
#    transition conformance, tree hygiene).  Runs first and cheapest.
# 2. Model leg: the protocol models from the port's tables, in the same
#    60 s budget as the JAX leg.
# 3. ASan+UBSan leg: GGRS_NATIVE_SANITIZE=1 makes ggrs_tpu_torch/_build.py
#    build libggrs_host_san-<hash>.so (-O1 -g -fsanitize=address,undefined
#    -fno-sanitize-recover=all) from ggrs_tpu_torch/csrc/host/*.cpp, and
#    the port's host-side tests run on it, so any heap or UB fault in the
#    bank, the datapath or the runner aborts the run.  ASan must be loaded before Python, hence
#    the LD_PRELOAD.  Shard-runner children inherit both variables, so the
#    out-of-process serving loop runs the sanitized bank too.
# 4. TSan leg: GGRS_NATIVE_SANITIZE=thread builds libggrs_host_tsan-<hash>.so
#    (-O1 -g -fsanitize=thread) and runs the tests that drive the
#    GIL-released pump, the thread-ownership guard and the runner, with
#    GGRS_TPU_DECODE_BACKEND=thread so the decode plane's fan-out runs on
#    real worker threads.  Only the host library is instrumented, so a
#    report is a race in the native code, not in CPython or torch.
#
# Usage: scripts/port_build_sanitized.sh [extra pytest args]
#   GGRS_SKIP_VERIFY=1  skip the static gate (sanitizers only)
#   GGRS_SKIP_MODEL=1   skip the model-exploration leg (static only)
#   GGRS_SKIP_TSAN=1    skip the TSan leg (ASan only)
set -euo pipefail
cd "$(dirname "$0")/.."

echo "=== port-verify (static analysis plane) ==="
if [ -z "${GGRS_SKIP_VERIFY:-}" ]; then
    python scripts/port_verify.py
else
    echo "skipped (GGRS_SKIP_VERIFY)"
fi

echo "=== ggrs-model (protocol model exploration, port tables) ==="
if [ -z "${GGRS_SKIP_MODEL:-}" ] && [ -z "${GGRS_SKIP_VERIFY:-}" ]; then
    timeout -k 10 60 python scripts/port_verify.py --model --no-runtime
else
    echo "skipped (GGRS_SKIP_MODEL / GGRS_SKIP_VERIFY)"
fi

if ! command -v g++ >/dev/null; then
    echo "skip: no g++ toolchain" >&2
    exit 0
fi
asan_rt="$(g++ -print-file-name=libasan.so)"
if [ ! -e "$asan_rt" ]; then
    echo "skip: g++ has no libasan runtime" >&2
    exit 0
fi

# The port's tests hold each result against the JAX package on the same
# inputs.  Where the JAX side compiles an XLA computation, XLA's compiler
# trips ASan's interceptors (an upstream finding, as in
# build_sanitized.sh) and aborts the run before the port's code under
# test runs.  These cases do, and are left out of both legs by -k (found
# by recording, per test, every XLA compile with the caches cleared
# before each test):
#   test_hosted_pool_matches_jax            the JAX BatchedRequestExecutor
#   test_eviction_feeds_the_batched_executor_like_jax   (same)
#   test_kill_with_executors_matches_jax    JAX DeviceRequestExecutors
#   test_host_kill_with_executors_matches_jax           (same)
#   test_runner_executors_match_jax_executors           (same)
#   test_prediction_plane_on_a_fallback_pool  the JAX DevicePredictionPlane
#   test_checkpoints_cross_load             the JAX DeviceSyncTestSession
#   test_scrub_matches_per_frame_playback_and_jax  the JAX scrub program
# Two cases of tests/test_torch_proc_fleet.py are left out too, for time,
# not for a report: the kill scenario SIGKILLs the runner half-way through
# 48 ticks of about 2 ms each, and its failover happens when the parent
# reaps the child.  A sanitized process takes about 60 ms to be reaped
# (its shadow memory is unmapped), against 15 ms for the production one, so
# the failover falls after the run's last tick:
#   test_kill_matches_jax_inproc_kill       (placements after the kill)
#   test_journal_streams_match_jax          (the recovered journals)
# The slow soaks are left out as in the JAX script ("-m slow" runs them).
SANITIZER_TIMING="test_kill_matches_jax_inproc_kill or test_journal_streams_match_jax"
JAX_COMPILES="test_hosted_pool_matches_jax or test_eviction_feeds_the_batched_executor_like_jax or test_kill_with_executors_matches_jax or test_host_kill_with_executors_matches_jax or test_runner_executors_match_jax_executors or test_prediction_plane_on_a_fallback_pool or test_checkpoints_cross_load or test_scrub_matches_per_frame_playback_and_jax"

echo "=== ASan+UBSan leg: building the port's sanitized host library ==="
GGRS_NATIVE_SANITIZE=1 python -c \
    "import ggrs_tpu_torch._build as b; b.build_host(); print(b.host_library_path())"

# detect_leaks=0: CPython itself "leaks" interned objects at exit, which is
# noise here: the target is heap corruption and UB in the native cores.
# The JAX reference side loads its own sanitized library
# (ggrs_tpu/net/_ggrs_codec_san.so) under the same variable.
LD_PRELOAD="$asan_rt" \
ASAN_OPTIONS="detect_leaks=0:abort_on_error=1" \
GGRS_NATIVE_SANITIZE=1 \
JAX_PLATFORMS=cpu \
python -m pytest tests/test_torch_host_bank.py tests/test_torch_hosted_pool.py \
    tests/test_torch_bank_faults.py \
    tests/test_torch_native_io.py tests/test_torch_dispatch.py \
    tests/test_torch_decode_pool.py \
    tests/test_torch_broadcast_hub.py tests/test_torch_journal.py \
    tests/test_torch_fleet.py tests/test_torch_proc_fleet.py \
    tests/test_torch_fleet_link.py \
    tests/test_torch_ingress.py tests/test_torch_placement.py \
    -q -p no:cacheprovider -m "not slow" \
    -k "not ($JAX_COMPILES or $SANITIZER_TIMING)" "$@"

if [ -n "${GGRS_SKIP_TSAN:-}" ]; then
    echo "TSan leg skipped (GGRS_SKIP_TSAN)"
    exit 0
fi
tsan_rt="$(g++ -print-file-name=libtsan.so)"
if [ ! -e "$tsan_rt" ]; then
    echo "skip: g++ has no libtsan runtime" >&2
    exit 0
fi

echo "=== TSan leg: building the port's TSan host library ==="
GGRS_NATIVE_SANITIZE=thread python -c \
    "import ggrs_tpu_torch._build as b; b.build_host(); print(b.host_library_path())"

# One more case is left out of this leg, for time again: under the TSan
# runtime a process that has imported torch takes about 1.1 s to exit, even
# through os._exit (the runtime's own finalization), so a runner answering
# the shutdown call cannot be gone within the 0.5 s drain deadline of the
# JAX tests' tuning, and is SIGKILLed:
#   test_shutdown_rpc_closes_cleanly
TSAN_TIMING="test_shutdown_rpc_closes_cleanly"

# The concurrency surface: the kernel-batched socket datapath (GIL
# released around recvmmsg/sendmmsg), the dispatch hub, the decode
# plane's workers, the thread-ownership guard (the sessions' and the
# decode pool's) and the shard runners' serving loops.  halt_on_error
# aborts on the first race; second_deadlock_stack improves lock reports.
LD_PRELOAD="$tsan_rt" \
TSAN_OPTIONS="halt_on_error=1:second_deadlock_stack=1" \
GGRS_NATIVE_SANITIZE=thread \
GGRS_TPU_DECODE_BACKEND=thread \
JAX_PLATFORMS=cpu \
python -m pytest tests/test_torch_native_io.py tests/test_torch_dispatch.py \
    tests/test_torch_decode_pool.py tests/test_torch_sessions.py \
    tests/test_torch_proc_fleet.py tests/test_torch_fleet_link.py \
    tests/test_torch_ingress.py tests/test_torch_placement.py \
    -q -p no:cacheprovider -m "not slow" \
    -k "not ($JAX_COMPILES or $SANITIZER_TIMING or $TSAN_TIMING)" "$@"

echo "sanitized legs green (ASan+UBSan, TSan) + port-verify"
