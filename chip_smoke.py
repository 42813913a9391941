#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``ggrs_tpu_torch``) on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure ends the run non-zero:

1. build -- compile the CUDA kernels from ``ggrs_tpu_torch/csrc`` with nvcc
   (all sources at once) and report the build seconds and ptxas summary;
   beside them, g++ builds the host library from the port's five sources
   in ``ggrs_tpu_torch/csrc/host/`` (``codec.cpp``, ``endpoint.cpp``,
   ``sync_core.cpp``, ``session_bank.cpp`` and ``net_batch.cpp``, one
   shared object: the bank calls the others' entry points; its seconds are
   reported too).
2. kernel -- the digest kernel against its plain PyTorch version on the
   card, bitwise, at every shape the port uses: through ``lane_sums_rows``
   (raw lanes of a word matrix) and through ``state_digest`` (whole batches
   of states read from their leaves: the ChipVM live and folded resim
   digests, BoxGame, a strided ring slot view, a state of every dtype and a
   2^26-word leaf; the EcsWorld live and folded resim digests, a strided
   EcsWorld ring slot and a float BoxGame state; the fulfilled speculation
   window, the pool's 64- and 512-row writes, states of 33 and 40 leaves (one
   raw launch per group of 32) and transposed, gapped and expanded leaves
   (each copied once first)).  Per shape: device us per launch from CUDA events
   around a CUDA graph of many launches (inputs rotated so the working set
   exceeds the L2 cache), host us per wrapper call, the plain version's
   time and the bytes bound.  The profiler checks that one CUDA
   ``checksum_device`` runs exactly one kernel.
3. flagship -- BoxGame(2) in a DeviceSyncTestSession at check_distance=8 on
   the card for 2048 ticks, 0 mismatches, bitwise equal to the same run on
   the CPU and to the NumPy oracle, exactly 2 digest launches per tick.
   Every steady tick is one input copy and one replay of its phase's CUDA
   graph (``ops.replay.TickGraphs``), under the sync debug mode "error"
   from the first steady tick (captures included).  The same drive through
   the eager ``steady_tick`` loop on the card (``eager_drive``, the graphs'
   plain version): carries and digest counts bitwise equal.  One line
   (``graph_vs_eager``) gives ms per tick of both paths over the same timed
   ticks, graph captures (= R) and replays (= steady ticks), the pool's
   bytes, and from the profiler over the last 16 ticks the host's launch
   calls a tick inside the replay's span (one ``cudaGraphLaunch`` and at
   most one copy), kernels, busy ms and the idle share.
4. batched (the main path at real scale) -- ChipVM(2), B = 16,384 sessions,
   d = 8, 64 ticks, on the graphs and eager as phase 3 (18 untimed ticks:
   the warmup and every capture; 4 profiled): 0 mismatches; sessions 0-7
   rerun on the CPU bitwise equal; exactly 2 digest launches per tick,
   counted per replay.  Kernel launch counts are zeroed just before the
   graph drive and read just after it.
5. executor (the request-list path) -- ``SessionBuilder`` -> host
   ``SyncTestSession`` (check_distance 7, max_prediction 8) ->
   ``DeviceRequestExecutor`` on the card, for BoxGame(2) over 1,000 frames
   and ChipVM(2) over 160.  Every ``executor.run`` runs under
   ``torch.cuda.set_sync_debug_mode("error")``, so a device->host read
   there fails the run.  Every saved checksum and the final live state
   equal the same run on the CPU (BoxGame also the NumPy oracle), and the
   digest launches exactly once per frame (counts zeroed just before each
   drive).  The executor's single advance and burst run as CUDA graph
   replays (``ops.executor.ExecutorGraphs``): 9 captures a game in its
   warmup (the advance and depths 2-9), one replay a frame, and in the last
   8 frames (profiled) one ``cudaGraphLaunch`` and at most 2L + 2 other
   launch calls inside ``run`` (L leaves).  The same drive through the
   plain versions on the card (``EagerPrograms``): saved checksums, live
   state and digest launches bitwise equal.  Host ms per frame of both,
   kernels, busy ms and idle share a frame, the graphs' pool bytes, the
   digest's us inside the graph, and the digest's device us at the 1 and 7
   rows the executor digests, with both held bitwise against the plain
   version.
6. checkpoint -- the ChipVM B = 16,384, d = 8 batch saved after 32 ticks,
   loaded into another ``BatchedSessions`` that has run 32 ticks of its own
   (all 9 phase graphs captured), and run 32 more ticks under the sync
   debug mode "error": the load keeps every carry buffer, the resumed run
   replays the same 9 graphs, and its carry (16,384 x 2,964 bytes) is
   bitwise the uninterrupted run's.  File size, save and load seconds.
7. p2p (the P2P rollback path) -- two ``P2PSession`` peers in one process,
   built by ``SessionBuilder.add_player(...).start_p2p_session``, each with
   its own ``DeviceRequestExecutor`` on the card, linked by a seeded
   ``InMemoryNetwork`` with 5 % loss, 5 % reordering and 3 ticks of latency,
   on a fake 16 ms clock, with desync detection at interval 1: BoxGame(2)
   for 750 frames and ChipVM(2) for 80.  Inputs change every few frames,
   so rollbacks come regularly.  0 ``DesyncDetected``; every checksum each
   peer sent and both final live states equal the same seeded run on the
   CPU (BoxGame also the NumPy oracle); every ``executor.run`` runs under
   the sync debug mode "error"; the digest's launches (counts zeroed just
   before the drive) equal the count the request lists predict: one per
   burst that saves plus one per lone Save.  Rollbacks, depth, kernels and
   digest launches per frame, host ms per frame split into
   ``poll_remote_clients``, ``advance_frame`` (with its checksum read) and
   ``run``.  A second, short BoxGame drive corrupts peer B's live state and
   must raise ``DesyncDetected`` with unequal checksums.

8. ecs (BASELINE config 4) -- ``EcsWorld(4, 32)`` (128 units, 3,104 B of
   int32 state) in a ``DeviceSyncTestSession`` at check_distance 16 on the
   card for 768 ticks: 0 mismatches, bitwise equal to the same run on the
   CPU and to the NumPy oracle, exactly 2 digest launches per tick.  Then
   B = 4,096 worlds in ``BatchedSessions`` at d = 16 for 64 ticks, started
   from a world in melee (units in contact): 0 mismatches, sessions 0-7
   rerun on the CPU bitwise equal, 2 digest launches per tick.  Both on the
   graphs (17 a carry) and eager as phase 3, with its line.  ms per tick,
   resim frames/s, kernels per advance and per tick, the digest's share of
   device time.
9. float -- ``BoxGame(2, "float")`` in a ``DeviceSyncTestSession`` at d = 8
   for 1,024 ticks: 0 mismatches on the card (its resimulations repeat
   bitwise), 2 digest launches per tick, on the graphs bitwise its eager
   card run (phase 3's line), and the max abs error per leaf against the
   same run on the CPU within ``FLOAT_ATOL`` (positions and angles measured
   on their torus).
10. journal -- two ``P2PSession`` peers play ``RtsCmd(2, 4, 4)`` (command
   streams in varrec envelopes) over phase 7's seeded network, each with an
   executor on the card reading the raw envelopes; peer A carries a
   ``JournalTap`` (``adopt_spectator_endpoint``) writing a ``MatchJournal``.
   0 ``DesyncDetected``, no device->host read in ``run``, digest launches
   as the request lists predict, the journal and final states equal to the
   CPU run and to ``RtsCmdGame``.  The closed journal is replayed by
   ``ReplaySession``: fast-forwarded on the card by ``build_scrub_program``
   in 64-frame windows (one CUDA graph replay a window, under the sync
   debug mode "error", each window bitwise the eager scrub's), and its
   first 64 frames played through
   ``advance_frame`` and an executor; both equal the oracle at every window
   edge, and the end state equals peer A's live state at the frame the
   journal ends.  Journal bytes and host ms per frame, scrub ms per window
   for the graphs and the eager scrub, kernels per RtsCmd advance.
11. speculation (BASELINE config 3) -- four ``BoxGame(4)`` P2P peers over an
   in-memory network, max_prediction 8, desync detection at interval 1, for
   400 ticks (the last 20 with inputs held); peer 0's executor carries
   ``SpeculativeRollback(K=8, max_window=8)`` with ``bench.py``'s
   hypotheses (seven held-button guesses and the schedule itself).  On the
   card every speculation call is one CUDA graph replay
   (``parallel.spec_rollback.SpecGraphs``: 18 captured in the warmup,
   ``advance_and_extend``, ``extend`` and the fused tick at n = 1..8 with
   and without the live advance).  The same drive on the eager twin
   (``EagerSpec``), without speculation, and on the CPU: all four peers'
   states and every checksum they sent are bitwise equal across the four,
   0 ``DesyncDetected``, hits + misses equal peer 0's rollbacks and the
   CPU's, every window the branches cover hits, and no fused rollback tick
   runs a burst.  Every ``run`` under the sync debug mode "error".  Peer
   0's profiled ticks (40 rollback ticks mid-run, two plain ticks of the
   drain that extend the window and its last eight, each ``run`` alone under
   the profiler) are counted at the dispatcher: a fused rollback tick is 1
   graph launch and 3L + 2 copies, a plain tick 1 graph launch and 2L + 1
   copies (L leaves).  Kernels and device busy per tick, host launch calls
   in ``run``, host ms per rollback tick, plain tick that extends the window
   and plain tick for the graphs, the eager twin and speculation off, digest
   launches observed and predicted, captures and replays.  Then
   ``build_speculation_programs(BoxGame(4).advance, 8)`` at W = 8 on its
   graphs (5 captures), its eager twin and the CPU: ``init``,
   ``speculate_window``, ``resolve`` of a hit and a miss, ``replay_window``
   and ``collapse`` bitwise equal.
12. pool -- ``bench.py``'s massed hosting: 32 two-peer BoxGame matches (64
   sessions, ring 10, max_burst 9, desync detection at interval 8) for 180
   ticks through one ``BatchedRequestExecutor``, and through 64
   ``DeviceRequestExecutor``s, and the pool on the CPU: live states, the
   last tick's ring checksums and every sent checksum bitwise equal, 0
   ``DesyncDetected``, every fulfilment under the sync debug mode "error".
   Kernels, busy and idle share per tick (the fulfilment of the last 8
   ticks, each alone under the profiler) and host ms per tick for both;
   digest launches per tick, observed and predicted from the descriptors.
   The pool's masked tick is one CUDA graph replay a tick
   (``parallel.session_pool._ShardGraphs``, keyed by the tick's host
   decisions); the same drive through the eager tick on the card
   (``EagerPool``) is bitwise equal (states, ring and sent checksums,
   frames, digest launches), and each profiled tick that captured nothing
   makes one ``cudaGraphLaunch`` and at most two other launch calls inside
   ``run``.  One line (``graphs``) with both paths' host ms, captures,
   replays, pool bytes, busy, idle and the digest's us inside the graph.
   Then 256 matches (512 sessions) for 24 ticks, the first 32 matches held
   against a CPU rerun of them.
   Phases 7, 10, 11 and 12 run the native host cores (the C++ sync core and
   endpoint core), the default for their configs; phases 7 and 12 check it.
13. native -- phase 7's two P2P drives and phase 12's 64-session pool again,
   with the sessions on the Python input queues and Python endpoint cores,
   then on the native cores right after: both peers' states, every checksum
   sent and every request list (the pool: live states, ring and sent
   checksums) bitwise equal to phases 7 and 12, 0 ``DesyncDetected``.  Host
   ms per peer-frame and per pool tick for the two side-by-side legs (no
   frame under the profiler) and for phases 7 and 12.
14. plane -- the 64-session pool with ``Config.for_uint(8)`` carrying
   ``BatchedRepeatLast``, then ``BatchedDefault``: the prediction plane on
   the card (its kernel one CUDA graph replay a ``begin_tick``), on its
   eager twin (``EagerPlane``), off, and on the CPU; live states, ring and
   sent checksums bitwise equal across the four, the plane's hits > 0 and
   its stats equal to the eager twin's and the CPU's, one host-to-device
   and one device-to-host copy (counted at PyTorch's dispatcher) and one
   graph launch per ``begin_tick``, one capture, and its host us.
15. mesh (BASELINE config 5's shape) -- ChipVM(2) at d = 8 over
   ``make_mesh(1)``, ``make_mesh2d(1, 1)`` and ``make_distributed_mesh()`` in
   a world-size-1 NCCL group (a ``file://`` store in a temporary directory,
   destroyed at the end): 256 sessions and 16,384 for 24 ticks each, every
   leg on the graphs under the sync debug mode "error" (18 untimed ticks,
   2 profiled), the unsharded batch bitwise its eager twin, each mesh's
   carry bitwise the unsharded batch, 2 digest launches per tick per shard;
   a corrupted session found through the group's all-reduce; a checkpoint
   saved from the mesh resumed unsharded (its first capture after an eager
   rehearsal of the tick), equal to the uninterrupted run.  ms per tick,
   captures, replays and host launches of each leg, the eager twin's ms.
   Phase 2 holds the digest at the 256-session shard's shapes too.
16. bank -- the host session bank: ``bench.py``'s match population
   (two-peer BoxGame matches, no desync detection) over phase 7's seeded
   faults, one network per match, on a fake 16 ms clock, fulfilled by one
   ``BatchedRequestExecutor`` with checksums on, through (a) ``HostedPool``
   on the native bank (one ``stage_inputs`` crossing, one ``ggrs_bank_tick``
   crossing, the RequestPlan's columns into the masked tick), (b) the same
   under ``GGRS_TPU_NO_FASTPATH=1``, (c) under ``GGRS_TPU_NO_NATIVE=1`` (the
   pool's Python fallback), (d) per-session ``P2PSession``s into one
   ``run(lists)``, and (e) leg (a) on the CPU; 64 sessions for 180 ticks and
   512 for 24.  All legs bitwise equal (live states, each session's last
   ring checksum, frames, per-session request lists and each socket's sent
   bytes, as digests), exactly one crossing a tick, the whole tick under the
   sync debug mode "error", quiet and resim rows both taken, digest launches
   equal to the descriptors' count.  Host ms a tick split into staging,
   ``advance_all`` and ``run`` for legs (a) and (d), kernels, busy and idle
   share (the last 8 ticks' fulfilment alone under the profiler), the quiet
   share.  Then the fault leg: one slot of the 64-session bank faults at
   tick 60, is quarantined and evicted, its next list leads with the
   adoption ``LoadGameState``, the other matches' sessions stay bitwise
   equal to leg (a), and the faulted match's peers hold equal states at
   their common confirmed frame.
17. datapath -- the bank over real loopback UDP (fake 16 ms clock), into one
   ``BatchedRequestExecutor`` with checksums on through ``HostedPool``.
   Population A is ``bench.py``'s ``run_host_bank_io``: 64 two-peer
   BoxGame(2) matches, each host slot on its own ``UdpNonBlockingSocket(0)``
   and each peer an outside ``P2PSession``, 8 viewers a match attached
   through ``SpectatorHub`` (viewer 0 of matches 0-3 a real
   ``SpectatorSession``, the rest acking viewers), matches 0-3 journaled,
   16 + 120 ticks; legs (a) ``native_io=True`` (the pump), (b) the Python
   shuttle with the send and receive tables, (c) every slot a view on one
   ``DispatchHub(siblings=1)``, (d) leg (c) under ``GGRS_TPU_NO_GSO`` and
   ``GGRS_TPU_NO_GRO``, (e) leg (a) with the thread decode backend, (f) leg
   (a) on the CPU.  Population B is ``run_inbound_gen2``'s: 512 matches, no
   viewers, 24 ticks; legs (b), (c) and (g), leg (b) under
   ``GGRS_TPU_NO_RECV_TABLE``.  The legs of a population are bitwise equal
   (live states, last ring checksums, frames, request lists, each socket's
   sent bytes with ports mapped to roles, the real viewers' streams); the
   pump, the receive table (one crossing a tick, plus one per buffer
   regrowth, no unroutable datagram), GSO on the fan-out and GRO on the hub
   are shown on; no UDP receive drop; digest launches as the descriptors
   predict.  The four journals replay to their viewers' streams, and the
   fused scrub, digested on the card, equals the host's ring checksum.  The
   fault leg storms one slot with ENOBUFS (nothing faults), then EPERM with
   its harvest gone: the slot alone is evicted, resumed from its journal,
   its viewers grafted, its journal still growing, and the other 63 matches
   equal to leg (a).  Syscalls counted a tick, host ms a tick (p50, p99),
   ``run`` ms, kernels, idle share, ``rmem_max``, ``RLIMIT_NOFILE``.
18. fleet -- ``scripts/chaos.py``'s fleet leg (``verify_fleet_leg`` at its
   defaults: seed 3, 32 matches a shard, its 96-tick floor) through the
   port's ``drive_fleet_chaos``: a two-shard ``ShardSupervisor`` serving
   journaled two-peer ``BoxGame(2)`` matches (``checkpoint_every`` 8,
   ``journal_tail_window`` 64, ``identity_refresh_every`` 4), one seeded
   ``InMemoryNetwork`` a match, a fake 16 ms clock, desync detection at
   interval 1.  Each host match's lists run on its own
   ``DeviceRequestExecutor`` on the card under the sync debug mode "error";
   each outside peer's on one on the CPU, so every checksum report compares
   a card digest with a CPU digest.  Five runs: control; ``s1`` killed at
   tick 48 (journal failover onto ``s0``); ``s1`` drained from tick 32
   (retired); the lossy control (5 % loss, 2 % duplication, 5 % reordering,
   2 viewers on ``m0``, 8 matches a shard); ``m0`` migrated at tick 32
   under that loss (its bundle pickled with its card tensors).  ``fleet_survivor_violations`` and
   ``fleet_recovery_violations`` empty, nothing lost, 0 ``DesyncDetected``
   on any host, peer or viewer, the survivors' live card states and newest
   saved checksums bitwise the control's, the viewers' streams never
   regressing, every killed match resumed through a Load of its numpy
   journal checkpoint, digest launches (counts zeroed just before each run)
   equal to the request lists' prediction.  ``/metrics`` and ``/healthz`` of
   the merged registry scraped once over loopback, the exposition valid.
   Host ms a tick (p50, p99) split into ``advance_all`` and fulfilment,
   checkpoints and their ms, failover and migration ms, max lag, journal
   bytes a frame, timeline events a match, the healthz (its SLO verdict
   printed, not asserted), ``fleet_metrics_digest``, and the digest at 1 and
   8 rows against its plain version with device us and the bytes bound.
19. proc_fleet -- the process fleet: ``scripts/chaos.py``'s proc and net legs
   and its placement host kill (``--fleet-matches`` 32, ``--seed`` 3) through
   the port's ``drive_proc_fleet`` and ``drive_placement_fleet``.  Every host
   match fulfils on the card through ``chaos.ExecutorGame`` (a
   ``DeviceRequestExecutor`` under the sync debug mode "error"), in this
   process for ``s0`` and the placement hosts and in the runner subprocess
   (``scripts/port_shard_runner.py``, its own CUDA context) for ``s1``; every
   peer on the CPU, with desync detection at interval 1, so 0
   ``DesyncDetected`` means the card digest agreed with the plain one on
   every confirmed frame.  (a) proc control: 32 matches a shard, 64 ticks,
   ``verify_proc_leg``'s tuning; (b) the runner SIGKILLed at tick 32, every
   ``s1`` match failed over from its journal onto ``s0`` through a numpy
   checkpoint load, the survivors bitwise (a), no orphan; (c) the same over
   the authenticated TCP link at 8 matches a shard for 80 ticks, control
   and a sever at tick 40 that resumes inside the window with no failover, epoch 1, the
   severed shard's matches recovered in place and the others bitwise the
   control (the runner replays the cut tick when its redial lands, a
   wall-clock moment); (d) the placement world (2 matches a host, 48
   ticks, 2 viewers on ``m2``), control and ``kill_host("h1")`` at tick 24:
   ``h1``'s matches fail over across hosts behind unchanged virtual
   endpoints, ``h0``'s bitwise the control.  Digest launches in this process
   (counts zeroed before each run) and in each runner (counted from its
   start, written to a file when it exits at ``sup.close()``) equal the
   request lists' prediction.  Host ms a tick (p50, p99) split into the
   ``s1`` tick RPC, ``s0``'s ``advance_all`` and the fulfilment here; the
   runner's tick ms from its ferried ``runner.tick`` spans; spawn seconds
   (the ``hello`` round trip); SIGKILL detection, failover and link resume
   ms.
20. verify -- ``scripts/port_verify.py --model --json`` in a subprocess, with
   both libraries of phase 1 on disk: exit 0, verdict PASS, no new finding,
   the five gates and the model leg counted, both runtime probes run (the
   host library's header and record strides, the digest library's
   ``ggrs_digest_limits`` against ``csrc/digest.cu``), 18 models.  Its
   seconds, the legacy findings, the models' states.
21. sanitized -- g++ builds the ASan+UBSan host library
   (``GGRS_NATIVE_SANITIZE=1``), then phase 16's fault leg cut to 60 ticks
   (64 sessions on phase 7's faults, the slot fault at tick 30, fulfilled on
   the card through ``HostedPool``) runs here on the production library and
   in a subprocess that loads the sanitized one with the ASan runtime
   preloaded (``ASAN_OPTIONS`` ``detect_leaks=0:abort_on_error=1:
   protect_shadow_gap=0``).  Request lists, events, wire bytes, checksums,
   frames, slot states and transitions and the live states bitwise equal;
   digest launches in both as predicted; exit 0 and no sanitizer report.
   Build and leg seconds.
22. examples -- the port's five examples (``examples/port_ex_game*.py``) on
   the card, in process through their factored functions: the host
   ``SyncTestSession`` with its ``Game`` executor at d = 7 for 600 frames,
   ``--device-session`` for 600 frames, the server's 8 matches x 240 frames
   in one ``BatchedRequestExecutor``, ``--both`` for 600 frames on two
   threads, and a host, peer and spectator trio on three threads for 240
   frames (the spectator to 200), every UDP port chosen here.  The
   synctest's live state, the device session's carry and every one of the
   server's 16 live states bitwise their CPU reruns; the P2P peers and the
   spectator at their full frame counts with 0 ``DesyncDetected``; digest
   launches equal to the prediction (each game's warmup, each request list
   by ``predicted_digest_launches``, each pooled tick from its descriptor,
   two a device-session tick).  Then each example once through its command
   line on the card, all seven processes side by side: exit 0 and its marker
   lines.  Frames/s past the build, host ms of ``run`` a frame, the server's
   session-ticks/s, each command's seconds.
23. scripts -- the port's operator scripts: ``port_floor_probe.main`` cut to
   64 ticks x 2 dispatches x 2 repeats (its four rows, digest launches as
   the formula predicts, ``desync gate green``), ``port_profile_tick.py
   --matches 64 --ticks 50 --fulfil cuda`` in a subprocess (the native
   bank's phases named; its device half one graph launch a tick), ``port_fleet_top.render`` over phase 18's control healthz,
   merged registry and timelines, and ``port_match_timeline``'s ``--list``
   and ``-m ... --perfetto`` over phase 19's SIGKILL timelines (a trace
   that ``validate_chrome_trace`` accepts).  µs per advance step of each
   probe variant.
24. soak -- ``scripts/port_soak.py``'s two legs on the card, no CPU
   fallback.  (a) Two ``P2PSession`` peers over ``InMemoryNetwork(seed=1234,
   loss=0.08, duplicate=0.04, reorder=0.04)``, desync detection at interval
   100, the injected 16 ms clock, ``BoxGame(2)``, each peer fulfilled by a
   ``DeviceRequestExecutor`` on its ``ExecutorGraphs`` (every ``run`` under
   the sync debug mode "error"), for 20,000 frames (~156 input-ring and ~6
   checksum-history wraps): 0 ``DesyncDetected``, the checksum reports sent
   and compared, the last frame both peers settled bitwise equal between
   them and to ``advance_np`` replayed over the confirmed inputs recorded
   from the ``AdvanceFrame`` requests, its card checksum equal to the plain
   digest of that state, digest launches equal to
   ``predicted_digest_launches`` summed over the request lists.  (b)
   ``pool_soak``: one ``BatchedRequestExecutor`` over 8 sessions (4
   matches) on ``_ShardGraphs`` for 512 warm ticks then 20,000, at least 156
   ring wraps (from the sessions' frames), every session at the horizon, and
   each match's newest frame both its sessions confirmed read from the
   pool's ring: bitwise equal between them and to ``advance_np`` replayed
   over the inputs the schedules added.  Both legs sampled at 25, 50, 75
   and 100 % of the horizon: no graph captured after the warmup (the legs'
   graphs and ``GRAPH_COUNTS``), ``memory_reserved`` flat after the 25 %
   sample, ``memory_allocated`` within ``SOAK_ALLOC_BOUND`` of it, RSS
   within 64 MiB, the sessions' queue bounds.  Frames/s and session-ticks/s,
   host ms a frame and a tick (p50, p99), the samples.

After each phase, a line with its seconds and the CUDA graphs (the
replay's, the scrub's, the executors', the pools', speculation's and the
plane's) it captured and replayed in this process.
Then the seconds each phase took, one ``{"kernels": [...]}`` line (phase
21's launches as ``launches_sanitized_production`` and
``launches_sanitized``, phases 22–24's as ``launches_examples``,
``launches_floor_probe`` and ``launches_soak``), the
card's name and power limit as nvidia-smi prints them, and, last,
``{"ok": true, "device": {...}}``.
Exits non-zero with no result when CUDA is not available.
"""

from __future__ import annotations

import contextlib
import errno
import functools
import hashlib
import importlib
import io
import json
import math
import os
import random
import re
import resource
import select
import signal
import socket as pysocket
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ggrs_tpu_torch import (
    AdvanceFrame,
    BatchedRequestExecutor,
    BatchedSessions,
    BoxGame,
    ChipVM,
    DesyncDetected,
    DesyncDetection,
    DeviceRequestExecutor,
    DeviceSyncTestSession,
    EcsWorld,
    ExecutorPrograms,
    InMemoryNetwork,
    InputStatus,
    JournalTap,
    LoadGameState,
    Local,
    MatchJournal,
    Remote,
    ReplaySession,
    RtsCmd,
    RtsCmdGame,
    SaveGameState,
    SessionBuilder,
    SpeculativeRollback,
    _build,
    boxgame_config,
    build_replay_programs,
    build_scrub_program,
    to_numpy,
)
from ggrs_tpu_torch import (
    BatchedDefault,
    BatchedRepeatLast,
    Config,
    DevicePredictionPlane,
    HostedPool,
    HostSessionPool,
    make_distributed_mesh,
    make_mesh,
    make_mesh2d,
)
from ggrs_tpu_torch import NotSynchronized, PredictionThreshold, UdpNonBlockingSocket
from ggrs_tpu_torch.broadcast import SpectatorHub
from ggrs_tpu_torch.convert import from_numpy
from ggrs_tpu_torch.chaos import (
    EXECUTOR_COUNTS,
    ExecutorGame,
    drive_fleet_chaos,
    drive_placement_fleet,
    drive_proc_fleet,
    fleet_recovery_violations,
    fleet_survivor_violations,
    predicted_digest_launches,
)
from ggrs_tpu_torch.fleet import FleetTuning, ProcShard
from ggrs_tpu_torch.net import _native as net_native
from ggrs_tpu_torch.net import protocol as net_protocol
from ggrs_tpu_torch.net.messages import InputAck, InputMessage, Message
from ggrs_tpu_torch.net.sockets import DispatchHub
from ggrs_tpu_torch.net.wire import WireError
from ggrs_tpu_torch.net.endpoint import PyEndpointCore
from ggrs_tpu_torch.obs import (
    FlightRecorder,
    Tracer,
    fleet_metrics_digest,
    json_snapshot,
    start_http_server,
    validate_chrome_trace,
    validate_exposition,
)
from ggrs_tpu_torch.ops import graphs as graph_ops
from ggrs_tpu_torch.ops.checksum import checksum_device, checksum_device_plain, checksum_to_u128
from ggrs_tpu_torch.ops.digest import (
    MAX_LEAVES,
    lane_sums_rows,
    lane_sums_rows_plain,
    state_digest,
)
from ggrs_tpu_torch.parallel.speculation import BranchPrograms
from ggrs_tpu_torch.utils.tree import tree_leaves, tree_map

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
L2_BYTES = 50e6
D = 8
# the flagship is cut from 4,096 ticks to 2,048, and phase 7's drives from
# 1,500 BoxGame and 150 ChipVM frames to 750 and 80, to keep the whole run
# well under 7 minutes on a slow host now that phases 8-10 run too
FLAGSHIP_TICKS, FLAGSHIP_CHUNK, FLAGSHIP_PROFILED = 2048, 512, 16
# the untimed ticks cover the warmup and one ring period of steady ticks,
# so that every phase graph is captured before the timed ones
BATCH, BATCH_TICKS, BATCH_UNTIMED, BATCH_PROFILED = 16384, 64, 2 * (D + 1), 4
CHIPVM_WORDS = 66  # 256 mem bytes + 4 regs + 1 pc byte -> 64 + 1 + 1 words
KERNEL_SHAPES = [  # (rows, width, offset)
    (1, 1, 0), (1, 100, 0), (1, 128, 0), (1, 32768, 0), (1, 32769, 0),
    (1, 3 * 32768 - 7, 0), (BATCH, CHIPVM_WORDS, 0), (BATCH, CHIPVM_WORDS, 5),
    (1, 1 << 26, 0),
]
BIG_LEAF_WORDS = 1 << 26  # one 256 MiB leaf
MAIN_CASE = "chipvm_live"
EXEC_D, EXEC_MAX_PREDICTION = 7, 8
# the executor drives are cut to keep the whole run near 810 s on a slow
# host: ChipVM's from 500 frames to 250 when phase 7 came, then to 160 (past
# the 128-slot input ring, which each drive must cross) and BoxGame's from
# 2,000 to 1,000 when phase 24 came (its eager twin and CPU rerun are most of
# the phase)
EXEC_GAMES = [("BoxGame(2)", BoxGame(2), 1000, 16), ("ChipVM(2)", ChipVM(2), 160, 256)]
EXEC_PROFILED = 8  # the last frames of a card drive, under the profiler
CKPT_TICKS = 32
CHIPVM_STATE_BYTES = 256 + 4 + 1
P2P_GAMES = [("BoxGame(2)", BoxGame(2), 750, 100), ("ChipVM(2)", ChipVM(2), 80, 20)]
P2P_NET = dict(seed=2026, loss=0.05, reorder=0.05, latency_ticks=3)
P2P_TICK_MS, P2P_DRAIN, P2P_MAX_PREDICTION = 16, 20, 8
P2P_CORRUPT_FRAMES, P2P_CORRUPT_FROM, P2P_CORRUPT_FOR = 90, 30, 10
ECS_PLAYERS, ECS_EPP, ECS_D = 4, 32, 16  # BASELINE config 4
ECS_WORDS = 776  # 128 x (2 pos + 2 vel + health + owner) + 4 x 2 rally, int32
ECS_CONVERGE = (10, 5, 6, 9)  # each player's input steering its rally to the center
ECS_TICKS, ECS_CHUNK, ECS_PROFILED = 768, 256, 8  # bench.py's tick count off the TPU
ECS_BATCH, ECS_BATCH_TICKS, ECS_BATCH_UNTIMED, ECS_BATCH_PROFILED = 4096, 64, 2 * (ECS_D + 1), 4
ECS_MELEE_FRAMES = 200
FLOAT_D, FLOAT_TICKS, FLOAT_CHUNK, FLOAT_PROFILED = 8, 1024, 256, 16
FLOAT_ATOL = 1e-3  # per leaf, card against CPU; cos/sin may differ in the last bit
RTS_FRAMES, RTS_DRAIN, RTS_SETTLE, RTS_WINDOW = 600, 20, 200, 64
SPEC_PLAYERS, SPEC_K, SPEC_W, SPEC_MAX_PREDICTION = 4, 8, 8, 8  # BASELINE config 3
SPEC_TICKS, SPEC_DRAIN = 400, 20
# peer 0's profiled ticks: rollback ticks mid-run, and in the drain two
# plain ticks that extend the window and the last eight (the window full)
SPEC_PROFILED = (tuple(range(100, 140)) + (SPEC_TICKS - 14, SPEC_TICKS - 13)
                 + tuple(range(SPEC_TICKS - 8, SPEC_TICKS)))
POOL_MATCHES, POOL_RING, POOL_MAX_BURST, POOL_DESYNC_INTERVAL = 32, 10, 9, 8
POOL_SESSIONS, POOL_TICKS, POOL_PROFILED = 2 * POOL_MATCHES, 180, 8
POOL_BIG_MATCHES, POOL_BIG_TICKS = 256, 24
POOL_BIG_SESSIONS = 2 * POOL_BIG_MATCHES
NATIVE_CORES = {("_NativeSyncCore", "NativeEndpointCore")}
PYTHON_CORES = {("InputQueue", "PyEndpointCore")}
PLANE_PREDICTORS = (("BatchedRepeatLast", BatchedRepeatLast), ("BatchedDefault", BatchedDefault))
PLANE_PROFILED = 4
PLANE_CALLS = 200  # begin_tick calls a timed round, graph and eager twin alternating
# BASELINE config 5 (256 SyncTest sessions over a mesh), and phase 4's
# 16,384 sessions for a shortened run: 24 ticks, the first 18 untimed (the
# warmup and every graph's capture), the last 2 profiled
MESH_SIZES = ((256, 24), (BATCH, 24))
MESH_UNTIMED, MESH_PROFILED = 2 * (D + 1), 2
# the host's CUDA calls the profiler names that launch work on the card
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpy",
                "cuMemcpy", "cudaMemset", "cuMemset")
MESH_CORRUPT_SESSION = 200
# phase 16: the host bank legs (see drive_bank), phase 12's sizes
BANK_LEGS = ("bank", "nofastpath", "fallback", "sessions")
BANK_ENV = {"bank": {}, "nofastpath": {"GGRS_TPU_NO_FASTPATH": "1"},
            "fallback": {"GGRS_TPU_NO_NATIVE": "1"}, "sessions": {}}
BANK_FAULT_TICK, BANK_FAULT_SLOT = 60, 6
BANK_PROFILED = 8
# phase 17: population A (bench.py's run_host_bank_io: 64 matches x 8
# viewers, the first 4 journaled with a real viewer 0) and population B
# (run_inbound_gen2's 512 matches); the fault leg's slot and ticks
DATAPATH_MATCHES, DATAPATH_VIEWERS, DATAPATH_JOURNALED = 64, 8, 4
DATAPATH_WARMUP, DATAPATH_TICKS, DATAPATH_PROFILED = 16, 120, 8
INBOUND_MATCHES, INBOUND_WARMUP, INBOUND_TICKS = 512, 4, 20
DATAPATH_FAULT_SLOT, DATAPATH_STORM_TICK, DATAPATH_EPERM_TICK, DATAPATH_STORM = 2, 40, 70, 10
# descriptors: population B's per-slot legs hold 1,024 UDP sockets at once
FDS_NEEDED = 2 * INBOUND_MATCHES + 512
# phase 18: the fleet leg of scripts/chaos.py (verify_fleet_leg at its
# defaults: --fleet-matches 32 a shard, --seed 3, its 96-tick floor)
FLEET_MATCHES, FLEET_TICKS, FLEET_SEED = 32, 96, 3
# the lossy pair is cut to 8 matches a shard, as scripts/chaos.py:1837 cuts
# its smaller legs: at 32 it took phase 18 to 191 s on a slow host
FLEET_LOSSY_MATCHES = 8
FLEET_KILL_TICK, FLEET_DRAIN_TICK = FLEET_TICKS // 2, FLEET_TICKS // 3
FLEET_MIGRATE_TICK = FLEET_TICKS // 3
FLEET_LOSSY = dict(latency_ticks=1, loss=0.05, duplicate=0.02, reorder=0.05)
FLEET_VIEWERS = 2
FLEET_SCENARIOS = ("control", "shard_kill", "shard_drain", "lossy_control", "shard_migrate")
FLEET_MAX_PREDICTION = 8  # the session builder's default window
FLEET_DIGEST_ROWS = (1, FLEET_MAX_PREDICTION)  # a lone save; a full rollback burst
# phase 19: scripts/chaos.py's proc and net legs and its placement host kill
# (--fleet-matches 32, --seed 3), each fault at half the run as the legs put
# it.  Cut in ticks from the 240 their default --ticks gives (and below their
# 120-tick floor): at 120 ticks phase 19 took 136 s of a 636 s whole run on
# one H100 whose host was among the faster ones, and hosts differ by 1.6x
PROC_MATCHES, PROC_TICKS, PROC_SEED = 32, 64, 3
PROC_KILL_TICK = PROC_TICKS // 2
NET_MATCHES, NET_TICKS = 8, 80  # the net leg caps its matches at 8
NET_SEVER_TICK = NET_TICKS // 2
PLACE_MATCHES, PLACE_TICKS, PLACE_VIEWERS = 2, 48, 2  # the placement leg's own size
PLACE_KILL_TICK = PLACE_TICKS // 2
PROC_TUNING = dict(heartbeat_interval_s=0.05, heartbeat_deadline_s=0.5, rpc_timeout_s=0.75,
                   drain_deadline_s=0.4, spawn_timeout_s=120.0, restart_max=0)  # verify_proc_leg's
NET_TUNING = dict(PROC_TUNING, link_auth_token="chaos-net-token", link_reconnect_window_s=0.6,
                  link_backoff_s=0.01, link_handshake_timeout_s=0.3)  # verify_net_leg's
PROC_SCENARIOS = ("proc_control", "proc_sigkill", "net_control", "net_sever")
# phase 20: scripts/port_verify.py's gates and its time limit here
VERIFY_GATES = ("layout", "determinism", "ownership", "transitions", "hygiene")
VERIFY_TIMEOUT_S = 120
# phase 21: phase 16's fault leg cut from 180 ticks to 60, the fault moved
# from tick 60 to 30; ASan's options: no leak report (CPython's interned
# objects at exit are noise), abort on the first report, and the shadow gap
# left unprotected, since the CUDA driver maps memory into it
SAN_TICKS, SAN_FAULT_TICK = 60, 30
SAN_ASAN_OPTIONS = "detect_leaks=0:abort_on_error=1:protect_shadow_gap=0"
SAN_TIMEOUT_S = 400
SAN_KEYS = ("summaries", "events", "sent", "last_checksums", "frames", "confirmed",
            "slot_states", "crossings", "harvests", "launches", "predicted", "around")
# phase 22: the examples at their own defaults (the synctest's d = 7 and 600
# frames, the server's 8 matches x 240 frames, --both's 600 frames); the
# threaded trio's host and peer at 240 frames as tests/test_examples.py runs
# it, its spectator to 200; each CLI once, cut to EX_CLI_FRAMES
EX_D, EX_SYNCTEST_FRAMES = 7, 600
EX_SERVER_MATCHES, EX_SERVER_FRAMES = 8, 240
EX_BOTH_FRAMES, EX_TRIO_FRAMES, EX_SPECTATOR_FRAMES = 600, 240, 200
EX_CLI_FRAMES, EX_CLI_SPECTATOR_FRAMES, EX_CLI_TIMEOUT_S = 120, 60, 240
EX_MODULES = ("port_ex_game", "port_ex_game_synctest", "port_ex_game_server",
              "port_ex_game_p2p", "port_ex_game_spectator")
# phase 23: the floor probe cut from 1,024 ticks x 8 dispatches x 3 repeats
# (73,728 eager advances a pass, minutes a variant) to 64 x 2 x 2; the bank
# profile at B = 64 for 50 ticks
PROBE_CUT = dict(ticks_per_dispatch=64, dispatches=2, repeats=2)
PROFILE_ARGS = ("--matches", "64", "--ticks", "50", "--fulfil", "cuda")
SCRIPT_MODULES = ("port_floor_probe", "port_fleet_top", "port_match_timeline")
# phase 24: the soak legs on the card (scripts/port_soak.py): the P2P leg at
# the horizon the JAX package's tier certifies on the CPU cut from 100,000 to
# 20,000 frames (~156 input-ring wraps, ~6 checksum-history wraps), the pool
# at the JAX test's 20,000 ticks after 512 ticks in which every graph key of
# the population has its first tick
SOAK_FRAMES = 20_000
SOAK_TICKS = 20_000
SOAK_POOL_WARM = 512
SOAK_ALLOC_BOUND = 1 << 20  # bytes that memory_allocated may grow after 25 %
SOAK_RSS_MB = 64.0


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, from CUDA
    events around the run (the host's dispatch floor for short kernels)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_us(fn, inputs: list, launches: int = 64, reps: int = 5) -> float:
    """Device us per call of ``fn``: CUDA events around replays of a CUDA
    graph of ``launches`` calls, cycling over ``inputs`` (copies, so that a
    working set above the L2 cache is read from device memory)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in inputs:  # first calls (library load, occupancy) outside capture
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    us = start.elapsed_time(end) * 1e3 / (reps * launches)
    del graph
    torch.cuda.empty_cache()
    return us


def host_us(fn, calls: int = 200) -> float:
    """Host us per call of ``fn`` (the enqueue cost), then a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def copies_for(nbytes: int) -> int:
    """How many copies of an input exceed the L2 cache twice over."""
    return max(1, min(32, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound_us(bytes_read: int, rows: int) -> float:
    """Least time: the bytes the kernel must read once, and 16 B of output
    per row written once, at the device memory rate.  About a dozen integer
    operations per 4-byte word puts the digest far on the bytes side."""
    return (bytes_read + 16 * rows) / HBM_BYTES_PER_S * 1e6


def u32_err(got: torch.Tensor, want: torch.Tensor) -> int:
    diff = (got.to(torch.int64) & 0xFFFFFFFF) - (want.to(torch.int64) & 0xFFFFFFFF)
    return int(diff.abs().max()) if diff.numel() else 0


def trees_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(la, lb)
    )


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- the states of phase 2 ---------------------------------------------------


def _card(arr: np.ndarray, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return (t if dtype is None else t.view(dtype)).cuda()


def chipvm_state(rng, lead: tuple) -> dict:
    u8 = lambda shape: _card(rng.integers(0, 256, size=shape, dtype=np.uint8))
    return {"mem": u8(lead + (256,)), "pc": u8(lead), "regs": u8(lead + (4,))}


def boxgame_state(rng, lead: tuple, players: int = 2) -> dict:
    i32 = lambda shape: _card(rng.integers(-(2**31), 2**31, size=shape, dtype=np.int32))
    p = players
    return {"pos": i32(lead + (p, 2)), "rot": i32(lead + (p,)), "vel": i32(lead + (p, 2))}


def many_leaves_state(rng, b: int, count: int) -> dict:
    """``count`` small leaves of mixed dtypes and odd byte counts."""
    kinds = [(np.uint8, (3,)), (np.int16, (5,)), (np.int32, ()), (np.int32, (2,)),
             (np.int64, (1,))]
    out = {}
    for i in range(count):
        dt, shape = kinds[i % len(kinds)]
        out[f"l{i:02d}"] = _card(rng.integers(0, 2**63, size=(b,) + shape, dtype=np.int64).astype(dt))
    return out


def copied_base(rng, shape: tuple) -> dict:
    """An int32 leaf and a contiguous u8 leaf; the view functions below make
    the first one a layout the kernel cannot read in place."""
    return {"t": _card(rng.integers(-(2**31), 2**31, size=shape, dtype=np.int32)),
            "u": _card(rng.integers(0, 256, size=(shape[0], 3), dtype=np.uint8))}


def transposed(state):
    return {**state, "t": state["t"].transpose(1, 2)}


def gapped(state):
    return {**state, "t": state["t"][:, ::2]}


def expanded(state):
    return {**state, "t": state["t"].expand(-1, 4, -1)}


def ecs_state(rng, lead: tuple) -> dict:
    e, i32 = ECS_PLAYERS * ECS_EPP, lambda shape: _card(
        rng.integers(-(2**31), 2**31, size=shape, dtype=np.int32))
    return {"health": i32(lead + (e,)), "owner": i32(lead + (e,)), "pos": i32(lead + (e, 2)),
            "rally": i32(lead + (ECS_PLAYERS, 2)), "vel": i32(lead + (e, 2))}


def boxgame_float_state(rng, lead: tuple) -> dict:
    f32 = lambda shape, scale: _card((rng.standard_normal(shape) * scale).astype(np.float32))
    return {"pos": f32(lead + (2, 2), 300.0), "rot": f32(lead + (2,), 3.0), "vel": f32(lead + (2, 2), 6.0)}


def all_dtypes_state(rng, b: int) -> dict:
    """Every dtype the structure salt knows, odd byte counts and 0-d leaves."""
    bits = lambda shape, np_t: rng.integers(0, 2**64, size=shape, dtype=np.uint64).astype(np_t)
    return {
        "bool": _card(rng.integers(0, 2, size=(b, 3)).astype(bool)),
        "u8": _card(bits((b, 3), np.uint8)),
        "u8_0d": _card(bits((b,), np.uint8)),
        "i8": _card(bits((b, 5), np.int8)),
        "i16": _card(bits((b, 5), np.int16)),
        "u16": _card(bits((b, 3), np.int16), torch.uint16),
        "f16": _card(bits((b, 3), np.int16), torch.float16),
        "bf16": _card(bits((b, 5), np.int16), torch.bfloat16),
        "i32": _card(bits((b,), np.int32)),
        "u32": _card(bits((b, 2), np.int32), torch.uint32),
        "f32": _card(bits((b, 3), np.int32), torch.float32),
        "i64": _card(bits((b, 2), np.int64)),
        "u64": _card(bits((b, 1), np.int64), torch.uint64),
        "f64": _card(bits((b, 2), np.int64), torch.float64),
    }


def flat_rows(state):
    """A (B, n, ...) stack as B*n rows: views, as the replay digests its window."""
    return tree_map(lambda leaf: leaf.flatten(0, 1), state)


def ring_slot(ring):
    """Slot 4 of a (B, R, ...) ring: rows strided by the ring's length."""
    return tree_map(lambda buf: buf[:, 4], ring)


def state_cases(rng):
    """(name, the state's tensors, the view of them that is digested)."""
    same = lambda s: s
    return [
        ("chipvm_live", chipvm_state(rng, (BATCH,)), same),
        ("chipvm_resim_folded", chipvm_state(rng, (BATCH, D)), flat_rows),
        ("boxgame_b1", boxgame_state(rng, (1,)), same),
        ("boxgame_b1_resim_folded", boxgame_state(rng, (1, D)), flat_rows),
        ("chipvm_ring_slot_view", chipvm_state(rng, (BATCH, D + 1)), ring_slot),
        ("all_dtypes", all_dtypes_state(rng, BATCH), same),
        ("leaf_2p26_words", {"w": _card(rng.integers(0, 2**32, size=(1, BIG_LEAF_WORDS),
                                                     dtype=np.uint32).view(np.int32))}, same),
        ("ecs_live", ecs_state(rng, (ECS_BATCH,)), same),
        ("ecs_resim_folded", ecs_state(rng, (ECS_BATCH, ECS_D)), flat_rows),
        ("ecs_ring_slot_view", ecs_state(rng, (ECS_BATCH, ECS_D + 1)), ring_slot),
        ("boxgame_float_b1", boxgame_float_state(rng, (1,)), same),
        ("boxgame_float_b1_resim_folded", boxgame_float_state(rng, (1, FLOAT_D)), flat_rows),
        # the fulfilled speculation window (phase 11) and the pool's B-row
        # writes (phase 12)
        ("boxgame4_spec_window", boxgame_state(rng, (SPEC_W, ), players=4), same),
        ("boxgame_pool_64", boxgame_state(rng, (POOL_SESSIONS,)), same),
        ("boxgame_pool_512", boxgame_state(rng, (POOL_BIG_SESSIONS,)), same),
        # more leaves than one launch takes: one raw launch per group
        ("leaves_33", many_leaves_state(rng, BATCH, 33), same),
        ("leaves_40", many_leaves_state(rng, BATCH, 40), same),
        # leaves the kernel cannot read in place: each copied once
        ("copied_transposed", copied_base(rng, (BATCH, 5, 3)), transposed),
        ("copied_gapped", copied_base(rng, (BATCH, 6, 2)), gapped),
        ("copied_expanded", copied_base(rng, (BATCH, 1, 6)), expanded),
        # a mesh shard of BASELINE config 5's 256 sessions (phase 15): the
        # live and the folded resim digests
        ("chipvm_mesh_256", chipvm_state(rng, (MESH_SIZES[0][0],)), same),
        ("chipvm_mesh_256_resim_folded", chipvm_state(rng, (MESH_SIZES[0][0], D)), flat_rows),
    ]


# -- phases ------------------------------------------------------------------


def phase_build(smi: str) -> None:
    """The CUDA kernels (one nvcc per source, all at once) and, beside them,
    the host library of the native cores (g++ over csrc/host/*.cpp)."""
    host = {}

    def build_host():
        try:
            host["seconds"] = _build.build_host()
        except Exception as e:  # reported below, after the kernels' build
            host["error"] = e

    thread = threading.Thread(target=build_host)
    thread.start()
    seconds = _build.build()
    thread.join()
    if "error" in host:
        raise host["error"]
    ptxas = [
        line.strip()
        for log in _build.build_logs.values()
        for line in log.splitlines()
        if "ptxas info" in line and ("Used" in line or "spill" in line)
    ]
    emit({"phase": "build", "seconds": seconds, "sources": sorted(_build.SOURCES),
          "ptxas": ptxas, "card": smi, "host_library_seconds": host["seconds"],
          "host_library": os.path.relpath(_build.host_library_path()),
          "host_sources": [os.path.relpath(p) for p in _build.HOST_SOURCES]})


def phase_lane_sums(rng) -> int:
    """``lane_sums_rows`` against its plain version; returns the worst error."""
    worst = 0
    for rows, width, offset in KERNEL_SHAPES:
        host = rng.integers(0, 2**32, size=(rows, width), dtype=np.uint32)
        words = torch.from_numpy(host.view(np.int32)).cuda()
        del host
        got = lane_sums_rows(words, offset)
        want = lane_sums_rows_plain(words, offset)
        torch.cuda.synchronize()
        err = u32_err(got, want)
        check(torch.equal(got, want), f"lane_sums_rows != plain at {(rows, width, offset)}")
        worst = max(worst, err)
        nbytes = 4 * rows * width
        inputs = [words] + [words.clone() for _ in range(copies_for(nbytes) - 1)]
        big = nbytes >= 1 << 26
        emit({"phase": "kernel", "entry": "lane_sums_rows", "rows": rows, "width": width,
              "offset": offset, "bitwise_equal": True, "max_abs_err": err,
              "device_us": graph_us(lambda w: lane_sums_rows(w, offset), inputs),
              "host_us": host_us(lambda: lane_sums_rows(words, offset)),
              "plain_ms": device_ms(lambda: lane_sums_rows_plain(words, offset),
                                    iters=3 if big else 20, warmup=1),
              "bound_us": bound_us(nbytes, rows)})
        del words, got, want, inputs
        torch.cuda.empty_cache()
    return worst


def one_kernel_per_digest(state) -> dict:
    """Profile one CUDA ``checksum_device``: it must run exactly one kernel
    and nothing else on the device (the output comes from torch.empty)."""
    from torch.profiler import ProfilerActivity, profile

    checksum_device(state)
    torch.cuda.synchronize()
    # a capture that recorded nothing at all on the device (seen once on the
    # card: the process's first profiled window came back empty) is taken
    # again, twice at most; the first capture that recorded the device is
    # the one judged
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            checksum_device(state)
            torch.cuda.synchronize()
        device_events = [e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
        if device_events:
            break
    names = [e.name for e in device_events]
    check(len(device_events) == 1 and "state_digest" in names[0],
          f"a CUDA checksum_device ran {names} on the device, not one state_digest kernel")
    return {"device_ops": names, "profiler_device_us": device_events[0].device_time}


def phase_state_digest(rng) -> dict:
    """``state_digest`` (through ``checksum_device``) against
    ``checksum_device_plain`` at every state shape; returns the records."""
    records = {}
    for name, state, view in state_cases(rng):
        rows_state = view(state)
        leaves = tree_leaves(rows_state)
        rows = leaves[0].shape[0]
        bytes_per_row = sum(math.prod(l.shape[1:]) * l.element_size() for l in leaves)
        before = state_digest.launches
        got = checksum_device(rows_state)
        launches = state_digest.launches - before
        want = checksum_device_plain(rows_state)
        torch.cuda.synchronize()
        err = u32_err(got, want)
        check(got.shape == (rows, 4) and torch.equal(got, want),
              f"state_digest != plain on {name}")
        groups = -(-sum(1 for l in leaves if l[0].numel()) // MAX_LEAVES)
        check(launches == groups, f"state_digest on {name}: {launches} launches, not {groups}")
        n_copies = copies_for(bytes_per_row * rows)
        inputs = [rows_state] + [view(tree_map(torch.clone, state)) for _ in range(n_copies - 1)]
        big = bytes_per_row * rows >= 1 << 26
        rec = {"phase": "kernel", "entry": "state_digest", "case": name, "rows": rows,
               "leaves": len(leaves), "launches_per_digest": launches,
               "bytes_per_row": bytes_per_row,
               "bitwise_equal": True, "max_abs_err": err,
               "device_us": graph_us(checksum_device, inputs),
               "device_us_l2_warm": graph_us(checksum_device, [rows_state]),
               "input_copies": n_copies,
               "host_us": host_us(lambda: checksum_device(rows_state)),
               "plain_ms": device_ms(lambda: checksum_device_plain(rows_state),
                                     iters=3 if big else 20, warmup=1),
               "bound_us": bound_us(bytes_per_row * rows, rows)}
        rec["share_of_bound"] = rec["bound_us"] / rec["device_us"]
        if name == MAIN_CASE:
            rec.update(one_kernel_per_digest(rows_state))
        emit(rec)
        records[name] = rec
        del state, rows_state, leaves, got, want, inputs
        torch.cuda.empty_cache()
    return records


# -- the replay's CUDA graphs (phases 3, 4, 6, 8, 9, 15) ------------------------


def graph_stats(programs) -> dict:
    """The steady tick's graphs of every carry ``programs`` ran on the card:
    carries, captures, replays, and the bytes of their shared pools (the
    allocator's segments of each pool)."""
    sets = programs.tick_graphs
    pools = {tuple(g.pool) for g in sets if g.pool is not None}
    pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                     if tuple(seg.get("segment_pool_id", ())) in pools)
    return {"carries": len(sets), "captures": sum(g.captures for g in sets),
            "replays": sum(g.replays for g in sets), "pool_bytes": pool_bytes}


def profile_ticks(fn, ticks: int, span: str = "ggrs:replay_steady") -> dict:
    """One call of ``fn`` (``ticks`` steady ticks, or frames) under the
    profiler: the device kernels and busy ms a tick, and the host's CUDA
    calls that launch work (``LAUNCH_CALLS``) inside the ``span`` ranges
    (the replay's by default), a tick, by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()
    spans = [e.time_range for e in events if e.name == span and e.device_type == cpu]
    host = {}
    for e in events:
        start = e.time_range.start
        if (e.device_type == cpu and e.name.startswith(LAUNCH_CALLS)
                and any(r.start <= start <= r.end for r in spans)):
            host[e.name] = host.get(e.name, 0) + 1
    dev = device_summary(prof, ticks)
    return {"kernels_per_tick": dev["kernels"], "busy_ms_per_tick": dev["busy_us"] / 1e3,
            "digest_share_of_busy": dev["digest_share"], "digest_us_per_tick": dev["digest_us"],
            "digest_kernels_per_tick": dev["digest_kernels"],
            "host_launches_per_tick": {k: v / ticks for k, v in sorted(host.items())}}


def graph_drive(sess, chunks: list, axis: int) -> dict:
    """``sess`` (a ``DeviceSyncTestSession`` or ``BatchedSessions`` on the
    card) through ``chunks`` (ticks on ``axis``): the first chunk untimed, the
    last one profiled, those between timed.  The warmup ticks run outside
    the sync debug mode (their first advance builds the game's device
    constants with a synchronizing copy); every steady tick, the graphs'
    captures and replays, runs under "error".  Digest counts are zeroed
    just before the drive and read just after."""
    w = sess.programs.warmup_ticks
    state_digest.launches = lane_sums_rows.launches = 0
    sess.run_ticks(chunks[0].narrow(axis, 0, w), check=False)
    sess.block_until_ready()
    t0 = time.perf_counter()
    with no_device_reads(True):
        sess.run_ticks(chunks[0].narrow(axis, w, chunks[0].shape[axis] - w), check=False)
    sess.block_until_ready()
    captures_s = time.perf_counter() - t0  # every capture, and a replay after each
    t0 = time.perf_counter()
    with no_device_reads(True):
        for c in chunks[1:-1]:
            sess.run_ticks(c, check=False)
    sess.block_until_ready()
    elapsed = time.perf_counter() - t0
    timed = sum(c.shape[axis] for c in chunks[1:-1])

    def last():
        with no_device_reads(True):
            sess.run_ticks(chunks[-1], check=False)

    prof = profile_ticks(last, chunks[-1].shape[axis])
    launches, around = state_digest.launches, lane_sums_rows.launches
    ms = elapsed / timed * 1e3
    return {"ms_per_tick": ms, "timed_ticks": timed, "captures_s": captures_s,
            "digest_launches": launches,
            "around": around, "idle_share": 1 - prof["busy_ms_per_tick"] / ms, **prof}


def eager_drive(programs, init, template, batch: int, chunks: list, axis: int):
    """The same drive through the eager ``steady_tick`` loop on the card, the
    graphs' plain version: a carry of ``batch`` sessions from a fresh
    program over ``programs``' advance, ring and depth, ``run_warmup`` for
    the warmup ticks and ``steady_tick`` from Python for every other, timed
    over the same chunks.  Digest counts are zeroed just before.  Returns
    (carry, ms per timed tick, digest launches)."""
    progs = build_replay_programs(programs.advance, programs.ring.length,
                                  programs.check_distance, programs.checksum)
    carry = progs.init_carry(init, template, batch_size=batch)
    ticks_run = 0

    def run(c):
        nonlocal ticks_run
        c = c if axis == 1 else c.unsqueeze(0)
        n = c.shape[1]
        w = progs.split_at_warmup(ticks_run, n)
        if w:
            progs.run_warmup(carry, c[:, :w], ticks_run)
        for t in range(w, n):
            progs.steady_tick(carry, c[:, t], ticks_run + t)
        ticks_run += n

    state_digest.launches = lane_sums_rows.launches = 0
    run(chunks[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in chunks[1:-1]:
        run(c)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    run(chunks[-1])
    torch.cuda.synchronize()
    timed = sum(c.shape[axis] for c in chunks[1:-1])
    return carry, elapsed / timed * 1e3, state_digest.launches


def cards_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def graph_vs_eager(name: str, sess, init, template, chunks: list, axis: int) -> dict:
    """``graph_drive`` of ``sess``, then ``eager_drive`` of the same ticks:
    carries (mismatches and first_bad included) and digest launches bitwise
    equal, 2 launches a tick on each path, one capture a phase (= R), one
    replay a steady tick, and in the profiled ticks one graph launch and at
    most one other launch (the input copy) a tick.  Emits the phase's
    graphs line and returns it."""
    programs = sess.programs
    ticks = sum(c.shape[axis] for c in chunks)
    steady = ticks - programs.warmup_ticks
    g = graph_drive(sess, chunks, axis)
    stats = graph_stats(programs)
    batch = 1 if axis == 0 else chunks[0].shape[0]
    carry, eager_ms, eager_launches = eager_drive(programs, init, template, batch, chunks, axis)
    graph_carry = sess.carry if axis == 1 else tree_map(lambda l: l.unsqueeze(0), sess.carry)
    check(g["around"] == 0, f"{name}: the digest went around state_digest")
    check(g["digest_launches"] == eager_launches == 2 * ticks,
          f"{name}: {g['digest_launches']} digest launches on the graphs, {eager_launches} eager, "
          f"not 2 x {ticks} ticks")
    check(stats["captures"] == stats["carries"] * programs.ring.length
          and stats["replays"] == stats["carries"] * steady,
          f"{name}: {stats} for {steady} steady ticks of ring {programs.ring.length}")
    host = g["host_launches_per_tick"]
    graph_launches = sum(v for k, v in host.items() if "GraphLaunch" in k)
    check(graph_launches == 1 and sum(host.values()) <= 2,
          f"{name}: host launches a tick {host}, not one graph launch and one copy")
    check(cards_equal(graph_carry, carry), f"{name}: the graphs' carry != the eager carry")
    line = {"phase": name, "graphs": True, "ring": programs.ring.length, "ticks": ticks,
            "steady_ticks": steady, "timed_ticks": g["timed_ticks"],
            "graph_ms_per_tick": g["ms_per_tick"], "eager_ms_per_tick": eager_ms,
            "speedup": eager_ms / g["ms_per_tick"], **stats,
            "untimed_steady_s": g["captures_s"],
            "host_launches_per_tick": host, "kernels_per_tick": g["kernels_per_tick"],
            "device_busy_ms_per_tick": g["busy_ms_per_tick"], "idle_share": g["idle_share"],
            "digest_share_of_busy": g["digest_share_of_busy"],
            "digest_us_per_launch_in_graph": g["digest_us_per_tick"] / 2,
            "digest_launches": g["digest_launches"], "digest_launches_eager": eager_launches,
            "graph_equal_to_eager": True, "sync_debug_mode": "error"}
    emit(line)
    return line


def phase_flagship() -> None:
    game = BoxGame(2)
    inputs = np.random.default_rng(7).integers(0, 16, size=(FLAGSHIP_TICKS, 2)).astype(np.uint8)
    card = torch.from_numpy(inputs).cuda()
    p = FLAGSHIP_TICKS - FLAGSHIP_PROFILED
    chunks = [card[:FLAGSHIP_CHUNK], card[FLAGSHIP_CHUNK:p], card[p:]]
    sess = DeviceSyncTestSession(
        game.advance, game.init_state_np(), np.zeros(2, np.uint8), check_distance=D
    )
    g = graph_vs_eager("flagship", sess, game.init_state_np(), np.zeros(2, np.uint8), chunks, 0)
    sess.verify()  # raises MismatchedChecksum on any desync

    cpu = DeviceSyncTestSession(
        game.advance, game.init_state_np(), np.zeros(2, np.uint8), check_distance=D, device="cpu"
    )
    for c in np.split(inputs, FLAGSHIP_TICKS // FLAGSHIP_CHUNK):
        cpu.run_ticks(c, check=False)
    cpu.verify()
    check(trees_equal(to_numpy(sess.carry), to_numpy(cpu.carry)),
          "flagship: card carry != CPU carry")
    ref = game.init_state_np()
    for i in range(FLAGSHIP_TICKS):
        ref = game.advance_np(ref, inputs[i])
    check(trees_equal(sess.live_state(), ref), "flagship: live state != NumPy oracle")
    emit({"phase": "flagship", "game": "BoxGame(2)", "check_distance": D,
          "ticks": FLAGSHIP_TICKS, "mismatches": 0, "equal_to_cpu": True,
          "equal_to_oracle": True, "equal_to_eager": True, "timed_ticks": g["timed_ticks"],
          "ms_per_tick": g["graph_ms_per_tick"],
          "resim_frames_per_s": D * 1e3 / g["graph_ms_per_tick"],
          "digest_launches": g["digest_launches"],
          "digest_launches_per_tick": g["digest_launches"] / FLAGSHIP_TICKS})


def phase_batched() -> int:
    vm = ChipVM(2)
    inputs = np.random.default_rng(11).integers(0, 256, size=(BATCH, BATCH_TICKS, 2)).astype(np.uint8)
    dev_inputs = torch.from_numpy(inputs).cuda()
    batch = BatchedSessions(
        vm.advance, vm.init_state_np(), np.zeros(2, np.uint8), batch_size=BATCH,
        check_distance=D, max_prediction=D,
    )
    torch.cuda.synchronize()
    p = BATCH_TICKS - BATCH_PROFILED
    chunks = [dev_inputs[:, :BATCH_UNTIMED], dev_inputs[:, BATCH_UNTIMED:p], dev_inputs[:, p:]]
    g = graph_vs_eager("batched", batch, vm.init_state_np(), np.zeros(2, np.uint8), chunks, 1)
    launches = g["digest_launches"]  # the main path's drive, counted from 0 just before it
    stats = batch.verify()
    check(stats["mismatches"] == 0, f"batched: {stats['mismatches']} mismatches")

    n_cpu = 8
    cpu = BatchedSessions(
        vm.advance, vm.init_state_np(), np.zeros(2, np.uint8), batch_size=n_cpu,
        check_distance=D, max_prediction=D, device="cpu",
    )
    check(cpu.run_ticks(inputs[:n_cpu])["mismatches"] == 0, "batched: CPU rerun mismatched")
    head = to_numpy(tree_map(lambda t: t[:n_cpu], batch.carry))
    check(trees_equal(head, to_numpy(cpu.carry)), "batched: sessions 0-7 != CPU rerun")
    live = batch.live_states()
    check(all(np.isfinite(l).all() and l.shape[0] == BATCH for l in tree_leaves(live)),
          "batched: live states malformed")
    emit({"phase": "batched", "game": "ChipVM(2)", "sessions": BATCH,
          "check_distance": D, "ring": D + 1, "ticks": BATCH_TICKS, "mismatches": 0,
          "sessions_equal_to_cpu": n_cpu, "equal_to_eager": True,
          "timed_ticks": g["timed_ticks"], "ms_per_tick": g["graph_ms_per_tick"],
          "resim_frames_per_s": BATCH * D * 1e3 / g["graph_ms_per_tick"],
          "digest_launches": launches,
          "digest_launches_per_tick": launches / BATCH_TICKS,
          "kernels": ["digest"]})
    del batch, dev_inputs
    torch.cuda.empty_cache()
    return launches


def executor_inputs(pairs) -> np.ndarray:
    return np.asarray([p[0] for p in pairs], np.uint8)


def guarded_run(fulfil, reqs, card: bool) -> None:
    """``fulfil(reqs)``; on the card under the sync debug mode "error", so
    that a device->host read there fails the run."""
    if card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        fulfil(reqs)
    finally:
        if card:
            torch.cuda.set_sync_debug_mode(0)


class EagerPrograms(ExecutorPrograms):
    """The executor's programs through their plain versions on the card
    (``advance_eager``, ``burst_eager``): the graphs' eager twin.  The
    package has no switch; this object offers no graphs, so its route is
    the eager one on any device."""

    def graphs(self, device):
        return None


def drive_executor(game, inputs: np.ndarray, device, programs=None, profiled: int = 0):
    """Play ``inputs`` through SessionBuilder -> SyncTestSession ->
    DeviceRequestExecutor (over ``programs`` where given).  On the card every
    ``run`` is under the sync debug mode "error", and the digest launch
    counts are zeroed just before the first frame (after the warmup).  Each
    frame's saved checksums are read back after its ``run``, as the session
    reads them next frame.  The last ``profiled`` frames run under the
    profiler, each ``run`` inside a ``smoke:run`` span, and are left out of
    the loop's seconds.  Returns (executor, saved (frame, checksum) per
    frame, loop seconds, the last frame's saved states, the profile or
    None)."""
    sess = (SessionBuilder(boxgame_config()).with_check_distance(EXEC_D)
            .with_max_prediction_window(EXEC_MAX_PREDICTION).start_synctest_session())
    ex = DeviceRequestExecutor(game.advance, game.init_state_np(), executor_inputs,
                               programs=programs, device=device)
    ex.warmup(inputs[0], burst_depths=range(2, EXEC_MAX_PREDICTION + 2))
    card = ex.device.type == "cuda"
    saved, saves = [], []
    timed = len(inputs) - profiled

    def frame(f: int) -> None:
        nonlocal saves
        sess.add_local_input(0, int(inputs[f, 0]))
        sess.add_local_input(1, int(inputs[f, 1]))
        reqs = sess.advance_frame()
        with torch.profiler.record_function("smoke:run"):
            guarded_run(ex.run, reqs, card)
        saves = [r for r in reqs if isinstance(r, SaveGameState)]
        saved.append([(r.frame, r.cell.checksum) for r in saves])

    state_digest.launches = lane_sums_rows.launches = 0
    t0 = time.perf_counter()
    for f in range(timed):
        frame(f)
    ex.block_until_ready()
    seconds = time.perf_counter() - t0
    prof = None
    if profiled:
        it = iter(range(timed, len(inputs)))
        prof = profile_ticks(lambda: [frame(f) for f in it], profiled, span="smoke:run")
    return ex, saved, seconds, [r.cell.data() for r in saves], prof


def pool_bytes(pools) -> int:
    """The bytes of the allocator's segments of CUDA graph pools ``pools``."""
    ids = {tuple(p) for p in pools if p is not None}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in ids)


def sync_caught(fn) -> bool:
    """Whether ``fn`` raises under the sync debug mode "error"."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return False


def phase_executor() -> int:
    """The request-list path on the card against the CPU; returns the digest
    launches of the card's drives."""
    # the guard around executor.run must catch a device->host read
    item_caught = sync_caught(lambda: torch.ones(1, device="cuda").item())
    check(item_caught, "executor: the sync debug mode let .item() through")
    emit({"phase": "executor", "sync_debug_control": {
        "item_caught": item_caught,
        "pageable_copy_caught": sync_caught(lambda: torch.ones(2).to("cuda"))}})
    total = 0
    for name, game, frames, high in EXEC_GAMES:
        inputs = np.random.default_rng(17).integers(0, high, size=(frames, 2)).astype(np.uint8)
        programs = ExecutorPrograms(game.advance)
        ex, saved, seconds, last, prof = drive_executor(game, inputs, None, programs,
                                                        EXEC_PROFILED)
        launches = state_digest.launches
        check(lane_sums_rows.launches == 0, f"executor {name}: the digest went around state_digest")
        check(launches == frames, f"executor {name}: {launches} digest launches, not one per frame ({frames})")
        graphs = programs.graphs(tree_leaves(ex.state)[0].device)
        depths = EXEC_MAX_PREDICTION  # warmup: the advance and a burst of each depth 2..9
        check(graphs.captures == 1 + depths and graphs.replays == 1 + depths + frames,
              f"executor {name}: {graphs.captures} captures and {graphs.replays} replays for "
              f"{frames} frames")
        leaves = len(tree_leaves(ex.state))
        host = prof["host_launches_per_tick"]
        graph_launches = sum(v for k, v in host.items() if "GraphLaunch" in k)
        check(graph_launches == 1 and sum(host.values()) - graph_launches <= 2 * leaves + 2,
              f"executor {name}: host launches a frame {host}, not one graph launch and at "
              f"most {2 * leaves + 2} copies")
        twin, twin_saved, twin_seconds, _, _ = drive_executor(game, inputs, None,
                                                              EagerPrograms(game.advance))
        twin_launches = state_digest.launches
        check(twin_saved == saved and twin_launches == launches
              and cards_equal(ex.state, twin.state),
              f"executor {name}: the graphs' run != the eager run on the card")
        cpu, cpu_saved, _, _, _ = drive_executor(game, inputs, "cpu")
        check(saved == cpu_saved, f"executor {name}: saved checksums != CPU run")
        check(trees_equal(to_numpy(ex.state), to_numpy(cpu.state)), f"executor {name}: live state != CPU run")
        oracle = None
        if isinstance(game, BoxGame):
            ref = game.init_state_np()
            for f in range(frames):
                ref = game.advance_np(ref, inputs[f])
            oracle = trees_equal(to_numpy(ex.state), ref)
            check(oracle, f"executor {name}: live state != NumPy oracle")
        check(len(last) == EXEC_D, f"executor {name}: the last frame saved {len(last)} states")
        digest = {}
        for rows, st in ((1, tree_map(lambda l: l.unsqueeze(0), ex.state)),
                         (EXEC_D, tree_map(lambda *ls: torch.stack(ls), *last))):
            got, want = checksum_device(st), checksum_device_plain(st)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"executor {name}: digest of {rows} rows != plain")
            row_bytes = sum(math.prod(l.shape[1:]) * l.element_size() for l in tree_leaves(st))
            digest[rows] = {"device_us": graph_us(checksum_device, [st]),
                            "plain_ms": device_ms(lambda: checksum_device_plain(st), iters=20),
                            "bound_us": bound_us(row_bytes * rows, rows),
                            "max_abs_err": u32_err(got, want)}
        timed = frames - EXEC_PROFILED
        graph_ms = seconds / timed * 1e3
        eager_ms = twin_seconds / frames * 1e3
        emit({"phase": "executor", "game": name, "check_distance": EXEC_D,
              "max_prediction": EXEC_MAX_PREDICTION, "frames": frames,
              "saves": sum(len(s) for s in saved), "equal_to_cpu": True,
              "equal_to_oracle": oracle, "equal_to_eager": True, "sync_debug_mode": "error",
              "host_ms_per_frame": graph_ms, "timed_frames": timed,
              "eager_host_ms_per_frame": eager_ms, "speedup": eager_ms / graph_ms,
              "captures": graphs.captures, "replays": graphs.replays,
              "pool_bytes": pool_bytes([graphs.set.pool]), "leaves": leaves,
              "profiled_frames": EXEC_PROFILED, "host_launches_per_frame": host,
              "kernels_per_frame": prof["kernels_per_tick"],
              "device_busy_ms_per_frame": prof["busy_ms_per_tick"],
              "idle_share": 1 - prof["busy_ms_per_tick"] / graph_ms,
              "digest_us_in_graph": prof["digest_us_per_tick"],
              "digest_launches": launches, "digest_launches_eager": twin_launches,
              "digest_launches_per_frame": launches / frames,
              "digest_us_1_row": digest[1]["device_us"],
              f"digest_us_{EXEC_D}_rows": digest[EXEC_D]["device_us"],
              "digest_plain_ms_1_row": digest[1]["plain_ms"],
              f"digest_plain_ms_{EXEC_D}_rows": digest[EXEC_D]["plain_ms"],
              "digest_bound_us_1_row": digest[1]["bound_us"],
              f"digest_bound_us_{EXEC_D}_rows": digest[EXEC_D]["bound_us"],
              "digest_max_abs_err": max(d["max_abs_err"] for d in digest.values())})
        total += launches
    return total


def phase_checkpoint() -> None:
    vm = ChipVM(2)
    inputs = torch.from_numpy(np.random.default_rng(13).integers(
        0, 256, size=(BATCH, 2 * CKPT_TICKS, 2)).astype(np.uint8)).cuda()

    def fresh():
        return BatchedSessions(vm.advance, vm.init_state_np(), np.zeros(2, np.uint8),
                               batch_size=BATCH, check_distance=D, max_prediction=D)

    a = fresh()
    a.run_ticks(inputs[:, :CKPT_TICKS], check=False)
    carry_bytes = sum(l.numel() * l.element_size() for l in tree_leaves(a.carry))
    ring = D + 1  # states, digests, frames, inputs, history; live; 3 counters
    per_session = ring * (CHIPVM_STATE_BYTES + 16 + 4 + 2 + 16) + CHIPVM_STATE_BYTES + 12
    check(carry_bytes == BATCH * per_session,
          f"checkpoint: carry holds {carry_bytes} bytes, the layout counts {BATCH * per_session}")
    # b runs other ticks first, so that every phase graph of its carry is
    # captured before the checkpoint loads into that carry
    b = fresh()
    b.run_ticks(inputs[:, CKPT_TICKS:], check=False)
    captured = graph_stats(b.programs)
    buffers = [(x.data_ptr(), x.stride()) for x in tree_leaves(b.carry)]
    check(captured["captures"] == ring, f"checkpoint: {captured} before the load")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "batch.npz")
        a.block_until_ready()
        t0 = time.perf_counter()
        a.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        a.run_ticks(inputs[:, CKPT_TICKS:], check=False)
        b.block_until_ready()
        t0 = time.perf_counter()
        b.load_checkpoint(path)
        b.block_until_ready()
        load_s = time.perf_counter() - t0
    check(b.current_frame == CKPT_TICKS, f"checkpoint: resumed at frame {b.current_frame}")
    check([(x.data_ptr(), x.stride()) for x in tree_leaves(b.carry)] == buffers,
          "checkpoint: the load moved the carry out of its captured buffers")
    with no_device_reads(True):
        b.run_ticks(inputs[:, CKPT_TICKS:], check=False)
    resumed = graph_stats(b.programs)
    check(resumed["captures"] == ring and resumed["carries"] == 1
          and resumed["replays"] == captured["replays"] + CKPT_TICKS,
          f"checkpoint: {resumed} after the resumed run, {captured} before it")
    stats = a.verify()
    check(stats["mismatches"] == 0, f"checkpoint: {stats['mismatches']} mismatches")
    check(b.verify() == stats, "checkpoint: resumed batch's stats differ")
    check(cards_equal(a.carry, b.carry), "checkpoint: resumed carry != uninterrupted carry")
    emit({"phase": "checkpoint", "game": "ChipVM(2)", "sessions": BATCH, "check_distance": D,
          "ticks_before": CKPT_TICKS, "ticks_after": CKPT_TICKS, "carry_bytes": carry_bytes,
          "bytes_per_session": per_session, "file_bytes": size, "save_s": save_s,
          "load_s": load_s, "resumed_bitwise_equal": True, "mismatches": 0,
          "loaded_into_captured_graphs": True, "graph_captures": resumed["captures"],
          "graph_replays_after_load": resumed["replays"] - captured["replays"]})


def p2p_input(handle: int, frame: int, frames: int) -> int:
    """The schedule of ``tests/test_desync_device_executor.py``: inputs that
    change every few frames, held for the last ``P2P_DRAIN`` frames so that
    every prediction is right at the end."""
    i = min(frame, frames - P2P_DRAIN - 1)
    return (i // 4) % 16 if handle == 0 else (i // 3) % 16


@contextlib.contextmanager
def session_cores(kind: str):
    """Sessions built inside run the native cores (``"native"``, the default
    for an eligible config) or the Python ones (``"python"``: the
    ``GGRS_TPU_NO_NATIVE`` switch, which the sync layer reads at
    construction, and the Python endpoint core, as the JAX package's tests
    select it)."""
    if kind == "native":
        yield
        return
    saved = net_protocol.make_endpoint_core
    os.environ["GGRS_TPU_NO_NATIVE"] = "1"
    net_protocol.make_endpoint_core = PyEndpointCore
    try:
        yield
    finally:
        net_protocol.make_endpoint_core = saved
        del os.environ["GGRS_TPU_NO_NATIVE"]


def core_kinds(sessions) -> set:
    """The (sync core, endpoint core) class names the sessions run."""
    kinds = set()
    for s in sessions:
        native = s._sync_layer._native
        sync = "InputQueue" if native is None else type(native).__name__
        kinds |= {(sync, type(ep._core).__name__) for ep in s._player_reg.remotes.values()}
    return kinds


def request_summary(requests) -> list:
    """A request list as plain values: (kind, frame), or the inputs and
    statuses of an advance."""
    return [("adv", tuple((v, st.name) for v, st in r.inputs)) if isinstance(r, AdvanceFrame)
            else (type(r).__name__, r.frame) for r in requests]


def drive_p2p(game, frames: int, device, profiled: int = 0, corrupt: bool = False,
              cores: str = "native") -> dict:
    """Two P2P peers, each with its own executor on ``device``, over a seeded
    in-memory network on a fake clock.  On the card every ``run`` is under
    the sync debug mode "error", digest counts are zeroed after the warmup,
    and the ``profiled`` frames just before the drain run under the
    profiler (host times are taken over the other frames).  With ``corrupt``, peer B's live
    state is nudged for ``P2P_CORRUPT_FOR`` frames from ``P2P_CORRUPT_FROM``
    on, past the depth of any rollback."""
    from torch.profiler import ProfilerActivity, profile

    net = InMemoryNetwork(**P2P_NET)
    now = [0]
    peers = []
    for me, other, h in (("A", "B", 0), ("B", "A", 1)):
        ex = DeviceRequestExecutor(game.advance, game.init_state_np(), executor_inputs,
                                   device=device)
        ex.warmup(np.zeros(2, np.uint8), burst_depths=range(2, P2P_MAX_PREDICTION + 2))
        with session_cores(cores):
            sess = (SessionBuilder(boxgame_config()).with_clock(lambda: now[0])
                    .with_rng(random.Random(41 + h))
                    .with_max_prediction_window(P2P_MAX_PREDICTION)
                    .with_desync_detection_mode(DesyncDetection.on(1))
                    .add_player(Local(), h).add_player(Remote(other), 1 - h)
                    .start_p2p_session(net.socket(me)))
        sess.attach_forensics(recorder=FlightRecorder(checksum_window=frames + 8))
        peers.append((h, sess, ex))
    card = peers[0][2].device.type == "cuda"
    host = {"poll": 0.0, "advance_frame": 0.0, "run": 0.0}
    desyncs, predicted, summaries = [], 0, []
    prof_end = frames - P2P_DRAIN - 1
    prof_start = prof_end - profiled
    prof = None
    state_digest.launches = lane_sums_rows.launches = 0
    for f in range(frames):
        if profiled and f in (prof_start, prof_end):
            if card:
                torch.cuda.synchronize()
            if f == prof_start:
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
            else:
                prof.__exit__(None, None, None)
        timed = not profiled or not prof_start <= f < prof_end
        for h, sess, ex in peers:
            t0 = time.perf_counter()
            sess.poll_remote_clients()
            t1 = time.perf_counter()
            sess.add_local_input(h, p2p_input(h, f, frames))
            reqs = sess.advance_frame()
            t2 = time.perf_counter()
            guarded_run(ex.run, reqs, card)
            t3 = time.perf_counter()
            if timed:
                host["poll"] += t1 - t0
                host["advance_frame"] += t2 - t1
                host["run"] += t3 - t2
            predicted += predicted_digest_launches(reqs)
            summaries.append(request_summary(reqs))
            desyncs += [e for e in sess.events() if isinstance(e, DesyncDetected)]
            if corrupt and h == 1 and P2P_CORRUPT_FROM <= f < P2P_CORRUPT_FROM + P2P_CORRUPT_FOR:
                ex._state = {**ex.state, "pos": ex.state["pos"] + 1}
        net.tick()
        now[0] += P2P_TICK_MS
    if card:
        torch.cuda.synchronize()
    kernels = busy_us = None
    if prof is not None:
        device_ops = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and (getattr(e, "self_device_time_total", 0) or 0) > 0]
        kernels = sum(e.count for e in device_ops) / (2 * profiled)
        busy_us = sum(e.self_device_time_total for e in device_ops) / (2 * profiled)
    sessions = [s for _, s, _ in peers]
    return {
        "launches": state_digest.launches, "around": lane_sums_rows.launches,
        "predicted": predicted, "desyncs": desyncs,
        "sent": [dict(s.recorder.checksums.items()) for s in sessions],
        "states": [to_numpy(ex.state) for _, _, ex in peers],
        "frames_reached": [s.current_frame for s in sessions],
        "rollbacks": sum(s._stat_rollbacks for s in sessions),
        "rollback_frames": sum(s._stat_rollback_frames for s in sessions),
        "max_rollback": max(s._stat_max_rollback for s in sessions),
        "host_ms": {k: v / (2 * (frames - profiled)) * 1e3 for k, v in host.items()},
        "kernels_per_frame": kernels, "busy_us_per_frame": busy_us,
        "requests": summaries, "cores": core_kinds(sessions),
    }


def phase_p2p():
    """The P2P path on the card against the CPU; returns the digest launches
    of the card's drives and the card's runs by game."""
    total, runs = 0, {}
    for name, game, frames, profiled in P2P_GAMES:
        run = drive_p2p(game, frames, None, profiled)
        runs[name] = run
        check(run["cores"] == NATIVE_CORES, f"p2p {name}: the sessions ran {run['cores']}")
        check(run["around"] == 0, f"p2p {name}: the digest went around state_digest")
        check(run["desyncs"] == [], f"p2p {name}: {len(run['desyncs'])} DesyncDetected")
        check(run["launches"] == run["predicted"],
              f"p2p {name}: {run['launches']} digest launches, the request lists predict "
              f"{run['predicted']}")
        a, b = run["frames_reached"]
        check(a == b, f"p2p {name}: the peers stopped at frames {a} and {b}")
        check(trees_equal(*run["states"]), f"p2p {name}: the two peers' live states differ")
        check(all(len(s) > frames // 2 for s in run["sent"]),
              f"p2p {name}: too few checksum reports sent")
        cpu = drive_p2p(game, frames, "cpu")
        check(run["sent"] == cpu["sent"], f"p2p {name}: sent checksums != CPU run")
        check(all(trees_equal(g, c) for g, c in zip(run["states"], cpu["states"])),
              f"p2p {name}: live states != CPU run")
        oracle = None
        if isinstance(game, BoxGame):
            ref = game.init_state_np()
            for f in range(a):
                ref = game.advance_np(ref, np.asarray(
                    [p2p_input(0, f, frames), p2p_input(1, f, frames)], np.uint8))
            oracle = trees_equal(run["states"][0], ref)
            check(oracle, f"p2p {name}: live state != NumPy oracle")
        peer_frames = 2 * frames
        emit({"phase": "p2p", "game": name, "frames": frames, "peers": 2,
              "network": P2P_NET, "tick_ms": P2P_TICK_MS, "desync_interval": 1,
              "max_prediction": P2P_MAX_PREDICTION, "desyncs": 0,
              "sent_checksums_equal_to_cpu": True, "states_equal_to_cpu": True,
              "equal_to_oracle": oracle, "sync_debug_mode": "error",
              "frames_reached": a,
              "rollbacks_per_100_frames": run["rollbacks"] / peer_frames * 100,
              "mean_rollback_depth": run["rollback_frames"] / max(run["rollbacks"], 1),
              "max_rollback_depth": run["max_rollback"],
              "profiled_frames": profiled,
              "kernels_per_frame": run["kernels_per_frame"],
              "device_busy_ms_per_frame": run["busy_us_per_frame"] / 1e3,
              "digest_launches": run["launches"],
              "digest_launches_predicted": run["predicted"],
              "digest_launches_per_frame": run["launches"] / peer_frames,
              "host_ms_per_frame": sum(run["host_ms"].values()),
              "host_ms_poll_remote_clients": run["host_ms"]["poll"],
              "host_ms_advance_frame": run["host_ms"]["advance_frame"],
              "host_ms_run": run["host_ms"]["run"],
              "checksum_reports_sent": [len(s) for s in run["sent"]]})
        total += run["launches"]
    bad = drive_p2p(BoxGame(2), P2P_CORRUPT_FRAMES, None, corrupt=True)
    check(bad["desyncs"], "p2p: the corrupted peer was not detected")
    check(all(e.local_checksum != e.remote_checksum for e in bad["desyncs"]),
          "p2p: a DesyncDetected with equal checksums")
    emit({"phase": "p2p", "corrupted_drive": True, "frames": P2P_CORRUPT_FRAMES,
          "corrupted_from": P2P_CORRUPT_FROM, "desyncs_detected": len(bad["desyncs"]),
          "first_detected_frame": min(e.frame for e in bad["desyncs"])})
    return total, runs


def profile_device(fn, calls: int) -> dict:
    """Device kernels and busy us per call of ``fn`` over ``calls`` calls,
    and the digest kernel's share of that time, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return device_summary(prof, calls)


def device_summary(prof, calls: int) -> dict:
    """Device kernels, busy us and the digest's share a call, from a
    profile of ``calls`` calls."""
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and (getattr(e, "self_device_time_total", 0) or 0) > 0]
    # record_function ranges ("ggrs:...", and the "smoke:..." spans around
    # the calls profiled here) also appear as device-side annotations
    # spanning their kernels; only kernels count as busy time
    ops = [e for e in ops if not e.key.startswith(("ggrs:", "smoke:"))]
    busy = sum(e.self_device_time_total for e in ops)
    digest = sum(e.self_device_time_total for e in ops if "state_digest" in e.key)
    return {"kernels": sum(e.count for e in ops) / calls, "busy_us": busy / calls,
            "digest_us": digest / calls, "digest_share": digest / busy if busy else None,
            "digest_kernels": sum(e.count for e in ops if "state_digest" in e.key) / calls}


def copies_in(fn) -> dict:
    """Host<->device copies one call of ``fn`` issues, counted at PyTorch's
    dispatcher: every ``_to_copy`` / ``copy_`` whose source and result lie
    on the host and on a device, one each way."""
    from torch.utils._python_dispatch import TorchDispatchMode

    count = {"dtoh": 0, "htod": 0}
    aten = torch.ops.aten

    class Copies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (aten._to_copy.default, aten.copy_.default):
                src = args[0] if func is aten._to_copy.default else args[1]
                on_host = (src.device.type == "cpu", out.device.type == "cpu")
                if on_host == (True, False):
                    count["htod"] += 1
                elif on_host == (False, True):
                    count["dtoh"] += 1
            return out

    with Copies():
        fn()
    return count


def kernels_per_advance(advance, state: dict, inputs: torch.Tensor) -> dict:
    """Device kernels and busy us of one ``advance`` on the card."""
    advance(state, inputs)
    return profile_device(lambda: advance(state, inputs), 3)


def ecs_inputs(n: int, seed: int, converge: int) -> np.ndarray:
    """Random bitmasks; the first ``converge`` frames steer every rally to
    the center of the world, so that units meet, fight and respawn."""
    ins = np.random.default_rng(seed).integers(0, 16, size=(n, ECS_PLAYERS)).astype(np.uint8)
    ins[:converge] = ECS_CONVERGE
    return ins


def ecs_melee(world: EcsWorld) -> dict:
    """A world ``ECS_MELEE_FRAMES`` converging frames in: units in contact."""
    s = world.init_state_np()
    for inp in ecs_inputs(ECS_MELEE_FRAMES, 6, ECS_MELEE_FRAMES):
        s = world.advance_np(s, inp)
    return s


def phase_ecs() -> int:
    """BASELINE config 4 on the card: one session, then a B = 4,096 batch;
    returns the digest launches of both card drives."""
    world = EcsWorld(ECS_PLAYERS, ECS_EPP)
    blank = np.zeros(ECS_PLAYERS, np.uint8)
    # -- one session, from the initial world ----------------------------------
    inputs = ecs_inputs(ECS_TICKS, 4, converge=128)
    card = torch.from_numpy(inputs).cuda()
    p = ECS_TICKS - ECS_PROFILED
    sess = DeviceSyncTestSession(world.advance, world.init_state_np(), blank,
                                 check_distance=ECS_D, max_prediction=ECS_D)
    g = graph_vs_eager("ecs", sess, world.init_state_np(), blank,
                       [card[:ECS_CHUNK], card[ECS_CHUNK:p], card[p:]], 0)
    single_launches = g["digest_launches"]
    sess.verify()
    cpu = DeviceSyncTestSession(world.advance, world.init_state_np(), blank,
                                check_distance=ECS_D, max_prediction=ECS_D, device="cpu")
    for c in (inputs[:ECS_CHUNK], inputs[ECS_CHUNK:p], inputs[p:]):
        cpu.run_ticks(c, check=False)
    cpu.verify()
    check(trees_equal(to_numpy(sess.carry), to_numpy(cpu.carry)), "ecs: card carry != CPU carry")
    ref = world.init_state_np()
    for i in range(ECS_TICKS):
        ref = world.advance_np(ref, inputs[i])
    check(trees_equal(sess.live_state(), ref), "ecs: live state != NumPy oracle")
    one = {k: v.unsqueeze(0) for k, v in world.init_state().items()}
    adv1 = kernels_per_advance(world.advance, one, torch.from_numpy(inputs[:1]).cuda())
    emit({"phase": "ecs", "game": "EcsWorld(4, 32)", "sessions": 1, "check_distance": ECS_D,
          "ticks": ECS_TICKS, "mismatches": 0, "equal_to_cpu": True, "equal_to_oracle": True,
          "equal_to_eager": True, "units_hurt_at_end": int((ref["health"] < 100).sum()),
          "timed_ticks": g["timed_ticks"], "ms_per_tick": g["graph_ms_per_tick"],
          "resim_frames_per_s": ECS_D * 1e3 / g["graph_ms_per_tick"],
          "digest_launches": single_launches,
          "digest_launches_per_tick": single_launches / ECS_TICKS,
          "kernels_per_advance": adv1["kernels"], "advance_busy_us": adv1["busy_us"],
          "profiled_ticks": ECS_PROFILED, "kernels_per_tick": g["kernels_per_tick"],
          "device_busy_ms_per_tick": g["device_busy_ms_per_tick"],
          "idle_share": g["idle_share"], "digest_share_of_busy": g["digest_share_of_busy"]})

    # -- B = 4,096 worlds, from a world in melee -----------------------------
    melee = ecs_melee(world)
    batch_in = np.random.default_rng(12).integers(
        0, 16, size=(ECS_BATCH, ECS_BATCH_TICKS, ECS_PLAYERS)).astype(np.uint8)
    dev_in = torch.from_numpy(batch_in).cuda()
    u, p = ECS_BATCH_UNTIMED, ECS_BATCH_TICKS - ECS_BATCH_PROFILED
    batch = BatchedSessions(world.advance, melee, blank, batch_size=ECS_BATCH,
                            check_distance=ECS_D, max_prediction=ECS_D)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    g = graph_vs_eager("ecs_batch", batch, melee, blank,
                       [dev_in[:, :u], dev_in[:, u:p], dev_in[:, p:]], 1)
    batch_launches = g["digest_launches"]
    stats = batch.verify()
    check(stats["mismatches"] == 0, f"ecs batch: {stats['mismatches']} mismatches")
    n_cpu = 8
    cpu = BatchedSessions(world.advance, melee, blank, batch_size=n_cpu,
                          check_distance=ECS_D, max_prediction=ECS_D, device="cpu")
    check(cpu.run_ticks(batch_in[:n_cpu])["mismatches"] == 0, "ecs batch: CPU rerun mismatched")
    head = to_numpy(tree_map(lambda t: t[:n_cpu], batch.carry))
    check(trees_equal(head, to_numpy(cpu.carry)), "ecs batch: sessions 0-7 != CPU rerun")
    live = batch.live_states()
    check(all(l.shape[0] == ECS_BATCH for l in tree_leaves(live)), "ecs batch: live states malformed")
    carry_bytes = sum(l.numel() * l.element_size() for l in tree_leaves(batch.carry))
    many = tree_map(lambda t: t[:, 0].contiguous(), batch.carry["ring"]["states"])
    adv_b = kernels_per_advance(world.advance, many, dev_in[:, 0])
    emit({"phase": "ecs", "game": "EcsWorld(4, 32)", "sessions": ECS_BATCH,
          "start": f"melee after {ECS_MELEE_FRAMES} converging frames",
          "check_distance": ECS_D, "ring": ECS_D + 1, "ticks": ECS_BATCH_TICKS, "mismatches": 0,
          "sessions_equal_to_cpu": n_cpu, "equal_to_eager": True, "state_bytes": ECS_WORDS * 4,
          "carry_bytes": carry_bytes, "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "units_hurt_at_end": int((live["health"] < 100).sum()),
          "timed_ticks": g["timed_ticks"], "ms_per_tick": g["graph_ms_per_tick"],
          "resim_frames_per_s": ECS_BATCH * ECS_D * 1e3 / g["graph_ms_per_tick"],
          "digest_launches": batch_launches,
          "digest_launches_per_tick": batch_launches / ECS_BATCH_TICKS,
          "kernels_per_advance": adv_b["kernels"], "advance_busy_us": adv_b["busy_us"],
          "profiled_ticks": ECS_BATCH_PROFILED, "kernels_per_tick": g["kernels_per_tick"],
          "device_busy_ms_per_tick": g["device_busy_ms_per_tick"],
          "idle_share": g["idle_share"], "digest_share_of_busy": g["digest_share_of_busy"]})
    del batch, dev_in, many
    torch.cuda.empty_cache()
    return single_launches + batch_launches


def torus_err(a: np.ndarray, b: np.ndarray, period) -> float:
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    if period is not None:
        d = np.minimum(d, np.asarray(period, np.float64) - d)
    return float(d.max())


def phase_float() -> int:
    """The float BoxGame in a SyncTest on the card; returns its launches."""
    game = BoxGame(2, "float")
    inputs = np.random.default_rng(19).integers(0, 16, size=(FLOAT_TICKS, 2)).astype(np.uint8)
    card = torch.from_numpy(inputs).cuda()
    p = FLOAT_TICKS - FLOAT_PROFILED
    sess = DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                 check_distance=FLOAT_D)
    # the graphs bitwise the eager card run: the same kernels on the same card
    g = graph_vs_eager("float", sess, game.init_state_np(), np.zeros(2, np.uint8),
                       [card[:FLOAT_CHUNK], card[FLOAT_CHUNK:p], card[p:]], 0)
    launches = g["digest_launches"]
    sess.verify()  # its resimulations repeated every first-seen digest
    cpu = DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                check_distance=FLOAT_D, device="cpu")
    for c in np.split(inputs, FLOAT_TICKS // FLOAT_CHUNK):
        cpu.run_ticks(c, check=False)
    cpu.verify()
    card, host = sess.live_state(), cpu.live_state()
    periods = {"pos": (800.0, 600.0), "rot": 2 * math.pi, "vel": None}
    err = {k: torus_err(card[k], host[k], periods[k]) for k in sorted(card)}
    check(all(np.isfinite(card[k]).all() and card[k].dtype == np.float32 for k in card),
          "float: live state malformed")
    check(all(e <= FLOAT_ATOL for e in err.values()), f"float: card vs CPU error {err}")
    emit({"phase": "float", "game": "BoxGame(2, float)", "check_distance": FLOAT_D,
          "ticks": FLOAT_TICKS, "mismatches": 0, "atol": FLOAT_ATOL,
          "max_abs_err_vs_cpu": err, "bitwise_equal_to_cpu": all(e == 0 for e in err.values()),
          "bitwise_equal_to_eager": True,
          "timed_ticks": g["timed_ticks"], "ms_per_tick": g["graph_ms_per_tick"],
          "resim_frames_per_s": FLOAT_D * 1e3 / g["graph_ms_per_tick"],
          "digest_launches": launches, "digest_launches_per_tick": launches / FLOAT_TICKS})
    return launches


def rts_orders(handle: int, frame: int) -> tuple:
    """``bench.py``'s RtsCmd schedule: 0-3 orders a frame, seeded per
    (player, frame); held from frame ``RTS_FRAMES - 1`` on."""
    rng = random.Random(17 + handle * 613 + min(frame, RTS_FRAMES - 1))
    cmds = []
    for _ in range(rng.randrange(0, 4)):
        kind = rng.randrange(3)
        if kind == 0:
            cmds.append(("move", rng.randrange(4), rng.randrange(-2, 3), rng.randrange(-2, 3)))
        elif kind == 1:
            cmds.append(("gather", rng.randrange(4)))
        else:
            cmds.append(("build", rng.randrange(16), rng.randrange(16)))
    return tuple(cmds)


def drive_journal(rts: RtsCmd, device, path: str) -> dict:
    """Two RtsCmd peers with executors on ``device``; peer A records the
    match through a ``JournalTap``.  After the drain both stop advancing and
    poll until A holds B's every input; A's last ``advance_frame`` then
    sends the journal every frame up to the one A stood at.  On the card
    every ``run`` is under the sync debug mode "error"."""
    to_env = lambda pairs: rts.envelopes_np([v for v, _ in pairs])
    net = InMemoryNetwork(**P2P_NET)
    now = [0]
    journal = MatchJournal(path, 2, rts.config().native_input_size)
    peers = []
    for me, other, h in (("A", "B", 0), ("B", "A", 1)):
        ex = DeviceRequestExecutor(rts.advance, rts.init_state_np(), to_env, device=device)
        ex.warmup(rts.envelopes_np([(), ()]), burst_depths=range(2, P2P_MAX_PREDICTION + 2))
        sess = (SessionBuilder(rts.config()).with_clock(lambda: now[0])
                .with_rng(random.Random(41 + h))
                .with_max_prediction_window(P2P_MAX_PREDICTION)
                .with_desync_detection_mode(DesyncDetection.on(1))
                .add_player(Local(), h).add_player(Remote(other), 1 - h)
                .start_p2p_session(net.socket(me)))
        peers.append((h, sess, ex))
    peers[0][1].adopt_spectator_endpoint(JournalTap.ADDR, JournalTap(journal, rts.config()))
    card = peers[0][2].device.type == "cuda"
    desyncs, predicted, host_s, steps = [], 0, 0.0, 0

    def step(h, sess, ex):
        nonlocal predicted, host_s, steps
        t0 = time.perf_counter()
        sess.poll_remote_clients()
        sess.add_local_input(h, rts_orders(h, sess.current_frame))
        reqs = sess.advance_frame()
        guarded_run(ex.run, reqs, card)
        host_s += time.perf_counter() - t0
        steps += 1
        predicted += predicted_digest_launches(reqs)
        desyncs.extend(e for e in sess.events() if isinstance(e, DesyncDetected))

    state_digest.launches = lane_sums_rows.launches = 0
    for _ in range(RTS_FRAMES + RTS_DRAIN):
        for h, sess, ex in peers:
            step(h, sess, ex)
        net.tick()
        now[0] += P2P_TICK_MS
    a = peers[0][1]
    settle = 0
    while a.confirmed_frame() < a.current_frame - 1 and settle < RTS_SETTLE:
        net.tick()
        now[0] += P2P_TICK_MS
        for _, sess, _ in peers:
            sess.poll_remote_clients()
        settle += 1
    end = a.current_frame
    live_at_end = to_numpy(peers[0][2].state)
    step(*peers[0])
    journal.close()
    return {"launches": state_digest.launches, "around": lane_sums_rows.launches,
            "predicted": predicted, "desyncs": desyncs, "end": end, "settle_ticks": settle,
            "journal_next_frame": journal.next_frame, "live_at_end": live_at_end,
            "states": [to_numpy(ex.state) for _, _, ex in peers],
            "frames_reached": [s.current_frame for _, s, _ in peers],
            "sent": [dict(s._local_checksum_history) for _, s, _ in peers],
            "rollbacks": sum(s._stat_rollbacks for _, s, _ in peers),
            "host_ms_per_peer_frame": host_s / steps * 1e3}


def phase_journal() -> int:
    """RtsCmd over P2P on the card, recorded and replayed; returns the
    digest launches of the card's match."""
    rts = RtsCmd(2, num_units=4, max_cmds=4)
    with tempfile.TemporaryDirectory() as tmp:
        card_path, cpu_path = os.path.join(tmp, "card.ggjl"), os.path.join(tmp, "cpu.ggjl")
        run = drive_journal(rts, None, card_path)
        launches = run["launches"]
        check(run["around"] == 0, "journal: the digest went around state_digest")
        check(run["desyncs"] == [], f"journal: {len(run['desyncs'])} DesyncDetected")
        check(launches == run["predicted"],
              f"journal: {launches} digest launches, the request lists predict {run['predicted']}")
        check(run["journal_next_frame"] == run["end"],
              f"journal: the journal ends at frame {run['journal_next_frame']}, "
              f"peer A stood at {run['end']}: the drain left frames unconfirmed")
        check(run["end"] >= RTS_FRAMES, f"journal: the match reached frame {run['end']} only")
        cpu = drive_journal(rts, "cpu", cpu_path)
        with open(card_path, "rb") as f:
            journal_bytes = f.read()
        with open(cpu_path, "rb") as f:
            check(f.read() == journal_bytes, "journal: the journal's bytes != the CPU run's")
        check(run["sent"] == cpu["sent"], "journal: the checksums peers compared != CPU run")
        check(all(trees_equal(g, c) for g, c in zip(run["states"], cpu["states"])),
              "journal: final states != CPU run")
        check(run["frames_reached"][0] == run["frames_reached"][1] + 1,
              f"journal: the peers stopped at frames {run['frames_reached']}")
        oracle = RtsCmdGame(rts)
        at_end = None
        for f in range(run["frames_reached"][0]):
            if f == run["end"]:
                at_end = oracle.snapshot()[1]
            oracle.handle_requests([AdvanceFrame(inputs=[
                (rts_orders(h, f), InputStatus.CONFIRMED) for h in (0, 1)])])
        check(trees_equal(run["states"][0], oracle.state), "journal: peer A != RtsCmdGame")
        check(trees_equal(run["live_at_end"], at_end),
              "journal: peer A's live state at the journal's end != RtsCmdGame")
        b_oracle = RtsCmdGame(rts)
        for f in range(run["frames_reached"][1]):
            b_oracle.handle_requests([AdvanceFrame(inputs=[
                (rts_orders(h, f), InputStatus.CONFIRMED) for h in (0, 1)])])
        check(trees_equal(run["states"][1], b_oracle.state), "journal: peer B != RtsCmdGame")

        # -- replay: scrub windows on the card, then per-frame playback ---------
        rs = ReplaySession(card_path, rts.config())
        check(rs.closed and not rs.truncated and not rs.gaps and rs.first_frame == 0,
              "journal: the closed journal does not read back whole")
        check(rs.last_frame + 1 == run["end"], "journal: ReplaySession's last frame")
        # every window is one replay of its length's graph, under the sync
        # debug mode "error", held bitwise against the eager scrub's window
        scrub = build_scrub_program(rts.advance)
        state, eager, ref = rts.init_state_np(), rts.init_state_np(), rts.init_state_np()
        windows, scrub_s, eager_s, calls = 0, 0.0, 0.0, 0
        with no_device_reads(True):  # first call: the 64-frame graph's capture
            scrub(state, np.stack([rts.envelopes_np([(), ()])] * RTS_WINDOW))
        while rs.frames_remaining():
            inputs, statuses = rs.stacked_inputs(min(RTS_WINDOW, rs.frames_remaining()))
            check(all(s is InputStatus.CONFIRMED for row in statuses for s in row),
                  "journal: a replayed input is not confirmed")
            envs = np.stack([rts.envelopes_np(row) for row in inputs])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with no_device_reads(True):
                state = scrub(state, envs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eager = scrub.eager(eager, envs)
            torch.cuda.synchronize()
            calls += 1
            if len(inputs) == RTS_WINDOW:
                scrub_s += t1 - t0
                eager_s += time.perf_counter() - t1
                windows += 1
            check(cards_equal(state, eager),
                  f"journal: the graphed scrub != the eager scrub at frame {rs.current_frame}")
            for row in inputs:
                ref = rts.advance_np(ref, row)
            check(trees_equal(to_numpy(state), ref),
                  f"journal: the scrub != the oracle at frame {rs.current_frame}")
        check(trees_equal(to_numpy(state), run["live_at_end"]),
              "journal: the scrubbed end state != peer A's live state")
        check(scrub.replays == calls + 1 and scrub.captures == len({RTS_WINDOW, len(inputs)}),
              f"journal: {scrub.captures} scrub graphs and {scrub.replays} replays for "
              f"{calls + 1} windows")
        rs.seek(0)
        ex = DeviceRequestExecutor(rts.advance, rts.init_state_np(),
                                   lambda pairs: rts.envelopes_np([v for v, _ in pairs]))
        ref = rts.init_state_np()
        for _ in range(RTS_WINDOW):
            (req,) = rs.advance_frame()
            ex.run([req])
            ref = rts.advance_np(ref, [v for v, _ in req.inputs])
        check(trees_equal(to_numpy(ex.state), ref),
              f"journal: per-frame playback != the oracle at frame {RTS_WINDOW}")
        one = {k: v.unsqueeze(0) for k, v in rts.init_state().items()}
        envs = torch.from_numpy(rts.envelopes_np([rts_orders(0, 3), rts_orders(1, 5)])[None]).cuda()
        adv = kernels_per_advance(rts.advance, one, envs)
        emit({"phase": "journal", "game": "RtsCmd(2, 4, 4)", "peers": 2, "network": P2P_NET,
              "tick_ms": P2P_TICK_MS, "desync_interval": 1, "max_prediction": P2P_MAX_PREDICTION,
              "frames": RTS_FRAMES, "drain": RTS_DRAIN, "settle_ticks": run["settle_ticks"],
              "desyncs": 0, "sync_debug_mode": "error", "frames_reached": run["frames_reached"],
              "journal_frames": rs.last_frame + 1, "journal_bytes": len(journal_bytes),
              "journal_bytes_per_frame": len(journal_bytes) / (rs.last_frame + 1),
              "journal_equal_to_cpu": True, "states_equal_to_cpu": True,
              "equal_to_oracle": True, "replay_equal_to_live": True,
              "rollbacks_per_100_peer_frames": run["rollbacks"] / (2 * run["end"]) * 100,
              "digest_launches": launches, "digest_launches_predicted": run["predicted"],
              "host_ms_per_peer_frame": run["host_ms_per_peer_frame"],
              "scrub_windows_timed": windows, "scrub_ms_per_window": scrub_s / windows * 1e3,
              "scrub_frames_per_s": windows * RTS_WINDOW / scrub_s,
              "scrub_eager_ms_per_window": eager_s / windows * 1e3,
              "scrub_graphs": scrub.captures, "scrub_replays": scrub.replays,
              "scrub_equal_to_eager": True,
              "kernels_per_advance": adv["kernels"], "advance_busy_us": adv["busy_us"]})
    return launches


def spec_sched(player: int, i: int) -> int:
    """``bench.py``'s config-3 schedule (every player's input changes every
    3 frames, staggered), held for the last ``SPEC_DRAIN`` ticks."""
    return ((min(i, SPEC_TICKS - SPEC_DRAIN - 1) + player) // 3) % 16


def spec_branches():
    """``bench.py``'s hypotheses for peer 0 (``branch_inputs_all``):
    branches 0-6 hold every remote at k, branch 7 is the schedule itself."""
    base = np.zeros((SPEC_K, SPEC_PLAYERS), np.uint8)
    base[:7, 1:] = np.arange(7, dtype=np.uint8)[:, None]

    def branch_inputs_all(frame, arr):
        out = base.copy()
        out[:, 0] = arr[0]
        out[7, 1:] = [spec_sched(p, frame) for p in range(1, SPEC_PLAYERS)]
        return out

    return (lambda k, frame, arr: branch_inputs_all(frame, arr)[k]), branch_inputs_all


class EagerSpec(SpeculativeRollback):
    """Speculation through its plain versions on the card (the eager
    bodies): the graphs' eager twin.  The package has no switch; this
    object offers no graphs, so its route is the eager one on any device."""

    def graphs(self):
        return None


class EagerBranchPrograms(BranchPrograms):
    """``build_speculation_programs``' five programs through their eager
    bodies on any device: the branch graphs' eager twin."""

    def graphs(self, device):
        return None


def dispatched(fn) -> dict:
    """What one call of ``fn`` issues, counted at PyTorch's dispatcher:
    copies (``copy_``, ``_to_copy``, ``clone``, whatever the devices), the
    port's CUDA graph replays (one ``cudaGraphLaunch`` each) and digest
    launches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    copy_ops = (aten.copy_.default, aten._to_copy.default, aten.clone.default)
    count = {"graph_launches": 0, "copies": 0, "digest_launches": -state_digest.launches}

    class Copies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            count["copies"] += func in copy_ops
            return func(*args, **(kwargs or {}))

    replay = graph_ops.Graph.replay

    def counted(self):
        count["graph_launches"] += 1
        return replay(self)

    graph_ops.Graph.replay = counted
    try:
        with Copies():
            fn()
    finally:
        graph_ops.Graph.replay = replay
    count["digest_launches"] += state_digest.launches
    return count


def spec_tick_prediction(kind: str, leaves: int) -> dict:
    """The launches one peer-0 ``run`` issues on the graph route, by tick:
    a fused rollback tick is one ``fulfill_and_refill`` replay between one
    upload (inputs, hypotheses, window rows, offset), L copies of the loaded
    state in and 2L + 1 clones out (steps, digests, live state); a plain
    tick one ``advance_and_extend`` (or, with a full window, the executor's
    advance) replay between one upload, L copies in and L clones out, and
    its lone Save's one direct digest launch (a plain tick that extends the
    window and one without count alike)."""
    if kind == "rollback":
        return {"graph_launches": 1, "copies": 3 * leaves + 2, "digest_launches": 1}
    return {"graph_launches": 1, "copies": 2 * leaves + 1, "digest_launches": 1}


def spec_tick_kind(reqs, spec) -> str:
    """Peer 0's tick: a rollback, a plain tick that extends the window
    (``advance_and_extend``), or a plain tick without (no speculation, or
    the window unrooted or full: the executor's own advance)."""
    if any(isinstance(r, LoadGameState) for r in reqs):
        return "rollback"
    if spec is not None and spec.root_frame is not None and spec.window < spec.max_window:
        return "extend"
    return "plain"


def drive_spec(speculate: bool, device, profile: bool = False, eager: bool = False) -> dict:
    """BASELINE config 3: four ``BoxGame(4)`` P2P peers over an in-memory
    network, max_prediction 8, desync detection at interval 1, each with an
    executor on ``device``; with ``speculate`` peer 0 carries
    ``SpeculativeRollback(K=8, max_window=8)`` (its ``EagerSpec`` twin with
    ``eager``).  Every ``run`` on the card is under the sync debug mode
    "error".  With ``profile``, peer 0's runs of the ``SPEC_PROFILED`` ticks
    run alone under the profiler, inside a ``smoke:run`` span and counted
    at the dispatcher (``dispatched``), and are left out of the host
    times."""
    game = BoxGame(SPEC_PLAYERS)
    net = InMemoryNetwork()
    names = [f"P{p}" for p in range(SPEC_PLAYERS)]
    branch_inputs, branch_inputs_all = spec_branches()
    peers = []
    for me in range(SPEC_PLAYERS):
        spec = None
        if speculate and me == 0:
            spec = (EagerSpec if eager else SpeculativeRollback)(
                game.advance, SPEC_K, branch_inputs, max_window=SPEC_W,
                branch_inputs_all=branch_inputs_all, device=device)
        ex = DeviceRequestExecutor(game.advance, game.init_state_np(), executor_inputs,
                                   speculation=spec, device=device)
        ex.warmup(np.zeros(SPEC_PLAYERS, np.uint8),
                  burst_depths=range(2, SPEC_MAX_PREDICTION + 2))
        b = (SessionBuilder(boxgame_config()).with_num_players(SPEC_PLAYERS)
             .with_max_prediction_window(SPEC_MAX_PREDICTION).with_clock(lambda: 0)
             .with_rng(random.Random(91 + me)).with_desync_detection_mode(DesyncDetection.on(1)))
        for p in range(SPEC_PLAYERS):
            b = b.add_player(Local() if p == me else Remote(names[p]), p)
        sess = b.start_p2p_session(net.socket(names[me]))
        sess.attach_forensics(recorder=FlightRecorder(checksum_window=SPEC_TICKS + 8))
        peers.append((me, sess, ex))
    ex0 = peers[0][2]
    card = ex0.device.type == "cuda"
    spec_graphs = None if ex0._spec is None else ex0._spec.graphs()
    warm_captures = None if spec_graphs is None else spec_graphs.captures
    calls = {"burst": 0, "fused": 0}
    for obj, name, key in ((ex0, "_do_burst", "burst"), (ex0._spec, "fulfill_and_refill", "fused")):
        if obj is not None:
            orig = getattr(obj, name)
            setattr(obj, name, lambda *a, _o=orig, _k=key, **kw: (
                calls.__setitem__(_k, calls[_k] + 1), _o(*a, **kw))[1])
    loads = predicted = desyncs = fused_with_burst = 0
    host = {"tick": 0.0, "ticks": 0, "rollback": [0.0, 0], "extend": [0.0, 0], "plain": [0.0, 0]}
    prof = {"rollback": [], "extend": [], "plain": []}
    state_digest.launches = lane_sums_rows.launches = 0
    for i in range(SPEC_TICKS):
        in_prof = profile and card and i in SPEC_PROFILED
        t_tick = time.perf_counter()
        for _, sess, _ in peers:
            sess.poll_remote_clients()
        for p, sess, ex in peers:
            sess.add_local_input(p, spec_sched(p, i))
            t0 = time.perf_counter()
            reqs = sess.advance_frame()
            predicted += predicted_digest_launches(reqs)
            if p == 0:
                kind = spec_tick_kind(reqs, ex0._spec)
                loads += kind == "rollback"
                before = dict(calls)
                if in_prof:
                    counts = {}

                    def one(reqs=reqs, counts=counts):
                        with torch.profiler.record_function("smoke:run"):
                            counts.update(dispatched(lambda: guarded_run(ex.run, reqs, card)))

                    row = profile_ticks(one, 1, span="smoke:run")
                    row["dispatched"] = counts
                    row["fused"] = calls["fused"] > before["fused"]
                    prof[kind].append(row)
                else:
                    guarded_run(ex.run, reqs, card)
                    host[kind][0] += time.perf_counter() - t0
                    host[kind][1] += 1
                fused_with_burst += calls["fused"] > before["fused"] and calls["burst"] > before["burst"]
            else:
                guarded_run(ex.run, reqs, card)
            desyncs += sum(1 for e in sess.events() if isinstance(e, DesyncDetected))
        if not in_prof:
            host["tick"] += time.perf_counter() - t_tick
            host["ticks"] += 1
    if card:
        torch.cuda.synchronize()
    per_class = {}
    for kind, rows in prof.items():
        seen = {}
        for r in rows:
            k = json.dumps(r["dispatched"], sort_keys=True)
            seen[k] = seen.get(k, 0) + 1
        launches = {}
        for r in rows:
            for k, v in r["host_launches_per_tick"].items():
                launches[k] = launches.get(k, 0) + v / len(rows)
        n_digest = sum(r["digest_kernels_per_tick"] for r in rows)
        per_class[kind] = {
            "ticks_profiled": len(rows),
            "kernels": sum(r["kernels_per_tick"] for r in rows) / len(rows) if rows else None,
            "device_busy_us": (sum(r["busy_ms_per_tick"] for r in rows) / len(rows) * 1e3
                               if rows else None),
            "ticks_timed": host[kind][1],
            "host_ms_advance_frame_and_run": (host[kind][0] / host[kind][1] * 1e3
                                              if host[kind][1] else None),
            "host_launch_calls_in_run": launches,
            "dispatched_in_run": seen,
            "digest_us_per_launch": (sum(r["digest_us_per_tick"] for r in rows) / n_digest
                                     if n_digest else None),
        }
    graphs = None
    if spec_graphs is not None:
        graphs = {"captures": spec_graphs.captures, "replays": spec_graphs.replays,
                  "captures_in_warmup": warm_captures,
                  "pool_bytes": pool_bytes([spec_graphs.set.pool]) if card else None}
    return {
        "launches": state_digest.launches, "around": lane_sums_rows.launches,
        "predicted": predicted, "desyncs": desyncs, "loads": loads,
        "hits": ex0.spec_hits, "misses": ex0.spec_misses,
        "fused": calls["fused"], "bursts": calls["burst"], "fused_with_burst": fused_with_burst,
        "states": [to_numpy(ex.state) for _, _, ex in peers],
        "sent": [dict(s.recorder.checksums.items()) for _, s, _ in peers],
        "frames_reached": [s.current_frame for _, s, _ in peers],
        "host_ms_per_tick": host["tick"] / host["ticks"] * 1e3, "per_class": per_class,
        "profiled": prof, "spec_graphs": graphs, "leaves": len(tree_leaves(ex0.state)),
    }


def branch_leg(device, eager: bool = False) -> dict:
    """``build_speculation_programs(BoxGame(4).advance, 8)`` (its
    ``EagerBranchPrograms`` twin with ``eager``) on ``device`` at W = 8:
    ``init``, ``speculate_window``, ``resolve`` of a hit (branch 5's own
    window) and of a miss, ``replay_window`` of branch 5's window, and
    ``collapse`` at the hit's device index and at 3.  Returns the results
    on the host, the graphs' counts and host us per call."""
    game = BoxGame(SPEC_PLAYERS)
    programs = (EagerBranchPrograms if eager else BranchPrograms)(game.advance, SPEC_K)
    progs = programs.branches()
    rng = np.random.default_rng(33)
    inputs_kw = rng.integers(0, 16, size=(SPEC_K, SPEC_W, SPEC_PLAYERS)).astype(np.uint8)
    nowhere = np.full((SPEC_W, SPEC_PLAYERS), 255, np.uint8)
    base = from_numpy(game.init_state_np(), device)
    base = tree_map(lambda l: l[0], game.advance(tree_map(lambda l: l.unsqueeze(0), base),
                                                 from_numpy(inputs_kw[0, :1], device)))
    branches = progs.speculate_window(base, inputs_kw)
    hit = progs.resolve(branches, inputs_kw, inputs_kw[5])
    out = {"init": progs.init(base), "branches": branches, "hit": hit,
           "miss": progs.resolve(branches, inputs_kw, nowhere),
           "replay": progs.replay_window(base, inputs_kw[5]),
           "collapse_hit": progs.collapse(branches, hit[1]),
           "collapse_3": progs.collapse(branches, 3)}
    card = tree_leaves(base)[0].device.type == "cuda"
    g = programs.graphs(tree_leaves(base)[0].device)
    counts = (None, None) if g is None else (g.captures, g.replays)
    us, ms = {}, {}
    if card:
        for name, fn in (("speculate_window", lambda: progs.speculate_window(base, inputs_kw)),
                         ("resolve", lambda: progs.resolve(branches, inputs_kw, inputs_kw[5])),
                         ("replay_window", lambda: progs.replay_window(base, inputs_kw[5]))):
            us[name] = host_us(fn, calls=50)
            ms[name] = device_ms(fn, iters=50)
    return {"out": to_numpy(out), "idx": (int(hit[1]), int(out["miss"][1])),
            "found": (bool(hit[2]), bool(out["miss"][2])),
            "captures": counts[0], "replays": counts[1], "host_us_per_call": us,
            "wall_ms_per_call": ms}


def phase_speculation() -> int:
    """BASELINE config 3 on the card: speculation on its graphs, on their
    eager twin and off, against a CPU rerun, then the speculation programs'
    leg; returns the digest launches of the card's drives."""
    on = drive_spec(True, None, profile=True)
    eager = drive_spec(True, None, profile=True, eager=True)
    off = drive_spec(False, None, profile=True)
    for name, run in (("on", on), ("eager", eager), ("off", off)):
        check(run["around"] == 0, f"speculation {name}: the digest went around state_digest")
        check(run["desyncs"] == 0, f"speculation {name}: {run['desyncs']} DesyncDetected")
        check(run["launches"] == run["predicted"],
              f"speculation {name}: {run['launches']} digest launches, the request lists "
              f"predict {run['predicted']}")
        check(len(set(run["frames_reached"])) == 1 and all(
            trees_equal(run["states"][0], st) for st in run["states"][1:]),
              f"speculation {name}: the four peers differ after the drain")
    for name, run in (("eager twin", eager), ("speculation off", off)):
        check(all(trees_equal(a, b) for a, b in zip(on["states"], run["states"])),
              f"speculation: states on the graphs != {name}")
        check(on["sent"] == run["sent"], f"speculation: sent checksums on the graphs != {name}")
    for name, run in (("on", on), ("eager", eager)):
        check(run["hits"] + run["misses"] == run["loads"],
              f"speculation {name}: {run['hits']} hits + {run['misses']} misses != "
              f"{run['loads']} rollbacks")
        check(run["fused_with_burst"] == 0, f"speculation {name}: a fused rollback tick also ran a burst")
        # branch 7 is the schedule itself, so every window the branches cover hits
        check(run["hits"] == run["fused"] > 0,
              f"speculation {name}: {run['hits']} hits of {run['fused']} fused windows")
        check(run["bursts"] <= run["misses"], f"speculation {name}: bursts on ticks that hit")
    check((eager["hits"], eager["misses"], eager["fused"]) == (on["hits"], on["misses"], on["fused"]),
          "speculation: hits, misses and fused windows on the graphs != the eager twin")
    graphs = on["spec_graphs"]
    # warmup: advance_and_extend, extend and the fused tick at n = 1..8 with
    # and without the live advance
    check(graphs["captures_in_warmup"] == 2 + 2 * SPEC_W,
          f"speculation: {graphs['captures_in_warmup']} graphs captured in warmup")
    leaves = on["leaves"]
    for kind, rows in on["profiled"].items():
        for r in rows:
            if kind == "rollback" and not r["fused"]:
                continue
            want = spec_tick_prediction(kind, leaves)
            check(r["dispatched"] == want,
                  f"speculation: a {kind} tick's run dispatched {r['dispatched']}, not {want}")
    cpu = drive_spec(True, "cpu")
    check(all(trees_equal(a, b) for a, b in zip(on["states"], cpu["states"])),
          "speculation: card states != CPU rerun")
    check(on["sent"] == cpu["sent"], "speculation: sent checksums != CPU rerun")
    check((cpu["hits"], cpu["misses"]) == (on["hits"], on["misses"]),
          "speculation: hits and misses != CPU rerun")
    legs = {"graph": branch_leg(None), "eager": branch_leg(None, eager=True),
            "cpu": branch_leg("cpu")}
    for name in ("eager", "cpu"):
        check(trees_equal(legs["graph"]["out"], legs[name]["out"]),
              f"speculation programs: the graphs' results != {name}")
    g = legs["graph"]
    check(g["idx"] == (5, 0) and g["found"] == (True, False),
          f"speculation programs: resolve gave {g['idx']}, {g['found']}")
    check(trees_equal(g["out"]["hit"][0], g["out"]["replay"]),
          "speculation programs: the hit's branch != the replayed window")
    check((g["captures"], g["replays"]) == (5, 7),
          f"speculation programs: {g['captures']} captures, {g['replays']} replays")
    # without speculation the drain's ticks are all plain: the ticks that
    # extend the window on the graphs are plain ticks there
    # the digest the fused graphs replay, at the drive's window depths (1
    # row, and the full window's 8), against its plain version
    digest = {}
    rng = np.random.default_rng(11)
    for rows in (1, SPEC_W):
        st = boxgame_state(rng, (rows,), players=SPEC_PLAYERS)
        got, want = checksum_device(st), checksum_device_plain(st)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"speculation: digest of {rows} rows != plain")
        row_bytes = sum(math.prod(l.shape[1:]) * l.element_size() for l in tree_leaves(st))
        digest[rows] = {"device_us": graph_us(checksum_device, [st]),
                        "plain_ms": device_ms(lambda: checksum_device_plain(st), iters=20),
                        "bound_us": bound_us(row_bytes * rows, rows),
                        "max_abs_err": u32_err(got, want)}
    per_tick = {k: {**v, "host_ms_advance_frame_and_run": {
        "graph": v["host_ms_advance_frame_and_run"],
        "eager_twin": eager["per_class"][k]["host_ms_advance_frame_and_run"],
        "off": off["per_class"]["plain" if k == "extend" else k][
            "host_ms_advance_frame_and_run"]}}
        for k, v in on["per_class"].items()}
    emit({"phase": "speculation", "config": "BASELINE config 3", "game": "BoxGame(4)",
          "peers": SPEC_PLAYERS, "branches": SPEC_K, "max_window": SPEC_W,
          "max_prediction": SPEC_MAX_PREDICTION, "ticks": SPEC_TICKS, "drain": SPEC_DRAIN,
          "desync_interval": 1, "desyncs": 0, "sync_debug_mode": "error",
          "states_equal_graph_eager_off_cpu": True, "sent_checksums_equal_graph_eager_off_cpu": True,
          "rollbacks_peer0": on["loads"], "hits": on["hits"], "misses": on["misses"],
          "fused_windows": on["fused"], "fallback_bursts": on["bursts"],
          "frames_reached": on["frames_reached"][0], "spec_graphs": graphs,
          "digest_at_window": digest,
          "predicted_in_run": {k: spec_tick_prediction(k, leaves)
                               for k in ("rollback", "extend", "plain")},
          "peer0_per_tick": {"graph": per_tick,
                             "eager_twin": {k: {kk: vv for kk, vv in v.items()
                                                if kk != "dispatched_in_run"}
                                            for k, v in eager["per_class"].items()},
                             "off": off["per_class"]},
          "host_ms_per_tick_4_peers": {"graph": on["host_ms_per_tick"],
                                       "eager_twin": eager["host_ms_per_tick"],
                                       "off": off["host_ms_per_tick"]},
          "digest_launches": {"graph": on["launches"], "eager_twin": eager["launches"],
                              "off": off["launches"]},
          "digest_launches_predicted": {"graph": on["predicted"], "eager_twin": eager["predicted"],
                                        "off": off["predicted"]}})
    emit({"phase": "speculation", "leg": "build_speculation_programs", "K": SPEC_K, "W": SPEC_W,
          "equal_to_eager_and_cpu": True, "captures": g["captures"], "replays": g["replays"],
          "resolve_hit_idx": g["idx"][0],
          "host_us_per_call": {"graph": g["host_us_per_call"],
                               "eager_twin": legs["eager"]["host_us_per_call"]},
          "wall_ms_per_call_back_to_back": {"graph": g["wall_ms_per_call"],
                                            "eager_twin": legs["eager"]["wall_ms_per_call"]}})
    return on["launches"] + eager["launches"] + off["launches"]


def pool_sched(m: int, me: int, i: int) -> int:
    """``bench.py``'s ``_match_population`` schedule for match m's peer."""
    return ((i + 2 * m + me) // (2 + m % 3)) % 16


def pool_sessions(n_matches: int, ticks: int, config=None, cores: str = "native") -> list:
    """``bench.py``'s match population (``_match_population``): 2-peer
    BoxGame matches over one in-memory network, with desync detection;
    ``config`` replaces ``boxgame_config()`` (the same 8-bit inputs)."""
    net = InMemoryNetwork()
    sessions = []
    for m in range(n_matches):
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            with session_cores(cores):
                sess = (SessionBuilder(config or boxgame_config()).with_clock(lambda: 0)
                        .with_rng(random.Random(3 + 5 * m + me))
                        .with_desync_detection_mode(DesyncDetection.on(POOL_DESYNC_INTERVAL))
                        .add_player(Local(), me).add_player(Remote(names[1 - me]), 1 - me)
                        .start_p2p_session(net.socket(names[me])))
            sess.attach_forensics(recorder=FlightRecorder(checksum_window=ticks + 8))
            sessions.append(sess)
    return sessions


def pool_predicted(desc) -> int:
    """Digest launches of one pooled tick, from its descriptor: one per
    masked write that some row takes."""
    n_adv = desc["n_adv"]
    writes = int(desc["pre_save"].any()) + int(desc["postload_save"].any())
    for j in range(int(n_adv.max())):
        writes += int(((j < n_adv) & desc["save_mask"][:, j]).any())
    return writes


class EagerPool(BatchedRequestExecutor):
    """The pool's masked tick through its plain version on the card (the
    eager ``_tick_shard``, shard by shard): the graphs' eager twin.  The
    package has no switch; this pool never replays its graphs."""

    def _run_shard(self, shard, desc):
        self._tick_shard(shard, desc)


class EagerPlane(DevicePredictionPlane):
    """The prediction plane's kernel through its plain version on the card
    (called eagerly between the copies): the plane graph's eager twin."""

    def graphs(self):
        return None


def drive_pool(n_matches: int, ticks: int, device, pooled: bool = True, profiled_ticks: int = 0,
               config=None, cores: str = "native", plane: bool = False, eager: bool = False,
               eager_plane: bool = False):
    """``n_matches`` matches fulfilled by one ``BatchedRequestExecutor``
    (``pooled``; an ``EagerPool`` with ``eager``) or by one
    ``DeviceRequestExecutor`` per session, on ``device``.  On the card every
    fulfilment is under the sync debug mode "error"; in the last
    ``profiled_ticks`` ticks the fulfilment runs alone under the profiler,
    inside a ``smoke:fulfil`` span, and those ticks are left out of the host
    times.  Each tick adds every session's local input, then (with
    ``plane``) runs the prediction plane's ``begin_tick`` on ``device``,
    then advances every session, as the host session pool orders a tick
    (the plane's ``EagerPlane`` twin with ``eager_plane``).  Each profiled
    ``begin_tick`` counts its copies at the dispatcher and its graph
    launches."""
    sessions = pool_sessions(n_matches, ticks, config, cores)
    pl = None
    if plane:
        pl = (EagerPlane if eager_plane else DevicePredictionPlane)(
            config, capacity=len(sessions), device=device)
        for slot, sess in enumerate(sessions):
            sess.bind_prediction_plane(pl, slot)
    B = len(sessions)
    game = BoxGame(2)
    predicted = ticks_run = 0
    if pooled:
        pool = (EagerPool if eager else BatchedRequestExecutor)(
            game.advance, game.init_state_np(), executor_inputs, batch_size=B,
            ring_length=POOL_RING, max_burst=POOL_MAX_BURST, device=device)
        pool.warmup(np.zeros(2, np.uint8))
        card = pool.device.type == "cuda"
        real_tick = pool._tick

        def tick(desc):
            nonlocal predicted, ticks_run
            predicted += pool_predicted(desc)
            ticks_run += 1
            return real_tick(desc)

        pool._tick = tick
        fulfil = pool.run
    else:
        programs = ExecutorPrograms(game.advance)
        exs = [DeviceRequestExecutor(game.advance, game.init_state_np(), executor_inputs,
                                     programs=programs, device=device) for _ in range(B)]
        exs[0].warmup(np.zeros(2, np.uint8), burst_depths=range(2, POOL_MAX_BURST + 1))
        card = exs[0].device.type == "cuda"

        def fulfil(all_reqs):
            for ex, reqs in zip(exs, all_reqs):
                ex.run(reqs)

    host = {"sessions": 0.0, "fulfil": 0.0, "begin_tick": 0.0}
    desyncs, last, prof, plane_copies = 0, None, [], []
    state_digest.launches = lane_sums_rows.launches = 0
    timed = ticks - (profiled_ticks if card else 0)
    if card:
        torch.cuda.synchronize()
    t_start = time.perf_counter()
    for i in range(ticks):
        if i == timed and card:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_start
        t0 = time.perf_counter()
        for s in sessions:
            s.poll_remote_clients()
        for b, s in enumerate(sessions):
            s.add_local_input(b % 2, pool_sched(b // 2, b % 2, i))
        if pl is not None:
            if i >= timed and card and len(plane_copies) < PLANE_PROFILED:
                g = pl.graphs()
                before = 0 if g is None else g.replays
                plane_copies.append(copies_in(pl.begin_tick))
                plane_copies[-1]["graph_launches"] = (0 if g is None else g.replays) - before
            else:
                tb = time.perf_counter()
                pl.begin_tick()
                if i < timed:
                    host["begin_tick"] += time.perf_counter() - tb
        reqs = [s.advance_frame() for s in sessions]
        t1 = time.perf_counter()
        if not pooled:
            predicted += sum(predicted_digest_launches(r) for r in reqs)
        if i < timed:
            guarded_run(fulfil, reqs, card)
            host["sessions"] += t1 - t0
            host["fulfil"] += time.perf_counter() - t1
        else:
            captures = pool.captures if pooled else 0

            def one():
                with torch.profiler.record_function("smoke:fulfil"):
                    guarded_run(fulfil, reqs, card)

            prof.append(profile_ticks(one, 1, span="smoke:fulfil"))
            prof[-1]["captured"] = pooled and pool.captures != captures
        desyncs += sum(1 for s in sessions for e in s.events() if isinstance(e, DesyncDetected))
        last = reqs
    if card:
        torch.cuda.synchronize()
    if timed == ticks:
        wall = time.perf_counter() - t_start
    kernels = busy = digest_us = None
    host_launches = {}
    if prof:
        kernels = sum(r["kernels_per_tick"] for r in prof) / len(prof)
        busy = sum(r["busy_ms_per_tick"] for r in prof) / len(prof) * 1e3
        n_digest = sum(r["digest_kernels_per_tick"] for r in prof)
        digest_us = sum(r["digest_us_per_tick"] for r in prof) / n_digest if n_digest else None
        # the host's launch calls of the profiled ticks that captured no graph
        replay_only = [r["host_launches_per_tick"] for r in prof if not r["captured"]]
        for h in replay_only:
            for k, v in h.items():
                host_launches[k] = host_launches.get(k, 0) + v / len(replay_only)
    saved = [(b, r.frame) for b, rs in enumerate(last) for r in rs if isinstance(r, SaveGameState)]
    if pooled:
        states = [pool.live_state(b) for b in range(B)]
        cs = {(b, f): pool.ring_checksum(b, f) for b, f in saved}
    else:
        states = [to_numpy(ex.state) for ex in exs]
        cs = {(b, r.frame): r.cell.checksum for b, rs in enumerate(last)
              for r in rs if isinstance(r, SaveGameState)}
    wall_ms = wall / timed * 1e3
    return {
        "launches": state_digest.launches, "around": lane_sums_rows.launches,
        "predicted": predicted, "desyncs": desyncs, "states": states, "last_checksums": cs,
        "sent": [dict(s.recorder.checksums.items()) for s in sessions],
        "frames_reached": [s.current_frame for s in sessions],
        "rollbacks": sum(s._stat_rollbacks for s in sessions),
        "checksum_reads_per_tick": sum(len(s.recorder.checksums) for s in sessions) / ticks,
        "host_ms_per_tick": wall_ms,
        "host_ms_sessions": host["sessions"] / timed * 1e3,
        "host_ms_fulfil": host["fulfil"] / timed * 1e3,
        "kernels_per_tick": kernels,
        "device_busy_ms_per_tick": None if busy is None else busy / 1e3,
        "idle_share": None if busy is None else 1 - busy / 1e3 / wall_ms,
        "cores": core_kinds(sessions),
        "profiled": [{"host_launches": r["host_launches_per_tick"], "captured": r["captured"]}
                     for r in prof],
        "host_launches_per_tick": host_launches, "digest_us_per_launch": digest_us,
        "captures": pool.captures if pooled else None, "ticks_run": ticks_run,
        "replays": pool.replays if pooled else None,
        "pool_bytes": (pool_bytes([s["graphs"].set.pool for s in pool._shards
                                   if s["graphs"] is not None]) if pooled and card else None),
        "plane_obj": pl,
        "plane": None if pl is None else {
            **pl.stats(), "host_us_begin_tick": host["begin_tick"] / timed * 1e6,
            "copies_per_tick": plane_copies,
            "graphs": None if pl.graphs() is None else {"captures": pl.graphs().captures,
                                                        "replays": pl.graphs().replays},
            "plane_mispredicts": sum(q.plane_mispredicts for s in sessions
                                     for q in s._sync_layer.input_queues)},
    }


def pool_graph_vs_eager(name: str, graph: dict, eager: dict) -> dict:
    """A pooled drive on the graphs against its ``EagerPool`` twin on the
    card: live states, ring checksums, sent checksums, frames and digest
    launches bitwise equal; one replay a tick (after the two warmup
    captures, one capture a key met first in the drive); in every profiled
    tick that captured nothing, one ``cudaGraphLaunch`` and at most two
    other launch calls inside ``run`` (the descriptor's copy).  Emits the
    graphs line and returns it."""
    check(all(trees_equal(a, b) for a, b in zip(graph["states"], eager["states"]))
          and graph["last_checksums"] == eager["last_checksums"]
          and graph["sent"] == eager["sent"]
          and graph["frames_reached"] == eager["frames_reached"]
          and graph["launches"] == eager["launches"] == graph["predicted"],
          f"{name}: the graphs' drive != the eager drive on the card")
    check(graph["replays"] == graph["ticks_run"] and graph["captures"] >= 2,
          f"{name}: {graph['captures']} captures, {graph['replays']} replays for "
          f"{graph['ticks_run']} ticks")
    replayed = [p["host_launches"] for p in graph["profiled"] if not p["captured"]]
    check(len(replayed) >= POOL_PROFILED // 2, f"{name}: {len(replayed)} profiled ticks replayed only")
    for host in replayed:
        graphs = sum(v for k, v in host.items() if "GraphLaunch" in k)
        check(graphs == 1 and sum(host.values()) - graphs <= 2,
              f"{name}: host launches a tick {host}, not one graph launch and at most 2 copies")
    line = {"phase": name, "graphs": True, "sessions": len(graph["states"]),
            "graph_host_ms_per_tick": graph["host_ms_per_tick"],
            "eager_host_ms_per_tick": eager["host_ms_per_tick"],
            "graph_ms_fulfil": graph["host_ms_fulfil"], "eager_ms_fulfil": eager["host_ms_fulfil"],
            "speedup_fulfil": eager["host_ms_fulfil"] / graph["host_ms_fulfil"],
            "captures": graph["captures"], "replays": graph["replays"],
            "pool_bytes": graph["pool_bytes"], "profiled_replay_ticks": len(replayed),
            "host_launches_per_tick": graph["host_launches_per_tick"],
            "kernels_per_tick": graph["kernels_per_tick"],
            "eager_kernels_per_tick": eager["kernels_per_tick"],
            "device_busy_ms_per_tick": graph["device_busy_ms_per_tick"],
            "idle_share": graph["idle_share"], "eager_idle_share": eager["idle_share"],
            "digest_us_per_launch_in_graph": graph["digest_us_per_launch"],
            "digest_launches": graph["launches"], "digest_launches_eager": eager["launches"],
            "graph_equal_to_eager": True, "sync_debug_mode": "error"}
    emit(line)
    return line


def phase_pool():
    """Massed hosting on the card: one pool against one executor per
    session, and a CPU rerun; then B = 512.  Returns the digest launches
    of the card's drives and the 64-session pooled run."""
    pooled = drive_pool(POOL_MATCHES, POOL_TICKS, None, True, POOL_PROFILED)
    twin = drive_pool(POOL_MATCHES, POOL_TICKS, None, True, POOL_PROFILED, eager=True)
    single = drive_pool(POOL_MATCHES, POOL_TICKS, None, False, POOL_PROFILED)
    graph_line = pool_graph_vs_eager("pool", pooled, twin)
    check(pooled["cores"] == single["cores"] == NATIVE_CORES,
          f"pool: the sessions ran {pooled['cores']}")
    for name, run in (("pool", pooled), ("executors", single)):
        check(run["around"] == 0, f"pool {name}: the digest went around state_digest")
        check(run["desyncs"] == 0, f"pool {name}: {run['desyncs']} DesyncDetected")
        check(run["launches"] == run["predicted"],
              f"pool {name}: {run['launches']} digest launches, predicted {run['predicted']}")
        check(all(len(s) > POOL_TICKS // (2 * POOL_DESYNC_INTERVAL) for s in run["sent"]),
              f"pool {name}: too few checksum reports sent")
    check(pooled["frames_reached"] == single["frames_reached"], "pool: frames != executors'")
    check(all(trees_equal(a, b) for a, b in zip(pooled["states"], single["states"])),
          "pool: live states != 64 executors'")
    check(pooled["last_checksums"] == single["last_checksums"] and pooled["last_checksums"],
          "pool: ring checksums != the executors' saved checksums")
    check(pooled["sent"] == single["sent"], "pool: sent checksums != the executors'")
    cpu = drive_pool(POOL_MATCHES, POOL_TICKS, "cpu", True)
    check(all(trees_equal(a, b) for a, b in zip(pooled["states"], cpu["states"])),
          "pool: live states != CPU rerun")
    check(pooled["last_checksums"] == cpu["last_checksums"], "pool: ring checksums != CPU rerun")
    check(pooled["sent"] == cpu["sent"], "pool: sent checksums != CPU rerun")
    big = drive_pool(POOL_BIG_MATCHES, POOL_BIG_TICKS, None, True, POOL_PROFILED)
    check(big["around"] == 0 and big["desyncs"] == 0, "pool 512: desync or stray digest")
    check(big["launches"] == big["predicted"],
          f"pool 512: {big['launches']} digest launches, predicted {big['predicted']}")
    head = drive_pool(POOL_MATCHES, POOL_BIG_TICKS, "cpu", True)
    check(all(trees_equal(a, b) for a, b in zip(big["states"], head["states"])),
          "pool 512: sessions 0-63 != CPU rerun of their matches")
    check(big["sent"][:POOL_SESSIONS] == head["sent"], "pool 512: sent checksums != CPU rerun")
    keys = ("host_ms_per_tick", "host_ms_sessions", "host_ms_fulfil", "kernels_per_tick",
            "device_busy_ms_per_tick", "idle_share", "checksum_reads_per_tick")
    emit({"phase": "pool", "game": "BoxGame(2)", "matches": POOL_MATCHES,
          "sessions": POOL_SESSIONS, "ring_length": POOL_RING, "max_burst": POOL_MAX_BURST,
          "desync_interval": POOL_DESYNC_INTERVAL, "ticks": POOL_TICKS, "desyncs": 0,
          "captures": pooled["captures"], "replays": pooled["replays"],
          "equal_to_eager": graph_line["graph_equal_to_eager"],
          "sync_debug_mode": "error", "states_equal_to_executors_and_cpu": True,
          "ring_checksums_equal": True, "rollbacks_per_100_session_ticks":
              pooled["rollbacks"] / (POOL_SESSIONS * POOL_TICKS) * 100,
          "profiled_ticks": POOL_PROFILED,
          "pool": {k: pooled[k] for k in keys}, "executors": {k: single[k] for k in keys},
          "digest_launches_per_tick": {"pool": pooled["launches"] / POOL_TICKS,
                                       "executors": single["launches"] / POOL_TICKS},
          "digest_launches": {"pool": pooled["launches"], "executors": single["launches"]},
          "digest_launches_predicted": {"pool": pooled["predicted"],
                                        "executors": single["predicted"]}})
    emit({"phase": "pool", "game": "BoxGame(2)", "matches": POOL_BIG_MATCHES,
          "sessions": POOL_BIG_SESSIONS, "ticks": POOL_BIG_TICKS, "desyncs": 0,
          "sessions_equal_to_cpu": POOL_SESSIONS, "profiled_ticks": POOL_PROFILED,
          "captures": big["captures"], "replays": big["replays"],
          "host_launches_per_tick": big["host_launches_per_tick"],
          "pool": {k: big[k] for k in keys},
          "digest_launches": big["launches"], "digest_launches_predicted": big["predicted"],
          "digest_launches_per_tick": big["launches"] / POOL_BIG_TICKS})
    return pooled["launches"] + single["launches"] + big["launches"], pooled


def phase_native(p2p_runs: dict, pool_run: dict) -> int:
    """Phase 7's P2P drives and phase 12's 64-session pool again: on the
    Python input queues and endpoint cores, then once more on the native
    cores right after, so that the host times compared were taken side by
    side (no frame under the profiler).  Every leg bitwise equal to phases 7
    and 12 (both peers' states, every checksum sent, every request list; the
    pool's live states, ring and sent checksums), 0 desyncs.  Returns the
    digest launches of the legs."""
    total = 0
    for name, game, frames, _ in P2P_GAMES:
        ref = p2p_runs[name]
        legs = {cores: drive_p2p(game, frames, None, cores=cores) for cores in ("python", "native")}
        for cores, run in legs.items():
            want = PYTHON_CORES if cores == "python" else NATIVE_CORES
            check(run["cores"] == want, f"native {name}: the {cores} leg ran {run['cores']}")
            check(run["desyncs"] == [] and run["around"] == 0,
                  f"native {name} {cores}: desync or stray digest")
            check(run["launches"] == run["predicted"] == ref["launches"],
                  f"native {name} {cores}: {run['launches']} digest launches, not {ref['launches']}")
            check(run["requests"] == ref["requests"], f"native {name} {cores}: request lists differ")
            check(run["sent"] == ref["sent"], f"native {name} {cores}: sent checksums differ")
            check(all(trees_equal(a, b) for a, b in zip(run["states"], ref["states"])),
                  f"native {name} {cores}: live states differ")
            total += run["launches"]
        host = {"phase_7_native": ref["host_ms"], **{k: r["host_ms"] for k, r in legs.items()}}
        emit({"phase": "native", "drive": "p2p", "game": name, "frames": frames,
              "desyncs": 0, "requests_equal": True, "sent_checksums_equal": True,
              "states_equal": True, "request_lists": len(ref["requests"]),
              "cores": {k: sorted(r["cores"]) for k, r in legs.items()},
              "host_ms_per_frame": {k: sum(v.values()) for k, v in host.items()},
              "host_ms_poll_remote_clients": {k: v["poll"] for k, v in host.items()},
              "host_ms_advance_frame": {k: v["advance_frame"] for k, v in host.items()},
              "host_ms_run": {k: v["run"] for k, v in host.items()}})
    legs = {cores: drive_pool(POOL_MATCHES, POOL_TICKS, None, True, cores=cores)
            for cores in ("python", "native")}
    for cores, run in legs.items():
        want = PYTHON_CORES if cores == "python" else NATIVE_CORES
        check(run["cores"] == want, f"native pool: the {cores} leg ran {run['cores']}")
        check(run["desyncs"] == 0 and run["around"] == 0, f"native pool {cores}: desync")
        check(run["frames_reached"] == pool_run["frames_reached"], f"native pool {cores}: frames")
        check(all(trees_equal(a, b) for a, b in zip(run["states"], pool_run["states"])),
              f"native pool {cores}: live states differ")
        check(run["last_checksums"] == pool_run["last_checksums"],
              f"native pool {cores}: ring checksums differ")
        check(run["sent"] == pool_run["sent"], f"native pool {cores}: sent checksums differ")
        check(run["launches"] == pool_run["launches"], f"native pool {cores}: digest launches")
        total += run["launches"]
    keys = ("host_ms_per_tick", "host_ms_sessions", "host_ms_fulfil")
    emit({"phase": "native", "drive": "pool", "sessions": POOL_SESSIONS, "ticks": POOL_TICKS,
          "desyncs": 0, "states_equal": True, "ring_checksums_equal": True,
          "sent_checksums_equal": True, "phase_12_native": {k: pool_run[k] for k in keys},
          **{k: {key: r[key] for key in keys} for k, r in legs.items()}})
    return total


def phase_plane() -> int:
    """The 64-session pool with a batched predictor, the prediction plane on
    its graph (on the card), on its eager twin and off, for both batched
    strategies, against each other and a CPU rerun.  Returns the digest
    launches of the card's legs."""
    total = 0
    timing = ("host_us_begin_tick", "copies_per_tick", "graphs")
    for name, predictor in PLANE_PREDICTORS:
        config = Config.for_uint(8, predictor=predictor())
        on = drive_pool(POOL_MATCHES, POOL_TICKS, None, True, PLANE_PROFILED, config=config,
                        plane=True)
        eager = drive_pool(POOL_MATCHES, POOL_TICKS, None, True, PLANE_PROFILED, config=config,
                           plane=True, eager_plane=True)
        off = drive_pool(POOL_MATCHES, POOL_TICKS, None, True, PLANE_PROFILED, config=config)
        cpu = drive_pool(POOL_MATCHES, POOL_TICKS, "cpu", True, config=config, plane=True)
        for leg, run in (("on", on), ("eager", eager), ("off", off), ("cpu", cpu)):
            check(run["cores"] == {("InputQueue", "NativeEndpointCore")},
                  f"plane {name} {leg}: the sessions ran {run['cores']}")
            check(run["desyncs"] == 0 and run["around"] == 0, f"plane {name} {leg}: desync")
        for leg, run in (("eager", eager), ("off", off), ("cpu", cpu)):
            check(run["frames_reached"] == on["frames_reached"], f"plane {name}: frames != {leg}")
            check(all(trees_equal(a, b) for a, b in zip(on["states"], run["states"])),
                  f"plane {name}: live states != {leg}")
            check(on["last_checksums"] == run["last_checksums"],
                  f"plane {name}: ring checksums != {leg}")
            check(on["sent"] == run["sent"], f"plane {name}: sent checksums != {leg}")
        stats = on["plane"]
        check(stats["hits"] > 0, f"plane {name}: the plane served no prediction")
        check(stats["ticks"] == POOL_TICKS and len(stats["copies_per_tick"]) == PLANE_PROFILED,
              f"plane {name}: {stats['ticks']} plane ticks")
        for leg, run in (("eager twin", eager), ("CPU run", cpu)):
            check({k: v for k, v in stats.items() if k not in timing}
                  == {k: v for k, v in run["plane"].items() if k not in timing},
                  f"plane {name}: plane stats != {leg}")
        check(all(c == {"dtoh": 1, "htod": 1, "graph_launches": 1} for c in stats["copies_per_tick"]),
              f"plane {name}: begin_tick copies {stats['copies_per_tick']}")
        check(all(c == {"dtoh": 1, "htod": 1, "graph_launches": 0}
                  for c in eager["plane"]["copies_per_tick"]),
              f"plane {name}: the eager twin's begin_tick {eager['plane']['copies_per_tick']}")
        check(stats["graphs"] == {"captures": 1, "replays": POOL_TICKS},
              f"plane {name}: the plane's graphs {stats['graphs']}")
        # begin_tick alone, the graph and its eager twin alternating, over
        # the sessions as the drives left them
        begin_us = {"graph": [], "eager_twin": []}
        for _ in range(2):
            begin_us["graph"].append(host_us(on["plane_obj"].begin_tick, calls=PLANE_CALLS))
            begin_us["eager_twin"].append(host_us(eager["plane_obj"].begin_tick,
                                                  calls=PLANE_CALLS))
        keys = ("host_ms_per_tick", "host_ms_sessions", "host_ms_fulfil")
        emit({"phase": "plane", "predictor": name, "begin_tick_host_us_alternating": begin_us, "sessions": POOL_SESSIONS, "ticks": POOL_TICKS,
              "desyncs": 0, "states_equal_on_eager_off_cpu": True, "ring_checksums_equal": True,
              "sent_checksums_equal": True, "plane": stats,
              "eager_twin_host_us_begin_tick": eager["plane"]["host_us_begin_tick"],
              "on": {k: on[k] for k in keys}, "eager_twin": {k: eager[k] for k in keys},
              "off": {k: off[k] for k in keys}})
        total += on["launches"] + eager["launches"] + off["launches"]
    return total


def mesh_chunks(inputs: torch.Tensor) -> list:
    p = inputs.shape[1] - MESH_PROFILED
    return [inputs[:, :MESH_UNTIMED], inputs[:, MESH_UNTIMED:p], inputs[:, p:]]


def mesh_leg(mesh, sessions: int, inputs: torch.Tensor):
    """ChipVM(2) at d = 8 over ``mesh`` (None: unsharded) through
    ``graph_drive``; one capture a phase and one replay a steady tick on
    every shard's carry, one graph launch and at most one copy a tick.
    Returns (batch, the drive's record with the graphs' stats)."""
    vm = ChipVM(2)
    batch = BatchedSessions(vm.advance, vm.init_state_np(), np.zeros(2, np.uint8),
                            batch_size=sessions, check_distance=D, max_prediction=D, mesh=mesh)
    torch.cuda.synchronize()
    g = graph_drive(batch, mesh_chunks(inputs), 1)
    stats = graph_stats(batch.programs)
    steady = inputs.shape[1] - batch.programs.warmup_ticks
    host = g["host_launches_per_tick"]
    check(g["around"] == 0, "mesh: the digest went around state_digest")
    check(stats["captures"] == stats["carries"] * (D + 1)
          and stats["replays"] == stats["carries"] * steady,
          f"mesh: {stats} for {steady} steady ticks")
    check(sum(v for k, v in host.items() if "GraphLaunch" in k) == stats["carries"]
          and sum(host.values()) <= 2 * stats["carries"],
          f"mesh: host launches a tick {host} over {stats['carries']} carries")
    return batch, {"ms_per_tick": g["ms_per_tick"], "untimed_steady_s": g["captures_s"],
                   "digest_launches": g["digest_launches"],
                   "host_launches_per_tick": host, "kernels_per_tick": g["kernels_per_tick"],
                   "device_busy_ms_per_tick": g["busy_ms_per_tick"],
                   "idle_share": g["idle_share"], **stats}


def phase_mesh() -> int:
    """BASELINE config 5's shape: ChipVM(2) sessions at d = 8 over
    ``make_mesh(1)``, ``make_mesh2d(1, 1)`` and ``make_distributed_mesh()``
    under a world-size-1 NCCL group, each bitwise equal to the unsharded
    batch, itself bitwise its eager twin; a corrupted session found through
    the group's all-reduce; a checkpoint saved from the mesh resumed
    unsharded.  Returns the digest launches of the mesh legs."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    total = 0
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            meshes = {"make_mesh(1)": make_mesh(1), "make_mesh2d(1, 1)": make_mesh2d(1, 1),
                      "make_distributed_mesh()": make_distributed_mesh()}
            check(meshes["make_distributed_mesh()"].group is not None,
                  "mesh: make_distributed_mesh() did not take the process group")
            for sessions, ticks in MESH_SIZES:
                inputs = torch.from_numpy(np.random.default_rng(29).integers(
                    0, 256, size=(sessions, ticks, 2)).astype(np.uint8)).cuda()
                flat, flat_rec = mesh_leg(None, sessions, inputs)
                vm = ChipVM(2)
                carry, eager_ms, eager_launches = eager_drive(
                    flat.programs, vm.init_state_np(), np.zeros(2, np.uint8), sessions,
                    mesh_chunks(inputs), 1)
                check(cards_equal(flat.carry, carry) and eager_launches == 2 * ticks,
                      f"mesh at {sessions}: the unsharded graphs' carry != the eager carry")
                del carry
                want = to_numpy(flat.carry)
                legs = {}
                for name, mesh in meshes.items():
                    batch, rec = mesh_leg(mesh, sessions, inputs)
                    launches = rec["digest_launches"]
                    check(batch.verify()["mismatches"] == 0, f"mesh {name}: mismatches")
                    check(launches == 2 * ticks * mesh.size,
                          f"mesh {name}: {launches} digest launches, not 2 per tick per shard")
                    check(trees_equal(to_numpy(batch.carry), want),
                          f"mesh {name} at {sessions}: carry != the unsharded batch")
                    legs[name] = rec
                    total += launches
                emit({"phase": "mesh", "game": "ChipVM(2)", "sessions": sessions,
                      "check_distance": D, "ticks": ticks,
                      "timed_ticks": ticks - MESH_UNTIMED - MESH_PROFILED,
                      "mismatches": 0, "carry_equal_to_unsharded": True,
                      "unsharded_equal_to_eager": True, "sync_debug_mode": "error",
                      "unsharded": flat_rec,
                      "eager": {"ms_per_tick": eager_ms, "digest_launches": eager_launches},
                      "meshes": legs})
                del flat, legs
                torch.cuda.empty_cache()
            # corruption through the all-reduce, and a checkpoint that resumes
            # unsharded: BASELINE config 5's 256 sessions
            sessions, ticks = MESH_SIZES[0]
            inputs = torch.from_numpy(np.random.default_rng(31).integers(
                0, 256, size=(sessions, 2 * ticks, 2)).astype(np.uint8)).cuda()
            mesh = meshes["make_distributed_mesh()"]
            vm = ChipVM(2)

            def fresh(m=None):
                return BatchedSessions(vm.advance, vm.init_state_np(), np.zeros(2, np.uint8),
                                       batch_size=sessions, check_distance=D, max_prediction=D,
                                       mesh=m)

            sharded, whole = fresh(mesh), fresh()
            sharded.run_ticks(inputs[:, :ticks], check=False)
            whole.run_ticks(inputs[:, :ticks], check=False)
            path = os.path.join(tmp, "mesh_ckpt.npz")
            sharded.save_checkpoint(path)
            resumed = fresh()
            resumed.load_checkpoint(path)
            check(resumed.current_frame == ticks, "mesh: checkpoint frame")
            for b in (resumed, whole):
                b.run_ticks(inputs[:, ticks:], check=False)
            check(trees_equal(to_numpy(resumed.carry), to_numpy(whole.carry)),
                  "mesh: the checkpoint resumed unsharded != the uninterrupted run")
            # the next tick loads frame ticks - D: corrupt that saved state's
            # memory, so every resimulated frame from ticks - D + 1 differs
            slot = (ticks - D) % sharded._programs.ring.length
            rows = sessions // mesh.size
            shard, row = divmod(MESH_CORRUPT_SESSION, rows)
            sharded.shard_carries[shard]["ring"]["states"]["mem"][row, slot] += 1
            bad = sharded.run_ticks(inputs[:, ticks:ticks + 4])
            check(bad["mismatches"] >= 1 and bad["first_bad"] == ticks - D + 1,
                  f"mesh: the corruption was not found through the all-reduce ({bad})")
            emit({"phase": "mesh", "corrupted_session": MESH_CORRUPT_SESSION,
                  "found_through": "torch.distributed.all_reduce (NCCL, world size 1)",
                  "stats": bad, "checkpoint_resumed_unsharded_equal": True,
                  "checkpoint_bytes": os.path.getsize(path)})
        finally:
            dist.destroy_process_group()
    return total


# -- phase 16: the host session bank ------------------------------------------


class DigestSocket:
    """A ``FakeSocket`` whose sent datagrams fold into one sha256, through
    whichever send entry the session or the pool uses."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.digest = hashlib.sha256()

    def _note(self, data, addr) -> None:
        data = bytes(data)
        self.digest.update(f"{addr}|{len(data)}|".encode())
        self.digest.update(data)

    def send_to(self, msg, addr) -> None:
        self._note(msg.encode(), addr)
        self.inner.send_to(msg, addr)

    def send_datagram(self, data, addr) -> None:
        self._note(data, addr)
        self.inner.send_datagram(data, addr)

    def send_datagram_batch(self, items) -> None:
        for data, addr in items:
            self._note(data, addr)
        self.inner.send_datagram_batch(items)

    def receive_all_datagrams(self):
        return self.inner.receive_all_datagrams()

    def receive_all_messages(self):
        return self.inner.receive_all_messages()


@contextlib.contextmanager
def env_set(values: dict):
    """The environment with ``values`` set, restored afterwards."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def no_device_reads(card: bool):
    """On the card: the sync debug mode "error", so a device->host read
    fails the run."""
    if card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        if card:
            torch.cuda.set_sync_debug_mode(0)


def bank_raw_inputs(blobs: np.ndarray, statuses: np.ndarray) -> np.ndarray:
    """``raw_inputs_to_array`` of ``boxgame_config()``: one byte per player."""
    return blobs[:, :, 0]


def drive_bank(n_matches: int, ticks: int, device, leg: str, fault: bool = False,
               profiled_ticks: int = 0, fault_tick: int = BANK_FAULT_TICK,
               record_events: bool = False) -> dict:
    """``bench.py``'s match population (``_match_population``: two-peer
    BoxGame matches, rng seeds 3 + 5m + me, its input schedule, no desync
    detection) over phase 7's seeded faults (one network per match) on a
    fake 16 ms clock, every
    session fulfilled by one ``BatchedRequestExecutor`` (ring 10, max_burst
    9, checksums on) on ``device``.  ``leg``: "bank" is ``HostedPool`` on the
    native bank, "nofastpath" the same under ``GGRS_TPU_NO_FASTPATH=1``,
    "fallback" under ``GGRS_TPU_NO_NATIVE=1`` (the pool's Python fallback),
    "sessions" per-session ``P2PSession``s into one ``run(lists)``.  On the
    card the whole tick runs under the sync debug mode "error"; the last
    ``profiled_ticks`` ticks' fulfilment runs alone under the profiler and
    is left out of the host times.  ``fault`` injects a slot error into
    ``BANK_FAULT_SLOT`` at ``fault_tick``.  ``record_events`` folds every
    session's events of every tick into a digest too."""
    clock = [0]
    socks, builders, nets = [], [], []
    for m in range(n_matches):
        # one network per match (phase 7's faults, seeded per match), so
        # that no fault stream couples two matches and the fault leg's
        # other matches stay comparable with the fault-free run
        net = InMemoryNetwork(**{**P2P_NET, "seed": P2P_NET["seed"] + m})
        nets.append(net)
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            socks.append(DigestSocket(net.socket(names[me])))
            builders.append(SessionBuilder(boxgame_config()).with_clock(lambda: clock[0])
                            .with_rng(random.Random(3 + 5 * m + me))
                            .add_player(Local(), me).add_player(Remote(names[1 - me]), 1 - me))
    B = len(socks)
    game = BoxGame(2)
    ex = BatchedRequestExecutor(game.advance, game.init_state_np(), executor_inputs,
                                batch_size=B, ring_length=POOL_RING, max_burst=POOL_MAX_BURST,
                                device=device, raw_inputs_to_array=bank_raw_inputs)
    ex.warmup(np.zeros(2, np.uint8))
    card = ex.device.type == "cuda"
    predicted = 0
    real_tick = ex._tick

    def tick_counted(desc):
        nonlocal predicted
        predicted += pool_predicted(desc)
        return real_tick(desc)

    ex._tick = tick_counted
    host = sessions = None
    if leg == "sessions":
        sessions = [b.start_p2p_session(s) for b, s in zip(builders, socks)]
    else:
        host = HostSessionPool()
        for b, s in zip(builders, socks):
            host.add_session(b, s)
        with env_set(BANK_ENV[leg]):
            native = host.native_active  # finalized at clock 0, as the sessions start
        check(native == (leg in ("bank", "nofastpath")), f"bank {leg}: native_active {native}")
        hosted = HostedPool(host, ex)
    summaries = [hashlib.sha256() for _ in range(B)]
    events = [hashlib.sha256() for _ in range(B)]
    rows = {"quiet": 0, "resim": 0, "save_only": 0, "eager": 0}
    host_s = {"stage": 0.0, "advance": 0.0, "run": 0.0}
    counting = [True]
    last_reqs = [None]

    def timed_call(key, fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            if counting[0]:
                host_s[key] += time.perf_counter() - t0
            return out
        return call

    run = timed_call("run", ex.run)
    if host is not None:
        # HostedPool.tick calls these three: each timed where it runs
        host.stage_inputs = timed_call("stage", host.stage_inputs)
        advance_all = host.advance_all

        def keep(reqs):
            last_reqs[0] = reqs
            return reqs

        host.advance_all = timed_call("advance", lambda: keep(advance_all()))
        ex.run = run
    prof, evicted_lead, crossings_ok = [], None, True
    timed = ticks - (profiled_ticks if card else 0)
    state_digest.launches = lane_sums_rows.launches = 0
    for i in range(ticks):
        clock[0] += 16
        items = [(b, b % 2, pool_sched(b // 2, b % 2, i)) for b in range(B)]
        if fault and i == fault_tick:
            host.inject_slot_error(BANK_FAULT_SLOT)
        counting[0] = i < timed
        with no_device_reads(card):
            if host is None:
                timed_call("stage", lambda: [sessions[b].add_local_input(h, v)
                                             for b, h, v in items])()
                reqs = timed_call("advance", lambda: [s.advance_frame() for s in sessions])()
                if i < timed:
                    run(reqs)
            elif i < timed:
                hosted.tick(items)
                reqs = last_reqs[0]
            else:
                host.stage_inputs(items)
                reqs = host.advance_all()
        if i >= timed:
            prof.append(profile_device(lambda: guarded_run(ex.run, reqs, card), 1))
        if host is not None:
            crossings_ok &= host.crossings == (i + 1 if native else 0)
            plan = host._plan
            if plan is not None:
                rows["quiet"] += int(plan.quiet_rows.size)
                rows["resim"] += len(plan.resim_rows)
                rows["save_only"] += len(plan.save_only_rows)
                rows["eager"] += len(plan.eager_rows)
            if fault and evicted_lead is None and host.slot_state(BANK_FAULT_SLOT) == "evicted":
                evicted_lead = request_summary(reqs[BANK_FAULT_SLOT])[:1]
        for b in range(B):
            summaries[b].update(repr(request_summary(reqs[b])).encode())
            if record_events:
                evs = sessions[b].events() if host is None else host.events(b)
                events[b].update(repr([repr(e) for e in evs]).encode())
        for net in nets:
            net.tick()
    ex.block_until_ready()
    launches = state_digest.launches
    states = [ex.live_state(b) for b in range(B)]
    last = [int(f) for f in ex._host_frames.max(axis=1)]
    kernels = busy = None
    if prof:
        kernels = sum(r["kernels"] for r in prof) / len(prof)
        busy = sum(r["busy_us"] for r in prof) / len(prof) / 1e3
    host_ms = {k: v / timed * 1e3 for k, v in host_s.items()}
    tick_ms = sum(host_ms.values())
    frames = [s.current_frame for s in sessions] if host is None else \
        [host.current_frame(b) for b in range(B)]
    confirmed = [s._sync_layer.last_confirmed_frame for s in sessions] if host is None else \
        [host.last_confirmed_frame(b) for b in range(B)]
    return {
        "leg": leg, "launches": launches, "around": lane_sums_rows.launches,
        "predicted": predicted, "states": states, "frames": frames, "confirmed": confirmed,
        "last_checksums": [ex.ring_checksum(b, f) for b, f in enumerate(last)],
        "summaries": [h.hexdigest() for h in summaries],
        "events": [h.hexdigest() for h in events] if record_events else None,
        "sent": [s.digest.hexdigest() for s in socks], "rows": rows,
        "crossings": None if host is None else host.crossings,
        "harvests": None if host is None else host.harvests,
        "crossings_one_per_tick": crossings_ok,
        "slot_states": None if host is None else [host.slot_state(b) for b in range(B)],
        "transitions": None if host is None else host.drain_state_transitions(),
        "evicted_lead": evicted_lead, "executor": ex,
        "host_ms": host_ms, "host_ms_per_tick": tick_ms,
        "kernels_per_tick": kernels, "device_busy_ms_per_tick": busy,
        "idle_share": None if busy is None else 1 - busy / tick_ms,
        "quiet_share": rows["quiet"] / (B * ticks),
    }


BANK_KEYS = ("states", "frames", "last_checksums", "summaries", "sent")


def bank_equal(a: dict, b: dict, sessions=None) -> list:
    """The keys on which two legs differ, over ``sessions`` (all by default)."""
    idx = range(len(a["frames"])) if sessions is None else sessions
    bad = []
    for k in BANK_KEYS:
        same = all(trees_equal(a[k][i], b[k][i]) if k == "states" else a[k][i] == b[k][i]
                   for i in idx)
        if not same:
            bad.append(k)
    return bad


def phase_bank() -> int:
    """Phase 16: ``HostedPool`` on the native bank against its reference
    decoder, the pool's Python fallback, per-session sessions and a CPU
    rerun, at 64 sessions for 180 ticks and 512 for 24; then the fault leg.
    Returns the digest launches of the card's bank drives."""
    out, launches = [], 0
    for matches, ticks in ((POOL_MATCHES, POOL_TICKS), (POOL_BIG_MATCHES, POOL_BIG_TICKS)):
        runs = {leg: drive_bank(matches, ticks, None, leg,
                                profiled_ticks=BANK_PROFILED if leg in ("bank", "sessions") else 0)
                for leg in BANK_LEGS}
        runs["cpu"] = drive_bank(matches, ticks, "cpu", "bank")
        a = runs["bank"]
        for leg, run in runs.items():
            bad = bank_equal(a, run)
            check(not bad, f"bank {2 * matches}: leg {leg} differs from the bank on {bad}")
            check(run["around"] == 0, f"bank {leg}: the digest went around state_digest")
            if leg != "cpu":  # CPU tensors take the plain version: no launch
                check(run["launches"] == run["predicted"],
                      f"bank {leg}: {run['launches']} digest launches, "
                      f"predicted {run['predicted']}")
        check(a["crossings"] == ticks and a["crossings_one_per_tick"] and a["harvests"] == 0,
              f"bank: {a['crossings']} ggrs_bank_tick crossings in {ticks} ticks")
        check(runs["fallback"]["crossings"] == 0, "bank fallback: the pool crossed into the bank")
        check(a["rows"]["quiet"] > 0 and a["rows"]["resim"] > 0,
              f"bank: quiet and resim rows not both taken: {a['rows']}")
        check(runs["nofastpath"]["rows"]["quiet"] == 0, "bank nofastpath: the plan was used")
        launches += sum(runs[leg]["launches"] for leg in BANK_LEGS)
        keys = ("host_ms", "host_ms_per_tick", "kernels_per_tick", "device_busy_ms_per_tick",
                "idle_share", "quiet_share", "rows")
        emit({"phase": "bank", "game": "BoxGame(2)", "sessions": 2 * matches, "ticks": ticks,
              "network": P2P_NET, "with_checksums": True, "sync_debug_mode": "error",
              "legs_bitwise_equal": sorted(runs), "crossings_per_tick": a["crossings"] / ticks,
              "profiled_ticks": BANK_PROFILED,
              "frames_min": min(a["frames"]), "confirmed_min": min(a["confirmed"]),
              "bank": {k: a[k] for k in keys},
              "sessions_leg": {k: runs["sessions"][k] for k in keys},
              "nofastpath_host_ms_per_tick": runs["nofastpath"]["host_ms_per_tick"],
              "fallback_host_ms_per_tick": runs["fallback"]["host_ms_per_tick"],
              "digest_launches": {leg: runs[leg]["launches"] for leg in BANK_LEGS},
              "digest_launches_predicted": a["predicted"],
              "digest_launches_per_tick": a["launches"] / ticks})
        out.append(a)
    # the fault leg: one slot of the 64-session bank faults at tick 60
    a = out[0]
    f = drive_bank(POOL_MATCHES, POOL_TICKS, None, "bank", fault=True)
    launches += f["launches"]
    mate = BANK_FAULT_SLOT ^ 1
    others = [b for b in range(2 * POOL_MATCHES) if b // 2 != BANK_FAULT_SLOT // 2]
    states = f["slot_states"]
    check(states[BANK_FAULT_SLOT] == "evicted", f"bank fault: slot ended {states[BANK_FAULT_SLOT]}")
    check(all(states[b] == "native" for b in range(len(states)) if b != BANK_FAULT_SLOT),
          "bank fault: another slot left the bank")
    moves = [(old, new) for slot, old, new, _ in f["transitions"] if slot == BANK_FAULT_SLOT]
    check(moves == [("native", "quarantined"), ("quarantined", "evicted")],
          f"bank fault: transitions {moves}")
    check(f["evicted_lead"] and f["evicted_lead"][0][0] == "LoadGameState",
          f"bank fault: the evicted slot's list leads with {f['evicted_lead']}")
    bad = bank_equal(a, f, others)
    check(not bad, f"bank fault: the other matches' sessions differ on {bad}")
    check(f["crossings"] == POOL_TICKS and f["harvests"] == 1,
          f"bank fault: {f['crossings']} crossings, {f['harvests']} harvests")
    check(f["launches"] == f["predicted"], "bank fault: digest launches != predicted")
    ex = f["executor"]
    common = min(f["confirmed"][BANK_FAULT_SLOT], f["confirmed"][mate])
    check(common > POOL_TICKS - 40, f"bank fault: the match stalled at {common}")
    check(trees_equal(ex.ring_state(BANK_FAULT_SLOT, common), ex.ring_state(mate, common)),
          f"bank fault: the faulted match's peers differ at frame {common}")
    emit({"phase": "bank", "fault": "inject_slot_error", "slot": BANK_FAULT_SLOT,
          "tick": BANK_FAULT_TICK, "sessions": 2 * POOL_MATCHES, "ticks": POOL_TICKS,
          "transitions": moves, "evicted_list_leads_with": f["evicted_lead"][0][0],
          "others_bitwise_equal_to_fault_free": len(others), "peers_equal_at_frame": common,
          "crossings": f["crossings"], "harvests": f["harvests"],
          "host_ms_per_tick": f["host_ms_per_tick"]})
    return launches


# -- phase 17: the bank's datapath and broadcast on real sockets ----------------


class TapSocket:
    """A ``UdpNonBlockingSocket`` of an endpoint outside the pool (a peer or
    a real viewer) that keeps every datagram it sends and receives, with its
    address, in order: the host's sent bytes are read at their receivers."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.sent, self.received = [], []

    def local_port(self) -> int:
        return self.inner.local_port()

    def send_to(self, msg, addr) -> None:
        self.send_datagram(msg.encode(), addr)

    def send_datagram(self, data, addr) -> None:
        self.sent.append((addr, bytes(data)))
        self.inner.send_datagram(data, addr)

    def send_datagram_batch(self, items) -> None:
        for data, addr in items:
            self.send_datagram(data, addr)

    def receive_all_datagrams(self):
        got = self.inner.receive_all_datagrams()
        self.received.extend(got)
        return got

    def receive_all_messages(self):
        out = []
        for src, data in self.receive_all_datagrams():
            try:
                out.append((src, Message.decode(data)))
            except WireError:
                continue
        return out

    def close(self) -> None:
        self.inner.close()


class AckingViewer:
    """``bench.py``'s ``_AckingViewer``: a bare UDP endpoint that acks the
    newest input frame it saw once a tick (the host's stuck-viewer rule
    never fires) without ticking a whole ``SpectatorSession``."""

    def __init__(self, host_addr) -> None:
        self.sock = TapSocket(UdpNonBlockingSocket(0))
        self.addr = ("127.0.0.1", self.sock.local_port())
        self.host = host_addr
        self.last = -1

    def tick(self) -> None:
        saw = False
        for _, msg in self.sock.receive_all_messages():
            if isinstance(msg.body, InputMessage):
                if msg.body.start_frame > self.last:
                    self.last = msg.body.start_frame
                saw = True
        if saw:
            self.sock.send_to(Message(0x5150, InputAck(self.last)), self.host)


def datapath_leg_spec(leg: str) -> dict:
    """Leg (a): the pump over per-slot sockets; (b) the Python shuttle with
    the send and receive tables over per-slot sockets; (c) every slot a view
    on one ``DispatchHub(siblings=1)``; (d) leg (c) without GSO and GRO;
    (e) leg (a) with the thread decode backend; (f) leg (a) on the CPU;
    (g) leg (b) under ``GGRS_TPU_NO_RECV_TABLE=1``."""
    return {
        "a": dict(native_io=True, host="private", env={}),
        "b": dict(native_io=False, host="private", env={}),
        "c": dict(native_io=False, host="dispatch", env={}),
        "d": dict(native_io=False, host="dispatch",
                  env={"GGRS_TPU_NO_GSO": "1", "GGRS_TPU_NO_GRO": "1"}),
        "e": dict(native_io=True, host="private", env={"GGRS_TPU_DECODE_BACKEND": "thread"}),
        "f": dict(native_io=True, host="private", env={}),
        "g": dict(native_io=False, host="private", env={"GGRS_TPU_NO_RECV_TABLE": "1"}),
    }[leg]


def udp_drops():
    """The kernel's UDP receive-buffer drops so far (``/proc/net/snmp``), or
    None where the kernel does not report them (the legs' bitwise equality
    still catches a drop)."""
    try:
        with open("/proc/net/snmp") as f:
            rows = [line.split() for line in f if line.startswith("Udp:")]
        return int(rows[1][rows[0].index("RcvbufErrors")])
    except (OSError, IndexError, ValueError):
        return None


def segmented_send() -> dict:
    """Does this kernel take a real UDP_SEGMENT send on loopback?  The
    library's probe only sets the socket option; a kernel that refuses the
    segmented send itself makes the send table retreat to one datagram a
    record, which leaves the GSO counters at 0."""
    rx = pysocket.socket(pysocket.AF_INET, pysocket.SOCK_DGRAM)
    tx = pysocket.socket(pysocket.AF_INET, pysocket.SOCK_DGRAM)
    try:
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(1.0)
        seg = struct.pack("=H", 32)
        tx.sendmsg([b"a" * 32, b"b" * 32], [(pysocket.IPPROTO_UDP, 103, seg)], 0,
                   rx.getsockname())  # 103: UDP_SEGMENT
        got = [rx.recv(64), rx.recv(64)]
        return {"accepted": got == [b"a" * 32, b"b" * 32], "errno": None}
    except OSError as e:
        return {"accepted": False, "errno": e.errno}
    finally:
        rx.close()
        tx.close()


def role_digests(n: int, host_addrs, peers, viewers) -> dict:
    """sha256 per socket role of the datagrams it sent, addresses mapped to
    roles: the host's sends as its receivers got them (per receiver, in
    order), the peers' and viewers' at their send wrappers."""
    out = {}
    for m in range(n):
        roles = {peers[m][1].sock_addr: "peer"}
        for k, v in enumerate(viewers[m]):
            roles[v["addr"]] = f"viewer{k}"
        host = hashlib.sha256()
        for role, tap in [("peer", peers[m][1])] + [(f"viewer{k}", v["tap"])
                                                    for k, v in enumerate(viewers[m])]:
            for src, data in tap.received:
                if src == host_addrs[m]:
                    host.update(f"{role}|{len(data)}|".encode() + bytes(data))
        out[f"host {m}"] = host.hexdigest()
        for role, tap in [("peer", peers[m][1])] + [(f"viewer{k}", v["tap"])
                                                    for k, v in enumerate(viewers[m])]:
            h = hashlib.sha256()
            for dst, data in tap.sent:
                h.update(f"{'host' if dst == host_addrs[m] else roles.get(dst, '?')}|"
                         f"{len(data)}|".encode() + data)
            out[f"{role} {m}" if role == "peer" else f"viewer {m}.{role[6:]}"] = h.hexdigest()
    return out


def raise_fd_limit() -> None:
    """Raise the soft limit on open descriptors to the hard limit; fail,
    naming the limit, when even that is below what phase 17 holds."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = hard if hard != resource.RLIM_INFINITY else max(soft, FDS_NEEDED)
    if soft < want:
        resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
    soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    check(soft == resource.RLIM_INFINITY or soft >= FDS_NEEDED,
          f"RLIMIT_NOFILE is {soft} (hard {hard}); phase 17 needs {FDS_NEEDED} descriptors")


def drive_datapath(population: str, leg: str, device=None, fault: bool = False,
                   journal_dir=None, profiled: int = 0) -> dict:
    """One leg of phase 17 over real loopback UDP on a fake 16 ms clock.

    Population "A" is ``bench.py``'s ``run_host_bank_io`` topology on phase
    16's game: ``DATAPATH_MATCHES`` two-peer ``BoxGame(2)`` matches (host
    slot in the pool, peer an outside ``P2PSession``, rng seeds 3 + 5m and
    4 + 5m, phase 16's inputs), ``DATAPATH_VIEWERS`` viewers per match
    attached through ``SpectatorHub(pool, rng=random.Random(99))`` before
    the first tick (viewer 0 of the first ``DATAPATH_JOURNALED`` matches a
    real ``SpectatorSession``, the rest acking viewers), those matches
    journaled through ``hub.attach_journal``; ``DATAPATH_WARMUP`` +
    ``DATAPATH_TICKS`` ticks.  Population "B" is ``run_inbound_gen2``'s
    shape: ``INBOUND_MATCHES`` matches, no viewers, ``INBOUND_TICKS`` ticks.
    The pool feeds one ``BatchedRequestExecutor`` (checksums on) through
    ``HostedPool``.  ``fault`` storms slot ``DATAPATH_FAULT_SLOT`` with
    ENOBUFS, then makes it fail with EPERM with its native harvest gone."""
    spec = datapath_leg_spec(leg)
    a_pop = population == "A"
    n = DATAPATH_MATCHES if a_pop else INBOUND_MATCHES
    warmup, ticks = (DATAPATH_WARMUP, DATAPATH_TICKS) if a_pop else (INBOUND_WARMUP, INBOUND_TICKS)
    total = warmup + ticks
    game = BoxGame(2)
    ex = BatchedRequestExecutor(game.advance, game.init_state_np(), executor_inputs,
                                batch_size=n, ring_length=POOL_RING, max_burst=POOL_MAX_BURST,
                                device=device, raw_inputs_to_array=bank_raw_inputs)
    ex.warmup(np.zeros(2, np.uint8))
    card = ex.device.type == "cuda"
    predicted = 0
    real_tick = ex._tick

    def tick_counted(desc):
        nonlocal predicted
        predicted += pool_predicted(desc)
        return real_tick(desc)

    ex._tick = tick_counted
    clock = [0]

    def builder(seed, me, other):
        return (SessionBuilder(boxgame_config()).with_clock(lambda: clock[0])
                .with_rng(random.Random(seed)).add_player(Local(), me)
                .add_player(Remote(other), 1 - me))

    drops0 = udp_drops()
    with env_set(spec["env"]):
        pool = HostSessionPool(native_io=spec["native_io"])
        hub = SpectatorHub(pool, rng=random.Random(99)) if a_pop else None
        dhub = DispatchHub(siblings=1) if spec["host"] == "dispatch" else None
        host_socks, host_addrs, peers, viewers, journals = [], [], [], [], {}
        for m in range(n):
            sock = dhub.view() if dhub is not None else UdpNonBlockingSocket(0)
            host_addr = ("127.0.0.1", sock.local_port())
            tap = TapSocket(UdpNonBlockingSocket(0))
            tap.sock_addr = ("127.0.0.1", tap.local_port())
            pool.add_session(builder(3 + 5 * m, 0, tap.sock_addr), sock)
            peers.append((builder(4 + 5 * m, 1, host_addr).start_p2p_session(tap), tap))
            host_socks.append(sock)
            host_addrs.append(host_addr)
            viewers.append([])
        for m in range(n if a_pop else 0):
            for k in range(DATAPATH_VIEWERS):
                if k == 0 and m < DATAPATH_JOURNALED:
                    tap = TapSocket(UdpNonBlockingSocket(0))
                    sess = (SessionBuilder(boxgame_config()).with_clock(lambda: clock[0])
                            .with_rng(random.Random(7000 + 13 * m))
                            .start_spectator_session(host_addrs[m], tap))
                    v = dict(addr=("127.0.0.1", tap.local_port()), tap=tap, session=sess,
                             stream=[])
                else:
                    ack = AckingViewer(host_addrs[m])
                    v = dict(addr=ack.addr, tap=ack.sock, acker=ack)
                viewers[m].append(v)
                hub.attach(m, v["addr"])
            if m < DATAPATH_JOURNALED:
                journals[m] = MatchJournal(os.path.join(journal_dir, f"{leg}{'-fault' if fault else ''}"
                                                        f"-{m}.ggjl"),
                                           2, boxgame_config().native_input_size)
                hub.attach_journal(m, journals[m])
        check(pool.native_active, f"datapath {population}{leg}: the native bank did not engage")
        if spec["native_io"]:
            states = [pool.io_state(m) for m in range(n)]
            check(pool.native_io_active and states == ["native"] * n,
                  f"datapath {population}{leg}: io states {sorted(set(states))}")
        hosted = HostedPool(pool, ex)
        summaries = [hashlib.sha256() for _ in range(2 * n)]
        host_ms, run_ms, prof = [], [], []
        # HostedPool.tick calls these two, then ex.run: each marks its time
        marks = {}
        stage_inputs, advance_all = pool.stage_inputs, pool.advance_all

        def stage_marked(items):
            marks["stage"] = time.perf_counter()
            stage_inputs(items)

        def advance_marked():
            marks["reqs"] = advance_all()
            marks["advanced"] = time.perf_counter()
            return marks["reqs"]

        pool.stage_inputs, pool.advance_all = stage_marked, advance_marked
        timed_from = warmup
        profiled_from = total - (profiled if card else 0)
        io0 = sys0 = None
        evicted_lead = None
        target = DATAPATH_FAULT_SLOT
        storm_errors = None
        state_digest.launches = lane_sums_rows.launches = 0
        for i in range(total):
            clock[0] += 16
            if i == timed_from:
                io0 = pool.io_stats()
                sys0 = (dhub.io_syscalls if dhub is not None
                        else sum(s.io_syscalls for s in host_socks))
            for m, (peer, _) in enumerate(peers):
                peer.add_local_input(1, pool_sched(m, 1, i))
                reqs = peer.advance_frame()
                for r in reqs:
                    if isinstance(r, SaveGameState):
                        r.cell.save(r.frame, None, None)
                summaries[n + m].update(repr(request_summary(reqs)).encode())
            for group in viewers:
                for v in group:
                    if "acker" in v:
                        v["acker"].tick()
            if fault and i == DATAPATH_STORM_TICK:
                pool.inject_socket_errno(target, errno.ENOBUFS, DATAPATH_STORM)
            if fault and i == DATAPATH_EPERM_TICK:
                storm_errors = (pool.slot_state(target), pool.io_stats()["send_errors"])
                harvest = pool._harvest

                def dead_harvest(index, harvest=harvest):
                    if index == target:
                        raise RuntimeError("the slot's native state is gone")
                    return harvest(index)

                pool._harvest = dead_harvest
                pool.inject_socket_errno(target, errno.EPERM, 1)
            items = [(m, 0, pool_sched(m, 0, i)) for m in range(n)]
            if fault:
                # the fault slot stages in Python (add_local_input): an
                # eviction that resumes from the journal has no harvest to
                # carry inputs staged in the bank (as in the JAX pool)
                pool.add_local_input(*items.pop(target))
            with no_device_reads(card):
                if i < profiled_from:
                    hosted.tick(items)
                    done = time.perf_counter()
                else:
                    pool.stage_inputs(items)
                    pool.advance_all()
            reqs = marks["reqs"]
            if i >= profiled_from:
                prof.append(profile_device(lambda: guarded_run(ex.run, reqs, card), 1))
            elif i >= timed_from:
                host_ms.append((marks["advanced"] - marks["stage"]) * 1e3)
                run_ms.append((done - marks["advanced"]) * 1e3)
            for m in range(n):
                summaries[m].update(repr(request_summary(reqs[m])).encode())
            if fault and evicted_lead is None and pool.slot_state(target) == "evicted":
                evicted_lead = request_summary(reqs[target])[:1]
            for group in viewers:
                for v in group:
                    if "session" in v:
                        try:
                            got = v["session"].advance_frame()
                        except (NotSynchronized, PredictionThreshold):
                            continue
                        v["stream"].extend(tuple(p[0] for p in r.inputs) for r in got)
        ex.block_until_ready()
        launches = state_digest.launches
        around = lane_sums_rows.launches
        io1 = pool.io_stats()
        sys1 = dhub.io_syscalls if dhub is not None else sum(s.io_syscalls for s in host_socks)
        caps = pool.io_capabilities()
    for _, tap in peers:
        tap.receive_all_datagrams()  # the last tick's sends onto the tapes
    for group in viewers:
        for v in group:
            v["tap"].receive_all_datagrams()
    counted = (io1["recv_calls"] + io1["send_calls"] + io1["drain"]["recv_calls"]
               - io0["recv_calls"] - io0["send_calls"] - io0["drain"]["recv_calls"]
               + sys1 - sys0)
    busy = sum(r["busy_us"] for r in prof) / len(prof) / 1e3 if prof else None
    tick_ms = float(np.mean(host_ms) + np.mean(run_ms))
    last = [int(f) for f in ex._host_frames.max(axis=1)]
    grafted = None
    if fault:
        grafted = sorted(repr(a) for a in pool.session(target)._player_reg.spectators)
    out = {
        "leg": leg, "population": population, "executor": ex, "pool": pool,
        "launches": launches, "around": around, "predicted": predicted,
        "states": [ex.live_state(b) for b in range(n)],
        "last_checksums": [ex.ring_checksum(b, f) for b, f in enumerate(last)],
        "frames": [pool.current_frame(m) for m in range(n)] + [p.current_frame for p, _ in peers],
        "confirmed": [pool.last_confirmed_frame(m) for m in range(n)],
        "summaries": [h.hexdigest() for h in summaries],
        "sent": role_digests(n, host_addrs, peers, viewers),
        "streams": [v["stream"] for group in viewers for v in group if "stream" in v],
        "io": io1, "capabilities": caps, "crossings": pool.crossings,
        "drain_crossings": pool.drain_crossings,
        "crossings_one_per_tick": pool.crossings == total,
        "slot_states": [pool.slot_state(m) for m in range(n)],
        "fault_log": [f.detail for f in pool.fault_log(target)] if fault else None,
        "evicted_lead": evicted_lead, "storm": storm_errors, "grafted": grafted,
        "journal_next": {m: j.next_frame for m, j in journals.items()},
        "journal_paths": {m: j.path for m, j in journals.items()},
        "viewer_frames": [v["session"].current_frame for group in viewers for v in group
                          if "session" in v],
        "udp_drops": None if drops0 is None else udp_drops() - drops0,
        "syscalls_counted_per_tick": counted / (total - timed_from),
        "host_ms_p50": float(np.percentile(host_ms, 50)),
        "host_ms_p99": float(np.percentile(host_ms, 99)),
        "run_ms_per_tick": float(np.mean(run_ms)),
        "kernels_per_tick": sum(r["kernels"] for r in prof) / len(prof) if prof else None,
        "device_busy_ms_per_tick": busy,
        "idle_share": None if busy is None else 1 - busy / tick_ms,
        "fds": len(dhub.filenos()) if dhub is not None else n,
    }
    for j in journals.values():
        j.close()
    for s in host_socks:
        s.close()
    if dhub is not None:
        out["rcvbuf"] = [pysocket.socket(fileno=os.dup(fd)).getsockopt(
            pysocket.SOL_SOCKET, pysocket.SO_RCVBUF) for fd in dhub.filenos()]
        dhub.close()
    for _, tap in peers:
        tap.close()
    for group in viewers:
        for v in group:
            v["tap"].close()
    return out


DATAPATH_KEYS = ("states", "last_checksums", "frames", "summaries", "sent", "streams")


def datapath_equal(a: dict, b: dict, matches=None) -> list:
    """The keys on which two legs differ, over ``matches`` (all by default:
    host rows, peers, socket roles and real viewers of those matches)."""
    n = len(a["confirmed"])
    idx = range(n) if matches is None else matches
    bad = []
    for k in DATAPATH_KEYS:
        if k == "sent":
            keep = lambda role: int(role.split()[1].split(".")[0]) in idx
            same = {r: d for r, d in a[k].items() if keep(r)} == \
                {r: d for r, d in b[k].items() if keep(r)}
        elif k == "streams":
            same = all(a[k][m] == b[k][m] for m in range(len(a[k])) if m in idx)
        elif k in ("frames", "summaries"):
            same = all(a[k][m] == b[k][m] and a[k][n + m] == b[k][n + m] for m in idx)
        elif k == "states":
            same = all(trees_equal(a[k][m], b[k][m]) for m in idx)
        else:
            same = all(a[k][m] == b[k][m] for m in idx)
        if not same:
            bad.append(k)
    return bad


def datapath_replay(run: dict) -> list:
    """The journals of leg (a) replayed: each reproduces its real viewer's
    confirmed stream, and the fused scrub on the card, digested, equals the
    host's ring checksum at the newest ring frame the journal covers."""
    ex, game, out = run["executor"], BoxGame(2), []
    scrub = build_scrub_program(game.advance)
    for m, path in sorted(run["journal_paths"].items()):
        rs = ReplaySession(path, boxgame_config())
        check(rs.closed and not rs.truncated and not rs.gaps and rs.first_frame == 0,
              f"datapath replay {m}: the journal does not read back whole")
        stream = run["streams"][m]
        played = []
        while rs.frames_remaining():
            played.extend(tuple(v for v, _ in r.inputs) for r in rs.advance_frame())
        check(len(stream) > DATAPATH_TICKS and played[:len(stream)] == stream,
              f"datapath replay {m}: the journal != the viewer's stream "
              f"({len(played)} journaled, {len(stream)} viewed)")
        end = rs.last_frame + 1
        ring = [int(f) for f in ex._host_frames[m] if 0 < f <= end]
        check(ring, f"datapath replay {m}: no ring frame at or below the journal's end {end}")
        frame = max(ring)
        rs.seek(0)
        inputs, _ = rs.stacked_inputs(frame)
        state = scrub(game.init_state_np(), np.asarray(inputs, np.uint8))
        lanes = checksum_device(tree_map(lambda leaf: leaf.unsqueeze(0), state))
        digest = checksum_to_u128(lanes[0])
        check(digest == ex.ring_checksum(m, frame)
              and trees_equal(to_numpy(state), ex.ring_state(m, frame)),
              f"datapath replay {m}: the scrub's digest at frame {frame} != the host's ring")
        out.append({"match": m, "journal_frames": end, "viewer_frames": len(stream),
                    "scrub_frame": frame})
    return out


def phase_datapath(cases: dict) -> int:
    """Phase 17: the bank over real loopback UDP.  Returns the digest
    launches of the card's legs."""
    launches = 0
    with open("/proc/sys/net/core/rmem_max") as f:
        rmem_max = int(f.read())
    seg = segmented_send()
    emit({"phase": "datapath", "rmem_max": rmem_max,
          "rlimit_nofile": list(resource.getrlimit(resource.RLIMIT_NOFILE)),
          "gso_supported": net_native.net_lib().ggrs_net_gso_supported(),
          "segmented_send": seg,
          "gro_supported": net_native.net_lib().ggrs_net_gro_supported(),
          "digest_at_phase_17_rows": {
              name: {k: cases[name][k] for k in ("rows", "device_us", "plain_ms", "bound_us",
                                                   "max_abs_err")}
              for name in ("boxgame_pool_64", "boxgame_pool_512")}})
    # GSO is on where the library's probe passes and the kernel takes a
    # real segmented send
    gso = net_native.net_lib().ggrs_net_gso_supported() and seg["accepted"]
    with tempfile.TemporaryDirectory() as tmp:
        runs = {leg: drive_datapath("A", leg, "cpu" if leg == "f" else None, journal_dir=tmp,
                                    profiled=DATAPATH_PROFILED if leg in "ab" else 0)
                for leg in "abcdef"}
        a = runs["a"]
        for leg, run in runs.items():
            bad = datapath_equal(a, run)
            check(not bad, f"datapath A: leg {leg} differs from leg a on {bad}")
            check(run["around"] == 0, f"datapath A{leg}: the digest went around state_digest")
            check(run["crossings_one_per_tick"],
                  f"datapath A{leg}: {run['crossings']} crossings")
            check(run["udp_drops"] in (0, None),
                  f"datapath A{leg}: {run['udp_drops']} UDP receive drops")
            if leg != "f":
                check(run["launches"] == run["predicted"],
                      f"datapath A{leg}: {run['launches']} digest launches, "
                      f"predicted {run['predicted']}")
            io = run["io"]
            if leg in "aef":
                check(io["recv_datagrams"] > io["recv_calls"] > 0,
                      f"datapath A{leg}: no batching in io_stats {io}")
                check(io["gso"]["gso_sends"] == 0, f"datapath A{leg}: GSO on the NetBatch path")
            else:
                d = io["drain"]
                # one receive-table crossing a tick, plus one more each time
                # a drain outgrew its record or slab buffer (they double)
                check(d["crossings"] == run["crossings"] + d["backpressure_stops"]
                      and d["backpressure_stops"] <= 4 and d["unroutable"] == 0
                      and d["datagrams"] > d["recv_calls"],
                      f"datapath A{leg}: drain {d}")
                if leg in "bc":
                    check(io["gso"]["gso_segments"] > io["gso"]["gso_sends"] > 0 if gso
                          else io["gso"]["gso_sends"] == 0,
                          f"datapath A{leg}: GSO {io['gso']} where the kernel "
                          f"{'takes' if gso else 'refuses'} segmented sends")
                if leg == "d":
                    check(io["gso"] == {"gso_sends": 0, "gso_segments": 0}
                          and not run["capabilities"]["gro_active"],
                          f"datapath Ad: GSO {io['gso']} / GRO with both switched off")
        check(runs["e"]["io"]["decode"]["backend"] == "thread"
              and runs["e"]["io"]["decode"]["parallel_ticks"] > 0,
              "datapath Ae: the decode plane did not fan out on the thread backend")
        check(runs["c"]["capabilities"]["gro_active"]
              == bool(net_native.net_lib().ggrs_net_gro_supported()),
              f"datapath Ac: GRO {runs['c']['capabilities']}")
        replay = datapath_replay(a)
        fault = drive_datapath("A", "a", None, fault=True, journal_dir=tmp)
        t = DATAPATH_FAULT_SLOT
        others = [m for m in range(DATAPATH_MATCHES) if m != t]
        check(fault["storm"] is not None and fault["storm"][0] == "native"
              and fault["storm"][1] >= DATAPATH_STORM,
              f"datapath fault: the ENOBUFS storm left {fault['storm']}")
        check(fault["slot_states"][t] == "evicted"
              and all(fault["slot_states"][m] == "native" for m in others),
              f"datapath fault: slot states {sorted(set(fault['slot_states']))}")
        check(any("journal tail" in d for d in fault["fault_log"])
              and net_native.BANK_ERR_NAMES[net_native.BANK_ERR_IO] in fault["fault_log"],
              f"datapath fault: fault log {fault['fault_log']}")
        check(fault["evicted_lead"] and fault["evicted_lead"][0][0] == "LoadGameState",
              f"datapath fault: the evicted list leads with {fault['evicted_lead']}")
        check(len(fault["grafted"]) == DATAPATH_VIEWERS + 1,
              f"datapath fault: grafted endpoints {fault['grafted']}")
        end = DATAPATH_WARMUP + DATAPATH_TICKS - 20
        check(fault["journal_next"][t] > end,
              f"datapath fault: the journal stopped at {fault['journal_next'][t]}")
        check(fault["viewer_frames"][t] > end,
              f"datapath fault: the viewer stopped at {fault['viewer_frames'][t]}")
        check(fault["launches"] == fault["predicted"], "datapath fault: launches != predicted")
        bad = datapath_equal(a, fault, others)
        check(not bad, f"datapath fault: the other matches differ from leg a on {bad}")
    launches += sum(runs[leg]["launches"] for leg in "abcde") + fault["launches"]
    keys = ("syscalls_counted_per_tick", "host_ms_p50", "host_ms_p99", "run_ms_per_tick",
            "kernels_per_tick", "device_busy_ms_per_tick", "idle_share", "crossings",
            "drain_crossings", "fds", "udp_drops")
    emit({"phase": "datapath", "population": "A", "matches": DATAPATH_MATCHES,
          "viewers_per_match": DATAPATH_VIEWERS, "ticks": DATAPATH_WARMUP + DATAPATH_TICKS,
          "timed_ticks": DATAPATH_TICKS, "legs_bitwise_equal": sorted(runs),
          "legs": {leg: {k: run[k] for k in keys} | {
              "io": {k: run["io"][k] for k in ("recv_calls", "recv_datagrams", "send_calls",
                                               "send_datagrams", "send_errors")},
              "drain": run["io"]["drain"], "gso": run["io"]["gso"],
              "decode": {k: run["io"]["decode"][k] for k in ("backend", "parallel_ticks")},
              "digest_launches": run["launches"], "digest_predicted": run["predicted"]}
                   for leg, run in runs.items()},
          "capabilities": a["capabilities"], "replay": replay,
          "fault": {"slot": t, "storm_tick": DATAPATH_STORM_TICK, "eperm_tick": DATAPATH_EPERM_TICK,
                    "storm_send_errors": fault["storm"][1], "fault_log": fault["fault_log"],
                    "journal_frames": fault["journal_next"][t],
                    "others_bitwise_equal_to_leg_a": len(others)}})
    runs_b = {leg: drive_datapath("B", leg) for leg in "bcg"}
    b = runs_b["b"]
    for leg, run in runs_b.items():
        bad = datapath_equal(b, run)
        check(not bad, f"datapath B: leg {leg} differs from leg b on {bad}")
        check(run["crossings_one_per_tick"] and run["launches"] == run["predicted"]
              and run["around"] == 0, f"datapath B{leg}: crossings or launches")
        check(run["udp_drops"] in (0, None), f"datapath B{leg}: {run['udp_drops']} UDP receive drops "
              f"(rmem_max {rmem_max}, granted {run.get('rcvbuf')})")
        d = run["io"]["drain"]
        if leg == "g":
            check(d["crossings"] == 0, f"datapath Bg: the switch left {d['crossings']} drains")
        else:
            check(d["crossings"] == run["crossings"] + d["backpressure_stops"]
                  and d["backpressure_stops"] <= 4 and d["unroutable"] == 0,
                  f"datapath B{leg}: drain {d}")
        launches += run["launches"]
    emit({"phase": "datapath", "population": "B", "matches": INBOUND_MATCHES,
          "ticks": INBOUND_WARMUP + INBOUND_TICKS, "timed_ticks": INBOUND_TICKS,
          "legs_bitwise_equal": sorted(runs_b),
          "rcvbuf_granted": runs_b["c"].get("rcvbuf"), "rmem_max": rmem_max,
          "legs": {leg: {k: run[k] for k in keys} | {"drain": run["io"]["drain"],
                                                      "digest_launches": run["launches"]}
                   for leg, run in runs_b.items()}})
    return launches


# -- phase 18: the in-process fleet ---------------------------------------------


def fleet_games(device, counts_dir=None):
    """The host and peer game factories of a fleet world: the host's an
    ``ExecutorGame`` on ``device`` (a partial of a module-level class, so it
    can be shipped to a runner), the peer's one on the CPU.  One of each is
    built here first: a process's first ``ExecutorGame`` warms its programs
    up (BoxGame's device constants, the digest, every burst depth) before
    any count is zeroed and outside the sync-guarded runs."""
    host = functools.partial(ExecutorGame, "boxgame", 2, device=device, counts_dir=counts_dir)
    peer = functools.partial(ExecutorGame, "boxgame", 2, device="cpu")
    host(), peer()
    return host, peer


@contextlib.contextmanager
def timed_checkpoints():
    """Time every journal state checkpoint (``MatchJournal.append_checkpoint``:
    the card read of the checkpointed state, its npz and the append)."""
    orig = MatchJournal.append_checkpoint
    ms = []

    def timed(self, frame, state, meta=None):
        t0 = time.perf_counter()
        orig(self, frame, state, meta)
        ms.append((time.perf_counter() - t0) * 1e3)

    MatchJournal.append_checkpoint = timed
    try:
        yield ms
    finally:
        MatchJournal.append_checkpoint = orig


def drive_fleet(scenario: str, device, journal_dir: str, matches: int) -> dict:
    """One scenario of ``scripts/chaos.py``'s fleet leg through the port's
    ``drive_fleet_chaos``: each host match fulfilled by an ``ExecutorGame``
    on ``device``, each outside peer by one on the CPU.  The digest launch
    counts are zeroed just before the drive and read just after it."""
    make_host, make_peer = fleet_games(device)
    hosts = {}
    timing = {}

    def host(mid):
        hosts[mid] = make_host()
        return hosts[mid]

    def inject(i, ctx):
        sup = ctx["sup"]
        if scenario == "shard_kill" and i == FLEET_KILL_TICK:
            # the failover runs inside the next advance_all's health check
            fail = sup._fail_shard

            def timed_fail(*args, **kw):
                t0 = time.perf_counter()
                fail(*args, **kw)
                timing["failover_ms"] = (time.perf_counter() - t0) * 1e3

            sup._fail_shard = timed_fail
            sup.kill("s1")
        elif scenario == "shard_drain" and i == FLEET_DRAIN_TICK:
            sup.drain("s1")
        elif scenario == "shard_migrate" and i == FLEET_MIGRATE_TICK:
            t0 = time.perf_counter()
            sup.migrate("m0")
            timing["migration_ms"] = (time.perf_counter() - t0) * 1e3

    lossy = scenario in ("lossy_control", "shard_migrate")
    with timed_checkpoints() as ckpt_ms:
        state_digest.launches = lane_sums_rows.launches = 0
        EXECUTOR_COUNTS.update(launches=0, predicted=0, host_loads=0)
        ctx = drive_fleet_chaos(
            FLEET_TICKS, matches_per_shard=matches, seed=FLEET_SEED,
            inject=inject if scenario in ("shard_kill", "shard_drain", "shard_migrate") else None,
            fault_cfg=dict(FLEET_LOSSY) if lossy else None,
            n_spectators=FLEET_VIEWERS if lossy else 0, journal_dir=journal_dir,
            game_factory=host, peer_game_factory=lambda mid: make_peer(),
            state_template=BoxGame(2).init_state_np())
        launches, around = state_digest.launches, lane_sums_rows.launches
        predicted = EXECUTOR_COUNTS["predicted"]
    if hosts[ctx["match_ids"][0]].card:
        torch.cuda.synchronize()
    sup = ctx["sup"]
    journal_bytes = sum(os.path.getsize(os.path.join(journal_dir, f))
                        for f in os.listdir(journal_dir))
    viewer_desyncs = sum(isinstance(e, DesyncDetected)
                         for v in ctx["viewers"] for e in v.events())
    adv = [a for a, _ in ctx["host_ms"]]
    ful = [f for _, f in ctx["host_ms"]]
    tick = [a + f for a, f in ctx["host_ms"]]
    run = {
        "ctx": ctx, "hosts": hosts, "launches": launches, "around": around,
        "predicted": predicted,
        "states": {mid: to_numpy(h.state) for mid, h in hosts.items()},
        "last_checksums": {mid: (h.last_save.frame, h.last_save.checksum)
                           for mid, h in hosts.items()},
        "host_loads": {mid: h.host_loads for mid, h in hosts.items()},
        "viewer_desyncs": viewer_desyncs,
        "host_ms_p50": float(np.percentile(tick, 50)), "host_ms_p99": float(np.percentile(tick, 99)),
        "advance_all_ms_p50": float(np.percentile(adv, 50)),
        "advance_all_ms_p99": float(np.percentile(adv, 99)),
        "fulfil_ms_p50": float(np.percentile(ful, 50)), "fulfil_ms_p99": float(np.percentile(ful, 99)),
        "checkpoints": len(ckpt_ms),
        "checkpoint_ms_p50": float(np.percentile(ckpt_ms, 50)) if ckpt_ms else None,
        "checkpoint_ms_max": max(ckpt_ms) if ckpt_ms else None,
        "max_lag_frames": max(ctx["peer_frames"][m] - (ctx["frames"][m] or 0)
                              for m in ctx["match_ids"]),
        "journal_bytes": journal_bytes,
        "journal_bytes_per_frame": journal_bytes / max(1, sum(f or 0 for f in ctx["frames"].values())),
        "timeline_events_per_match": (sum(sup.fleet_obs.timelines.counts().values())
                                      / len(ctx["match_ids"])),
        **timing,
    }
    if scenario == "shard_kill":
        run["failover_tick_fulfil_ms"] = ful[FLEET_KILL_TICK]
    return run


FLEET_RUN_KEYS = ("host_ms_p50", "host_ms_p99", "advance_all_ms_p50", "advance_all_ms_p99",
                  "fulfil_ms_p50", "fulfil_ms_p99", "checkpoints", "checkpoint_ms_p50",
                  "checkpoint_ms_max", "max_lag_frames", "journal_bytes_per_frame",
                  "timeline_events_per_match", "failover_ms", "failover_tick_fulfil_ms",
                  "migration_ms")


def fleet_violations(scenario: str, run: dict, control: dict, matches: int) -> list:
    """``scripts/chaos.py``'s verdicts for one scenario, plus the port's:
    the survivors' live card states and newest saved checksums bitwise
    equal to the control's, 0 desyncs anywhere, the digest launches as the
    request lists predict, the viewers' streams never regressing, and every
    failed-over match resumed through a host-tree Load."""
    ctx, base = run["ctx"], control["ctx"]
    survivors = [f"m{k}" for k in range(matches)]
    affected = [f"m{k}" for k in range(matches, 2 * matches)]
    out = []
    if scenario == "shard_kill":
        out += fleet_survivor_violations(ctx, base, survivors)
        out += fleet_recovery_violations(ctx, affected, dead_shards=["s1"])
        out += [f"{m}: resumed without a host-tree load" for m in affected
                if run["host_loads"][m] < 1]
    elif scenario == "shard_drain":
        out += fleet_survivor_violations(ctx, base, survivors)
        out += fleet_recovery_violations(ctx, affected)
        if ctx["sup"].shards["s1"].state != "retired":
            out.append(f"drained shard is {ctx['sup'].shards['s1'].state}")
    elif scenario == "shard_migrate":
        survivors = [m for m in ctx["match_ids"] if m != "m0"]
        out += fleet_survivor_violations(ctx, base, survivors)
        out += fleet_recovery_violations(ctx, ["m0"])
        if ctx["locations"]["m0"] == base["locations"]["m0"]:
            out.append("m0 never moved")
    else:
        survivors = list(ctx["match_ids"])
        out += fleet_recovery_violations(ctx, survivors)
    if ctx["lost"]:
        out.append(f"lost {ctx['lost']}")
    for m in survivors:
        if not trees_equal(run["states"][m], control["states"][m]):
            out.append(f"{m}: live state != control")
        if run["last_checksums"][m] != control["last_checksums"][m]:
            out.append(f"{m}: newest saved checksum != control")
    if run["viewer_desyncs"]:
        out.append(f"{run['viewer_desyncs']} viewer desyncs")
    for v, stream in enumerate(ctx["viewer_streams"]):
        frames = [f for f, _ in stream]
        if frames != sorted(set(frames)):
            out.append(f"viewer {v} stream reset or regressed")
        if not frames or frames[-1] < FLEET_MIGRATE_TICK + 8:
            out.append(f"viewer {v} stalled at {frames[-1] if frames else None}")
    card = next(iter(run["hosts"].values())).card
    if card and run["launches"] != run["predicted"]:
        out.append(f"{run['launches']} digest launches, predicted {run['predicted']}")
    if run["around"]:
        out.append("the digest went around state_digest")
    return out


def fleet_scrape(sup) -> dict:
    """``/metrics`` and ``/healthz`` of the supervisor's merged registry over
    loopback HTTP; the exposition must validate."""
    import urllib.error
    import urllib.request

    server = start_http_server(sup.merged_registry(), port=0, health=sup.healthz)
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                health_status, health = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            health_status, health = e.code, json.loads(e.read())
    finally:
        server.close()
    errors = validate_exposition(text)
    check(not errors, f"fleet: /metrics exposition errors {errors[:5]}")
    return {"metrics_bytes": len(text), "metrics_lines": text.count("\n"),
            "exposition_errors": len(errors), "healthz_status": health_status,
            "healthz_ok": health.get("ok")}


def fleet_digest_rows(hosts: dict) -> dict:
    """The digest at the fleet's shapes (BoxGame(2), 1 and 8 rows of saved
    states) on the card against its plain version, bitwise, with device us,
    the plain version's ms and the bytes bound."""
    states = [h.state for h in hosts.values()][:max(FLEET_DIGEST_ROWS)]
    out = {}
    for rows in FLEET_DIGEST_ROWS:
        st = tree_map(lambda *ls: torch.stack(ls), *states[:rows])
        got, want = checksum_device(st), checksum_device_plain(st)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"fleet: digest of {rows} rows != plain")
        row_bytes = sum(math.prod(l.shape[1:]) * l.element_size() for l in tree_leaves(st))
        out[rows] = {"device_us": graph_us(checksum_device, [st]),
                     "plain_ms": device_ms(lambda: checksum_device_plain(st), iters=20),
                     "bound_us": bound_us(row_bytes * rows, rows),
                     "max_abs_err": u32_err(got, want)}
    return out


def fleet_matches(scenario: str) -> int:
    """Matches a shard in one scenario's run."""
    lossy = scenario in ("lossy_control", "shard_migrate")
    return FLEET_LOSSY_MATCHES if lossy else FLEET_MATCHES


def phase_fleet():
    """Phase 18: the in-process fleet.  Returns the digest launches of the
    card's drives, and the control run's healthz, merged registry (its JSON
    snapshot) and timelines for phase 23."""
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for scenario in FLEET_SCENARIOS:
            jdir = os.path.join(tmp, scenario)
            os.mkdir(jdir)
            runs[scenario] = drive_fleet(scenario, None, jdir, fleet_matches(scenario))
            if scenario == "control":
                sup = runs["control"]["ctx"]["sup"]
                scrape = fleet_scrape(sup)
                docs = {"healthz": sup.healthz(), "metrics": json_snapshot(sup.merged_registry()),
                        "timelines": sup.fleet_obs.timelines.to_dict()}
        for run in runs.values():
            run["ctx"]["sup"].close()
    controls = {"control": "control", "shard_kill": "control", "shard_drain": "control",
                "lossy_control": "lossy_control", "shard_migrate": "lossy_control"}
    for scenario, run in runs.items():
        bad = fleet_violations(scenario, run, runs[controls[scenario]], fleet_matches(scenario))
        check(not bad, f"fleet {scenario}: {bad[:6]}")
    digest = fleet_digest_rows(runs["control"]["hosts"])
    kill = runs["shard_kill"]
    affected = [f"m{k}" for k in range(FLEET_MATCHES, 2 * FLEET_MATCHES)]
    emit({"phase": "fleet", "matches_per_shard": FLEET_MATCHES,
          "lossy_matches_per_shard": FLEET_LOSSY_MATCHES, "shards": 2,
          "ticks": FLEET_TICKS, "seed": FLEET_SEED, "lossy": FLEET_LOSSY,
          "viewers_on_m0": FLEET_VIEWERS, "sync_debug_mode": "error",
          "scenarios": {name: {k: run.get(k) for k in FLEET_RUN_KEYS} | {
              "digest_launches": run["launches"], "digest_predicted": run["predicted"],
              "violations": 0, "lost": len(run["ctx"]["lost"]),
              "healthz": {k: v for k, v in run["ctx"]["healthz"].items() if k != "shards"}}
              for name, run in runs.items()},
          "kill_host_tree_loads": sum(kill["host_loads"][m] for m in affected),
          "drained_shard": runs["shard_drain"]["ctx"]["sup"].shards["s1"].state,
          "migrated_to": runs["shard_migrate"]["ctx"]["locations"]["m0"],
          "viewer_tips": [s[-1][0] if s else None
                          for s in runs["shard_migrate"]["ctx"]["viewer_streams"]],
          "scrape": scrape,
          "fleet_metrics_digest": fleet_metrics_digest(runs["control"]["ctx"]["sup"]),
          "digest_rows": digest})
    return sum(run["launches"] for run in runs.values()), docs


# -- phase 19: the process fleet -------------------------------------------------


@contextlib.contextmanager
def timed_spawns():
    """Time every runner spawn (``ProcShard._spawn``: the Popen and the
    ``hello`` round trip, which waits for the child's torch import, its
    CUDA context, the digest library's load and its warm-up of the fleet's
    card game)."""
    orig = ProcShard._spawn
    seconds = []

    def timed(self):
        t0 = time.perf_counter()
        orig(self)
        seconds.append(time.perf_counter() - t0)

    ProcShard._spawn = timed
    try:
        yield seconds
    finally:
        ProcShard._spawn = orig


@contextlib.contextmanager
def timed_admits():
    """Time every admission RPC into a runner (``ProcShard.admit_spec``: the
    runner builds the match's session, socket and game), in ms."""
    orig = ProcShard.admit_spec
    ms = []

    def timed(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return orig(self, *args, **kw)
        finally:
            ms.append((time.perf_counter() - t0) * 1e3)

    ProcShard.admit_spec = timed
    try:
        yield ms
    finally:
        ProcShard.admit_spec = orig


def runner_counts(counts_dir: str, pid: int) -> dict:
    """What a runner's ``ExecutorGame``s counted, written at its exit."""
    path = os.path.join(counts_dir, f"executor_game-{pid}.json")
    check(os.path.exists(path), f"runner {pid} wrote no counts to {counts_dir}")
    with open(path) as f:
        return json.load(f)


def pct(xs, q: float):
    return float(np.percentile(xs, q)) if len(xs) else None


def drive_proc(scenario: str, device, journal_dir: str, counts_dir: str) -> dict:
    """One run of ``scripts/chaos.py``'s proc or net leg through the port's
    ``drive_proc_fleet``: ``s0`` in this process and ``s1`` in a runner
    subprocess, every host match on an ``ExecutorGame`` on ``device`` (in
    the runner too), every peer on one on the CPU.  This process's digest
    counts are zeroed just before the drive and read just after it; the
    runner's are its own from its start, written when it exits at
    ``sup.close()``."""
    net = scenario.startswith("net")
    matches = NET_MATCHES if net else PROC_MATCHES
    host, peer = fleet_games(device, counts_dir)
    timing = {"rpc_ms": [], "spawn_s": []}

    def instrument(sup):
        shard = sup.shards["s1"]
        rpc = shard.advance_all

        def timed_rpc():
            t0 = time.perf_counter()
            out = rpc()
            # a dead or severed runner answers {} at once: keep tick RPCs only
            timing["rpc_ms"].append((time.perf_counter() - t0) * 1e3 if out else 0.0)
            return out

        shard.advance_all = timed_rpc
        fail = sup._fail_shard

        def timed_fail(*args, **kw):
            t0 = time.perf_counter()
            timing.setdefault("detect_ms", (t0 - timing.get("killed_at", t0)) * 1e3)
            fail(*args, **kw)
            timing["failover_ms"] = (time.perf_counter() - t0) * 1e3

        sup._fail_shard = timed_fail
        drive = shard._drive_link

        def timed_drive(now):
            drive(now)
            info = shard.link_info()
            if ("severed_at" in timing and "resume_ms" not in timing
                    and info["reconnects"] >= 1 and info["state"] == "up"):
                timing["resume_ms"] = (time.perf_counter() - timing["severed_at"]) * 1e3

        shard._drive_link = timed_drive

    def inject(i, ctx):
        sup = ctx["sup"]
        if i == 0:
            instrument(sup)
        if scenario == "proc_sigkill" and i == PROC_KILL_TICK:
            timing["pid"] = sup.shards["s1"].pid
            timing["killed_at"] = time.perf_counter()
            os.kill(timing["pid"], signal.SIGKILL)
        elif scenario == "net_sever" and i == NET_SEVER_TICK:
            timing["severed_at"] = time.perf_counter()
            sup.shards["s1"].chaos_sever_link("rdwr")

    tracer = Tracer(capacity=1 << 16)
    t_run = time.perf_counter()
    with timed_spawns() as spawn_s, timed_admits() as admit_ms:
        state_digest.launches = lane_sums_rows.launches = 0
        EXECUTOR_COUNTS.update(launches=0, predicted=0, host_loads=0)
        ctx = drive_proc_fleet(
            NET_TICKS if net else PROC_TICKS, matches_per_shard=matches, seed=PROC_SEED,
            backend="tcp" if net else "proc", inject=inject,
            tuning=FleetTuning(**(NET_TUNING if net else PROC_TUNING)), journal_dir=journal_dir,
            tick_sleep_s=0.005 if scenario == "net_sever" else 0.0, tracer=tracer,
            game_factory=host, peer_game_factory=peer, state_template=BoxGame(2).init_state_np())
        launches, around = state_digest.launches, lane_sums_rows.launches
        counts = dict(EXECUTOR_COUNTS)
    sup = ctx["sup"]
    shard = sup.shards["s1"]
    pid = shard.pid
    link = shard.link_info()
    sup.close()
    if device is None:
        torch.cuda.synchronize()
    adv = [a for a, _ in ctx["host_ms"]]
    ful = [f for _, f in ctx["host_ms"]]
    tick = [a + f for a, f in ctx["host_ms"]]
    runner_ticks = [ev[4] / 1e6 for ev in tracer.events() if ev[1] == "runner.tick"]
    served = [ms for ms in timing["rpc_ms"] if ms]
    run = {
        "ctx": ctx, "matches": matches, "launches": launches, "around": around,
        "predicted": counts["predicted"], "host_loads": counts["host_loads"],
        "orphans": shard.orphan_count(), "link": link,
        "failovers": int(ctx["registry"].value("ggrs_fleet_failovers_total") or 0),
        "runner": None if scenario == "proc_sigkill" else runner_counts(counts_dir, pid),
        "spawn_s": list(spawn_s),
        "admit_ms_first": admit_ms[0] if admit_ms else None, "admit_ms_max": max(admit_ms, default=None),
        "host_ms_p50": pct(tick, 50), "host_ms_p99": pct(tick, 99),
        "advance_all_ms_p50": pct(adv, 50), "advance_all_ms_p99": pct(adv, 99),
        "rpc_ms_p50": pct(served, 50), "rpc_ms_p99": pct(served, 99), "rpc_ticks": len(served),
        "s0_ms_p50": pct([a - r for a, r in zip(adv, timing["rpc_ms"])], 50),
        "fulfil_ms_p50": pct(ful, 50), "fulfil_ms_p99": pct(ful, 99),
        "runner_tick_ms_p50": pct(runner_ticks, 50), "runner_tick_ms_p99": pct(runner_ticks, 99),
        "runner_ticks_traced": len(runner_ticks), "seconds": time.perf_counter() - t_run,
        **{k: timing[k] for k in ("detect_ms", "failover_ms", "resume_ms") if k in timing},
    }
    return run


PROC_RUN_KEYS = ("matches", "spawn_s", "admit_ms_first", "admit_ms_max", "host_ms_p50", "host_ms_p99", "advance_all_ms_p50",
                 "advance_all_ms_p99", "rpc_ms_p50", "rpc_ms_p99", "rpc_ticks", "s0_ms_p50", "fulfil_ms_p50",
                 "fulfil_ms_p99", "runner_tick_ms_p50", "runner_tick_ms_p99",
                 "runner_ticks_traced", "seconds", "detect_ms", "failover_ms", "resume_ms", "failovers",
                 "orphans", "host_loads", "link", "severed_wire_equal")


def proc_violations(scenario: str, run: dict, control: dict, card: bool) -> list:
    """``scripts/chaos.py``'s proc and net verdicts for one run, plus the
    port's: 0 desyncs, nothing lost, no orphan, the survivors' peers
    bitwise the control's, the digest launches in this process and in the
    runner as the request lists predict."""
    ctx, base, p = run["ctx"], control["ctx"], run["matches"]
    survivors = [f"m{k}" for k in range(p)]
    affected = [f"m{k}" for k in range(p, 2 * p)]
    out = []
    if scenario == "proc_sigkill":
        out += fleet_survivor_violations(ctx, base, survivors)
        out += fleet_recovery_violations(ctx, affected, dead_shards=["s1"])
        out += [f"{m}: on {ctx['locations'][m]}" for m in affected if ctx["locations"][m] != "s0"]
        if run["host_loads"] != p:
            out.append(f"{run['host_loads']} host-tree loads for {p} failed-over matches")
    else:
        out += fleet_recovery_violations(ctx, ctx["match_ids"])
    if scenario == "net_sever":
        # the severed runner replays the cut tick when its redial lands, a
        # wall-clock moment: its matches are held to the recovery verdicts
        # and to their shard, the others bitwise to the control
        out += fleet_survivor_violations(ctx, base, survivors)
        out += [f"{m}: left s1" for m in affected if ctx["locations"][m] != "s1"]
        link = run["link"]
        if run["failovers"] or link["reconnects"] != 1 or link["window_expiries"] or link["epoch"] != 1:
            out.append(f"sever: {run['failovers']} failovers, link {link}")
    if scenario in ("proc_sigkill", "net_sever"):
        for m in survivors:
            if not trees_equal(to_numpy(ctx["peer_states"][m]), to_numpy(base["peer_states"][m])):
                out.append(f"{m}: peer state != control")
    if ctx["lost"]:
        out.append(f"lost {ctx['lost']}")
    if run["orphans"]:
        out.append(f"{run['orphans']} orphan runners")
    if card and run["launches"] != run["predicted"]:
        out.append(f"{run['launches']} digest launches here, predicted {run['predicted']}")
    runner = run["runner"]
    if runner is not None and card and (runner["launches"] != runner["predicted"]
                                        or runner["launches"] == 0):
        out.append(f"runner: {runner['launches']} digest launches, predicted "
                   f"{runner['predicted']}")
    if run["around"]:
        out.append("the digest went around state_digest")
    return out


def drive_placement(scenario: str, device, journal_dir: str) -> dict:
    """``scripts/chaos.py``'s placement host kill through the port's
    ``drive_placement_fleet``: two hosts behind one ingress, each host
    match on an ``ExecutorGame`` on ``device``, each peer on the CPU."""
    host, peer = fleet_games(device)
    timing = {}

    def inject(i, ctx):
        if i == PLACE_KILL_TICK:
            t0 = time.perf_counter()
            ctx["placement"].kill_host("h1")
            timing["kill_host_ms"] = (time.perf_counter() - t0) * 1e3

    t_run = time.perf_counter()
    state_digest.launches = lane_sums_rows.launches = 0
    EXECUTOR_COUNTS.update(launches=0, predicted=0, host_loads=0)
    ctx = drive_placement_fleet(
        PLACE_TICKS, matches_per_host=PLACE_MATCHES, seed=PROC_SEED, n_spectators=PLACE_VIEWERS,
        spectate_match=f"m{PLACE_MATCHES}", inject=inject if scenario == "host_kill" else None,
        journal_dir=journal_dir, game_factory=host, peer_game_factory=peer,
        state_template=BoxGame(2).init_state_np())
    launches, around = state_digest.launches, lane_sums_rows.launches
    counts = dict(EXECUTOR_COUNTS)
    ctx["close"]()
    if device is None:
        torch.cuda.synchronize()
    tick = [a + f for a, f in ctx["host_ms"]]
    return {"ctx": ctx, "launches": launches, "around": around, "predicted": counts["predicted"],
            "host_loads": counts["host_loads"], "host_ms_p50": pct(tick, 50),
            "host_ms_p99": pct(tick, 99), "seconds": time.perf_counter() - t_run, **timing}


def placement_violations(run: dict, control: dict, card: bool) -> list:
    """``scripts/chaos.py``'s placement host-kill verdicts, plus the port's:
    the survivors' card states bitwise the control's, every failed-over
    match resumed through a host-tree load, launches as predicted."""
    ctx, base = run["ctx"], control["ctx"]
    h0 = [f"m{k}" for k in range(PLACE_MATCHES)]
    h1 = [f"m{k}" for k in range(PLACE_MATCHES, 2 * PLACE_MATCHES)]
    out = fleet_survivor_violations(ctx, base, h0) + fleet_recovery_violations(ctx, h1)
    out += [f"{m}: not failed over cross-host ({ctx['locations'][m]})" for m in h1
            if not ctx["locations"][m] or ctx["locations"][m][0] != "h0"]
    out += [f"{m}: state != control" for m in h0
            if not trees_equal(to_numpy(ctx["states"][m]), to_numpy(base["states"][m]))]
    if ctx["vports"] != base["vports"]:
        out.append(f"virtual endpoints changed: {ctx['vports']} vs {base['vports']}")
    reg = ctx["registry"]
    if (ctx["healthz"].get("route_epoch") or 0) < 2:
        out.append(f"route epoch {ctx['healthz'].get('route_epoch')}")
    if int(reg.value("ggrs_placement_host_failovers_total") or 0) != len(h1) or \
            int(reg.value("ggrs_ingress_route_flips_total") or 0) < len(h1):
        out.append("host failovers or route flips short of the affected matches")
    for v, stream in enumerate(ctx["viewer_streams"]):
        frames = [f for f, _ in stream]
        if frames != sorted(set(frames)) or not frames or frames[-1] < PLACE_KILL_TICK + 4:
            out.append(f"viewer {v} reset or stalled at {frames[-1] if frames else None}")
    if run["host_loads"] != len(h1):
        out.append(f"{run['host_loads']} host-tree loads for {len(h1)} failed-over matches")
    for r in (run, control):
        if card and r["launches"] != r["predicted"]:
            out.append(f"{r['launches']} digest launches, predicted {r['predicted']}")
        if r["around"] or r["ctx"]["lost"]:
            out.append(f"around {r['around']}, lost {r['ctx']['lost']}")
    out += fleet_recovery_violations(base, base["match_ids"])
    return out


def phase_proc_fleet(device=None):
    """Phase 19: the process fleet.  ``device=None`` is the card; ``"cpu"``
    rehearses the phase on the CPU (a runner's games are built from the
    shipped factory, so this argument is the only way to reach them).
    Returns the digest launches of the card's drives, in this process and
    in the runners, and the SIGKILL run's merged timelines for phase 23."""
    card = device is None
    runs, place = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for scenario in PROC_SCENARIOS:
            jdir, cdir = os.path.join(tmp, scenario), os.path.join(tmp, scenario + ".counts")
            os.mkdir(jdir)
            os.mkdir(cdir)
            runs[scenario] = drive_proc(scenario, device, jdir, cdir)
        for scenario in ("control", "host_kill"):
            jdir = os.path.join(tmp, "placement_" + scenario)
            os.mkdir(jdir)
            place[scenario] = drive_placement(scenario, device, jdir)
    controls = {"proc_control": "proc_control", "proc_sigkill": "proc_control",
                "net_control": "net_control", "net_sever": "net_control"}
    for scenario, run in runs.items():
        bad = proc_violations(scenario, run, runs[controls[scenario]], card)
        check(not bad, f"proc fleet {scenario}: {bad[:6]}")
    bad = placement_violations(place["host_kill"], place["control"], card)
    check(not bad, f"proc fleet placement_host_kill: {bad[:6]}")
    sever, net_base = runs["net_sever"]["ctx"], runs["net_control"]["ctx"]
    severed = [f"m{k}" for k in range(NET_MATCHES, 2 * NET_MATCHES)]
    runs["net_sever"]["severed_wire_equal"] = sum(sever["wire"][m] == net_base["wire"][m]
                                                  for m in severed)
    runner_launches = sum(r["runner"]["launches"] for r in runs.values() if r["runner"])
    here = sum(r["launches"] for r in runs.values()) + sum(r["launches"] for r in place.values())
    emit({"phase": "proc_fleet", "seed": PROC_SEED, "sync_debug_mode": "error",
          "proc": {"matches_per_shard": PROC_MATCHES, "ticks": PROC_TICKS,
                   "kill_tick": PROC_KILL_TICK, "tuning": PROC_TUNING},
          "net": {"matches_per_shard": NET_MATCHES, "ticks": NET_TICKS,
                  "sever_tick": NET_SEVER_TICK, "tuning": NET_TUNING},
          "placement": {"matches_per_host": PLACE_MATCHES, "ticks": PLACE_TICKS,
                        "kill_tick": PLACE_KILL_TICK, "viewers": PLACE_VIEWERS},
          "scenarios": {name: {k: run.get(k) for k in PROC_RUN_KEYS} | {
              "digest_launches": run["launches"], "digest_predicted": run["predicted"],
              "runner_digest": run["runner"], "violations": 0, "lost": len(run["ctx"]["lost"]),
              "desyncs": 0} for name, run in runs.items()},
          "placement_runs": {name: {k: run[k] for k in ("launches", "predicted", "host_loads",
                                                       "host_ms_p50", "host_ms_p99", "seconds")}
                             | {"kill_host_ms": run.get("kill_host_ms"),
                                "route_epoch": run["ctx"]["healthz"].get("route_epoch"),
                                "locations": run["ctx"]["locations"], "violations": 0}
                             for name, run in place.items()},
          "digest_launches_here": here, "digest_launches_runners": runner_launches})
    return here + runner_launches, runs["proc_sigkill"]["ctx"]["sup"].fleet_obs.timelines.to_dict()


# -- phase 20: the static-analysis plane ---------------------------------------


def phase_verify() -> dict:
    """Phase 20: ``scripts/port_verify.py --model --json`` in a subprocess,
    after phase 1 built both libraries, so its runtime probes read them."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "verify.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts", "port_verify.py"), "--model",
             "--json", out],
            cwd=ROOT, capture_output=True, text=True, timeout=VERIFY_TIMEOUT_S,
        )
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"verify: port_verify.py exited {proc.returncode}\n"
              f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        with open(out) as f:
            verdict = json.load(f)
    check(verdict["verdict"] == "PASS" and verdict["new"] == [],
          f"verify: {verdict['verdict']}, new {verdict['new'][:6]}")
    check(set(verdict["counts"]) == set(VERIFY_GATES) | {"model"},
          f"verify: gates {sorted(verdict['counts'])}")
    probes = verdict.get("probes") or {}
    want = {"host": os.path.relpath(_build.host_library_path(""), ROOT),
            "digest": os.path.relpath(_build.library_path("digest"), ROOT)}
    check(probes == want, f"verify: runtime probes read {probes}, want {want}")
    models = verdict["models"]
    check(len(models) == 18 and verdict["counts"]["model"] == 0,
          f"verify: {len(models)} models, {verdict['counts']['model']} model findings")
    rec = {"phase": "verify", "seconds": seconds, "verdict": verdict["verdict"],
           "counts": verdict["counts"], "legacy": len(verdict["legacy"]), "probes": probes,
           "models": len(models), "model_states": sum(m["states"] for m in models),
           "model_seconds": sum(m["elapsed_s"] for m in models),
           "fixtures_with_counterexample": sum(m["expect"] == "counterexample" for m in models)}
    emit(rec)
    return rec


# -- phase 21: the bank on the sanitized host library --------------------------


def state_digests(ex, sessions: int) -> list:
    """sha256 of each session's live state, leaf bytes in tree order."""
    out = []
    for b in range(sessions):
        h = hashlib.sha256()
        for leaf in tree_leaves(ex.live_state(b)):
            h.update(np.ascontiguousarray(to_numpy(leaf)).tobytes())
        out.append(h.hexdigest())
    return out


def sanitized_leg(device) -> dict:
    """Phase 21's leg: phase 16's fault leg (64 sessions on phase 7's faults,
    the slot fault) cut to ``SAN_TICKS`` ticks, on whichever host library
    this process loads; a JSON-able record of what it produced."""
    run = drive_bank(POOL_MATCHES, SAN_TICKS, device, "bank", fault=True,
                     fault_tick=SAN_FAULT_TICK, record_events=True)
    ex = run["executor"]
    rec = {k: run[k] for k in SAN_KEYS}
    rec["transitions"] = [[slot, old, new] for slot, old, new, _ in run["transitions"]]
    rec["states"] = state_digests(ex, 2 * POOL_MATCHES)
    rec["library"] = os.path.relpath(net_native.bank_lib()._name, ROOT)
    rec["device"] = str(ex.device)
    return rec


def sanitized_child(device=None) -> None:
    """Entry of phase 21's subprocess (``GGRS_NATIVE_SANITIZE=1`` and the
    ASan runtime preloaded): the leg on the card (``device=None``), one JSON
    line."""
    state_digest.launches = lane_sums_rows.launches = 0
    rec = sanitized_leg(device)
    print(json.dumps(rec), flush=True)


def asan_runtime() -> str:
    gxx = subprocess.run(["g++", "-print-file-name=libasan.so"], capture_output=True,
                         text=True, check=True).stdout.strip()
    check(os.path.isabs(gxx) and os.path.exists(gxx), f"sanitized: no ASan runtime ({gxx!r})")
    return gxx


def phase_sanitized() -> dict:
    """Phase 21: the ASan+UBSan host library, and phase 16's fault leg cut to
    ``SAN_TICKS`` ticks in a subprocess that loads it (ASan preloaded),
    fulfilled on the card through ``HostedPool``; bitwise equal to the same
    leg here on the production library, digest launches as predicted, no
    sanitizer report.  Returns the record, with both runs' launches."""
    t0 = time.perf_counter()
    build_s = _build.build_host("1")
    runtime = asan_runtime()
    state_digest.launches = lane_sums_rows.launches = 0
    t1 = time.perf_counter()
    prod = sanitized_leg(None)
    prod_s = time.perf_counter() - t1
    env = dict(os.environ, LD_PRELOAD=runtime, ASAN_OPTIONS=SAN_ASAN_OPTIONS,
               GGRS_NATIVE_SANITIZE="1")
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.sanitized_child()"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=SAN_TIMEOUT_S,
    )
    child_s = time.perf_counter() - t1
    reports = [line for line in proc.stderr.splitlines()
               if "AddressSanitizer" in line or "runtime error:" in line
               or "LeakSanitizer" in line]
    check(proc.returncode == 0 and not reports,
          f"sanitized: the ASan leg exited {proc.returncode}, reports {reports[:4]}\n"
          f"{proc.stderr[-4000:]}")
    san = json.loads(proc.stdout.strip().splitlines()[-1])
    check(prod["library"] == os.path.relpath(_build.host_library_path(""), ROOT),
          f"sanitized: the production leg loaded {prod['library']}")
    check(san["library"] == os.path.relpath(_build.host_library_path("1"), ROOT),
          f"sanitized: the ASan leg loaded {san['library']}")
    check(san["device"] == prod["device"] == "cuda",
          f"sanitized: devices {san['device']} / {prod['device']}")
    bad = [k for k in SAN_KEYS + ("transitions", "states") if san[k] != prod[k]]
    check(not bad, f"sanitized: the ASan leg differs from the production leg on {bad}")
    for name, run in (("production", prod), ("asan", san)):
        check(run["launches"] == run["predicted"] and run["around"] == 0,
              f"sanitized {name}: {run['launches']} digest launches, predicted "
              f"{run['predicted']}, {run['around']} around state_digest")
    moves = [(o, n) for s, o, n in prod["transitions"] if s == BANK_FAULT_SLOT]
    check(moves == [("native", "quarantined"), ("quarantined", "evicted")],
          f"sanitized: fault transitions {moves}")
    check(prod["crossings"] == SAN_TICKS and prod["harvests"] == 1,
          f"sanitized: {prod['crossings']} crossings, {prod['harvests']} harvests")
    rec = {"phase": "sanitized", "sanitizer": "address,undefined",
           "flags": list(_build.host_flags("1")), "asan_options": SAN_ASAN_OPTIONS,
           "library": san["library"], "build_seconds": build_s,
           "game": "BoxGame(2)", "sessions": 2 * POOL_MATCHES, "ticks": SAN_TICKS,
           "network": P2P_NET, "fault": "inject_slot_error", "slot": BANK_FAULT_SLOT,
           "fault_tick": SAN_FAULT_TICK, "device": san["device"],
           "bitwise_equal": list(SAN_KEYS) + ["transitions", "states"],
           "digest_launches": prod["launches"], "digest_launches_sanitized": san["launches"],
           "digest_launches_predicted": prod["predicted"], "sanitizer_reports": 0,
           "production_seconds": prod_s, "sanitized_seconds": child_s,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


# -- phase 22: the examples ------------------------------------------------------


def repo_modules(names, folder: str) -> dict:
    """The port's examples or operator scripts, imported from ``folder`` of
    the checkout (appended to the path: their ``port_`` names shadow
    nothing)."""
    path = os.path.join(ROOT, folder)
    if path not in sys.path:
        sys.path.append(path)
    return {name: importlib.import_module(name) for name in names}


def free_udp_ports(n: int) -> list:
    """``n`` distinct loopback UDP ports that were free a moment ago."""
    socks = [pysocket.socket(pysocket.AF_INET, pysocket.SOCK_DGRAM) for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


@contextlib.contextmanager
def recorded_examples(ex_game):
    """While open, every ``Game`` of ``port_ex_game`` and every
    ``BatchedRequestExecutor`` adds the digest launches it makes on the card
    to ``rec["predicted"]``: a game's warmup (one digest and one per burst
    depth), each request list it fulfils (``predicted_digest_launches``), a
    pool's warmup (one) and each pooled tick (``pool_predicted``).  Each game
    keeps its build seconds and the host seconds of its ``run`` calls."""
    rec = {"predicted": 0}
    lock = threading.Lock()
    Game = ex_game.Game
    game_init, handle = Game.__init__, Game.handle_requests
    pool_warmup, pool_tick = BatchedRequestExecutor.warmup, BatchedRequestExecutor._tick

    def add(n):
        with lock:
            rec["predicted"] += n

    def init(self, num_players, render=False, rollbacks=True,
             max_prediction=ex_game.MAX_PREDICTION, device=None):
        t0 = time.perf_counter()
        game_init(self, num_players, render, rollbacks, max_prediction, device)
        self.init_s, self.run_s = time.perf_counter() - t0, 0.0
        add(1 + (max_prediction if rollbacks else 0))

    def handle_requests(self, requests):
        t0 = time.perf_counter()
        handle(self, requests)
        self.run_s += time.perf_counter() - t0
        add(predicted_digest_launches(requests))

    def warmup(self, example_inputs):
        add(1)
        return pool_warmup(self, example_inputs)

    def tick(self, desc):
        add(pool_predicted(desc))
        return pool_tick(self, desc)

    Game.__init__, Game.handle_requests = init, handle_requests
    BatchedRequestExecutor.warmup, BatchedRequestExecutor._tick = warmup, tick
    try:
        yield rec
    finally:
        Game.__init__, Game.handle_requests = game_init, handle
        BatchedRequestExecutor.warmup, BatchedRequestExecutor._tick = pool_warmup, pool_tick


def game_times(games, wall: float, frames: int) -> dict:
    """Frames/s of a run past its games' builds, and host ms a frame in
    ``run`` (each game's own frames)."""
    build = max(g.init_s for g in games)
    return {"wall_s": wall, "build_s": build, "frames_per_s": frames / (wall - build),
            "run_ms_per_frame": [g.run_s / max(g.frames_run, 1) * 1e3 for g in games]}


def in_threads(legs: dict, timeout: float = 300.0) -> dict:
    """Run each ``name: (fn, args, kwargs)`` on its own thread; their results
    by name once all ended (the first error re-raised here)."""
    results, errors = {}, []

    def run(name, fn, args, kwargs):
        try:
            results[name] = fn(*args, **kwargs)
        except BaseException as e:  # re-raised on this thread below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(name, *leg)) for name, leg in legs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    check(not any(t.is_alive() for t in threads), "examples: a thread outlived its time limit")
    if errors:
        raise errors[0]
    return results


def p2p_desyncs(events) -> int:
    return sum(isinstance(e, DesyncDetected) for e in events)


def drive_trio(p2p, spectator, frames: int, spectator_frames: int, device=None) -> dict:
    """A spectator, then a host listing it and the host's peer, each on its
    own thread and port, as tests/test_examples.py runs the three processes
    (the host only once the spectator listens: it streams from frame 0)."""
    host, peer, spec = free_udp_ports(3)
    listening = threading.Event()
    box = {}

    def follow():
        try:
            box["spectator"] = spectator.run_spectator(
                spec, f"127.0.0.1:{host}", 2, spectator_frames, device=device,
                ready=listening.set)
        finally:
            listening.set()

    follower = threading.Thread(target=follow)
    follower.start()
    check(listening.wait(120), "examples: the spectator never listened")
    out = in_threads({
        "host": (p2p.run_session, (host, ["local", f"127.0.0.1:{peer}"], [f"127.0.0.1:{spec}"],
                                   frames, False, device), {}),
        "peer": (p2p.run_session, (peer, [f"127.0.0.1:{host}", "local"], [], frames, False,
                                   device), {}),
    })
    follower.join(120)
    check(not follower.is_alive() and "spectator" in box, "examples: the spectator failed")
    return {**out, "spectator": box["spectator"]}


def start_example(script: str, *args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, os.path.join(ROOT, "examples", script),
                             *map(str, args)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wait_for_line(proc, needle: str, timeout: float) -> bool:
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline and proc.poll() is None:
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if ready and needle in proc.stdout.readline():
            return True
    return False


def example_clis() -> dict:
    """Each example once through its command line, on the card, all at once
    (a spectator first, then its host and peer): exit 0 and its marker lines.
    The seconds each took, from its start."""
    host, peer, spec = free_udp_ports(3)
    n, sn = EX_CLI_FRAMES, EX_CLI_SPECTATOR_FRAMES
    runs = {
        "synctest": (["port_ex_game_synctest.py", "--frames", n],
                     [f"synctest: {n} frames, no desyncs"]),
        "synctest_device_session": (["port_ex_game_synctest.py", "--frames", n,
                                     "--device-session"],
                                    [f"device synctest: {n} frames, no desyncs"]),
        "server": (["port_ex_game_server.py", "--frames", n], ["SERVER-EXAMPLE-OK"]),
        "p2p_both": (["port_ex_game_p2p.py", "--both", "--frames", n],
                     [f"[:7777] done: {n} frames", f"[:8888] done: {n} frames"]),
        "spectator": (["port_ex_game_spectator.py", "--local-port", spec, "--host",
                       f"127.0.0.1:{host}", "--frames", sn], ["[spectator] done"]),
        "p2p_host": (["port_ex_game_p2p.py", "--local-port", host, "--players", "local",
                      f"127.0.0.1:{peer}", "--spectators", f"127.0.0.1:{spec}", "--frames", n],
                     [f"done: {n} frames"]),
        "p2p_peer": (["port_ex_game_p2p.py", "--local-port", peer, "--players",
                      f"127.0.0.1:{host}", "local", "--frames", n], [f"done: {n} frames"]),
    }
    procs, started, seconds = {}, {}, {}
    try:
        for name in ("synctest", "synctest_device_session", "server", "p2p_both", "spectator"):
            started[name], procs[name] = time.perf_counter(), start_example(*runs[name][0])
        check(wait_for_line(procs["spectator"], "[spectator] listening", EX_CLI_TIMEOUT_S),
              "examples: the spectator's command never listened")
        for name in ("p2p_host", "p2p_peer"):
            started[name], procs[name] = time.perf_counter(), start_example(*runs[name][0])
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=EX_CLI_TIMEOUT_S)
            seconds[name] = time.perf_counter() - started[name]
            check(proc.returncode == 0, f"examples: {name} exited {proc.returncode}\n"
                  f"{out[-2000:]}{err[-3000:]}")
            missing = [m for m in runs[name][1] if m not in out]
            check(not missing and "DesyncDetected" not in out,
                  f"examples: {name} printed no {missing}\n{out[-2000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return seconds


def phase_examples() -> int:
    """Phase 22: the port's five examples on the card, in process through
    their factored functions, then each through its command line.  Returns
    the digest launches of the in-process drives."""
    m = repo_modules(EX_MODULES, "examples")
    synctest, server = m["port_ex_game_synctest"], m["port_ex_game_server"]
    p2p, spectator = m["port_ex_game_p2p"], m["port_ex_game_spectator"]
    out, runs = io.StringIO(), {}
    state_digest.launches = lane_sums_rows.launches = 0
    with recorded_examples(m["port_ex_game"]) as rec, contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        game, sess = synctest.run_synctest(2, EX_D, 0, EX_SYNCTEST_FRAMES)
        torch.cuda.synchronize()
        runs["synctest"] = game_times([game], time.perf_counter() - t0, EX_SYNCTEST_FRAMES)
        t0 = time.perf_counter()
        dgame, dsess = synctest.run_synctest(2, EX_D, 0, EX_SYNCTEST_FRAMES, device_session=True)
        dsess.block_until_ready()
        wall = time.perf_counter() - t0
        runs["device_session"] = {"wall_s": wall, "build_s": dgame.init_s,
                                  "ticks_per_s": EX_SYNCTEST_FRAMES / (wall - dgame.init_s)}
        t0 = time.perf_counter()
        pool, sessions, desyncs, rate = server.run_server(EX_SERVER_MATCHES, EX_SERVER_FRAMES)
        runs["server"] = {"wall_s": time.perf_counter() - t0, "session_ticks_per_s": rate,
                          "sessions": len(sessions), "desynced_matches": desyncs}
        t0 = time.perf_counter()
        both = p2p.run_both(EX_BOTH_FRAMES, ports=free_udp_ports(2))
        runs["p2p_both"] = game_times([r[0] for r in both], time.perf_counter() - t0,
                                      EX_BOTH_FRAMES)
        t0 = time.perf_counter()
        trio = drive_trio(p2p, spectator, EX_TRIO_FRAMES, EX_SPECTATOR_FRAMES)
        runs["trio"] = game_times([r[0] for r in trio.values()], time.perf_counter() - t0,
                                  EX_TRIO_FRAMES)
    launches, around = state_digest.launches, lane_sums_rows.launches
    predicted = rec["predicted"] + 2 * EX_SYNCTEST_FRAMES  # the device session: 2 a tick
    check(launches == predicted and around == 0,
          f"examples: {launches} digest launches, predicted {predicted}, {around} around")
    check(desyncs == 0, f"examples: the server desynced {desyncs} matches")
    for name, results, want in (("p2p_both", both, [EX_BOTH_FRAMES] * 2),
                                ("trio", [trio["host"], trio["peer"]], [EX_TRIO_FRAMES] * 2)):
        check([r[2] for r in results] == want and not sum(p2p_desyncs(r[3]) for r in results),
              f"examples: {name} frames {[r[2] for r in results]}, events "
              f"{[r[3] for r in results]}")
    spec_frames = trio["spectator"][2]
    check(spec_frames >= EX_SPECTATOR_FRAMES and not p2p_desyncs(trio["spectator"][3]),
          f"examples: the spectator reached frame {spec_frames}: {trio['spectator'][3]}")
    check("DesyncDetected" not in out.getvalue(), "examples: a DesyncDetected was printed")

    # the deterministic examples again on the CPU: bitwise the card's
    cpu_game, _ = synctest.run_synctest(2, EX_D, 0, EX_SYNCTEST_FRAMES, device="cpu")
    check(trees_equal(to_numpy(game.executor.state), to_numpy(cpu_game.executor.state)),
          "examples: the synctest's card state != the CPU's")
    _, cpu_sess = synctest.run_synctest(2, EX_D, 0, EX_SYNCTEST_FRAMES, device_session=True,
                                        device="cpu")
    check(trees_equal(to_numpy(dsess.carry), to_numpy(cpu_sess.carry)),
          "examples: the device session's card carry != the CPU's")
    cpu_pool, _, cpu_desyncs, _ = server.run_server(EX_SERVER_MATCHES, EX_SERVER_FRAMES,
                                                    device="cpu")
    unequal = [b for b in range(len(sessions))
               if not trees_equal(pool.live_state(b), cpu_pool.live_state(b))]
    check(not unequal and cpu_desyncs == 0,
          f"examples: the server's sessions {unequal[:8]} differ from the CPU's")
    clis = example_clis()
    emit({"phase": "examples", "game": "BoxGame(2)", "synctest_check_distance": EX_D,
          "synctest_frames": EX_SYNCTEST_FRAMES, "server_matches": EX_SERVER_MATCHES,
          "server_frames": EX_SERVER_FRAMES, "both_frames": EX_BOTH_FRAMES,
          "trio_frames": EX_TRIO_FRAMES, "spectator_frames": spec_frames,
          "bitwise_cpu": ["synctest live state", "device session carry",
                          f"server live states ({len(sessions)})"],
          "desyncs": 0, "digest_launches": launches, "digest_predicted": predicted,
          "runs": runs, "cli_frames": EX_CLI_FRAMES, "cli_seconds": clis})
    return launches


# -- phase 23: the operator scripts ------------------------------------------------


def run_script_main(mod, argv: list):
    """``mod.main()`` as its command line ``argv`` would run it: exit code
    and what it printed."""
    saved, out = sys.argv, io.StringIO()
    sys.argv = [mod.__file__, *argv]
    try:
        with contextlib.redirect_stdout(out):
            rc = mod.main()
    finally:
        sys.argv = saved
    return rc, out.getvalue()


def floor_probe_predicted(ticks_per_dispatch: int, dispatches: int, repeats: int) -> int:
    """Digest launches of ``port_floor_probe.main``: one a step in the digest
    and ring variants and two a flagship tick, over the warmup pass (two for
    the flagship) and the timed passes."""
    passes = repeats * dispatches
    steps = (D + 1) * ticks_per_dispatch
    return 2 * (1 + passes) * steps + 2 * ticks_per_dispatch * (2 + passes)


def phase_scripts(fleet_docs: dict, proc_timelines: dict) -> int:
    """Phase 23: the port's operator scripts.  Returns the floor probe's
    digest launches."""
    m = repo_modules(SCRIPT_MODULES, "scripts")
    probe = m["port_floor_probe"]
    out = io.StringIO()
    state_digest.launches = lane_sums_rows.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        best = probe.main(**PROBE_CUT)
    probe_s = time.perf_counter() - t0
    launches, around = state_digest.launches, lane_sums_rows.launches
    predicted = floor_probe_predicted(**PROBE_CUT)
    check(launches == predicted and around == 0,
          f"scripts: floor probe {launches} digest launches, predicted {predicted}, "
          f"{around} around")
    lines = out.getvalue().splitlines()
    check([line.split()[0] for line in lines[1:5]] == list(probe.VARIANTS)
          and lines[-1] == "desync gate green", f"scripts: floor probe printed {lines}")
    steps = PROBE_CUT["dispatches"] * (D + 1) * PROBE_CUT["ticks_per_dispatch"]

    t0 = time.perf_counter()
    prof = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "port_profile_tick.py"),
                           *PROFILE_ARGS], cwd=ROOT, capture_output=True, text=True, timeout=300)
    profile_s = time.perf_counter() - t0
    check(prof.returncode == 0, f"scripts: port_profile_tick.py exited {prof.returncode}\n"
          f"{prof.stdout[-2000:]}{prof.stderr[-3000:]}")
    phases = [line.split()[0] for line in prof.stdout.splitlines()
              if line.lstrip().startswith(("pool.", "bank."))]
    check({"pool.tick", "bank.crossing", "pool.slot"} <= set(phases)
          and sum(p.startswith("bank.") for p in phases) >= 9,
          f"scripts: the bank profile names {phases}")
    device_half = prof.stdout[prof.stdout.index("# device fulfilment"):].splitlines() \
        if "# device fulfilment" in prof.stdout else []
    check(any(line.split()[:3] == ["launch", "calls", "in"]
              and re.search(r"GraphLaunch\S* 1\.00 ", line) for line in device_half),
          f"scripts: the profile's device half shows no graph launch a tick: {device_half}")

    frame = m["port_fleet_top"].render(fleet_docs["healthz"], fleet_docs["metrics"],
                                       timelines=fleet_docs["timelines"])
    check(frame.startswith(f"ggrs fleet_top — tick {FLEET_TICKS}")
          and all(f"\n{s} " in frame for s in ("s0", "s1"))
          and f"admissions={2 * FLEET_MATCHES}" in frame
          and "match timelines (latest events):" in frame,
          f"scripts: fleet_top rendered\n{frame}")

    timeline = m["port_match_timeline"]
    failed_over = sorted(mid for mid, evs in proc_timelines.items()
                         if any(e.get("ev") == "FAILOVER" for e in evs))
    check(failed_over, "scripts: phase 19's timelines hold no FAILOVER")
    with tempfile.TemporaryDirectory() as tmp:
        artifact, trace = os.path.join(tmp, "proc_sigkill.json"), os.path.join(tmp, "m.json")
        with open(artifact, "w") as f:
            json.dump({"proc_sigkill": {"timelines": proc_timelines}}, f)
        rc_list, listing = run_script_main(timeline, ["--artifact", artifact, "--list"])
        rc, shown = run_script_main(timeline, ["--artifact", artifact, "-m", failed_over[0],
                                               "--perfetto", trace])
        with open(trace) as f:
            problems = validate_chrome_trace(json.load(f))
    check(rc_list == rc == 0 and not problems and len(listing.splitlines()) == len(proc_timelines)
          and "FAILOVER" in shown and "perfetto trace written" in shown,
          f"scripts: match_timeline exited {rc_list} / {rc}, problems {problems}\n{shown}")
    emit({"phase": "scripts",
          "floor_probe": {**PROBE_CUT, "check_distance": D, "rows": lines[1:5],
                          "us_per_advance_step": {k: v / steps * 1e6 for k, v in best.items()},
                          "seconds": probe_s, "digest_launches": launches,
                          "digest_predicted": predicted, "gate": lines[-1]},
          "profile_tick": {"args": list(PROFILE_ARGS), "seconds": profile_s,
                           "phases": phases, "head": prof.stdout.splitlines()[:4],
                           "device_half": device_half},
          "fleet_top": {"lines": frame.count("\n") + 1, "head": frame.splitlines()[0]},
          "match_timeline": {"matches": len(proc_timelines), "rendered": failed_over[0],
                             "events": len(shown.splitlines()) - 2,
                             "perfetto_problems": len(problems)}})
    return launches


# -- phase 24: the soak tier ---------------------------------------------------------


def soak_growth(leg: str, run: dict) -> dict:
    """The growth a soak leg showed between its samples (25, 50, 75 and 100 %
    of the horizon), checked: no graph captured after the warmup (the leg's
    own graphs and ``GRAPH_COUNTS``), the allocator's reserved bytes flat
    after the 25 % sample, allocated bytes within ``SOAK_ALLOC_BOUND`` of it,
    RSS within ``SOAK_RSS_MB`` of it, and the sessions' queue bounds held at
    every sample."""
    samples = run["samples"]
    first = samples[0]
    growth = {
        "captures_after_warmup": run["captures_after_warmup"],
        "graph_counts_captures": [s["probe"] - first["probe"] for s in samples],
        "reserved_growth": max(s["reserved"] for s in samples) - first["reserved"],
        "allocated_growth": max(s["allocated"] for s in samples) - first["allocated"],
        "rss_growth_mb": max(s["rss_mb"] for s in samples) - first["rss_mb"],
        "violations": [v for s in samples for v in s["violations"]],
    }
    check(growth["captures_after_warmup"] == 0 and not any(growth["graph_counts_captures"]),
          f"soak {leg}: graphs captured after the warmup: {growth}")
    check(growth["reserved_growth"] <= 0, f"soak {leg}: reserved memory grew: {growth}")
    check(growth["allocated_growth"] <= SOAK_ALLOC_BOUND,
          f"soak {leg}: allocated memory grew past {SOAK_ALLOC_BOUND}: {growth}")
    check(growth["rss_growth_mb"] < SOAK_RSS_MB and run.get("rss_drift_mb", 0.0) < SOAK_RSS_MB,
          f"soak {leg}: RSS grew: {growth}, drift {run.get('rss_drift_mb')}")
    check(not growth["violations"], f"soak {leg}: queue bounds: {growth['violations']}")
    return growth


def phase_soak() -> int:
    """Phase 24: ``scripts/port_soak.py``'s two legs on the card's graph
    routes.  Returns the P2P leg's digest launches."""
    soak = repo_modules(("port_soak",), "scripts")["port_soak"]
    probe = lambda: GRAPH_COUNTS["captures"]  # noqa: E731
    legs = {}
    for leg, run in (
            ("p2p", lambda: soak.p2p_soak(SOAK_FRAMES, device="cuda", probe=probe)),
            ("pool", lambda: soak.pool_soak(SOAK_TICKS, device="cuda", probe=probe,
                                            warm_ticks=SOAK_POOL_WARM))):
        t0 = time.perf_counter()
        try:
            legs[leg] = run()
        except AssertionError as e:
            check(False, f"soak {leg}: {e}")
        legs[leg]["seconds"] = time.perf_counter() - t0
        legs[leg]["growth"] = soak_growth(leg, legs[leg])
    p2p, pool = legs["p2p"], legs["pool"]
    check(p2p["desyncs"] == 0 and p2p["digest_launches"] == p2p["digest_predicted"],
          f"soak p2p: {p2p['desyncs']} desyncs, {p2p['digest_launches']} digest launches, "
          f"{p2p['digest_predicted']} predicted")
    horizon = SOAK_POOL_WARM + SOAK_TICKS - 64
    check(pool["sessions"] == 8 and pool["ring_wraps"] >= 156
          and min(pool["frames"]) >= horizon and min(pool["settled_frames"]) >= horizon,
          f"soak pool: {pool['sessions']} sessions, {pool['ring_wraps']} ring wraps, "
          f"frames {pool['frames']}, settled {pool['settled_frames']}")
    emit({"phase": "soak",
          "p2p": {"frames": SOAK_FRAMES, **{k: p2p[k] for k in (
              "fps", "host_ms", "desyncs", "compared", "checksum_reports",
              "checksum_reports_sent", "settled_frame", "settled_checksum", "digest_launches",
              "digest_predicted", "rss_drift_mb", "seconds", "growth", "samples")}},
          "pool": {"ticks": SOAK_TICKS, "warm_ticks": SOAK_POOL_WARM, **{k: pool[k] for k in (
              "session_ticks_per_sec", "host_ms", "sessions", "ring_wraps", "settled_frames",
              "replays",
              "seconds", "growth", "samples")}}})
    return p2p["digest_launches"]


# the CUDA graphs (ops.graphs) captured and replayed in this process,
# counted from count_graphs() on
GRAPH_COUNTS = {"captures": 0, "replays": 0}


def count_graphs() -> None:
    """Count every capture and replay of the port's CUDA graphs (the
    executors', the pools', the replay's, the scrub's, speculation's and
    the prediction plane's, all made through ``ops.graphs.GraphSet``) in
    ``GRAPH_COUNTS``: each phase's line then gives the graphs its drives
    captured and replayed in this process."""
    capture, replay = graph_ops.GraphSet.capture, graph_ops.Graph.replay

    def counted_capture(self, body):
        GRAPH_COUNTS["captures"] += 1
        return capture(self, body)

    def counted_replay(self):
        GRAPH_COUNTS["replays"] += 1
        return replay(self)

    graph_ops.GraphSet.capture, graph_ops.Graph.replay = counted_capture, counted_replay


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs the card",
              file=sys.stderr)
        return 2
    raise_fd_limit()
    smi = nvidia_smi()
    seconds = {}
    count_graphs()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        before = dict(GRAPH_COUNTS)
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        emit({"phase": name, "seconds": seconds[name],
              **{f"graph_{k}": GRAPH_COUNTS[k] - before[k] for k in GRAPH_COUNTS}})
        return out

    timed("build", phase_build, smi)
    rng = np.random.default_rng(2026)
    worst = timed("kernel_lane_sums", phase_lane_sums, rng)
    cases = timed("kernel_state_digest", phase_state_digest, rng)
    worst = max([worst] + [c["max_abs_err"] for c in cases.values()])
    timed("flagship", phase_flagship)
    launches = timed("batched", phase_batched)
    exec_launches = timed("executor", phase_executor)
    timed("checkpoint", phase_checkpoint)
    p2p_launches, p2p_runs = timed("p2p", phase_p2p)
    ecs_launches = timed("ecs", phase_ecs)
    float_launches = timed("float", phase_float)
    journal_launches = timed("journal", phase_journal)
    spec_launches = timed("speculation", phase_speculation)
    pool_launches, pool_run = timed("pool", phase_pool)
    native_launches = timed("native", phase_native, p2p_runs, pool_run)
    plane_launches = timed("plane", phase_plane)
    mesh_launches = timed("mesh", phase_mesh)
    bank_launches = timed("bank", phase_bank)
    datapath_launches = timed("datapath", phase_datapath, cases)
    fleet_launches, fleet_docs = timed("fleet", phase_fleet)
    proc_launches, proc_timelines = timed("proc_fleet", phase_proc_fleet)
    timed("verify", phase_verify)
    san = timed("sanitized", phase_sanitized)
    example_launches = timed("examples", phase_examples)
    probe_launches = timed("scripts", phase_scripts, fleet_docs, proc_timelines)
    soak_launches = timed("soak", phase_soak)
    emit({"phase_seconds": seconds, "total_seconds": sum(seconds.values())})
    main_case = cases[MAIN_CASE]
    emit({"kernels": [{
        "name": "digest", "route": "cuda", "source": "ggrs_tpu_torch/csrc/digest.cu",
        "replaces": "ggrs_tpu/ops/pallas_checksum.py:66",
        "launches": launches, "launches_executor": exec_launches,
        "launches_p2p": p2p_launches, "launches_ecs": ecs_launches,
        "launches_float": float_launches, "launches_journal": journal_launches,
        "launches_speculation": spec_launches, "launches_pool": pool_launches,
        "launches_native": native_launches, "launches_plane": plane_launches,
        "launches_mesh": mesh_launches, "launches_bank": bank_launches,
        "launches_datapath": datapath_launches, "launches_fleet": fleet_launches,
        "launches_proc": proc_launches, "launches_sanitized_production": san["digest_launches"],
        "launches_sanitized": san["digest_launches_sanitized"],
        "launches_examples": example_launches, "launches_floor_probe": probe_launches,
        "launches_soak": soak_launches,
        "max_abs_err": worst,
        "ms": main_case["device_us"] / 1e3, "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_us"] / 1e3, "bound_by": "bytes", "library_ms": None,
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
