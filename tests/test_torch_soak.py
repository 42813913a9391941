"""The port's soak tier on the CPU: the twin of tests/test_soak.py over
``scripts/port_soak.py``.

- test_p2p_soak_100k_frames: two port peers over the seeded fault net for
  1e5 frames with desync detection on; bit-exact convergence at every
  settled frame, bounded send queues / event queues / checksum history /
  digest backlog (checked every 10k frames and at each quarter of the
  horizon), bounded RSS growth.  Crosses the 128-slot input-queue ring
  ~780x and the 32-entry checksum history cap ~60x, through the port's
  own native cores (``ggrs_tpu_torch/csrc/host``).
- test_pool_soak_wraparound: 8 pooled sessions (4 matches) for 2e4 ticks of
  the eager CPU pool: ~156 input-ring wraps per queue.
- the card's routes rehearsed on the CPU: the P2P leg on executors whose
  advances and bursts take the graph route (``ExecutorGraphs`` with a
  stand-in capture, the digest kernel emulated so its launches count), the
  pool on ``_ShardGraphs``: no capture after the warmup, digest launches as
  the request lists predict, the settled frame bitwise the numpy oracle and
  its checksum the plain digest's.
- test_p2p_soak_matches_jax_settled_frame_for_frame: the port's harness and
  ``bench.p2p_soak`` at the same seeds for 3,000 frames give the same digest
  for every settled frame and the same final frames, so the port's network,
  sessions and native cores hold the JAX side's over a fault-injected run.

The card runs the same harnesses over the CUDA graph routes
(``chip_smoke.py`` phase 24).  Marked ``soak`` like the JAX file.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]

import bench  # noqa: E402
import port_soak  # noqa: E402
from ggrs_tpu_torch.ops import ExecutorPrograms  # noqa: E402
from ggrs_tpu_torch.ops import digest as tdg  # noqa: E402
from ggrs_tpu_torch.ops.executor import ExecutorGraphs  # noqa: E402
from ggrs_tpu_torch.parallel import session_pool as pool_mod  # noqa: E402
from test_torch_checksum import _emulated_launch, _FakeCuda  # noqa: E402
from test_torch_request_graph import _graph_pool, stand_in  # noqa: E402,F401

pytestmark = pytest.mark.soak

CROSS_FRAMES = 3_000


def _bounded_growth_invariants(sessions, digests) -> None:
    assert port_soak.bounded_growth_violations(sessions, digests) == []


def test_p2p_soak_100k_frames():
    stats = port_soak.p2p_soak(100_000, periodic=_bounded_growth_invariants, device="cpu")
    # convergence and horizon asserts live inside the harness; pin the
    # test-tier extras here
    assert stats["desyncs"] == 0
    assert stats["compared"] > 50_000
    assert stats["rss_drift_mb"] < 64.0, (
        f"RSS grew {stats['rss_drift_mb']:.0f} MiB in the second half"
    )
    assert [s["at"] for s in stats["samples"]] == list(port_soak.SAMPLES)
    assert all(s["violations"] == [] for s in stats["samples"])


def test_pool_soak_wraparound():
    stats = port_soak.pool_soak(20_000, device="cpu")
    assert stats["sessions"] == 8
    assert stats["ring_wraps"] >= 156
    assert min(stats["frames"]) >= 20_000 - 64
    assert min(stats["settled_frames"]) >= 20_000 - 64
    assert all(s["violations"] == [] for s in stats["samples"])


class _Recording(dict):
    """A peer's digest map that also logs every save into ``log``: the
    compare deletes settled frames, the log keeps each frame's last save."""

    def __init__(self, log: dict, items: dict) -> None:
        super().__init__(items)
        self.log = log
        log.update(items)

    def __setitem__(self, frame, value) -> None:
        super().__setitem__(frame, value)
        self.log[frame] = value


def _recorded_run(soak) -> tuple:
    """``soak(frames, periodic=...)`` with both peers' digest maps swapped
    for recording ones at the first periodic call (frame 0): each peer's
    last-saved digest by frame, and the sessions."""
    logs, held = [{}, {}], []

    def periodic(sessions, digests):
        if not held:
            held.extend(sessions)
            for me in (0, 1):
                digests[me] = _Recording(logs[me], digests[me])

    soak(CROSS_FRAMES, periodic=periodic)
    settled = min(s.current_frame for s in held) - (held[0]._max_prediction + 1)
    maps = [{f: d for f, d in log.items() if f <= settled} for log in logs]
    return maps, [s.current_frame for s in held], settled


def test_p2p_soak_matches_jax_settled_frame_for_frame():
    port_maps, port_frames, settled = _recorded_run(
        lambda n, periodic: port_soak.p2p_soak(n, periodic=periodic, device="cpu"))
    jax_maps, jax_frames, _ = _recorded_run(bench.p2p_soak)
    assert port_frames == jax_frames
    assert settled > CROSS_FRAMES - 64
    for me in (0, 1):
        assert len(port_maps[me]) == settled + 1
        assert port_maps[me] == jax_maps[me], f"peer {me}"
    assert port_maps[0] == port_maps[1]


@pytest.fixture
def card_route(monkeypatch, stand_in):
    """The card's graph routes on CPU tensors: the P2P peers on executors,
    every programs object handing out ``ExecutorGraphs``, every warmed pool
    ``_ShardGraphs``, captures run through the stand-in, and the digest's
    launches go through the numpy emulation of the kernel (so they count as
    on the card)."""
    monkeypatch.setattr(port_soak, "CPU_P2P_ROUTE", "executor")
    monkeypatch.setattr(tdg, "_launch", _emulated_launch([]))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    monkeypatch.setattr(ExecutorPrograms, "graphs", lambda self, device: self._graphs.setdefault(
        device, ExecutorGraphs(self, device)))
    warmup = pool_mod.BatchedRequestExecutor.warmup

    def graphed_warmup(self, example_inputs):
        warmup(self, example_inputs)
        _graph_pool(self)

    monkeypatch.setattr(pool_mod.BatchedRequestExecutor, "warmup", graphed_warmup)
    return stand_in


def test_p2p_soak_card_route_rehearsed_on_cpu(card_route):
    frames = 3_000
    stats = port_soak.p2p_soak(frames, device="cpu")
    assert stats["desyncs"] == 0
    assert stats["captures_after_warmup"] == 0
    assert stats["digest_launches"] == stats["digest_predicted"] > frames
    assert stats["digest_around"] == 0
    assert stats["settled_frame"] > frames - 32
    # each peer sent a report every 100 frames, and compared those of the
    # other's that the lossy net delivered
    sent = stats["checksum_reports_sent"]
    assert min(sent) >= frames // port_soak.DESYNC_INTERVAL - 5
    assert all(0.8 * n <= r <= n for r, n in zip(stats["checksum_reports"], sent[::-1]))
    samples = stats["samples"]
    assert [s["captures"] for s in samples] == [samples[0]["captures"]] * 4
    assert samples[-1]["replays"] > samples[0]["replays"] > 0
    assert all(s["violations"] == [] for s in samples)


def test_pool_soak_card_route_rehearsed_on_cpu(card_route):
    stats = port_soak.pool_soak(2_048, device="cpu", warm_ticks=512)
    assert stats["captures_after_warmup"] == 0
    assert stats["replays"] >= 2_048 + 512
    assert stats["ring_wraps"] >= 16
    assert min(stats["frames"]) >= 2_048 + 512 - 64
    assert min(stats["settled_frames"]) >= 2_048 + 512 - 64
    assert all(s["violations"] == [] for s in stats["samples"])
