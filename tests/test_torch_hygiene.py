"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ggrs_tpu_torch
from ggrs_tpu_torch import (
    BatchedSessions,
    BoxGame,
    ChipVM,
    DeviceRequestExecutor,
    DeviceSyncTestSession,
    EcsWorld,
    RtsCmd,
    build_scrub_program,
)
from ggrs_tpu_torch.core.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ggrs_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ggrs_tpu'] = None\n"
        "import ggrs_tpu_torch, ggrs_tpu_torch.ops.replay, ggrs_tpu_torch.parallel.batch\n"
        "import ggrs_tpu_torch.sessions.device_synctest, ggrs_tpu_torch._build\n"
        "import ggrs_tpu_torch.ops.executor, ggrs_tpu_torch.sessions.builder\n"
        "import ggrs_tpu_torch.utils.checkpoint, ggrs_tpu_torch.core.sync_layer\n"
        "import ggrs_tpu_torch.net, ggrs_tpu_torch.net.protocol, ggrs_tpu_torch.obs\n"
        "import ggrs_tpu_torch.sessions.p2p, ggrs_tpu_torch.sessions.spectator\n"
        "import ggrs_tpu_torch.games.ecs_world, ggrs_tpu_torch.games.rtscmd\n"
        "import ggrs_tpu_torch.broadcast, ggrs_tpu_torch.broadcast.journal\n"
        "import ggrs_tpu_torch.sessions.replay\n"
        "import chip_smoke\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_loopback_p2p_match_with_jax_blocked():
    # two port peers over loopback UDP, each fulfilled by its own executor,
    # in a process where jax and the JAX package cannot be imported
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ggrs_tpu'] = None\n"
        "import numpy as np\n"
        "from ggrs_tpu_torch import (BoxGame, DesyncDetection, DeviceRequestExecutor, Local,\n"
        "    Remote, SessionBuilder, UdpNonBlockingSocket, boxgame_config, to_numpy)\n"
        "socks = [UdpNonBlockingSocket.bind_to_port(0) for _ in range(2)]\n"
        "addrs = [('127.0.0.1', s.local_port()) for s in socks]\n"
        "game = BoxGame(2)\n"
        "peers = []\n"
        "for h in (0, 1):\n"
        "    sess = (SessionBuilder(boxgame_config()).with_clock(lambda: 0)\n"
        "            .with_desync_detection_mode(DesyncDetection.on(1))\n"
        "            .add_player(Local(), h).add_player(Remote(addrs[1 - h]), 1 - h)\n"
        "            .start_p2p_session(socks[h]))\n"
        "    ex = DeviceRequestExecutor(game.advance, game.init_state_np(),\n"
        "        lambda pairs: np.asarray([v for v, _ in pairs], np.uint8), device='cpu')\n"
        "    peers.append((h, sess, ex))\n"
        "events = []\n"
        "for i in range(80):\n"
        "    for h, sess, ex in peers:\n"
        "        sess.poll_remote_clients()\n"
        "        sess.add_local_input(h, (min(i, 59) // (3 + h)) % 16)\n"
        "        ex.run(sess.advance_frame())\n"
        "        events += sess.events()\n"
        "assert events == [], events\n"
        "assert peers[0][1].current_frame == peers[1][1].current_frame == 80\n"
        "a, b = (to_numpy(ex.state) for _, _, ex in peers)\n"
        "assert all(np.array_equal(a[k], b[k]) for k in a)\n"
        "assert all(s._last_sent_checksum_frame > 50 for _, s, _ in peers)\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_rtscmd_journal_replay_with_jax_blocked(tmp_path):
    # two port peers play RtsCmd over the in-memory network, peer A records
    # the match through a JournalTap, and the journal is replayed by the
    # scrub and by per-frame playback, in a process where jax and the JAX
    # package cannot be imported
    code = (
        "import random, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ggrs_tpu'] = None\n"
        "import numpy as np\n"
        "from ggrs_tpu_torch import (DesyncDetection, DeviceRequestExecutor, InMemoryNetwork,\n"
        "    JournalTap, Local, MatchJournal, Remote, ReplaySession, RtsCmd, SessionBuilder,\n"
        "    build_scrub_program, to_numpy)\n"
        "rts = RtsCmd(2, num_units=4, max_cmds=4)\n"
        "to_env = lambda pairs: rts.envelopes_np([v for v, _ in pairs])\n"
        "net, now = InMemoryNetwork(seed=3, loss=0.05, latency_ticks=2), [0]\n"
        "journal = MatchJournal(sys.argv[1], 2, rts.config().native_input_size)\n"
        "peers = []\n"
        "for me, other, h in (('A', 'B', 0), ('B', 'A', 1)):\n"
        "    sess = (SessionBuilder(rts.config()).with_clock(lambda: now[0])\n"
        "            .with_rng(random.Random(h)).with_desync_detection_mode(DesyncDetection.on(1))\n"
        "            .add_player(Local(), h).add_player(Remote(other), 1 - h)\n"
        "            .start_p2p_session(net.socket(me)))\n"
        "    peers.append((h, sess, DeviceRequestExecutor(rts.advance, rts.init_state_np(),\n"
        "                                                 to_env, device='cpu')))\n"
        "peers[0][1].adopt_spectator_endpoint(JournalTap.ADDR, JournalTap(journal, rts.config()))\n"
        "orders = lambda h, f: (('move', f % 4, 1, -1),) * (f % 3) + (('gather', h),) * (f % 2)\n"
        "live = {}\n"
        "for i in range(70):\n"
        "    for h, sess, ex in peers:\n"
        "        sess.poll_remote_clients()\n"
        "        sess.add_local_input(h, orders(h, min(sess.current_frame, 49)))\n"
        "        ex.run(sess.advance_frame())\n"
        "        assert 'DesyncDetected' not in str(sess.events())\n"
        "        if h == 0:\n"
        "            live[sess.current_frame] = to_numpy(ex.state)\n"
        "    net.tick()\n"
        "    now[0] += 16\n"
        "journal.close()\n"
        "rs = ReplaySession(sys.argv[1], rts.config())\n"
        "end = rs.last_frame + 1\n"
        "assert rs.closed and end > 50, end\n"
        "inputs, _ = rs.stacked_inputs()\n"
        "fused = to_numpy(build_scrub_program(rts.advance, device='cpu')(\n"
        "    rts.init_state_np(), np.stack([rts.envelopes_np(row) for row in inputs])))\n"
        "rs.seek(0)\n"
        "ex = DeviceRequestExecutor(rts.advance, rts.init_state_np(), to_env, device='cpu')\n"
        "while rs.frames_remaining():\n"
        "    ex.run(rs.advance_frame())\n"
        "for k in fused:\n"
        "    assert np.array_equal(fused[k], live[end][k]), k\n"
        "    assert np.array_equal(to_numpy(ex.state)[k], live[end][k]), k\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "match.ggjl")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ggrs_tpu"), f"{path.name} imports {mod}"


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    game = BoxGame(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8))
    vm = ChipVM(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedSessions(vm.advance, vm.init_state_np(), np.zeros(2, np.uint8), batch_size=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        game.init_state()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceRequestExecutor(game.advance, game.init_state_np(), lambda pairs: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_scrub_program(game.advance)
    for other in (EcsWorld(2, 4), RtsCmd(2), BoxGame(2, "float")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            other.init_state()
    assert resolve_device("cpu") == torch.device("cpu")


def test_public_surface():
    for name in ggrs_tpu_torch.__all__:
        assert hasattr(ggrs_tpu_torch, name), name
