"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points never fall back to the CPU on their own."""

import ast
import os
import re
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
from ggrs_tpu_torch.chaos import ExecutorGame
from ggrs_tpu_torch.core.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("port_ex_game*.py"))
SCRIPTS = [ROOT / "scripts" / f"port_{name}.py"
           for name in ("fleet_top", "match_timeline", "floor_probe", "profile_tick", "soak")]
PORT_FILES = sorted((ROOT / "ggrs_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "port_shard_runner.py",
    ROOT / "scripts" / "port_verify.py"] + EXAMPLES + SCRIPTS


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
        "import ggrs_tpu_torch.predict, ggrs_tpu_torch.predict.batched, ggrs_tpu_torch.net._native\n"
        "import ggrs_tpu_torch.parallel.host_bank, ggrs_tpu_torch.parallel.decode_pool\n"
        "import ggrs_tpu_torch.broadcast.hub, ggrs_tpu_torch.net.sockets\n"
        "import ggrs_tpu_torch.obs.timeline, ggrs_tpu_torch.obs.slo, ggrs_tpu_torch.obs.exporters\n"
        "import ggrs_tpu_torch.obs.fleet_obs, ggrs_tpu_torch.fleet, ggrs_tpu_torch.fleet.rpc\n"
        "import ggrs_tpu_torch.fleet.shard, ggrs_tpu_torch.fleet.supervisor, ggrs_tpu_torch.chaos\n"
        "import ggrs_tpu_torch.fleet.transport, ggrs_tpu_torch.fleet.proc\n"
        "import ggrs_tpu_torch.fleet.ingress, ggrs_tpu_torch.fleet.placement_service\n"
        "from ggrs_tpu_torch.parallel.batch import Mesh, make_mesh, make_mesh2d\n"
        "from ggrs_tpu_torch.parallel.batch import make_distributed_mesh\n"
        "assert ggrs_tpu_torch.net._native.available()\n"
        "assert make_mesh(2, device='cpu').size == make_mesh2d(1, 2, device='cpu').size == 2\n"
        "assert make_distributed_mesh(device='cpu').devices.shape == (1, 1)\n"
        "import chip_smoke\n"
        "sys.modules['bench'] = None\n"
        "sys.path[:0] = ['examples', 'scripts']\n"
        f"import {', '.join(p.stem for p in EXAMPLES + SCRIPTS)}\n"
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


def test_loopback_pump_and_hub_viewer_with_jax_blocked():
    # one bank slot on the kernel-batched pump, its peer and a hub-attached
    # viewer over loopback UDP, in a process where jax and the JAX package
    # cannot be imported
    code = (
        "import random, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ggrs_tpu'] = None\n"
        "from ggrs_tpu_torch import (Config, HostSessionPool, Local, Remote, SessionBuilder,\n"
        "    UdpNonBlockingSocket)\n"
        "from ggrs_tpu_torch.broadcast import SpectatorHub\n"
        "from ggrs_tpu_torch.core.errors import NotSynchronized, PredictionThreshold\n"
        "cfg, now = Config.for_uint(16), [0]\n"
        "host, peer_sock, view_sock = (UdpNonBlockingSocket(0) for _ in range(3))\n"
        "addr = lambda s: ('127.0.0.1', s.local_port())\n"
        "b = lambda h, other, seed: (SessionBuilder(cfg).with_clock(lambda: now[0])\n"
        "    .with_rng(random.Random(seed)).add_player(Local(), h).add_player(Remote(other), 1 - h))\n"
        "pool = HostSessionPool(native_io=True)\n"
        "hub = SpectatorHub(pool, rng=random.Random(9))\n"
        "pool.add_session(b(0, addr(peer_sock), 3), host)\n"
        "peer = b(1, addr(host), 4).start_p2p_session(peer_sock)\n"
        "viewer = (SessionBuilder(cfg).with_clock(lambda: now[0]).with_rng(random.Random(5))\n"
        "          .start_spectator_session(addr(host), view_sock))\n"
        "hub.attach(0, addr(view_sock))\n"
        "assert pool.native_io_active and pool.io_state(0) == 'native'\n"
        "save = lambda reqs: [r.cell.save(r.frame, None, None) for r in reqs\n"
        "                     if type(r).__name__ == 'SaveGameState']\n"
        "for i in range(80):\n"
        "    now[0] += 16\n"
        "    peer.add_local_input(1, i % 16)\n"
        "    save(peer.advance_frame())\n"
        "    pool.add_local_input(0, 0, (i // 3) % 16)\n"
        "    for reqs in pool.advance_all():\n"
        "        save(reqs)\n"
        "    try:\n"
        "        viewer.advance_frame()\n"
        "    except (NotSynchronized, PredictionThreshold):\n"
        "        pass\n"
        "st = pool.io_stats()\n"
        "assert pool.crossings == 80 and st['recv_datagrams'] > st['recv_calls'] / 2, st\n"
        "assert pool.current_frame(0) > 60 and viewer.current_frame > 50, viewer.current_frame\n"
        "assert pool.spectator_states(0)[0]['running']\n"
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


def test_fleet_failover_with_executors_and_jax_blocked(tmp_path):
    # the in-process fleet kills a shard mid-match and fails its match over
    # from the journal onto the survivor, every match fulfilled by a CPU
    # executor, in a process where jax and the JAX package cannot be imported
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ggrs_tpu'] = None\n"
        "import numpy as np\n"
        "from ggrs_tpu_torch import BoxGame, DeviceRequestExecutor\n"
        "from ggrs_tpu_torch.chaos import drive_fleet_chaos, fleet_recovery_violations\n"
        "game = BoxGame(2)\n"
        "class Host:\n"
        "    def __init__(self):\n"
        "        self.ex = DeviceRequestExecutor(game.advance, game.init_state_np(),\n"
        "            lambda pairs: np.asarray([v for v, _ in pairs], np.uint8), device='cpu')\n"
        "    def fulfill(self, reqs):\n"
        "        self.ex.run(reqs)\n"
        "    state = property(lambda self: self.ex.state)\n"
        "def kill(i, ctx):\n"
        "    if i == 16:\n"
        "        ctx['sup'].kill('s1')\n"
        "ctx = drive_fleet_chaos(32, matches_per_shard=1, seed=2, inject=kill,\n"
        "    journal_dir=sys.argv[1], game_factory=lambda mid: Host(),\n"
        "    peer_game_factory=lambda mid: Host(), state_template=game.init_state_np())\n"
        "ctx['sup'].close()\n"
        "assert ctx['locations'] == {'m0': 's0', 'm1': 's0'}, ctx['locations']\n"
        "assert fleet_recovery_violations(ctx, ['m1'], dead_shards=['s1']) == []\n"
        "assert all(f > 24 for f in ctx['frames'].values()), ctx['frames']\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_proc_fleet_runner_child_with_jax_blocked(tmp_path):
    # a process fleet whose runner subprocess fulfils its match through an
    # ExecutorGame on the CPU; PYTHONPATH leads with packages named jax and
    # ggrs_tpu that refuse to import, so the spawned runner, which inherits
    # the environment, proves it imports neither
    blocker = tmp_path / "blocked"
    for name in ("jax", "ggrs_tpu"):
        (blocker / name).mkdir(parents=True)
        (blocker / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked in this process')\n")
    code = (
        "import functools, sys\n"
        "from ggrs_tpu_torch import BoxGame\n"
        "from ggrs_tpu_torch.chaos import ExecutorGame, drive_proc_fleet, fleet_recovery_violations\n"
        "from ggrs_tpu_torch.fleet import FleetTuning\n"
        "game = functools.partial(ExecutorGame, 'boxgame', 2, device='cpu')\n"
        "tuning = FleetTuning(heartbeat_interval_s=0.05, heartbeat_deadline_s=1.0,\n"
        "    rpc_timeout_s=5.0, spawn_timeout_s=120.0, drain_deadline_s=0.5, restart_max=0)\n"
        "ctx = drive_proc_fleet(16, matches_per_shard=1, seed=4, backend='proc', tuning=tuning,\n"
        "    journal_dir=sys.argv[1], game_factory=game, peer_game_factory=game,\n"
        "    state_template=BoxGame(2).init_state_np())\n"
        "shard = ctx['sup'].shards['s1']\n"
        "pid = shard.pid\n"
        "ctx['sup'].close()\n"
        "assert shard.backend == 'proc' and shard.last_exit == 'exit code 0', shard.last_exit\n"
        "assert shard.orphan_count() == 0\n"
        "assert ctx['frames'] == {'m0': 16, 'm1': 16}, ctx['frames']\n"
        "assert fleet_recovery_violations(ctx, ctx['match_ids']) == []\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok', pid)\n"
    )
    env = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
               PYTHONPATH=str(blocker))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] == "ok"
    assert "is blocked" not in out.stderr


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
        assert top not in ("jax", "jaxlib", "ggrs_tpu", "bench"), f"{path.name} imports {mod}"


@pytest.mark.parametrize("argv", [
    pytest.param(["port_ex_game_synctest.py", "--frames", "1"], id="synctest"),
    pytest.param(["port_ex_game_synctest.py", "--frames", "1", "--device-session"],
                 id="synctest-device-session"),
    pytest.param(["port_ex_game_server.py", "--matches", "1", "--frames", "1"], id="server"),
    pytest.param(["port_ex_game_p2p.py", "--local-port", "0", "--frames", "1"], id="p2p"),
    pytest.param(["port_ex_game_p2p.py", "--both", "--frames", "1"], id="p2p-both"),
    pytest.param(["port_ex_game_spectator.py", "--local-port", "0", "--frames", "1"],
                 id="spectator"),
])
def test_examples_need_cuda_unless_told_cpu(argv, monkeypatch):
    # without --device the examples mean the card; with no card they raise
    # before they bind a socket or print a result
    if torch.cuda.is_available():
        return
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    monkeypatch.setattr(sys, "argv", argv)
    import importlib

    mod = importlib.import_module(argv[0][:-3])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main()


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExecutorGame()
    for other in (EcsWorld(2, 4), RtsCmd(2), BoxGame(2, "float")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            other.init_state()
    cfg = ggrs_tpu_torch.Config.for_uint(8, predictor=ggrs_tpu_torch.BatchedRepeatLast())
    for entry in (ggrs_tpu_torch.make_mesh, ggrs_tpu_torch.make_distributed_mesh,
                  lambda: ggrs_tpu_torch.make_mesh2d(1, 1),
                  lambda: ggrs_tpu_torch.DevicePredictionPlane(cfg, 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
    # the soak harnesses, as the rest of the port, mean the card
    monkeypatch.syspath_prepend(str(ROOT / "scripts"))
    import port_soak

    for harness in (lambda: port_soak.p2p_soak(1), lambda: port_soak.pool_soak(1),
                    lambda: port_soak.pooled_matches_setup(1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            harness()
    assert resolve_device("cpu") == torch.device("cpu")


def test_public_surface():
    for name in ggrs_tpu_torch.__all__:
        assert hasattr(ggrs_tpu_torch, name), name


# -- the port reads no file of the JAX side ---------------------------------------

# every .py and .sh file of the port: the package, its scripts, its examples
# and the smoke test
PORT_SOURCES = sorted(
    {*(ROOT / "ggrs_tpu_torch").rglob("*.py"), *(ROOT / "scripts").glob("port_*.py"),
     *(ROOT / "scripts").glob("port_*.sh"), *EXAMPLES, ROOT / "chip_smoke.py"})
# a path into the JAX side: its native tree or its package
JAX_PATH = re.compile(r"(?<![\w.-])(?:native|ggrs_tpu)/")
JAX_DIRS = ("native", "ggrs_tpu")


def _docstrings(tree) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                out.add(id(body[0].value))
    return out


def _cited(tree) -> set:
    """String constants that cite a JAX file rather than read it: the value
    of a ``"replaces"`` key, the smoke test's "file:line of the TPU kernel"
    that a port kernel replaces."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "replaces":
                    out.add(id(v))
    return out


def _is_jax_part(node) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and node.value.strip("/").split("/")[0] in JAX_DIRS)


def jax_path_uses(text: str, suffix: str) -> list:
    """Where a port file names a path into ``native/`` or ``ggrs_tpu/`` in
    code, or builds one (``parent / "native"``, ``os.path.join(root,
    "ggrs_tpu")``, ``.joinpath("native")``).  Comments and docstrings that
    cite the JAX counterpart by file are allowed, and so is a
    ``"replaces"`` entry."""
    if suffix == ".sh":
        return [line for line in text.splitlines()
                if JAX_PATH.search(line.split("#", 1)[0])]
    tree = ast.parse(text)
    skip = _docstrings(tree) | _cited(tree)
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in skip and JAX_PATH.search(node.value)):
            found.append(f"line {node.lineno}: {node.value[:60]!r}")
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div) \
                and _is_jax_part(node.right):
            found.append(f"line {node.lineno}: / {node.right.value!r}")
        elif isinstance(node, ast.Call) and any(_is_jax_part(a) for a in node.args[1:]) \
                and ast.unparse(node.func) in ("os.path.join", "path.join"):
            found.append(f"line {node.lineno}: {ast.unparse(node)[:60]}")
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "joinpath" and any(_is_jax_part(a) for a in node.args):
            found.append(f"line {node.lineno}: {ast.unparse(node)[:60]}")
    return found


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_path_into_the_jax_side(path):
    assert jax_path_uses(path.read_text(), path.suffix) == []


@pytest.mark.parametrize("snippet, suffix, hits", [
    ('NATIVE_DIR = _PKG.parent / "native"\n', ".py", 1),
    ('src = ROOT / "native/codec.cpp"\n', ".py", 2),
    ('p = os.path.join(root, "ggrs_tpu", "ops")\n', ".py", 1),
    ('p = root.joinpath("native")\n', ".py", 1),
    ('x = f"{root}/ggrs_tpu/net/_native.py"\n', ".py", 1),
    ('"""The port of ``ggrs_tpu/ops/replay.py``."""\n# mirrors native/codec.cpp\n', ".py", 0),
    ('line = {"replaces": "ggrs_tpu/ops/pallas_checksum.py:66"}\n', ".py", 0),
    ('p = root / "ggrs_tpu_torch" / "csrc/host"\nslot = "native"\n', ".py", 0),
    ('g++ -shared -o lib.so native/*.cpp\n', ".sh", 1),
    ('# built from native/*.cpp in the JAX tree\nmake -C csrc/host\n', ".sh", 0),
], ids=["parent-div", "literal-and-div", "os-path-join", "joinpath", "f-string",
        "docstring-and-comment", "replaces", "port-paths", "sh-command", "sh-comment"])
def test_jax_path_check_finds_each_form(snippet, suffix, hits):
    assert len(jax_path_uses(snippet, suffix)) == hits


def test_host_library_is_built_from_the_package_sources():
    from ggrs_tpu_torch import _build

    host = ROOT / "ggrs_tpu_torch" / "csrc" / "host"
    assert _build.HOST_DIR == host
    assert {p.name for p in _build.HOST_SOURCES} == {p.name for p in host.glob("*.cpp")}
    assert all(p.parent == host and p.exists() for p in _build.HOST_SOURCES + _build.HOST_HEADERS)
    assert {p.name for p in _build.HOST_HEADERS} == {p.name for p in host.glob("*.h")}
