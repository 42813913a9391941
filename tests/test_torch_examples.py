"""The port's examples (``examples/port_ex_game*.py``) against the JAX ones.

(a) Every port example runs headless as a real subprocess on the CPU
(``--device cpu``) with the assertions of ``tests/test_examples.py``, on
ports the test picks (the JAX example tests bind 7777, 8888 and 9999 in
another worker at the same time).  (b) In process, the port's factored
example functions give bitwise the states of the JAX examples, each JAX
file loaded by ``importlib`` under its own module name.  (c) Across
packages over loopback UDP: a JAX peer plays a port peer, and a port
spectator follows a JAX host, with desync detection on and no desync.
Tolerance is exact equality: BoxGame is 16.16 fixed point.
"""

import importlib.util
import os
import select
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import jax

from ggrs_tpu_torch import to_numpy

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
sys.path.insert(0, str(EXAMPLES))

import port_ex_game_p2p  # noqa: E402
import port_ex_game_server  # noqa: E402
import port_ex_game_synctest  # noqa: E402


def free_ports(n):
    """``n`` distinct UDP ports that were free a moment ago."""
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def example_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # examples are single-device
    return env


def start(script, *args):
    return subprocess.Popen(
        [sys.executable, str(EXAMPLES / script), *map(str, args)],
        cwd=REPO, env=example_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )


def wait_for_line(proc, needle, timeout=120.0):
    """Wait until ``proc`` prints a stdout line containing ``needle``."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            return False
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if ready and needle in proc.stdout.readline():
            return True
    return False


def finish(procs, timeout=300):
    """Every process's stdout, after each exited 0."""
    try:
        results = [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("example processes timed out")
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, f"{p.args}: rc={p.returncode}\n{out}\n{err}"
    return [out for out, _ in results]


CPU = ("--device", "cpu")


def p2p_args(port, players, frames, *extra):
    return ("--local-port", port, "--players", *players, "--frames", frames, *extra)


@pytest.fixture(scope="module")
def launched():
    """Every subprocess run of this file, started together: most of them wait
    on a 60 Hz frame clock, so running them side by side keeps the file
    short.  Each test reads its own group.  A spectator starts first and its
    host only once it listens: the host streams to it from frame 0."""
    procs = {}
    (pa, pb, host, peer, spec, port_vs_jax, jax_peer, jax_host, cross_peer,
     cross_spec) = free_ports(10)
    try:
        procs["synctest_host"] = [start("port_ex_game_synctest.py", "--frames", 100,
                                        "--check-distance", 3, *CPU)]
        procs["synctest_device"] = [start("port_ex_game_synctest.py", "--frames", 100,
                                          "--check-distance", 3, "--device-session", *CPU)]
        procs["server"] = [start("port_ex_game_server.py", "--matches", 4, "--frames", 80, *CPU)]
        procs["pair"] = [
            start("port_ex_game_p2p.py", *p2p_args(pa, ("local", f"127.0.0.1:{pb}"), 120, *CPU)),
            start("port_ex_game_p2p.py", *p2p_args(pb, (f"127.0.0.1:{pa}", "local"), 120, *CPU)),
        ]
        # a port peer (handle 0) against a JAX peer (handle 1)
        procs["cross_pair"] = [
            start("port_ex_game_p2p.py",
                  *p2p_args(port_vs_jax, ("local", f"127.0.0.1:{jax_peer}"), 240, *CPU)),
            start("ex_game_p2p.py", *p2p_args(jax_peer, (f"127.0.0.1:{port_vs_jax}", "local"), 240)),
        ]
        for name, (port, host_port) in {"trio": (spec, host),
                                        "cross_trio": (cross_spec, jax_host)}.items():
            procs[name] = [start("port_ex_game_spectator.py", "--local-port", port,
                                 "--host", f"127.0.0.1:{host_port}", "--frames", 100, *CPU)]
        for name in ("trio", "cross_trio"):
            assert wait_for_line(procs[name][0], "[spectator] listening"), \
                f"{name}: the spectator never signalled ready"
        # the port trio; then a JAX host (handle 0) playing a port peer, with
        # the second port spectator following the JAX host
        procs["trio"] += [
            start("port_ex_game_p2p.py", *p2p_args(host, ("local", f"127.0.0.1:{peer}"), 240,
                                                  "--spectators", f"127.0.0.1:{spec}", *CPU)),
            start("port_ex_game_p2p.py", *p2p_args(peer, (f"127.0.0.1:{host}", "local"), 240,
                                                  *CPU)),
        ]
        procs["cross_trio"] += [
            start("ex_game_p2p.py", *p2p_args(jax_host, ("local", f"127.0.0.1:{cross_peer}"), 240,
                                              "--spectators", f"127.0.0.1:{cross_spec}")),
            start("port_ex_game_p2p.py", *p2p_args(cross_peer, (f"127.0.0.1:{jax_host}", "local"),
                                                  240, *CPU)),
        ]
        yield procs
    finally:
        for group in procs.values():
            for p in group:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def load_jax_example(name):
    """``examples/<name>.py`` as module ``name`` (registered, so the JAX
    examples' own ``from ex_game import ...`` finds the same module)."""
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def recording(monkeypatch, owner, attr):
    """Replace ``owner.attr`` (a class) with a subclass that keeps every
    instance it builds; returns that list."""
    made = []
    base = getattr(owner, attr)

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(owner, attr, Recorded)
    return made


def assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            w = np.asarray(want[k])
            assert got[k].dtype == w.dtype, f"{path}/{k}: {got[k].dtype} != {w.dtype}"
            np.testing.assert_array_equal(got[k], w, err_msg=f"{path}/{k}")


# -- (a) every port example as a subprocess ------------------------------------


class TestPortExampleSmoke:
    def test_synctest_host_session(self, launched):
        (out,) = finish(launched["synctest_host"])
        assert "no desyncs" in out

    def test_synctest_device_session(self, launched):
        (out,) = finish(launched["synctest_device"])
        assert "device synctest: 100 frames, no desyncs" in out

    def test_p2p_two_processes(self, launched):
        for out in finish(launched["pair"]):
            assert "done: 120 frames" in out and "DesyncDetected" not in out, out

    def test_p2p_both_peers_in_process(self, capsys):
        ports = free_ports(2)
        results = port_ex_game_p2p.run_both(120, ports=ports, device="cpu")
        out = capsys.readouterr().out
        for port, (game, sess, frames, events) in zip(ports, results):
            assert f"[:{port}] done: 120 frames" in out
            assert frames == game.frames_run == 120
            assert not [e for e in events if type(e).__name__ == "DesyncDetected"], events

    def test_p2p_with_spectator(self, launched):
        spec_out, host_out, peer_out = finish(launched["trio"])
        # the spectator must have followed its whole frame budget, not
        # bailed early on a disconnect
        assert "[spectator] done" in spec_out, spec_out
        assert "done: 240 frames" in host_out and "done: 240 frames" in peer_out

    def test_server_massed_hosting(self, launched):
        (out,) = finish(launched["server"])
        assert "SERVER-EXAMPLE-OK" in out
        assert "hosted 4 matches (8 sessions) for 80 frames" in out


# -- (b) in process, bitwise against the JAX examples ---------------------------


@pytest.fixture
def jax_examples():
    return {name: load_jax_example(name)
            for name in ("ex_game", "ex_game_synctest", "ex_game_server")}


def test_synctest_state_matches_jax(jax_examples, monkeypatch):
    games = recording(monkeypatch, jax_examples["ex_game"], "Game")
    monkeypatch.setattr(sys, "argv", ["ex_game_synctest.py", "--frames", "100",
                                      "--check-distance", "3"])
    jax_examples["ex_game_synctest"].main()
    game, sess = port_ex_game_synctest.run_synctest(2, 3, 0, 100, device="cpu")
    assert sess.current_frame == 100 and game.frames_run == games[0].frames_run == 100
    assert_trees_equal(to_numpy(game.executor.state), jax.device_get(games[0].executor.state))


def test_device_session_carry_matches_jax(jax_examples, monkeypatch):
    import ggrs_tpu.sessions

    sessions = recording(monkeypatch, ggrs_tpu.sessions, "DeviceSyncTestSession")
    monkeypatch.setattr(sys, "argv", ["ex_game_synctest.py", "--frames", "100",
                                      "--check-distance", "3", "--device-session"])
    jax_examples["ex_game_synctest"].main()
    _, sess = port_ex_game_synctest.run_synctest(2, 3, 0, 100, device_session=True,
                                                 device="cpu")
    want = jax.device_get(sessions[0]._carry)
    assert_trees_equal(to_numpy(sess.carry), want)
    assert int(np.asarray(want["mismatches"]).sum()) == 0


def test_server_live_states_match_jax(jax_examples, monkeypatch):
    import ggrs_tpu.parallel

    pools = recording(monkeypatch, ggrs_tpu.parallel, "BatchedRequestExecutor")
    monkeypatch.setattr(sys, "argv", ["ex_game_server.py", "--matches", "4", "--frames", "80"])
    assert jax_examples["ex_game_server"].main() == 0
    pool, sessions, desyncs, _ = port_ex_game_server.run_server(4, 80, device="cpu")
    assert desyncs == 0 and len(sessions) == 8
    for b in range(8):
        assert_trees_equal(pool.live_state(b), jax.device_get(pools[0].live_state(b)),
                           f"session {b}")


# -- (c) across packages over loopback UDP --------------------------------------


def test_jax_peer_against_port_peer(launched):
    for out in finish(launched["cross_pair"]):
        assert "done: 240 frames" in out and "DesyncDetected" not in out, out


def test_port_spectator_follows_jax_host(launched):
    spec_out, host_out, peer_out = finish(launched["cross_trio"])
    assert "[spectator] done" in spec_out, spec_out
    for out in (spec_out, host_out, peer_out):
        assert "DesyncDetected" not in out, out
    assert "done: 240 frames" in host_out and "done: 240 frames" in peer_out
