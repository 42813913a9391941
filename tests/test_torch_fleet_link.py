"""The port's fleet link (``fleet/transport.py`` and the TCP half of
``fleet/proc.py``) against the JAX package's, on the CPU.

Mirrors ``tests/test_fleet_link.py`` and the TCP classes of
``tests/test_fleet_rpc.py`` (the adversarial handshakes and the fd hygiene
of their error paths).  The handshake's records are compared byte for byte
with the JAX package's on seeded inputs, and a runner of one package
completes the handshake against the other's listener.  The runners spawned
here are the port's (``scripts/port_shard_runner.py``).  No test reads a
verdict derived from the wall clock (``healthz()["ok"]``, heartbeat ages)."""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import ggrs_tpu.fleet.transport as jtransport
import ggrs_tpu_torch.fleet.transport as ttransport
from ggrs_tpu.obs import Registry as JaxRegistry
from ggrs_tpu_torch.fleet import FleetTuning, ShardSupervisor
from ggrs_tpu_torch.fleet.proc import PROC_EXITED, PROC_RUNNING, ProcShard
from ggrs_tpu_torch.fleet.transport import (
    CHALLENGE,
    HS_MAGIC_AUTH,
    HS_OK_FRESH,
    HS_REFUSED_AUTH,
    HS_REFUSED_FENCE,
    HS_REFUSED_VERSION,
    LINK_UP,
    VERDICT,
    HandshakeError,
    RunnerLink,
    ShardLink,
    client_handshake,
    pack_auth,
)
from ggrs_tpu_torch.obs import Registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "scripts", "port_shard_runner.py")

# tests/test_fleet_link.py's tuning
TUNING = FleetTuning(
    heartbeat_interval_s=0.05,
    heartbeat_deadline_s=1.0,
    rpc_timeout_s=5.0,
    spawn_timeout_s=120.0,
    drain_deadline_s=0.5,
    restart_max=3,
    link_auth_token="e2e-token",
    link_reconnect_window_s=2.0,
    link_backoff_s=0.01,
    link_handshake_timeout_s=1.0,
)
# tests/test_fleet_rpc.py's tuning for the bare link
LINK_TUNING = FleetTuning(
    link_auth_token="test-token",
    link_reconnect_window_s=1.0,
    link_handshake_timeout_s=0.4,
    link_backoff_s=0.01,
)


# -- the handshake's bytes --------------------------------------------------------


@pytest.mark.parametrize("case", range(6))
def test_auth_records_are_the_jax_bytes(case):
    rng = np.random.default_rng(case)
    token = "".join(chr(c) for c in rng.integers(33, 127, size=int(rng.integers(1, 40))))
    nonce = rng.bytes(16)
    prefix = rng.bytes(int(rng.integers(0, 64)))
    kw = dict(epoch=int(rng.integers(0, 2**63)), cursor=int(rng.integers(0, 2**63)),
              shard_id="s" + "x" * int(rng.integers(0, 24)), resume=bool(case % 2))
    assert ttransport.handshake_mac(token, nonce, prefix) == \
        jtransport.handshake_mac(token, nonce, prefix)
    assert ttransport.pack_auth(token, nonce, **kw) == jtransport.pack_auth(token, nonce, **kw)


def test_wire_layouts_and_codes_match_jax():
    names = ("CHALLENGE", "AUTH_PREFIX", "AUTH", "VERDICT", "TRACE_CTX")
    for name in names:
        assert getattr(ttransport, name).format == getattr(jtransport, name).format, name
    for name in dir(jtransport):
        if name.startswith(("HS_", "LINK_", "AUTH_FLAG")) or name.endswith("_BYTES"):
            assert getattr(ttransport, name) == getattr(jtransport, name), name


def _serve_one(link, result):
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        ev = link.pump()
        if ev is not None:
            result["event"] = ev
            return
        time.sleep(0.005)


@pytest.mark.parametrize("server,client", [("port", "jax"), ("jax", "port")])
def test_handshake_across_packages(server, client):
    """A runner of one package is granted the other's link: the
    challenge, the MAC'd auth record and the verdict are the same bytes."""
    mods = {"port": (ttransport, Registry), "jax": (jtransport, JaxRegistry)}
    smod, sreg = mods[server]
    cmod = mods[client][0]
    link = smod.ShardLink("s0", LINK_TUNING, metrics=sreg())
    result = {}
    try:
        link.mint_epoch()
        t = threading.Thread(target=_serve_one, args=(link, result))
        t.start()
        s = socket.create_connection(link.address, timeout=2.0)
        try:
            code, granted, cursor = cmod.client_handshake(
                s, token="test-token", shard_id="s0", epoch=0, cursor=0,
                resume=False, timeout=2.0)
        finally:
            s.close()
        t.join(timeout=5.0)
        assert result["event"][0] == "fresh"
        result["event"][1].close()
        assert (code, granted, cursor) == (HS_OK_FRESH, link.epoch, 0)
    finally:
        link.close()


# -- adversarial handshakes (tests/test_fleet_rpc.py) ------------------------------


def _count_fds() -> int:
    return len(os.listdir("/proc/self/fd"))


def _mk_link(**kw):
    return ShardLink("s0", LINK_TUNING, metrics=Registry(), **kw)


def _dial_raw(link):
    s = socket.create_connection(link.address, timeout=2.0)
    s.settimeout(2.0)
    return s


def _pump_until(link, pred, timeout=3.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ev = link.pump()
        if pred(ev, link):
            return ev
        time.sleep(0.005)
    raise AssertionError("link pump never reached the condition")


def _read_challenge(sock):
    raw = b""
    while len(raw) < CHALLENGE.size:
        raw += sock.recv(CHALLENGE.size - len(raw))
    return CHALLENGE.unpack(raw)


def _read_verdict(sock):
    raw = b""
    while len(raw) < VERDICT.size:
        chunk = sock.recv(VERDICT.size - len(raw))
        if not chunk:
            raise AssertionError("no verdict before close")
        raw += chunk
    return VERDICT.unpack(raw)


def _pending(ev, lk):
    return lk.info()["pending"] == 1


class TestTcpHandshakeAdversarial:
    def test_wrong_token_refused(self):
        link = _mk_link()
        try:
            s = _dial_raw(link)
            _pump_until(link, _pending)
            _, _, _, nonce = _read_challenge(s)
            s.sendall(pack_auth("WRONG-token", nonce, epoch=0, cursor=0,
                                shard_id="s0", resume=False))
            _pump_until(link, lambda ev, lk: lk.refusals.get("auth"))
            _, _, code, _, _ = _read_verdict(s)
            assert code == HS_REFUSED_AUTH
            assert link.link_state == "connecting"
            s.close()
        finally:
            link.close()

    def test_replayed_handshake_refused(self):
        link = _mk_link()
        try:
            s1 = _dial_raw(link)
            _pump_until(link, _pending)
            _, _, _, nonce1 = _read_challenge(s1)
            record = pack_auth("test-token", nonce1, epoch=0, cursor=0,
                               shard_id="s0", resume=False)
            s1.close()
            _pump_until(link, lambda ev, lk: lk.info()["pending"] == 0)
            s2 = _dial_raw(link)
            _pump_until(link, _pending)
            _read_challenge(s2)
            s2.sendall(record)
            _pump_until(link, lambda ev, lk: lk.refusals.get("auth"))
            _, _, code, _, _ = _read_verdict(s2)
            assert code == HS_REFUSED_AUTH
            s2.close()
        finally:
            link.close()

    def test_stale_epoch_fenced(self):
        link = _mk_link()
        try:
            link.mint_epoch()
            link.mint_epoch()
            s = _dial_raw(link)
            _pump_until(link, _pending)
            _, _, _, nonce = _read_challenge(s)
            s.sendall(pack_auth("test-token", nonce, epoch=1, cursor=0,
                                shard_id="s0", resume=True))
            _pump_until(link, lambda ev, lk: lk.refusals.get("fence"))
            _, _, code, current, _ = _read_verdict(s)
            assert code == HS_REFUSED_FENCE and current == 2
            s.close()
        finally:
            link.close()

    def test_wrong_version_refused(self):
        link = _mk_link()
        try:
            s = _dial_raw(link)
            _pump_until(link, _pending)
            _, _, _, nonce = _read_challenge(s)
            rec = bytearray(pack_auth("test-token", nonce, epoch=0, cursor=0,
                                      shard_id="s0", resume=False))
            rec[2] = 99
            s.sendall(bytes(rec))
            _pump_until(link, lambda ev, lk: lk.refusals.get("version"))
            _, _, code, _, _ = _read_verdict(s)
            assert code == HS_REFUSED_VERSION
            s.close()
        finally:
            link.close()

    def test_truncated_auth_counted_not_wedged(self):
        link = _mk_link()
        try:
            s = _dial_raw(link)
            _pump_until(link, _pending)
            _read_challenge(s)
            s.sendall(HS_MAGIC_AUTH + b"\x01")
            s.close()
            _pump_until(link, lambda ev, lk: lk.refusals.get("eof"))
            assert link.info()["pending"] == 0
        finally:
            link.close()

    def test_slowloris_dribble_times_out(self):
        link = _mk_link()
        try:
            s = _dial_raw(link)
            _pump_until(link, _pending)
            _read_challenge(s)
            s.sendall(HS_MAGIC_AUTH)
            t0 = time.monotonic()
            _pump_until(link, lambda ev, lk: lk.refusals.get("timeout"))
            assert time.monotonic() - t0 < 3.0
            assert link.info()["pending"] == 0
            s.close()
        finally:
            link.close()

    def test_garbage_before_magic_dropped_early(self):
        link = _mk_link()
        try:
            s = _dial_raw(link)
            _pump_until(link, _pending)
            _read_challenge(s)
            s.sendall(b"GET / HTTP/1.1\r\n\r\n")
            _pump_until(link, lambda ev, lk: lk.refusals.get("garbage"), timeout=0.3)
            assert link.info()["pending"] == 0
            s.close()
        finally:
            link.close()

    def test_fresh_handshake_grants_epoch(self):
        link = _mk_link()
        result = {}
        try:
            link.mint_epoch()

            def dial():
                s = socket.create_connection(link.address, timeout=2.0)
                try:
                    result["verdict"] = client_handshake(
                        s, token="test-token", shard_id="s0", epoch=0,
                        cursor=0, resume=False, timeout=2.0)
                finally:
                    s.close()

            t = threading.Thread(target=dial)
            t.start()
            ev = _pump_until(link, lambda ev, lk: ev is not None)
            t.join(timeout=2.0)
            assert ev[0] == "fresh" and ev[1] is not None
            ev[1].close()
            code, granted, cursor = result["verdict"]
            assert code == HS_OK_FRESH and granted == link.epoch and cursor == 0
        finally:
            link.close()


class TestHandshakeFdHygiene:
    def test_refused_and_garbage_paths_leak_nothing(self):
        base = _count_fds()
        link = _mk_link()
        try:
            for payload in (b"junkjunkjunk", HS_MAGIC_AUTH + b"\x00"):
                s = _dial_raw(link)
                _pump_until(link, _pending)
                _read_challenge(s)
                s.sendall(payload)
                if payload.startswith(HS_MAGIC_AUTH):
                    s.close()
                    _pump_until(link, lambda ev, lk: lk.refusals.get("eof"))
                else:
                    _pump_until(link, lambda ev, lk: lk.refusals.get("garbage"))
                    s.close()
            s = _dial_raw(link)
            _pump_until(link, _pending)
            _, _, _, nonce = _read_challenge(s)
            s.sendall(pack_auth("bad", nonce, epoch=0, cursor=0, shard_id="s0", resume=False))
            _pump_until(link, lambda ev, lk: lk.refusals.get("auth"))
            s.close()
            assert link.info()["pending"] == 0
        finally:
            link.close()
        assert _count_fds() == base, "handshake error path leaked an fd"

    def test_timeout_mid_handshake_leaks_nothing(self):
        base = _count_fds()
        link = _mk_link()
        try:
            s = _dial_raw(link)
            _pump_until(link, _pending)
            _read_challenge(s)
            _pump_until(link, lambda ev, lk: lk.refusals.get("timeout"))
            s.close()
        finally:
            link.close()
        assert _count_fds() == base

    def test_client_refused_version_leaks_nothing(self):
        base = _count_fds()
        with socket.socket() as srv:
            srv.bind(("127.0.0.1", 0))
            srv.listen(1)
            addr = srv.getsockname()[:2]

            def server():
                c, _ = srv.accept()
                with c:
                    c.sendall(CHALLENGE.pack(b"GC", 99, 0, b"\x00" * 16))
                    c.recv(256)

            t = threading.Thread(target=server)
            t.start()
            rl = RunnerLink(addr[0], addr[1], token="x", shard_id="s0")
            with pytest.raises(HandshakeError):
                rl.dial_fresh(timeout=1.0)
            t.join(timeout=2.0)
        assert _count_fds() == base


# -- a real runner over the link (tests/test_fleet_link.py) -------------------------


def _poll_until(shard, pred, timeout=10.0, expect=(None,)):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        r = shard.poll_lifecycle()
        assert r in expect, f"unexpected lifecycle verdict {r!r}"
        if pred(shard):
            return
        time.sleep(0.02)
    raise AssertionError("condition not reached before timeout")


@pytest.fixture
def shard():
    s = ProcShard("s0", tuning=TUNING, metrics=Registry(), tcp=True)
    yield s
    for p in s._all_procs:
        if p.poll() is None:
            try:
                os.kill(p.pid, signal.SIGCONT)
            except (OSError, ProcessLookupError):
                pass
            p.kill()
            p.wait(timeout=10)
    s.close()


class TestTcpSpawn:
    def test_spawn_serves_over_tcp(self, shard):
        assert shard._status == PROC_RUNNING
        info = shard.link_info()
        assert info["state"] == LINK_UP and info["epoch"] == 1
        h = shard.healthz()
        assert h["link"]["state"] == "up" and h["pid"] == shard.pid
        assert h["backend"] == "proc" and h["alive"]
        # the runner is the port's script
        with open(f"/proc/{shard.pid}/cmdline", "rb") as f:
            assert b"port_shard_runner.py" in f.read()
        _poll_until(shard, lambda s: s.heartbeat_age_s() is not None)

    def test_sever_resumes_with_zero_failovers(self, shard):
        shard.chaos_sever_link()
        _poll_until(shard, lambda s: s.link_info()["reconnects"] >= 1
                    and s.link_info()["state"] == LINK_UP)
        info = shard.link_info()
        assert info["reconnects"] == 1 and info["window_expiries"] == 0
        assert info["epoch"] == 1
        assert shard._call("ping") is not None

    def test_half_open_sever_resumes(self, shard):
        shard.chaos_sever_link("wr")
        _poll_until(shard, lambda s: s.link_info()["reconnects"] == 1)
        assert shard.link_info()["state"] == LINK_UP

    def test_window_expiry_confirms_death_without_kill(self, shard):
        pid = shard.pid
        os.kill(pid, signal.SIGSTOP)
        try:
            shard.chaos_sever_link()
            deadline = time.monotonic() + 15
            died = None
            while time.monotonic() < deadline:
                died = shard.poll_lifecycle()
                if died is not None:
                    break
                time.sleep(0.02)
            assert died == "died"
            assert shard._status == PROC_EXITED
            assert "fenced" in (shard.last_exit or "")
            assert shard.link_info()["window_expiries"] == 1
            assert shard.link_info()["epoch"] == 2
            os.kill(pid, 0)  # not signalled: still exists (stopped)
        finally:
            os.kill(pid, signal.SIGCONT)

    def test_resurrected_stale_runner_fenced_at_handshake(self, shard):
        old_pid = shard.pid
        old_proc = shard._proc
        os.kill(old_pid, signal.SIGSTOP)
        shard.chaos_sever_link()
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if shard.poll_lifecycle() is not None:
                break
            time.sleep(0.02)
        assert shard._status == PROC_EXITED
        os.kill(old_pid, signal.SIGCONT)
        assert shard.try_respawn()
        assert shard._status == PROC_RUNNING and shard.pid != old_pid
        assert shard.link_info()["epoch"] == 3
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            shard.poll_lifecycle()
            if old_proc.poll() is not None and shard.link_info()["refusals"].get("fence"):
                break
            time.sleep(0.02)
        assert shard.link_info()["refusals"].get("fence", 0) >= 1
        assert old_proc.poll() == 1
        assert shard.link_info()["state"] == LINK_UP
        assert shard._call("ping") is not None


def _external_runner(shard, token):
    host, port = shard._link.address
    env = dict(os.environ, GGRS_FLEET_LINK_AUTH_TOKEN=token, GGRS_FLEET_LINK_SHARD="s9")
    return subprocess.Popen([sys.executable, RUNNER, "--tcp", f"{host}:{port}"],
                            env=env, cwd=REPO)


class TestTcpAdoption:
    def test_adopt_external_runner(self):
        shard = ProcShard("s9", tuning=TUNING, metrics=Registry(), tcp=True, spawn=False)
        proc = None
        try:
            proc = _external_runner(shard, TUNING.link_auth_token)
            shard.adopt_tcp(timeout=120.0)
            assert shard._status == PROC_RUNNING
            assert shard.link_info()["state"] == LINK_UP
            assert shard.pid == proc.pid
        finally:
            shard.close()
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)

    def test_wrong_token_runner_never_adopted(self):
        shard = ProcShard("s9", tuning=TUNING, metrics=Registry(), tcp=True, spawn=False)
        proc = None
        try:
            proc = _external_runner(shard, "not-the-token")
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                shard._link.pump()
                if proc.poll() is not None:
                    break
                time.sleep(0.02)
            assert proc.poll() == 1
            assert shard._link.refusals.get("auth", 0) >= 1
            assert shard._status == PROC_EXITED
        finally:
            shard.close()
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


class TestSupervisorTcp:
    def test_tcp_shards_must_be_proc_backed(self):
        with pytest.raises(ValueError, match="tcp_shards"):
            ShardSupervisor(("a", "b"), tuning=TUNING, tcp_shards=("a",))

    def test_healthz_carries_link_state_and_renders_in_fleet_top(self):
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        try:
            from fleet_top import render
        finally:
            sys.path.pop(0)
        from ggrs_tpu_torch.obs.exporters import json_snapshot

        sup = ShardSupervisor(("s0", "s1"), capacity=4, metrics=Registry(), tuning=TUNING,
                              proc_shards=("s1",), tcp_shards=("s1",))
        try:
            h = sup.healthz()
            assert h["proc"]["s1"]["link"]["state"] == "up"
            assert h["shards"]["s1"]["link"]["epoch"] == 1
            assert h["shards"]["s0"].get("link") is None
            out = render(h, json_snapshot(sup.metrics))
            assert "LINK" in out and "up/e1" in out
        finally:
            sup.close()
        assert sup.shards["s1"].orphan_count() == 0
