"""The port's ingress plane (``fleet/ingress.py``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_ingress.py``: the route-update and forward frames are
the JAX bytes on seeded inputs, and both decoders give the same verdict on
the same malformed frames; one seeded sequence of route updates gets the
same verdicts from both packages' ``IngressNode``; a JAX serving leg talks
through the port's node over loopback UDP; then the port's node,
``VirtualEndpointSocket`` and an ingress runner spawned from
``scripts/port_shard_runner.py --ingress --tcp`` as the JAX tests drive
theirs.  Tolerance: exact equality."""

from __future__ import annotations

import socket
import time

import numpy as np
import pytest

import ggrs_tpu.fleet.ingress as jingress
import ggrs_tpu.obs as jobs
import ggrs_tpu_torch.fleet.ingress as tingress
from ggrs_tpu_torch.core.errors import InvalidRequest
from ggrs_tpu_torch.fleet import FleetTuning
from ggrs_tpu_torch.fleet.ingress import (
    FWD_HEADER,
    FWD_VERSION,
    INGRESS_MAGIC,
    IngressHandle,
    IngressNode,
    ROUTE_OP_DEL,
    ROUTE_OP_PUT,
    ROUTE_UPDATE,
    ROUTE_WIRE_VERSION,
    VirtualEndpointSocket,
    decode_route_update,
    encode_route_update,
    pack_fwd,
    unpack_fwd,
)
from ggrs_tpu_torch.net.wire import WireError
from ggrs_tpu_torch.obs import Registry
from ggrs_tpu_torch.obs.timeline import (
    ZERO_TRACE_CTX,
    match_trace_id,
    pack_trace_ctx,
    unpack_trace_ctx,
)

PKGS = {"jax": (jingress, jobs.Registry), "port": (tingress, Registry)}


# -- the wire codec, across packages -------------------------------------------------


def _addr(rng):
    return (".".join(str(int(b)) for b in rng.integers(0, 256, size=4)),
            int(rng.integers(0, 65536)))


@pytest.mark.parametrize("case", range(8))
def test_frames_are_the_jax_bytes(case):
    rng = np.random.default_rng(100 + case)
    op = ROUTE_OP_PUT if case % 2 else ROUTE_OP_DEL
    epoch, version = int(rng.integers(0, 2**63)), int(rng.integers(0, 2**63))
    vport, dst = int(rng.integers(0, 65536)), _addr(rng)
    ctx = pack_trace_ctx(f"m{case}", int(rng.integers(0, 2**31)), int(rng.integers(0, 2**31))) \
        if case % 3 else ZERO_TRACE_CTX
    data = tingress.encode_route_update(op, epoch, version, vport, dst, ctx)
    assert data == jingress.encode_route_update(op, epoch, version, vport, dst, ctx)
    assert tingress.decode_route_update(data) == jingress.decode_route_update(data)
    payload = rng.bytes(int(rng.integers(0, 1200)))
    peer = _addr(rng)
    fwd = tingress.pack_fwd(vport, peer, payload)
    assert fwd == jingress.pack_fwd(vport, peer, payload)
    assert tingress.unpack_fwd(fwd) == jingress.unpack_fwd(fwd)


def _verdict(fn, data):
    try:
        return ("ok", fn(data))
    except Exception as e:  # the classes differ by package: compare by name
        return (type(e).__name__, str(e))


def _malformed():
    good_route = jingress.encode_route_update(ROUTE_OP_PUT, 1, 1, 1, ("127.0.0.1", 1))
    good_fwd = jingress.pack_fwd(1, ("1.2.3.4", 9), b"x")
    rng = np.random.default_rng(7)
    frames = [b"", b"GI", b"GI\x01\x01", b"XX" + good_route[2:], good_route[:-1],
              good_route + b"\x00", b"XY" + good_fwd[2:], b"GI\x01", good_fwd[:11]]
    for pos, val in ((2, ROUTE_WIRE_VERSION + 1), (3, 9), (3, 0), (2, 0)):
        bad = bytearray(good_route)
        bad[pos] = val
        frames.append(bytes(bad))
    for pos, val in ((2, FWD_VERSION + 1), (3, 1)):
        bad = bytearray(good_fwd)
        bad[pos] = val
        frames.append(bytes(bad))
    frames += [rng.bytes(n) for n in (12, 44, 60)]
    return frames


@pytest.mark.parametrize("decoder", ["decode_route_update", "unpack_fwd"])
def test_decoders_judge_malformed_frames_as_jax(decoder):
    for data in _malformed():
        assert _verdict(getattr(tingress, decoder), data) == \
            _verdict(getattr(jingress, decoder), data), data


def test_route_fence_verdicts_match_jax():
    """One seeded sequence of PUTs and DELs (stale epochs, stale versions,
    unknown vports, garbage) through both packages' nodes: the same verdict
    for every update, the same routes and counters at the end."""
    rng = np.random.default_rng(11)
    nodes = {pkg: mod.IngressNode(metrics=reg()) for pkg, (mod, reg) in PKGS.items()}
    try:
        vports = {pkg: [n.allocate_endpoint() for _ in range(4)] for pkg, n in nodes.items()}
        assert vports["port"] == vports["jax"]
        updates = []
        for _ in range(200):
            if rng.random() < 0.05:
                updates.append(rng.bytes(int(rng.integers(0, 50))))
                continue
            op = ROUTE_OP_DEL if rng.random() < 0.2 else ROUTE_OP_PUT
            vport = int(rng.choice(vports["port"] + [999]))
            updates.append(jingress.encode_route_update(
                op, int(rng.integers(0, 4)), int(rng.integers(0, 40)), vport,
                ("127.0.0.1", int(rng.integers(40000, 40010)))))
        verdicts = {pkg: [n.apply_route_update(u) for u in updates] for pkg, n in nodes.items()}
        assert verdicts["port"] == verdicts["jax"]
        assert len(set(verdicts["port"])) >= 4
        for attr in ("route_updates", "flips"):
            assert getattr(nodes["port"], attr) == getattr(nodes["jax"], attr)
        routes = {pkg: {v: (e.dst, e.epoch, e.version) for v, e in n._routes.items()}
                  for pkg, n in nodes.items()}
        assert routes["port"] == routes["jax"]
    finally:
        for n in nodes.values():
            n.close()


# -- the port's dataplane (tests/test_ingress.py) -------------------------------------


def _udp(port: int = 0) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", port))
    s.setblocking(False)
    return s


def _recv(sock: socket.socket, timeout: float = 2.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return sock.recvfrom(65535)
        except BlockingIOError:
            time.sleep(0.002)
    raise AssertionError("no datagram arrived")


@pytest.fixture
def node():
    n = IngressNode(metrics=Registry())
    yield n
    n.close()


def _route(node, vport, leg_addr, epoch=1, version=None, op=ROUTE_OP_PUT):
    if version is None:
        _route.v += 1
        version = _route.v
    return node.apply_route_update(encode_route_update(op, epoch, version, vport, leg_addr))


_route.v = 0


class TestRouteUpdateCodec:
    def test_round_trip_put(self):
        data = encode_route_update(ROUTE_OP_PUT, 3, 17, 9, ("127.0.0.1", 40001))
        assert len(data) == ROUTE_UPDATE.size == 44
        assert decode_route_update(data) == (ROUTE_OP_PUT, 3, 17, 9, ("127.0.0.1", 40001),
                                             ZERO_TRACE_CTX)

    def test_trace_ctx_rides_the_frame(self):
        ctx = pack_trace_ctx("m7", 3, 12)
        *_, got = decode_route_update(
            encode_route_update(ROUTE_OP_PUT, 3, 18, 9, ("127.0.0.1", 40001), ctx))
        assert got == ctx
        assert unpack_trace_ctx(got) == (match_trace_id("m7"), 3, 12)

    def test_refusals(self):
        with pytest.raises(WireError, match="bytes"):
            decode_route_update(b"GI\x01\x01")
        data = bytearray(encode_route_update(ROUTE_OP_PUT, 1, 1, 1, ("127.0.0.1", 1)))
        data[3] = 9
        with pytest.raises(WireError, match="op"):
            decode_route_update(bytes(data))
        with pytest.raises(WireError, match="short"):
            unpack_fwd(b"GI\x01")


class TestFwdCodec:
    def test_round_trip(self):
        data = pack_fwd(7, ("192.168.1.20", 5555), b"payload!")
        assert data[:FWD_HEADER.size] == FWD_HEADER.pack(
            INGRESS_MAGIC, FWD_VERSION, 0, 7, 5555, socket.inet_aton("192.168.1.20"))
        assert unpack_fwd(data) == (7, ("192.168.1.20", 5555), b"payload!")
        assert unpack_fwd(pack_fwd(1, ("1.2.3.4", 9), b""))[2] == b""


class TestIngressNodeForwarding:
    def test_forwarded_round_trip(self, node):
        peer, leg = _udp(), _udp()
        try:
            vport = node.allocate_endpoint(peers=[peer.getsockname()])
            assert _route(node, vport, leg.getsockname()) == "ok"
            peer.sendto(b"hello-in", node.public_addr())
            node.pump()
            data, src = _recv(leg)
            got_vport, got_peer, payload = unpack_fwd(data)
            assert (got_vport, got_peer, payload) == (vport, peer.getsockname(), b"hello-in")
            leg.sendto(pack_fwd(vport, got_peer, b"hello-out"), src)
            node.pump()
            data, reply_src = _recv(peer)
            assert data == b"hello-out" and reply_src == node.public_addr()
            assert node.forwarded == {"in": 1, "out": 1}
        finally:
            peer.close()
            leg.close()

    def test_jax_leg_through_the_port_node(self, node):
        """A JAX ``VirtualEndpointSocket`` serves behind the port's node:
        the forward frames are one format."""
        peer = _udp()
        up_host, up_port = node.uplink_addr()
        leg = jingress.VirtualEndpointSocket(up_host, up_port, vport=0)
        try:
            vport = node.allocate_endpoint(peers=[peer.getsockname()])
            leg.vport = vport
            assert _route(node, vport, ("127.0.0.1", leg.local_port())) == "ok"
            peer.sendto(b"from-peer", node.public_addr())
            node.pump()
            deadline, got = time.monotonic() + 2.0, []
            while not got and time.monotonic() < deadline:
                got = leg.receive_all_datagrams()
            assert got == [(peer.getsockname(), b"from-peer")]
            leg.send_datagram(b"to-peer", peer.getsockname())
            time.sleep(0.02)
            node.pump()
            data, src = _recv(peer)
            assert (data, src) == (b"to-peer", node.public_addr())
        finally:
            leg.close()
            peer.close()

    def test_unrouted_vport_drops(self, node):
        peer = _udp()
        try:
            node.allocate_endpoint(peers=[peer.getsockname()])
            peer.sendto(b"early", node.public_addr())
            node.pump()
            assert node.dropped.get("no-route") == 1
        finally:
            peer.close()

    def test_fenced_sender_cannot_speak(self, node):
        peer, old_leg, new_leg = _udp(), _udp(), _udp()
        try:
            vport = node.allocate_endpoint(peers=[peer.getsockname()])
            assert _route(node, vport, old_leg.getsockname()) == "ok"
            assert _route(node, vport, new_leg.getsockname()) == "ok"
            assert node.flips == 1
            old_leg.sendto(pack_fwd(vport, peer.getsockname(), b"stale!"), node.uplink_addr())
            node.pump()
            assert node.dropped.get("fenced-sender") == 1
            with pytest.raises(AssertionError):
                _recv(peer, timeout=0.05)
        finally:
            peer.close()
            old_leg.close()
            new_leg.close()

    def test_unclaimed_peer_never_hears(self, node):
        leg, stranger = _udp(), _udp()
        try:
            vport = node.allocate_endpoint()
            assert _route(node, vport, leg.getsockname()) == "ok"
            leg.sendto(pack_fwd(vport, stranger.getsockname(), b"psst"), node.uplink_addr())
            node.pump()
            assert node.dropped.get("unclaimed-peer") == 1
        finally:
            leg.close()
            stranger.close()

    def test_claim_unknown_vport_refused(self, node):
        with pytest.raises(InvalidRequest, match="no virtual endpoint"):
            node.claim_peers(42, [("127.0.0.1", 1)])


class TestRouteFence:
    def test_stale_epoch_and_version_refused(self, node):
        vport = node.allocate_endpoint()
        assert _route(node, vport, ("127.0.0.1", 40000), epoch=2, version=5) == "ok"
        assert _route(node, vport, ("127.0.0.1", 40001), epoch=1) == "stale-epoch"
        assert _route(node, vport, ("127.0.0.1", 40001), epoch=2, version=5) == "stale-version"
        assert _route(node, vport, ("127.0.0.1", 40001), epoch=2, version=6) == "ok"

    def test_fence_survives_delete(self, node):
        vport = node.allocate_endpoint()
        assert _route(node, vport, ("127.0.0.1", 40000), epoch=2, version=10) == "ok"
        assert _route(node, vport, ("127.0.0.1", 40000), epoch=2, version=11,
                      op=ROUTE_OP_DEL) == "ok"
        assert vport not in node._routes
        assert _route(node, vport, ("127.0.0.1", 40666), epoch=1, version=99) == "stale-epoch"

    def test_verdicts_counted(self, node):
        vport = node.allocate_endpoint()
        _route(node, vport, ("127.0.0.1", 40000), epoch=2)
        _route(node, vport, ("127.0.0.1", 40001), epoch=1)
        assert _route(node, 777, ("127.0.0.1", 1)) == "unknown-vport"
        assert node.apply_route_update(b"junk") == "bad-frame"
        reg = node.metrics
        assert reg.value("ggrs_ingress_route_updates_total", verdict="ok") == 1
        assert reg.value("ggrs_ingress_route_updates_total", verdict="stale-epoch") == 1


class TestVirtualEndpointSocket:
    def test_wraps_and_unwraps(self):
        uplink = _udp()
        try:
            up_host, up_port = uplink.getsockname()
            leg = VirtualEndpointSocket(up_host, up_port, vport=5)
            try:
                peer = ("203.0.113.9", 7777)
                leg.send_datagram(b"to-peer", peer)
                data, src = _recv(uplink)
                assert unpack_fwd(data) == (5, peer, b"to-peer")
                assert src[1] == leg.local_port()
                uplink.sendto(pack_fwd(5, peer, b"from-peer"), ("127.0.0.1", leg.local_port()))
                uplink.sendto(pack_fwd(6, peer, b"wrong-vport"), ("127.0.0.1", leg.local_port()))
                deadline, got = time.monotonic() + 2.0, []
                while not got and time.monotonic() < deadline:
                    got = leg.receive_all_datagrams()
                assert got == [(peer, b"from-peer")]
            finally:
                leg.close()
        finally:
            uplink.close()

    def test_batch_send_and_strangers(self):
        uplink, stranger = _udp(), _udp()
        try:
            up_host, up_port = uplink.getsockname()
            leg = VirtualEndpointSocket(up_host, up_port, vport=3)
            try:
                leg.send_datagram_batch([(b"a", ("1.2.3.4", 10)), (b"b", ("1.2.3.4", 11))])
                seen = {unpack_fwd(_recv(uplink)[0]) for _ in range(2)}
                assert seen == {(3, ("1.2.3.4", 10), b"a"), (3, ("1.2.3.4", 11), b"b")}
                stranger.sendto(pack_fwd(3, ("1.2.3.4", 9), b"forged"),
                                ("127.0.0.1", leg.local_port()))
                time.sleep(0.05)
                assert leg.receive_all_datagrams() == []
            finally:
                leg.close()
        finally:
            uplink.close()
            stranger.close()


class TestIngressRunnerE2E:
    def test_spawned_runner_serves_control_and_dataplane(self):
        tuning = FleetTuning(
            heartbeat_interval_s=0.05, heartbeat_deadline_s=1.0, rpc_timeout_s=5.0,
            spawn_timeout_s=120.0, drain_deadline_s=2.0, link_auth_token="ingress-e2e-token",
            link_reconnect_window_s=2.0, link_backoff_s=0.01, link_handshake_timeout_s=1.0,
        )
        handle = IngressHandle("ing0", tuning=tuning, metrics=Registry(), spawn_child=True)
        peer = leg = None
        try:
            hello = handle.adopt()
            assert hello["role"] == "ingress"
            with open(f"/proc/{handle.pid}/cmdline", "rb") as f:
                assert b"port_shard_runner.py" in f.read()
            public = handle.public_addr()
            peer, leg = _udp(), _udp()
            vport = handle.allocate_endpoint(peers=[peer.getsockname()])
            assert handle.apply_route_update(encode_route_update(
                ROUTE_OP_PUT, 1, 1, vport, leg.getsockname())) == "ok"
            peer.sendto(b"over-the-wall", tuple(public))
            data, src = _recv(leg, timeout=10.0)
            got_vport, got_peer, payload = unpack_fwd(data)
            assert (got_vport, payload) == (vport, b"over-the-wall")
            leg.sendto(pack_fwd(vport, got_peer, b"and-back"), src)
            data, reply_src = _recv(peer, timeout=10.0)
            assert (data, reply_src) == (b"and-back", tuple(public))
            assert handle.apply_route_update(encode_route_update(
                ROUTE_OP_PUT, 0, 99, vport, leg.getsockname())) == "stale-epoch"
            info = handle.info()
            assert info["routes"] == 1
            assert info["forwarded"]["in"] >= 1 and info["forwarded"]["out"] >= 1
        finally:
            for s in (peer, leg):
                if s is not None:
                    s.close()
            handle.close()
