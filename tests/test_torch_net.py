"""The port's wire against the JAX package's, on the CPU.

Every message type, the input codec, the frame-advantage averaging and the
endpoint protocol must be the JAX package's byte for byte and event for
event, so that a JAX peer and a port peer can play one match.  Inputs come
from numpy seeds.  The JAX side runs as its own tests run it (its native
codec and endpoint core when they are built, which its tests pin to its
Python codec); the port has the Python codec only.  Tolerance: exact
equality everywhere."""

import random

import numpy as np
import pytest

import ggrs_tpu.core as jcore
import ggrs_tpu.net.compression as jcomp
import ggrs_tpu.net.messages as jmsg
import ggrs_tpu.net.protocol as jproto
import ggrs_tpu.net.sockets as jsock
from ggrs_tpu.core.frame_info import PlayerInput as JPlayerInput
from ggrs_tpu.core.time_sync import TimeSync as JTimeSync
from ggrs_tpu.core.varrec import envelope_pack as jenvelope_pack
from ggrs_tpu.net.wire import WireError as JWireError

import ggrs_tpu_torch.core as tcore
import ggrs_tpu_torch.net.compression as tcomp
import ggrs_tpu_torch.net.messages as tmsg
import ggrs_tpu_torch.net.protocol as tproto
import ggrs_tpu_torch.net.sockets as tsock
from ggrs_tpu_torch.core.frame_info import PlayerInput as TPlayerInput
from ggrs_tpu_torch.core.time_sync import TimeSync as TTimeSync
from ggrs_tpu_torch.core.varrec import envelope_pack as tenvelope_pack
from ggrs_tpu_torch.net.wire import WireError as TWireError
from ggrs_tpu_torch.net.wire import Writer

BODY_KINDS = ("input", "ack", "quality_report", "quality_reply", "checksum",
              "keep_alive", "sync_request", "sync_reply")


# -- messages -----------------------------------------------------------------


def _body_fields(rng, kind):
    """Field values of one random body of ``kind``, as plain Python ints."""
    big = lambda bits: int(rng.integers(0, 1 << min(bits, 63))) << max(0, bits - 63)
    frame = lambda: int(rng.choice([-1, int(rng.integers(0, 1 << 40)), int(rng.integers(0, 100))]))
    if kind == "input":
        n = int(rng.choice([0, 1, 2, 4, int(rng.integers(5, 65))]))
        return dict(
            peer_connect_status=[(bool(rng.integers(2)), frame()) for _ in range(n)],
            disconnect_requested=bool(rng.integers(2)),
            start_frame=frame(), ack_frame=frame(),
            bytes=rng.integers(0, 256, size=int(rng.integers(0, 48)), dtype=np.uint8).tobytes(),
        )
    if kind == "ack":
        return dict(ack_frame=int(rng.choice([-1, int(rng.integers(0, 1 << 62))])))
    if kind == "quality_report":
        return dict(frame_advantage=int(rng.integers(-32768, 32768)), ping=big(64))
    if kind == "quality_reply":
        return dict(pong=big(64))
    if kind == "checksum":
        return dict(checksum=big(64) | (big(64) << 64), frame=frame())
    if kind == "keep_alive":
        return {}
    return dict(random=int(rng.integers(0, 1 << 32)))


def _message(msg_mod, magic, kind, fields):
    cls = {"input": msg_mod.InputMessage, "ack": msg_mod.InputAck,
           "quality_report": msg_mod.QualityReport, "quality_reply": msg_mod.QualityReply,
           "checksum": msg_mod.ChecksumReport, "keep_alive": msg_mod.KeepAlive,
           "sync_request": msg_mod.SyncRequest, "sync_reply": msg_mod.SyncReply}[kind]
    fields = dict(fields)
    if "peer_connect_status" in fields:
        fields["peer_connect_status"] = [
            msg_mod.ConnectionStatus(d, f) for d, f in fields["peer_connect_status"]]
    return msg_mod.Message(magic=magic, body=cls(**fields))


def _plain(msg):
    """A decoded message as plain data: (magic, body type, field values)."""
    body = msg.body
    values = []
    for name in type(body).__slots__:
        v = getattr(body, name)
        if name == "peer_connect_status":
            v = [(s.disconnected, s.last_frame) for s in v]
        values.append((name, v))
    return msg.magic, type(body).__name__, values


def _decode_outcome(msg_mod, err_type, data):
    try:
        return ("ok", _plain(msg_mod.Message.decode(data)))
    except err_type:
        return ("wire_error",)


@pytest.mark.parametrize("kind", BODY_KINDS)
@pytest.mark.parametrize("seed", range(6))
def test_message_bytes_and_fields_match(kind, seed):
    rng = np.random.default_rng(1000 * seed + BODY_KINDS.index(kind))
    magic = int(rng.integers(1, 1 << 16))
    fields = _body_fields(rng, kind)
    port, jax_ = _message(tmsg, magic, kind, fields), _message(jmsg, magic, kind, fields)
    data = port.encode()
    assert data == jax_.encode()
    assert _plain(tmsg.Message.decode(data)) == _plain(jmsg.Message.decode(data))
    assert _plain(tmsg.Message.decode(data)) == _plain(port)
    # RawMessage is what the endpoint queues: it decodes lazily
    raw = tmsg.RawMessage(data)
    assert raw.encode() == data and raw.magic == magic


def _mutations(rng, data):
    """Truncated, garbled and oversized variants of one datagram."""
    out = [data[:n] for n in range(len(data))]
    for _ in range(12):
        b = bytearray(data)
        for i in rng.integers(0, len(b), size=int(rng.integers(1, 4))):
            b[i] ^= int(rng.integers(1, 256))
        out.append(bytes(b))
    out.append(data + b"\x00")
    out.append(data + rng.integers(0, 256, size=9, dtype=np.uint8).tobytes())
    out.append(data[:3] + b"\xff" * 11 + data[3:])  # a uvarint past 64 bits
    return out


@pytest.mark.parametrize("kind", BODY_KINDS)
@pytest.mark.parametrize("seed", range(3))
def test_malformed_datagrams_decode_alike(kind, seed):
    rng = np.random.default_rng(77 + 10 * seed + BODY_KINDS.index(kind))
    data = _message(tmsg, int(rng.integers(1, 1 << 16)), kind, _body_fields(rng, kind)).encode()
    for bad in _mutations(rng, data):
        assert _decode_outcome(tmsg, TWireError, bad) == _decode_outcome(jmsg, JWireError, bad), bad


@pytest.mark.parametrize("case", ["65_statuses", "bad_tag", "bad_bool", "long_bytes",
                                  "empty", "ack_trailing", "huge_frame"])
def test_oversized_and_invalid_datagrams_decode_alike(case):
    w = Writer().u16(0x1234)
    if case == "65_statuses":
        w.u8(0).uvarint(65)
        for _ in range(65):
            w.bool(False).svarint(3)
        w.bool(False).svarint(0).svarint(-1).bytes(b"\x00\x01")
    elif case == "bad_tag":
        w.u8(9)
    elif case == "bad_bool":
        w.u8(0).uvarint(1).u8(2).svarint(0).bool(False).svarint(0).svarint(0).bytes(b"")
    elif case == "long_bytes":
        w.u8(0).uvarint(0).bool(False).svarint(0).svarint(0).uvarint(1 << 40).raw(b"\x00" * 8)
    elif case == "empty":
        w = Writer()
    elif case == "ack_trailing":
        w.u8(1).svarint(5).u8(0)
    else:  # a frame beyond i64, which only the Python varint reader surfaces
        w.u8(4).uvarint((1 << 70) - 1).u128(7)
    data = w.finish()
    assert _decode_outcome(tmsg, TWireError, data) == _decode_outcome(jmsg, JWireError, data)


@pytest.mark.parametrize("ack_frame", [-1, 0, 1, 63, 64, 1 << 20, (1 << 62) - 1, -(1 << 40)])
def test_input_ack_fast_paths_match(ack_frame):
    data = tmsg.encode_input_ack(0xBEEF, ack_frame)
    assert data == jmsg.encode_input_ack(0xBEEF, ack_frame)
    assert data == tmsg.Message(0xBEEF, tmsg.InputAck(ack_frame)).encode()
    assert tmsg.parse_input_ack_frame(data) == jmsg.parse_input_ack_frame(data) == ack_frame


# -- the input codec ------------------------------------------------------------


def _codec_case(rng, case):
    """(reference, inputs) for one codec case."""
    rand = lambda n: rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
    if case == "fixed":
        k = int(rng.integers(1, 17))
        return rand(k), [rand(k) for _ in range(int(rng.integers(1, 40)))]
    if case == "fixed_held":  # held buttons: long zero runs after the delta
        k = int(rng.integers(1, 9))
        held = rand(k)
        return rand(k), [held] * int(rng.integers(1, 60)) + [rand(k)]
    if case == "variable":
        return rand(int(rng.integers(0, 12))), [rand(int(rng.integers(0, 20)))
                                                 for _ in range(int(rng.integers(0, 30)))]
    if case == "varrec":
        cap = int(rng.integers(4, 40))
        recs = [rand(int(rng.integers(0, cap + 1))) for _ in range(int(rng.integers(1, 30)))]
        envs = [tenvelope_pack(r, cap) for r in recs]
        assert envs == [jenvelope_pack(r, cap) for r in recs]
        return tenvelope_pack(b"", cap), envs
    if case == "empty":
        return rand(int(rng.integers(0, 4))), []
    if case == "empty_reference":
        return b"", [rand(3), b"", rand(5)]
    # long: hundreds of inputs and runs longer than one varint byte
    k = int(rng.integers(64, 1100))
    return bytes(k), [bytes(k)] * 300 + [rand(k)] + [bytes(k)] * 5


CODEC_CASES = ("fixed", "fixed_held", "variable", "varrec", "empty", "empty_reference", "long")


@pytest.mark.parametrize("case", CODEC_CASES)
@pytest.mark.parametrize("seed", range(4))
def test_compression_matches_byte_for_byte(case, seed):
    rng = np.random.default_rng(500 + 10 * seed + CODEC_CASES.index(case))
    reference, inputs = _codec_case(rng, case)
    data = tcomp.encode(reference, inputs)
    assert data == jcomp.encode_py(reference, inputs)
    assert data == jcomp.encode(reference, inputs)
    decoded = tcomp.decode(reference, data) if inputs or reference else None
    if decoded is not None:
        assert decoded == list(inputs) == jcomp.decode_py(reference, data)
    # every garbling fails or succeeds alike
    for bad in _mutations(rng, data)[: 40]:
        outcome = []
        for mod, err in ((tcomp, tcomp.CodecError), (jcomp, jcomp.CodecError)):
            try:
                outcome.append(("ok", mod.decode(reference, bad)))
            except err:
                outcome.append(("codec_error",))
        assert outcome[0] == outcome[1], bad


def test_compression_refuses_oversized_claims_alike():
    for data in (
        Writer().u8(0).bytes(Writer().uvarint(((1 << 30) << 1) | 1).finish()).finish(),
        Writer().u8(1).uvarint(1 << 40).finish(),
        Writer().u8(2).bytes(b"").finish(),
        Writer().u8(1).uvarint(1).svarint(-9).bytes(b"").finish(),
    ):
        with pytest.raises(tcomp.CodecError):
            tcomp.decode(b"\x01\x02", data)
        with pytest.raises(jcomp.CodecError):
            jcomp.decode(b"\x01\x02", data)


# -- frame-advantage averaging -----------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_time_sync_matches(seed):
    rng = np.random.default_rng(seed)
    port, jax_ = TTimeSync(), JTimeSync()
    for frame in range(200):
        local, remote = (int(v) for v in rng.integers(-40, 41, size=2))
        port.advance_frame(frame, local, remote)
        jax_.advance_frame(frame, local, remote)
        assert port.average_frame_advantage() == jax_.average_frame_advantage()


# -- the endpoint protocol over the in-memory network -------------------------------


def _endpoint_pair(proto, sock, core, seed, loss, duplicate, reorder, latency, clock):
    net = sock.InMemoryNetwork(seed=seed, loss=loss, duplicate=duplicate, reorder=reorder,
                               latency_ticks=latency)
    wire = []
    send = net._send

    def recording_send(frm, to, payload):
        wire.append((frm, to, bytes(payload)))
        send(frm, to, payload)

    net._send = recording_send
    config = core.Config.for_uint(8)
    eps = []
    for me, other, handle in (("A", "B", 0), ("B", "A", 1)):
        eps.append((proto.PeerProtocol(
            config=config, handles=[1 - handle], peer_addr=other, num_players=2,
            local_players=1, max_prediction=8, disconnect_timeout_ms=2000,
            disconnect_notify_start_ms=500, fps=60,
            desync_detection=core.DesyncDetection.on(5), clock=clock,
            rng=random.Random(seed + handle)), net.socket(me), handle))
    return net, eps, wire


def _event_plain(ev):
    if type(ev).__name__ == "EvInput":
        return ("EvInput", ev.player, ev.input.frame, ev.input.input)
    return (type(ev).__name__,) + tuple(getattr(ev, "__dict__", {}).values())


def _drive_endpoints(pkg, seed, loss, duplicate, reorder, latency, raw):
    """Two endpoints exchanging inputs, acks, quality reports and checksum
    reports for 400 ticks of 16 ms, with two blackouts of endpoint A: 50
    ticks (interrupted, then resumed) and 140 ticks (disconnected)."""
    proto, sock, core, player_input, conn = {
        "port": (tproto, tsock, tcore, TPlayerInput, tmsg.ConnectionStatus),
        "jax": (jproto, jsock, jcore, JPlayerInput, jmsg.ConnectionStatus),
    }[pkg]
    now = [0]
    net, eps, wire = _endpoint_pair(proto, sock, core, seed, loss, duplicate, reorder,
                                    latency, lambda: now[0])
    status = {h: [conn(), conn()] for _, _, h in eps}
    log = []
    frame = {0: 0, 1: 0}
    for tick in range(400):
        dark = 100 <= tick < 150 or 220 <= tick < 360
        for ep, socket, h in eps:
            if h == 0 and dark:
                continue
            ep.send_input({h: player_input(frame[h], (tick // 5 + 3 * h) % 256)}, status[h])
            status[h][h].last_frame = frame[h]
            frame[h] += 1
            if tick % 7 == 0:
                ep.send_checksum_report(tick, (tick * 0x9E3779B97F4A7C15) & ((1 << 128) - 1))
            ep.send_all_messages(socket)
            if raw:
                for _addr, data in socket.receive_all_datagrams():
                    ep.handle_datagram(data)
            else:
                for _addr, msg in socket.receive_all_messages():
                    ep.handle_message(msg)
            for ev in ep.poll(status[h]):
                log.append((tick, h, _event_plain(ev)))
            ep.send_all_messages(socket)
        net.tick()
        now[0] += 16
    checksums = [sorted(ep.pending_checksums.items()) for ep, _, _ in eps]
    return log, wire, checksums, [ep.magic for ep, _, _ in eps]


@pytest.mark.parametrize("raw", [True, False], ids=["datagrams", "messages"])
@pytest.mark.parametrize("seed,loss,duplicate,reorder,latency", [
    (1, 0.0, 0.0, 0.0, 0),
    (2, 0.1, 0.05, 0.1, 2),
    (3, 0.3, 0.0, 0.2, 5),
])
def test_endpoint_protocol_matches(seed, loss, duplicate, reorder, latency, raw):
    port = _drive_endpoints("port", seed, loss, duplicate, reorder, latency, raw)
    jax_ = _drive_endpoints("jax", seed, loss, duplicate, reorder, latency, raw)
    log, wire, checksums, magics = port
    assert magics == jax_[3]
    assert wire == jax_[1]
    assert log == jax_[0]
    assert checksums == jax_[2]
    kinds = {(h, e[0]) for _, h, e in log}
    # the timers really fired: B saw A go quiet, come back, then drop
    assert {(1, "EvNetworkInterrupted"), (1, "EvNetworkResumed"), (1, "EvDisconnected"),
            (1, "EvInput"), (0, "EvInput")} <= kinds
    first = {}
    for tick, h, e in log:
        first.setdefault((h, e[0]), tick)
    assert first[(1, "EvNetworkInterrupted")] > 100 and first[(1, "EvDisconnected")] > 220


def test_garbled_input_datagram_is_dropped_alike():
    """A corrupted input datagram mid-stream is dropped whole by both
    packages' endpoints: the next datagrams they send are equal."""
    sent = {}
    for pkg, proto, core, player_input, msg_mod in (
        ("port", tproto, tcore, TPlayerInput, tmsg), ("jax", jproto, jcore, JPlayerInput, jmsg)
    ):
        now = [0]
        kw = dict(config=core.Config.for_uint(8), num_players=2, local_players=1,
                  max_prediction=8, disconnect_timeout_ms=2000,
                  disconnect_notify_start_ms=500, fps=60,
                  desync_detection=core.DesyncDetection.off(), clock=lambda: now[0])
        a = proto.PeerProtocol(handles=[1], peer_addr="B", rng=random.Random(1), **kw)
        b = proto.PeerProtocol(handles=[0], peer_addr="A", rng=random.Random(2), **kw)
        status = [msg_mod.ConnectionStatus(), msg_mod.ConnectionStatus()]
        out = []
        for f in range(12):
            a.send_input({0: player_input(f, f * 3 % 7)}, status)
            datagrams = [m.encode() for m, _ in a._send_queue]
            a._send_queue.clear()
            for d in datagrams:
                if f == 6:  # flip a byte inside the compressed inputs
                    d = d[:-1] + bytes([d[-1] ^ 0x5A])
                b.handle_datagram(d)
            out.append([m.encode() for m, _ in b._send_queue])
            b._send_queue.clear()
            out.append([_event_plain(e) for e in b.poll(status)])
            now[0] += 16
        sent[pkg] = out
    assert sent["port"] == sent["jax"]
