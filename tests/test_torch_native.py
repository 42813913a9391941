"""The port's native host cores against the JAX package's, on the CPU.

The port compiles its own copies of the codec, endpoint and sync-core
sources (``ggrs_tpu_torch/csrc/host/codec.cpp``, ``endpoint.cpp``,
``sync_core.cpp``; ``ggrs_tpu_torch/_build.py``) and binds them with its own
ctypes copy (``ggrs_tpu_torch/net/_native.py``); the JAX package compiles
its ``native/`` tree, so the two native paths are two libraries built from
two source trees whose code is still the same: a fault common to both
passes here, and what these tests catch is a change of behaviour once the
trees diverge.  On the same
seeded inputs, three implementations must agree byte for byte:

- the port's native path,
- the port's Python path (the codec's ``encode_py`` / ``decode_py``, the
  Python message reader and writer, ``PyEndpointCore``, the ``InputQueue``
  bank),
- ``ggrs_tpu``'s native path.

Covered: the input codec under a seeded fuzz (encode bytes, cross
round-trips, garbage, the resource-cap fallback), message framing, the
endpoint core over two-peer protocol pumps (clean, lossy, latency, garbage,
oversized windows, the status cap, the adoption seams) and the sync core
over randomized operation streams and its error paths.  The ctypes layout
of ``GgrsMsg`` is pinned against the C++ compiler's own offsets, and the
return codes against the C++ sources and the JAX module.  The oracles are
``tests/test_native_codec.py``, ``test_native_endpoint.py`` and
``test_native_sync.py``.  Tolerance: exact equality.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import random
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import ggrs_tpu.core as jcore
import ggrs_tpu.core.sync_layer as jsync
import ggrs_tpu.net as jnet
import ggrs_tpu.net._native as jnative
import ggrs_tpu.net.compression as jcomp
import ggrs_tpu.net.endpoint as jendpoint
import ggrs_tpu.net.messages as jmsg
import ggrs_tpu.net.protocol as jproto
from ggrs_tpu.net.wire import WireError as JWireError

import ggrs_tpu_torch._build as tbuild
import ggrs_tpu_torch.core as tcore
import ggrs_tpu_torch.core.sync_layer as tsync
import ggrs_tpu_torch.net as tnet
import ggrs_tpu_torch.net._native as tnative
import ggrs_tpu_torch.net.compression as tcomp
import ggrs_tpu_torch.net.endpoint as tendpoint
import ggrs_tpu_torch.net.messages as tmsg
import ggrs_tpu_torch.net.protocol as tproto
from ggrs_tpu_torch.net.wire import WireError as TWireError
from ggrs_tpu_torch.predict import BatchedDefault, BatchedRepeatLast

ROOT = Path(__file__).resolve().parents[1]

PKGS = {
    "jax": SimpleNamespace(core=jcore, net=jnet, native=jnative, comp=jcomp, ep=jendpoint,
                           msg=jmsg, proto=jproto, sync=jsync, wire_error=JWireError),
    "port": SimpleNamespace(core=tcore, net=tnet, native=tnative, comp=tcomp, ep=tendpoint,
                            msg=tmsg, proto=tproto, sync=tsync, wire_error=TWireError),
}


def test_jax_native_library_is_available():
    # every comparison below holds the port against the JAX package's
    # native path, so that path must really run here
    assert jnative.available() and jnative.endpoint_lib() is not None
    assert jnative.sync_lib() is not None
    assert tnative.available()


# -- the build ----------------------------------------------------------------------


def test_library_name_hashes_every_source_header_and_flag(tmp_path, monkeypatch):
    base = tbuild.host_library_path()
    assert base.parent == tbuild.BUILD_DIR and base.name.startswith("libggrs_host-")
    copies = []
    for src in tbuild.HOST_SOURCES + tbuild.HOST_HEADERS:
        dst = tmp_path / src.name
        shutil.copy(src, dst)
        copies.append(dst)
    monkeypatch.setattr(tbuild, "HOST_SOURCES", tuple(copies[:3]))
    monkeypatch.setattr(tbuild, "HOST_HEADERS", tuple(copies[3:]))
    assert tbuild.host_library_path() == base  # same bytes, same name
    names = {base.name}
    for path in copies:
        original = path.read_bytes()
        path.write_bytes(original + b"\n// edited\n")
        names.add(tbuild.host_library_path().name)
        path.write_bytes(original)
    monkeypatch.setattr(tbuild, "HOST_FLAGS", tbuild.HOST_FLAGS + ("-DGGRS_PROBE",))
    names.add(tbuild.host_library_path().name)
    assert len(names) == len(copies) + 2


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("int ggrs_broken( { return 0; }\n")
    monkeypatch.setattr(tbuild, "HOST_SOURCES", (broken,))
    monkeypatch.setattr(tbuild, "HOST_HEADERS", ())
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(tbuild.KernelBuildError, match="g\\+\\+ exited") as err:
        tbuild.build_host()
    assert "broken.cpp" in str(err.value)
    assert not list((tmp_path / "build").iterdir())  # no library, no temp file


def test_concurrent_builds_leave_one_library(tmp_path):
    # three processes build into one empty directory at once, as pytest's
    # workers may: each loads a whole library, and only it remains
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "import ggrs_tpu_torch._build as b\n"
        "b.BUILD_DIR = Path(sys.argv[1])\n"
        "lib = b.load_host()\n"
        "assert lib.ggrs_sync_new and lib.ggrs_ep_new and lib.ggrs_codec_encode\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0 and out.strip() == "ok", err
    assert [f.name for f in tmp_path.iterdir()] == [tbuild.host_library_path().name]


def test_kill_switch_gives_the_python_paths():
    code = (
        "import os, sys\n"
        "os.environ['GGRS_TPU_NO_NATIVE'] = '1'\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ggrs_tpu'] = None\n"
        "from ggrs_tpu_torch.net import _native, compression\n"
        "from ggrs_tpu_torch.net.endpoint import PyEndpointCore, make_endpoint_core\n"
        "from ggrs_tpu_torch.core.sync_layer import SyncLayer\n"
        "from ggrs_tpu_torch.core.config import Config\n"
        "assert not _native.available()\n"
        "assert type(make_endpoint_core(b'\\0', b'\\0', 8)) is PyEndpointCore\n"
        "assert SyncLayer(Config.for_uint(8), 2, 8)._native is None\n"
        "assert compression.decode(b'\\1', compression.encode(b'\\1', [b'\\2'])) == [b'\\2']\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -- the ctypes layout and the return codes -----------------------------------------


def test_ggrs_msg_layout_matches_the_compiler(tmp_path):
    fields = [name for name, _ in tnative._GgrsMsg._fields_]
    probe = tmp_path / "probe.cpp"
    probe.write_text(
        f'#include "{tnative._build.HOST_DIR / "codec.cpp"}"\n'
        "#include <cstddef>\n#include <cstdio>\n"
        "int main() {\n"
        '  std::printf("size %zu\\n", sizeof(GgrsMsg));\n'
        + "".join(f'  std::printf("{f} %zu\\n", offsetof(GgrsMsg, {f}));\n' for f in fields)
        + "  return 0;\n}\n"
    )
    exe = tmp_path / "probe"
    subprocess.run(["g++", "-std=c++17", "-o", str(exe), str(probe)], check=True,
                   capture_output=True, timeout=120)
    got = dict(line.split() for line in subprocess.run(
        [str(exe)], check=True, capture_output=True, text=True).stdout.splitlines())
    assert int(got.pop("size")) == ctypes.sizeof(tnative._GgrsMsg)
    for name in fields:
        assert int(got[name]) == getattr(tnative._GgrsMsg, name).offset, name


def test_ggrs_msg_layout_matches_the_jax_binding():
    assert [(n, t) for n, t in tnative._GgrsMsg._fields_] == \
        [(n, t) for n, t in jnative._GgrsMsg._fields_]
    assert ctypes.sizeof(tnative._GgrsMsg) == ctypes.sizeof(jnative._GgrsMsg)


CODES = [
    "EP_DROP", "EP_FALLBACK", "EP_BAD_PENDING_HEAD", "EP_ERR_BUFFER_TOO_SMALL",
    "EP_ERR_TOO_MANY_INPUTS", "SYNC_OK", "SYNC_ERR_PREDICTION_PENDING",
    "SYNC_ERR_BEFORE_TAIL", "SYNC_ERR_NO_CONFIRMED", "SYNC_ERR_NON_SEQUENTIAL",
    "SYNC_ERR_CONFIRM_PAST_INCORRECT", "SYNC_ERR_BAD_ARGS", "SYNC_ERR_QUEUE_FULL",
    "_MAX_PLAYERS_ON_WIRE", "_MSG_FALLBACK", "_RESOURCE_ERRORS", "_ERROR_NAMES",
    "_MSG_ERROR_NAMES", "_DECODE_CAP_BYTES", "_DECODE_CAP_INPUTS",
    "_TAG_INPUT", "_TAG_INPUT_ACK", "_TAG_QUALITY_REPORT", "_TAG_QUALITY_REPLY",
    "_TAG_CHECKSUM_REPORT", "_TAG_KEEP_ALIVE", "_TAG_SYNC_REQUEST", "_TAG_SYNC_REPLY",
]


@pytest.mark.parametrize("name", CODES)
def test_constant_matches_the_jax_binding(name):
    assert getattr(tnative, name) == getattr(jnative, name)


def _cpp_constant(path: Path, symbol: str) -> int:
    m = re.search(rf"\b{symbol}\s*=\s*(-?[0-9]+)", path.read_text())
    assert m, f"{symbol} not found in {path.name}"
    return int(m.group(1))


def test_constants_match_the_cpp_sources():
    from ggrs_tpu_torch.analysis.layout import MIRRORED_CONSTANTS

    ours = {"codec.cpp", "endpoint.cpp", "sync_core.cpp", "wire_common.h"}
    checked = 0
    for cpp, symbol, py, name in MIRRORED_CONSTANTS:
        if py != "ggrs_tpu_torch/net/_native.py" or Path(cpp).name not in ours:
            continue
        assert getattr(tnative, name) == _cpp_constant(ROOT / cpp, symbol), name
        checked += 1
    assert checked >= 13
    assert tnative._MSG_FALLBACK == _cpp_constant(tnative._build.HOST_DIR / "codec.cpp", "kMsgFallback")


# -- the codec ------------------------------------------------------------------------


def _cases(seed, n_cases=200):
    rng = np.random.default_rng(seed)
    for _ in range(n_cases):
        ref_len = int(rng.integers(0, 12))
        reference = bytes(rng.integers(0, 256, ref_len, dtype=np.uint8))
        n = int(rng.integers(0, 12))
        if rng.random() < 0.5 and ref_len > 0:
            sizes = [ref_len] * n  # same-size fast path
        else:
            sizes = [int(rng.integers(0, 20)) for _ in range(n)]
        inputs = [bytes(rng.integers(0, 256, s, dtype=np.uint8)) for s in sizes]
        if n >= 2 and rng.random() < 0.5:  # repeated inputs: the favorable case
            inputs = [inputs[0]] * n
        yield reference, inputs


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_codec_encode_is_byte_identical(seed):
    for reference, inputs in _cases(seed):
        want = jnative.encode(reference, inputs)
        assert want is not None
        assert tnative.encode(reference, inputs) == want
        assert tcomp.encode_py(reference, inputs) == want
        assert tcomp.encode(reference, inputs) == want


@pytest.mark.parametrize("seed", [4, 5])
def test_codec_decode_round_trips_across_packages(seed):
    for reference, inputs in _cases(seed):
        blob = jnative.encode(reference, inputs)
        assert tnative.decode(reference, blob) == inputs
        assert tcomp.decode_py(reference, blob) == inputs
        assert jcomp.decode_py(reference, tnative.encode(reference, inputs)) == inputs


def _codec_outcome(fn, reference, data, error):
    try:
        return ("ok", fn(reference, data))
    except error as e:
        return ("error", str(e))


def test_codec_garbage_agrees_everywhere():
    rng = np.random.default_rng(6)
    for _ in range(400):
        reference = bytes(rng.integers(0, 256, int(rng.integers(0, 6)), dtype=np.uint8))
        data = bytes(rng.integers(0, 256, int(rng.integers(0, 24)), dtype=np.uint8))
        want = _codec_outcome(jnative.decode, reference, data, jcomp.CodecError)
        got = _codec_outcome(tnative.decode, reference, data, tcomp.CodecError)
        assert got == want, (reference, data)
        py = _codec_outcome(tcomp.decode_py, reference, data, tcomp.CodecError)
        assert py[0] == got[0] and (got[0] == "error" or py == got), (reference, data)


def test_codec_resource_cap_falls_back_to_python():
    # more inputs than the native decode cap: legal, so the dispatcher hands
    # the packet to the Python codec, in both packages
    reference = b"\x03"
    inputs = [bytes([i % 7]) for i in range(tnative._DECODE_CAP_INPUTS + 10)]
    blob = tcomp.encode(reference, inputs)
    assert blob == jcomp.encode(reference, inputs)
    assert tnative.decode(reference, blob) is None
    assert jnative.decode(reference, blob) is None
    assert tcomp.decode(reference, blob) == inputs == jcomp.decode(reference, blob)


def test_codec_hardening_bounds_a_huge_zero_run():
    # a run claiming far more than MAX_DECODED_BYTES raises, never allocates
    from ggrs_tpu_torch.net.wire import Writer

    w = Writer()
    w.u8(0)
    w.uvarint(1 << 40)
    w.u8(0)
    blob = w.finish()
    for fn in (tnative.decode, tcomp.decode_py):
        with pytest.raises(tcomp.CodecError):
            fn(b"\x01", blob)
    with pytest.raises(jcomp.CodecError):
        jnative.decode(b"\x01", blob)


# -- message framing ----------------------------------------------------------------


def _message_specs(seed, n_cases=300):
    rng = np.random.default_rng(seed)

    def frame():
        return int(rng.integers(-1, 1 << 20))

    for _ in range(n_cases):
        magic = int(rng.integers(0, 1 << 16))
        kind = int(rng.integers(0, 8))
        if kind == 0:
            args = ([(bool(rng.integers(0, 2)), frame()) for _ in range(int(rng.integers(0, 8)))],
                    bool(rng.integers(0, 2)), frame(), frame(),
                    bytes(rng.integers(0, 256, int(rng.integers(0, 64)), dtype=np.uint8)))
        elif kind == 1:
            args = (frame(),)
        elif kind == 2:
            args = (int(rng.integers(-(1 << 15), 1 << 15)), int(rng.integers(0, 1 << 62)))
        elif kind in (3, 6, 7):
            args = (int(rng.integers(1, 1 << 62)),)
        elif kind == 4:
            args = (int(rng.integers(0, 1 << 62)) << 64 | int(rng.integers(0, 1 << 62)), frame())
        else:
            args = ()
        yield magic, kind, args


def _message(pkg, magic, kind, args):
    M = PKGS[pkg].msg
    if kind == 0:
        statuses, dreq, start, ack, payload = args
        body = M.InputMessage([M.ConnectionStatus(d, f) for d, f in statuses], dreq, start, ack,
                              payload)
    else:
        body = [None, M.InputAck, M.QualityReport, M.QualityReply, M.ChecksumReport,
                M.KeepAlive, M.SyncRequest, M.SyncReply][kind](*args)
    return M.Message(magic, body)


def _py_encode(pkg, msg, monkeypatch):
    m = PKGS[pkg]
    with monkeypatch.context() as mp:
        mp.setattr(m.native, "msg_encode", lambda msg: None)
        return m.msg.Message(msg.magic, msg.body).encode()


def _py_decode(pkg, data, monkeypatch):
    m = PKGS[pkg]
    with monkeypatch.context() as mp:
        mp.setattr(m.native, "msg_decode", lambda data: None)
        return m.msg.Message.decode(data)


def _plain(msg):
    """A message as plain values, comparable across the packages."""
    b = msg.body
    fields = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)
              if not f.name.startswith("_")}
    if "peer_connect_status" in fields:
        fields["peer_connect_status"] = [(c.disconnected, c.last_frame)
                                         for c in fields["peer_connect_status"]]
    return msg.magic, type(b).__name__, fields


@pytest.mark.parametrize("seed", [11, 12])
def test_message_encode_is_byte_identical(seed, monkeypatch):
    for spec in _message_specs(seed):
        want = jnative.msg_encode(_message("jax", *spec))
        assert want is not None
        assert tnative.msg_encode(_message("port", *spec)) == want
        assert _py_encode("port", _message("port", *spec), monkeypatch) == want
        assert _message("port", *spec).encode() == want


def test_message_decode_matches_across_packages(monkeypatch):
    for spec in _message_specs(13):
        data = jnative.msg_encode(_message("jax", *spec))
        want = _plain(jnative.msg_decode(data))
        assert _plain(tnative.msg_decode(data)) == want
        assert _plain(_py_decode("port", data, monkeypatch)) == want
        assert _plain(tmsg.Message.decode(data)) == want


def _msg_outcome(pkg, decode, data):
    try:
        got = decode(data)
    except PKGS[pkg].wire_error:
        return "error"
    return None if got is None else _plain(got)


def test_message_garbage_and_prefixes_agree(monkeypatch):
    rng = np.random.default_rng(14)
    datas = [bytes(rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8))
             for _ in range(400)]
    for spec in _message_specs(15, n_cases=30):
        real = jnative.msg_encode(_message("jax", *spec))
        datas += [real[:cut] for cut in range(len(real))]
    for data in datas:
        want = _msg_outcome("jax", jnative.msg_decode, data)
        assert _msg_outcome("port", tnative.msg_decode, data) == want, data
        py = _msg_outcome("port", lambda d: _py_decode("port", d, monkeypatch), data)
        assert want is None or py == want, data  # None: the fast path defers


def test_out_of_range_fields_fall_back_to_python_semantics():
    import struct

    big = tmsg.Message(1, tmsg.InputAck(2**63))
    assert tnative.msg_encode(big) is None
    assert big.encode() == jmsg.Message(1, jmsg.InputAck(2**63)).encode()
    assert tnative.msg_encode(tmsg.Message(1, tmsg.QualityReport(40000, 0))) is None
    with pytest.raises(struct.error):
        tmsg.Message(1, tmsg.QualityReport(40000, 0)).encode()
    assert tnative.msg_encode(tmsg.Message(1, tmsg.SyncRequest(-1))) is None
    with pytest.raises(ValueError):
        tmsg.Message(1, tmsg.SyncRequest(-1)).encode()


# -- the endpoint core ----------------------------------------------------------------

CORES = ["port-native", "port-python", "jax-native"]


def _make_protos(core, seed, net):
    """Two connected PeerProtocols on the requested core, and their sockets."""
    pkg = core.split("-")[0]
    m = PKGS[pkg]
    factory = m.ep.PyEndpointCore if core.endswith("python") else m.ep.make_endpoint_core
    orig = m.proto.make_endpoint_core
    m.proto.make_endpoint_core = factory
    protos, socks = {}, {}
    try:
        for me, other, h in (("A", "B", 0), ("B", "A", 1)):
            protos[me] = m.proto.PeerProtocol(
                config=m.core.Config.for_uint(bits=8), handles=[1 - h], peer_addr=other,
                num_players=2, local_players=1, max_prediction=8,
                disconnect_timeout_ms=2000, disconnect_notify_start_ms=500, fps=60,
                desync_detection=m.core.DesyncDetection.off(), clock=lambda: 0,
                rng=random.Random(seed + h),
            )
            socks[me] = net.socket(me)
    finally:
        m.proto.make_endpoint_core = orig
    want = m.ep.PyEndpointCore if core.endswith("python") else m.ep.NativeEndpointCore
    assert type(protos["A"]._core) is want
    return protos, socks


def _pump(core, seed, ticks, **faults):
    """Drive two peers for ``ticks`` frames; record every delivered datagram
    and every protocol event, in order (tests/test_native_endpoint.py's
    record)."""
    m = PKGS[core.split("-")[0]]
    net = m.net.InMemoryNetwork(seed=seed, **faults)
    protos, socks = _make_protos(core, seed, net)
    record = []
    status = {me: [m.msg.ConnectionStatus(), m.msg.ConnectionStatus()] for me in "AB"}
    for i in range(ticks):
        net.tick()
        for me, h in (("A", 0), ("B", 1)):
            p = protos[me]
            for _, data in socks[me].receive_all_datagrams():
                record.append(("recv", me, bytes(data)))
                p.handle_datagram(data)
            for ev in p.poll(status[me]):
                if type(ev).__name__ == "EvInput":
                    record.append(("input", me, ev.player, ev.input.frame, ev.input.input))
                    status[me][ev.player].last_frame = ev.input.frame
                else:
                    record.append(("event", me, type(ev).__name__))
            status[me][h].last_frame = i
            p.send_input({h: m.core.PlayerInput(i, (i * 7 + h * 3) % 251)}, status[me])
            p.send_all_messages(socks[me])
    for me in "AB":
        record.append(("final", me, protos[me].last_recv_frame(), protos[me]._core.pending_len()))
    return record


@pytest.mark.parametrize("link", [
    dict(seed=3, ticks=60),
    dict(seed=1, ticks=80, loss=0.2, duplicate=0.1, reorder=0.2),
    dict(seed=42, ticks=80, loss=0.2, duplicate=0.1, reorder=0.2),
    dict(seed=9, ticks=80, latency_ticks=3),
], ids=["clean", "lossy_1", "lossy_42", "latency"])
def test_endpoint_pump_record_identical(link):
    records = {core: _pump(core, **link) for core in CORES}
    assert records["port-native"] == records["jax-native"]
    assert records["port-python"] == records["jax-native"]
    assert sum(1 for r in records["port-native"] if r[0] == "input") > 40


GARBAGE = [
    b"", b"\x00", b"\xff\xff", b"\xaa\xbb\x00", b"\xaa\xbb\x00\x01\x02",
    b"\xaa\xbb\x00\x00\x00\x00\x00\x05abc", b"\xaa\xbb\x63", bytes(range(256)),
]


@pytest.mark.parametrize("core", CORES)
def test_endpoint_drops_garbage_silently(core):
    m = PKGS[core.split("-")[0]]
    protos, socks = _make_protos(core, 5, m.net.InMemoryNetwork())
    p = protos["A"]
    before = (p.last_recv_frame(), p._core.pending_len())
    for g in GARBAGE:
        p.handle_datagram(g)
    assert p.poll([m.msg.ConnectionStatus(), m.msg.ConnectionStatus()]) == []
    assert (p.last_recv_frame(), p._core.pending_len()) == before
    p.send_all_messages(socks["A"])
    assert socks["B"].receive_all_datagrams() == []


@pytest.mark.parametrize("start", [2**62 + 5, 2**63 - 1, -(2**62) - 7, -(2**63)])
@pytest.mark.parametrize("core", ["port-native", "port-python"])
def test_endpoint_drops_frames_beyond_the_i64_contract(core, start):
    protos, _ = _make_protos(core, 17, tnet.InMemoryNetwork())
    p = protos["A"]
    evil = tmsg.Message(7, tmsg.InputMessage(
        [tmsg.ConnectionStatus(), tmsg.ConnectionStatus()], False, start, -1,
        tcomp.encode(b"", [b"\x01\x07"]))).encode()
    p.handle_datagram(evil)
    assert p.last_recv_frame() == tcore.NULL_FRAME
    assert not [e for e in p.poll([tmsg.ConnectionStatus(), tmsg.ConnectionStatus()])
                if type(e).__name__ == "EvInput"]


@pytest.mark.parametrize("core", CORES)
def test_endpoint_huge_window_takes_the_python_codec(core):
    # more staged frames than the native caps (512): the native core falls
    # back to the Python codec and still delivers every input in order
    m = PKGS[core.split("-")[0]]
    protos, socks = _make_protos(core, 11, m.net.InMemoryNetwork())
    a, b = protos["A"], protos["B"]
    status = [m.msg.ConnectionStatus(), m.msg.ConnectionStatus()]
    for i in range(600):
        status[0].last_frame = i
        a.send_input({0: m.core.PlayerInput(i, i % 251)}, status)
    a.send_all_messages(socks["A"])
    delivered = socks["B"].receive_all_datagrams()
    b.handle_datagram(delivered[-1][1])
    events = [e for e in b.poll(status) if type(e).__name__ == "EvInput"]
    assert [e.input.frame for e in events] == list(range(600))
    assert [e.input.input for e in events] == [i % 251 for i in range(600)]
    assert b.last_recv_frame() == 599


def _cores():
    return [tendpoint.PyEndpointCore(b"\x00", b"\x00", 8),
            tendpoint.NativeEndpointCore(tnative.endpoint_lib(), b"\x00", b"\x00", 8),
            jendpoint.NativeEndpointCore(jnative.endpoint_lib(), b"\x00", b"\x00", 8)]


def test_endpoint_status_cap_holds_in_every_core():
    for core, cs in zip(_cores(), (tmsg, tmsg, jmsg)):
        core.push_input(0, b"\x05")
        statuses = [cs.ConnectionStatus() for _ in range(65)]
        with pytest.raises(RuntimeError, match="65 connect statuses exceed"):
            core.emit_input(0xABCD, statuses, False)
        assert core.emit_input(0xABCD, statuses[:64], False) is not None


def _status(pkg, n=2):
    return [PKGS[pkg].msg.ConnectionStatus() for _ in range(n)]


def test_endpoint_seams_agree_with_the_python_core():
    """seed_send, seed_recv and rewind_send on each core, then the same
    emits and receives: the cores stay byte-identical."""
    outs = []
    for core, pkg in zip(_cores(), ("port", "port", "jax")):
        out = []
        core.seed_send(9, b"\x04")
        for f in range(10, 14):
            core.push_input(f, bytes([f]))
        out.append(core.emit_input(0x1234, _status(pkg), False))
        core.ack(11)
        out.append((core.pending_len(), core.last_acked_frame()))
        out.append(core.emit_input(0x1234, _status(pkg), True))
        core.rewind_send(10, b"\x0a")
        out.append(core.pending_len())
        for f in range(11, 15):
            core.push_input(f, bytes([f + 1]))
        out.append(core.emit_input(0x1234, _status(pkg), False))
        core.seed_recv(20, [(19, b"\x13"), (20, b"\x14")])
        out.append(core.last_recv_frame())
        comp = PKGS[pkg].comp.encode(b"\x14", [b"\x15", b"\x16"])
        out.append(core.on_input(21, comp))
        core.commit()
        out.append(core.last_recv_frame())
        out.append(core.on_input(23, PKGS[pkg].comp.encode(b"\x16", [b"\x17"])))
        core.commit()
        out.append(core.emit_input(0x1234, _status(pkg), False))
        outs.append(out)
    assert outs[1] == outs[0]
    assert outs[2] == outs[0]
    assert outs[0][-1] is not None and outs[0][6] == (21, [b"\x15", b"\x16"])


# -- the sync core ----------------------------------------------------------------------


def _layers(players, max_prediction=8, bits=16):
    """Port native, port Python and JAX native sync layers on one config."""
    out = [tsync.SyncLayer(tcore.Config.for_uint(bits), players, max_prediction, use_native=True),
           tsync.SyncLayer(tcore.Config.for_uint(bits), players, max_prediction, use_native=False),
           jsync.SyncLayer(jcore.Config.for_uint(bits), players, max_prediction, use_native=True)]
    assert isinstance(out[0]._native, tsync._NativeSyncCore) and not out[0].input_queues
    assert out[1]._native is None and len(out[1].input_queues) == players
    assert out[2]._native is not None
    return out


def _statuses(players):
    return [tmsg.ConnectionStatus() for _ in range(players)], \
        [tmsg.ConnectionStatus() for _ in range(players)], \
        [jmsg.ConnectionStatus() for _ in range(players)]


def _pi(layer, frame, value):
    core = jcore if isinstance(layer, jsync.SyncLayer) else tcore
    return core.PlayerInput(frame, value)


def _plain_inputs(inputs):
    return [(v, s.name) for v, s in inputs]


def _all_same(values):
    assert values[1] == values[0] and values[2] == values[0], values
    return values[0]


@pytest.mark.parametrize("seed", [1, 7, 23, 99])
def test_sync_lockfree_stream_identical(seed):
    """Remote inputs stream in late and in bursts while the local side runs
    ahead on predictions; mispredictions reset prediction as the session's
    rollback would (tests/test_native_sync.py's stream)."""
    rng = random.Random(seed)
    layers = _layers(2)
    stats = _statuses(2)
    remote_frame = -1
    for step in range(400):
        cur = _all_same([l.current_frame for l in layers])
        v = rng.randrange(0, 1 << 16)
        _all_same([l.add_local_input(0, _pi(l, cur, v)) for l in layers])
        for st in stats:
            st[0].last_frame = cur
        while remote_frame < cur - rng.randrange(0, 6) and remote_frame < cur:
            remote_frame += 1
            rv = rng.randrange(0, 1 << 16)
            for l, st in zip(layers, stats):
                l.add_remote_input(1, _pi(l, remote_frame, rv))
                st[1].last_frame = remote_frame
        fi = _all_same([l.check_simulation_consistency(tcore.NULL_FRAME) for l in layers])
        if fi != tcore.NULL_FRAME:
            for l in layers:
                l.reset_prediction()
        _all_same([_plain_inputs(l.synchronized_inputs(st)) for l, st in zip(layers, stats)])
        for l in layers:
            l.advance_frame()
        confirmed = min(stats[0][0].last_frame, stats[0][1].last_frame)
        if confirmed > 0 and rng.random() < 0.5:
            for l in layers:
                l.set_last_confirmed_frame(confirmed, sparse_saving=False)
            _all_same([l.last_confirmed_frame for l in layers])
        if step % 37 == 0:
            for f in (max(0, cur - 3), cur):
                outcomes = []
                for l in layers:
                    try:
                        outcomes.append(l.confirmed_input(0, f).input)
                    except AssertionError:
                        outcomes.append("missing")
                _all_same(outcomes)


@pytest.mark.parametrize("seed", [5, 13])
def test_sync_delay_changes_and_disconnect_identical(seed):
    rng = random.Random(seed)
    layers = _layers(2)
    stats = _statuses(2)
    for step in range(200):
        cur = layers[0].current_frame
        if step in (31, 90):  # grow, then shrink, player 0's delay
            for l in layers:
                l.set_frame_delay(0, 3 if step == 31 else 1)
        if step == 120:
            for st in stats:
                st[1].disconnected = True
        v = rng.randrange(0, 1 << 16)
        _all_same([l.add_local_input(0, _pi(l, cur, v)) for l in layers])
        if not stats[0][1].disconnected:
            rv = rng.randrange(0, 1 << 16)
            for l, st in zip(layers, stats):
                l.add_remote_input(1, _pi(l, cur, rv))
                st[1].last_frame = cur
        for st in stats:
            st[0].last_frame = cur
        _all_same([_plain_inputs(l.synchronized_inputs(st)) for l, st in zip(layers, stats)])
        for l in layers:
            l.advance_frame()
        fi = _all_same([l.check_simulation_consistency(tcore.NULL_FRAME) for l in layers])
        if fi != tcore.NULL_FRAME:
            for l in layers:
                l.reset_prediction()
        outcomes = []
        for l, st in zip(layers, stats):
            try:
                outcomes.append([(p.frame, p.input) for p in l.confirmed_inputs(cur - 2, st)])
            except AssertionError:
                outcomes.append("missing")
        _all_same(outcomes)


def test_sync_error_paths_raise_identically():
    # confirming past the first incorrect frame
    layers = _layers(1)
    stats = _statuses(1)
    for l, st in zip(layers, stats):
        l.add_local_input(0, _pi(l, 0, 1))
        st[0].last_frame = 0
        l.synchronized_inputs(st)
        l.advance_frame()
        l.synchronized_inputs(st)  # predicted for frame 1
        l.advance_frame()
        l.add_remote_input(0, _pi(l, 1, 999))
    assert _all_same([l.check_simulation_consistency(tcore.NULL_FRAME) for l in layers]) == 1
    for l in layers:
        with pytest.raises(AssertionError):
            l.set_last_confirmed_frame(2, sparse_saving=False)
    # the 128-slot ring's capacity guard
    for l in _layers(1):
        with pytest.raises(AssertionError):
            for i in range(200):
                l.add_remote_input(0, _pi(l, i, i % 251))
    # negative frames
    for frame in (-5, -129):
        for l in _layers(1):
            l.add_remote_input(0, _pi(l, 0, 7))
            with pytest.raises(AssertionError):
                l.confirmed_input(0, frame)
    layers = _layers(1)
    for l in layers:
        l.add_remote_input(0, _pi(l, 0, 7))
    assert _all_same([l.confirmed_input(0, -1).input for l in layers]) == 0


def test_sync_eligibility_matches_the_jax_gate(monkeypatch):
    cases = [
        ("uint8", lambda c: c.Config.for_uint(8)),
        ("default_predictor", lambda c: c.Config.for_uint(8, predictor=c.PredictDefault())),
        ("bytes", lambda c: c.Config.for_bytes()),
        ("float_struct", lambda c: c.Config.for_struct("<fI")),
        ("int_struct", lambda c: c.Config.for_struct("<hI")),
    ]
    for name, make in cases:
        assert tsync._native_sync_eligible(make(tcore)) == \
            jsync._native_sync_eligible(make(jcore)), name
    # the gate tests the port's own PredictRepeatLast by type: batched
    # strategies (a subclass of it, and the batched default) are not eligible
    for predictor in (BatchedRepeatLast(), BatchedDefault()):
        cfg = tcore.Config.for_uint(8, predictor=predictor)
        assert not tsync._native_sync_eligible(cfg)
        assert tsync.SyncLayer(cfg, 2, 8)._native is None
        with pytest.raises(ValueError):
            tsync.SyncLayer(cfg, 2, 8, use_native=True)
    with pytest.raises(ValueError):
        tsync.SyncLayer(tcore.Config.for_bytes(), 1, 8, use_native=True)
    monkeypatch.setenv("GGRS_TPU_NO_NATIVE", "1")
    assert not tsync._native_sync_eligible(tcore.Config.for_uint(8))
    assert tsync.SyncLayer(tcore.Config.for_uint(8), 2, 8)._native is None
