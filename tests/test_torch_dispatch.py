"""The port's dispatch sockets, one-crossing receive table, GSO and GRO
against the JAX package's, on the CPU over loopback UDP.

Mirrors ``tests/test_net_gen2.py`` and ``tests/test_socket_datapath.py``:
``DispatchHub`` / ``DispatchSocket`` demux by source address, count
``unroutable`` datagrams and spread over ``SO_REUSEPORT`` siblings as the
JAX hub does; a pool whose sockets are drained by ``ggrs_net_recv_table``
(per-slot sockets, or every slot a view on one hub) sends the same bytes,
reaches the same frames and returns the same request lists as the per-socket
Python drain (``GGRS_TPU_NO_RECV_TABLE=1``) and as the JAX pool; GRO and GSO
on and off (``GGRS_TPU_NO_GRO`` / ``GGRS_TPU_NO_GSO``) change no byte; a
fatal errno on the shared fd evicts only its owner.  The packed fd, route
and receive tables are pinned to the library and to the JAX tables field by
field.  Tolerance: exact equality throughout."""

from __future__ import annotations

import ctypes
import errno
import socket as pysocket
import struct

import numpy as np
import pytest

from ggrs_tpu.net import _native as jnative
from ggrs_tpu.net.sockets import DispatchHub as JDispatchHub
from ggrs_tpu_torch.net import _native as tnative
from ggrs_tpu_torch.net.sockets import DispatchHub as TDispatchHub

from test_torch_native_io import LOSSY, udp_leg

HUBS = {"jax": JDispatchHub, "port": TDispatchHub}
NATIVE = {"jax": jnative, "port": tnative}
DRAIN_ENV = ("GGRS_TPU_NO_RECV_TABLE", "GGRS_TPU_NO_GSO", "GGRS_TPU_NO_GRO",
             "GGRS_TPU_NO_NATIVE_IO")


@pytest.fixture(autouse=True)
def _restore_postures(monkeypatch):
    """The GSO and GRO postures are process-wide in each library: every test
    starts from the defaults and puts them back."""
    for k in DRAIN_ENV:
        monkeypatch.delenv(k, raising=False)
    yield
    for native in NATIVE.values():
        lib = native.bank_lib()
        lib.ggrs_net_set_gso(-1)
        lib.ggrs_net_set_gro(0)


def _ip(host: str) -> int:
    return int.from_bytes(pysocket.inet_aton(host), "little")


def _bound():
    s = pysocket.socket(pysocket.AF_INET, pysocket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    s.setblocking(False)
    return s


def _hub_demux(pkg, siblings):
    """Three senders, two claimed by two views of one hub, one unclaimed."""
    hub = HUBS[pkg](siblings=siblings)
    a, b = hub.view(), hub.view()
    tx = [_bound() for _ in range(3)]
    try:
        a.claim(("127.0.0.1", tx[0].getsockname()[1]))
        b.claim(("127.0.0.1", tx[1].getsockname()[1]))
        dst = ("127.0.0.1", hub.local_port())
        for k in range(4):
            for j, s in enumerate(tx):
                s.sendto(bytes([j, k]) * (3 + k), dst)
        got_a = [d for _, d in a.receive_all_datagrams()]
        got_b = [d for _, d in b.take_pending()]
        out = dict(a=sorted(got_a), b=sorted(got_b), unroutable=hub.unroutable,
                   fds=len(hub.filenos()), primary=a.io_syscalls > 0, other=b.io_syscalls,
                   reuseport=hub.reuseport, dispatch=a.is_dispatch)
        b.close()  # releases b's claims: its source is unroutable from now on
        tx[1].sendto(b"late", dst)
        a.receive_all_datagrams()
        out["after_release"] = hub.unroutable
        return out
    finally:
        for s in tx:
            s.close()
        hub.close()


@pytest.mark.parametrize("siblings", [0, 1, 3])
def test_hub_demux_and_unroutable_equal_jax(siblings):
    port = _hub_demux("port", siblings)
    assert port == _hub_demux("jax", siblings)
    assert len(port["a"]) == len(port["b"]) == 4
    assert port["unroutable"] == 4 and port["after_release"] == 5
    assert port["fds"] == 1 + (siblings if port["reuseport"] else 0)
    assert port["primary"] and port["other"] == 0 and port["dispatch"]


def test_hub_without_reuseport_runs_one_fd(monkeypatch):
    import ggrs_tpu_torch.net.sockets as tsockets

    monkeypatch.delattr(tsockets._socket, "SO_REUSEPORT", raising=False)
    hub = TDispatchHub(siblings=3)
    try:
        assert not hub.reuseport and len(hub.filenos()) == 1
    finally:
        hub.close()


def test_hub_rcvbuf_and_gro():
    hub = TDispatchHub(siblings=1)
    try:
        granted = [pysocket.socket(fileno=pysocket.dup(fd)).getsockopt(
            pysocket.SOL_SOCKET, pysocket.SO_RCVBUF) for fd in hub.filenos()]
        with open("/proc/sys/net/core/rmem_max") as f:
            rmem_max = int(f.read())
        # the kernel doubles the request and caps it at rmem_max
        assert all(g >= min(8 << 20, rmem_max) for g in granted), (granted, rmem_max)
        assert hub.enable_gro() == bool(tnative.net_lib().ggrs_net_gro_supported())
        assert hub.enable_gro() == hub.gro  # idempotent
    finally:
        hub.close()


def _raw_table(pkg, fd_rows, route_rows):
    lib = NATIVE[pkg].net_lib()
    native = NATIVE[pkg]
    fd_tab = np.array(fd_rows, dtype=np.dtype(list(native.NET_FD_FIELDS))).tobytes()
    routes = np.zeros(len(route_rows), dtype=np.dtype(list(native.NET_ROUTE_FIELDS)))
    for k, (ip, port, slot) in enumerate(sorted(route_rows, key=lambda r: (r[0] << 16) | r[1])):
        routes[k] = (ip, port, 0, slot)
    recs = ctypes.create_string_buffer(64 * native.NET_RECV_STRIDE)
    slab = ctypes.create_string_buffer(1 << 16)
    stats = (ctypes.c_uint64 * native.NET_RECV_TABLE_STATS)()
    fatal = (ctypes.c_int32 * 64)()
    n_fatal = ctypes.c_int32(0)
    n = lib.ggrs_net_recv_table(fd_tab, len(fd_rows), routes.tobytes(), len(route_rows),
                                recs, 64, slab, 1 << 16, stats, fatal, 32, ctypes.byref(n_fatal))
    assert n >= 0
    rec = np.frombuffer(recs, dtype=np.dtype(list(native.NET_RECV_FIELDS)), count=n)
    return ([(int(r["slot"]), int(r["fd_idx"]), int(r["ip"]), int(r["port"]), int(r["seg"]),
              slab[int(r["off"]):int(r["off"]) + int(r["len"])]) for r in rec],
            list(stats), [(fatal[2 * k], fatal[2 * k + 1]) for k in range(n_fatal.value)])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_recv_table_records_pinned(pkg):
    """One crossing drains a private fd (slot 7), a shared fd demuxed by
    source (slots 3 and 5, one unclaimed source) and a dead fd (a fatal
    errno at its table index); both packages' libraries give the same
    records, stats and fault list, laid out as NET_RECV_FIELDS."""
    rx_priv, rx_shared = _bound(), _bound()
    tx = [_bound() for _ in range(3)]
    try:
        for k in range(3):
            tx[0].sendto(bytes([k]) * (5 + k), rx_priv.getsockname())
        for j, s in enumerate(tx):
            s.sendto(b"from%d" % j, rx_shared.getsockname())
        routes = [(_ip("127.0.0.1"), tx[0].getsockname()[1], 3),
                  (_ip("127.0.0.1"), tx[1].getsockname()[1], 5)]
        recs, stats, fatals = _raw_table(
            pkg, [(rx_priv.fileno(), 7), (rx_shared.fileno(), -1), (10_000, 9)], routes)
        port_of = {s.getsockname()[1]: j for j, s in enumerate(tx)}
        got = [(slot, fd_idx, ip == _ip("127.0.0.1"), port_of[port], seg, data)
               for slot, fd_idx, ip, port, seg, data in recs]
        assert got == [(7, 0, True, 0, 0, bytes([k]) * (5 + k)) for k in range(3)] + [
            (3, 1, True, 0, 0, b"from0"), (5, 1, True, 1, 0, b"from1")]
        assert stats[:4] == [stats[0], 5, 1, 0] and stats[0] >= 2
        assert fatals == [(2, errno.EBADF)]
    finally:
        for s in [rx_priv, rx_shared] + tx:
            s.close()


def _drain_leg(pkg, mode, monkeypatch, faults=LOSSY, ticks=90, n=3, seed=2):
    """``mode``: "reference" (per-slot sockets, GGRS_TPU_NO_RECV_TABLE),
    "batched" (per-slot sockets through the receive table), "dispatch" (one
    hub, native demux), "dispatch-reference" (the hub's Python demux)."""
    if mode in ("reference", "dispatch-reference"):
        monkeypatch.setenv("GGRS_TPU_NO_RECV_TABLE", "1")
    host = "dispatch" if mode.startswith("dispatch") else "private"
    leg = udp_leg(pkg, False, seed, ticks, n, faults, host=host, record=False)
    monkeypatch.delenv("GGRS_TPU_NO_RECV_TABLE", raising=False)
    return leg


def test_drain_modes_equal_each_other_and_jax(monkeypatch):
    ref = _drain_leg("port", "reference", monkeypatch)
    assert ref["pool"].drain_crossings == 0
    assert min(ref["frames"]) >= 90 - 64
    for mode in ("batched", "dispatch", "dispatch-reference"):
        port = _drain_leg("port", mode, monkeypatch)
        jax = _drain_leg("jax", mode, monkeypatch)
        for leg in (port, jax):
            assert leg["tapes"] == ref["tapes"], mode
            assert leg["trace"] == ref["trace"], mode
            assert leg["frames"] == ref["frames"], mode
        drain, jdrain = port["pool"].io_stats()["drain"], jax["pool"].io_stats()["drain"]
        assert drain == jdrain, mode
        if mode == "dispatch-reference":
            assert drain["crossings"] == 0
        else:
            assert drain["crossings"] == 90 and port["crossings"] == 90
            assert drain["datagrams"] > 0 and drain["unroutable"] == 0
        if mode.startswith("dispatch"):
            assert port["pool"]._drain_n_fds == (2 if mode == "dispatch" else 0)
            port["dispatch"].close()
            jax["dispatch"].close()


def test_route_and_fd_tables_pinned(monkeypatch):
    """The pool's packed fd and route tables, read back through the JAX
    package's field tables: the hub's two fds marked slot -1, one route per
    peer (ip in network byte order as the s_addr word, host-order port)
    sorted by (ip << 16) | port."""
    leg = udp_leg("port", False, 3, 4, 5, host="dispatch")
    pool, hub = leg["pool"], leg["dispatch"]
    fds = np.frombuffer(pool._drain_fd_tab, dtype=np.dtype(list(jnative.NET_FD_FIELDS)))
    assert [tuple(map(int, r)) for r in fds] == [(fd, -1) for fd in hub.filenos()]
    routes = np.frombuffer(pool._drain_route_tab, dtype=np.dtype(list(jnative.NET_ROUTE_FIELDS)))
    want = sorted(
        ((_ip(addr[0]), addr[1], m) for m in range(5) for addr in pool._mirrors[m].addr_to_ep),
        key=lambda r: (r[0] << 16) | r[1])
    assert [(int(r["ip"]), int(r["port"]), int(r["slot"])) for r in routes] == want
    assert all(int(r["pad"]) == 0 for r in routes)
    assert pool._drain_n_routes == 5 and pool._drain_n_fds == len(hub.filenos())
    hub.close()


@pytest.mark.parametrize("switch", ["GGRS_TPU_NO_GRO", "GGRS_TPU_NO_GSO"])
def test_gro_gso_switches_change_no_byte(switch, monkeypatch):
    """GRO on a covered hub and GSO on the fan-out, each on and off: the
    peers and viewers see the same bytes, and the JAX pool agrees on the
    capability matrix and the GSO totals."""
    def leg(pkg, off):
        if off:
            monkeypatch.setenv(switch, "1")
        out = udp_leg(pkg, False, 4, 70, 2, host="dispatch", n_viewers=2, record=False)
        out["caps"] = out["pool"].io_capabilities()  # read while the switch holds
        monkeypatch.delenv(switch, raising=False)
        out["dispatch"].close()
        return out

    on, off, jon = leg("port", False), leg("port", True), leg("jax", False)
    assert on["tapes"] == off["tapes"] == jon["tapes"]
    assert on["viewer_tapes"] == off["viewer_tapes"] == jon["viewer_tapes"]
    assert on["trace"] == off["trace"] == jon["trace"]
    assert on["caps"] == jon["caps"]
    lib = tnative.net_lib()
    gso_on = on["pool"].io_stats()["gso"]
    assert gso_on == jon["pool"].io_stats()["gso"]
    if switch == "GGRS_TPU_NO_GRO":
        assert on["caps"]["gro_active"] == bool(lib.ggrs_net_gro_supported())
        assert not off["caps"]["gro_active"] and not off["caps"]["gro"]
    else:
        assert off["pool"].io_stats()["gso"] == {"gso_sends": 0, "gso_segments": 0}
        assert not off["caps"]["gso"]
        if lib.ggrs_net_gso_supported():
            assert gso_on["gso_segments"] > gso_on["gso_sends"] > 0


def test_bank_on_one_hub_equals_private_sockets():
    priv = udp_leg("port", False, 9, 80, 4, LOSSY, record=False)
    disp = udp_leg("port", False, 9, 80, 4, LOSSY, host="dispatch")
    assert disp["tapes"] == priv["tapes"]
    assert disp["trace"] == priv["trace"]
    assert len(disp["dispatch"].filenos()) <= 2 < 4
    disp["dispatch"].close()


def _shared_fd_fault(pkg):
    lib = NATIVE[pkg].net_lib()
    armed = []

    def inject(i, pool):
        if i == 20:
            lib.ggrs_net_inject_table_errno(errno.EPERM, 0, 1)
            armed.append(i)
        elif armed:
            lib.ggrs_net_inject_table_errno(0, 0, 0)

    try:
        leg = udp_leg(pkg, False, 3, 90, 3, host="dispatch", before_tick=inject)
    finally:
        lib.ggrs_net_inject_table_errno(0, 0, 0)
    pool = leg["pool"]
    leg["dispatch"].close()
    return dict(states=[pool.slot_state(m) for m in range(3)], frames=leg["frames"],
                trace=leg["trace"], tapes=leg["tapes"],
                unroutable=pool.io_stats()["drain"]["unroutable"])


def test_shared_fd_fatal_evicts_only_its_owner_as_in_jax():
    port = _shared_fd_fault("port")
    assert port == _shared_fd_fault("jax")
    assert sorted(port["states"]) == ["evicted", "native", "native"]
    # the evicted co-tenant's inbound keeps arriving through the shared fd
    assert port["unroutable"] == 0
    assert min(port["frames"]) > 60
