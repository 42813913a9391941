"""The port's parallel slow-slot decode plane against the JAX package's, on
the CPU.

Mirrors ``tests/test_decode_parallel.py``: ``decode_slot_record`` (the pure
half of the pool's ``_parse_slot``) decodes every record of recorded tick
buffers exactly as the JAX package's does; a port pool whose slow slots fan
out over the ``thread`` backend returns the same request lists, events,
frames and wire bytes as the inline serial decoder and as the JAX pool,
through lossy traffic, blackouts, a slot fault and a journal tap, with the
slots' side effects (sends, journal appends) in the serial decoder's order.
Backend resolution follows the JAX package's switches.  Tolerance: exact
equality throughout."""

from __future__ import annotations

import contextlib
import os
import sys
import threading

import numpy as np
import pytest

import ggrs_tpu.broadcast as jbroadcast
import ggrs_tpu.parallel.decode_pool as jdecode
import ggrs_tpu_torch.broadcast as tbroadcast
import ggrs_tpu_torch.parallel.decode_pool as tdecode
from ggrs_tpu_torch.core.errors import CrossThreadAccess
from ggrs_tpu_torch.parallel.decode_pool import DecodePool
from ggrs_tpu_torch.parallel.host_bank import _HDR_DTYPE

from test_torch_host_bank import (
    LOSSY,
    PKGS,
    RecordingSocket,
    fulfill_saves,
    match_builders,
    sched,
    summary,
)

HUBS = {"jax": jbroadcast.SpectatorHub, "port": tbroadcast.SpectatorHub}
PLANE_ENV = ("GGRS_TPU_DECODE_BACKEND", "GGRS_TPU_NO_PARALLEL_DECODE",
             "GGRS_TPU_DECODE_WORKERS", "GGRS_TPU_NO_FASTPATH")
THREAD = {"GGRS_TPU_DECODE_BACKEND": "thread", "GGRS_TPU_NO_FASTPATH": "1"}
SERIAL = {"GGRS_TPU_NO_PARALLEL_DECODE": "1", "GGRS_TPU_NO_FASTPATH": "1"}


@contextlib.contextmanager
def plane_env(values):
    """Exactly ``values`` of the decode-plane switches, restored after."""
    saved = {k: os.environ.pop(k, None) for k in PLANE_ENV}
    os.environ.update(values)
    try:
        yield
    finally:
        for k in PLANE_ENV:
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in saved.items() if v is not None})


class OrderedSocket(RecordingSocket):
    """A RecordingSocket that also appends to one list shared by every slot:
    the pool-wide order of sends across slots."""

    def __init__(self, inner, order, tag):
        super().__init__(inner)
        self.order, self.tag = order, tag

    def send_datagram(self, data, addr):
        self.order.append((self.tag, bytes(data)))
        super().send_datagram(data, addr)

    def send_datagram_batch(self, items):
        for data, _ in items:
            self.order.append((self.tag, bytes(data)))
        super().send_datagram_batch(items)


class OrderedJournal:
    """Each slot's confirmed-stream sink, appending to one shared list."""

    def __init__(self, order, tag):
        self.order, self.tag = order, tag

    def append_frames(self, start, records):
        self.order.append((self.tag, start, tuple(records)))


def drive(pkg, env, ticks=80, faults=LOSSY, n_matches=3, blackout=(), fault_at=None,
          journals=False, buffers=None):
    """``n_matches`` two-peer matches in one pool over a seeded network, the
    decode-plane switches ``env`` held around every ``advance_all`` (the
    backend resolves at finalize).  Records per tick every slot's request
    summary, events and frame, plus the pool-wide send and journal order.
    ``buffers``, when a list, collects each tick's output buffer."""
    p = PKGS[pkg]
    clock = [0]
    net = p.net.InMemoryNetwork(**faults)
    order = []
    bs = [(b, OrderedSocket(s.inner, order, k))
          for k, (b, s) in enumerate(match_builders(pkg, net, clock, n_matches))]
    with plane_env(env):
        pool = p.bank.HostSessionPool()
        for b, s in bs:
            pool.add_session(b, s)
        assert pool.native_active
    if journals:
        HUBS[pkg](pool)
        for idx in range(len(bs)):
            pool.set_confirmed_stream(idx, OrderedJournal(order, idx))
    trace = []
    for i in range(ticks):
        if fault_at == i:
            pool.inject_slot_error(1)
        dark = i in blackout
        clock[0] += 316 if dark else 16
        for idx in range(len(bs)):
            pool.add_local_input(idx, idx % 2, sched(i, idx))
        with plane_env(env):
            reqs = pool.advance_all()
        if buffers is not None:
            buffers.append(bytes(pool._out_buf.raw[: pool._out_len.value]))
        row = []
        for idx in range(len(bs)):
            row.append((summary(reqs[idx]), pool.current_frame(idx),
                        [type(e).__name__ for e in pool.events(idx)]))
            fulfill_saves(reqs[idx])
        trace.append(row)
        if not dark:
            net.tick()
    return dict(pool=pool, trace=trace, order=order,
                transitions=pool.drain_state_transitions(),
                decode=pool.io_stats()["decode"])


@pytest.mark.parametrize("case", ["lossy", "blackout", "fault", "journal"])
def test_thread_backend_equals_serial_and_jax(case):
    kw = dict(lossy={}, blackout=dict(blackout={30, 31, 32, 60}),
              fault=dict(fault_at=12), journal=dict(journals=True))[case]
    thread = drive("port", THREAD, **kw)
    serial = drive("port", SERIAL, **kw)
    jax = drive("jax", THREAD, **kw)
    for other in (serial, jax):
        assert thread["trace"] == other["trace"]
        assert thread["order"] == other["order"]
        assert thread["transitions"] == other["transitions"]
    dec = thread["decode"]
    assert dec["backend"] == "thread" and dec["parallel_ticks"] > 0
    assert len(dec["worker_jobs"]) >= 2, dec["worker_jobs"]
    assert serial["decode"]["backend"] == "serial" and serial["decode"]["parallel_ticks"] == 0
    assert {k: dec[k] for k in ("backend", "jobs", "batches", "parallel_ticks")} == {
        k: jax["decode"][k] for k in ("backend", "jobs", "batches", "parallel_ticks")}
    if case == "blackout":
        assert any(ev for row in thread["trace"] for _, _, ev in row)
    if case == "fault":
        assert [t[2] for t in thread["transitions"]][:2] == ["quarantined", "evicted"]
    if case == "journal":
        assert any(len(o) == 3 for o in thread["order"])


def test_fast_path_regime_equals_serial():
    thread = drive("port", {"GGRS_TPU_DECODE_BACKEND": "thread"}, ticks=100)
    serial = drive("port", {"GGRS_TPU_NO_PARALLEL_DECODE": "1"}, ticks=100)
    assert thread["trace"] == serial["trace"] and thread["order"] == serial["order"]
    assert thread["pool"].fast_slot_ticks > 0


def test_decode_slot_record_equals_jax_on_recorded_buffers():
    buffers = []
    run = drive("port", SERIAL, ticks=60, buffers=buffers, blackout={20, 21})
    pool = run["pool"]
    n = len(pool._mirrors)
    lead = n * (pool._hdr_stride + pool._req_stride)
    decoded = 0
    for buf in buffers:
        hdr = np.frombuffer(buf, dtype=_HDR_DTYPE, count=n)
        pos = lead
        for idx in range(n):
            m = pool._mirrors[idx]
            got = tdecode.decode_slot_record(memoryview(buf), pos, m.num_players, m.input_size, True)
            want = jdecode.decode_slot_record(buf, pos, m.num_players, m.input_size, True)
            assert got == want
            assert got[tdecode.DEC_END] == pos + int(hdr["rec_len"][idx])
            pos = got[tdecode.DEC_END]
            decoded += 1
        # a whole tick through the pool's worker engine, in job order
        dp = DecodePool(backend="thread", workers=3)
        jobs = []
        pos = lead
        for idx in range(n):
            jobs.append((pos, 2, pool._mirrors[idx].input_size, True))
            pos += int(hdr["rec_len"][idx])
        assert dp.decode_slots(memoryview(buf), jobs) == [
            jdecode.decode_slot_record(buf, *job) for job in jobs]
        dp.close()
    assert decoded == 60 * n


@pytest.mark.parametrize("env,backend", [
    ({}, None),
    ({"GGRS_TPU_DECODE_BACKEND": "thread"}, "thread"),
    ({"GGRS_TPU_DECODE_BACKEND": "interp"}, None),
    ({"GGRS_TPU_DECODE_BACKEND": "bogus"}, "serial"),
    ({"GGRS_TPU_DECODE_BACKEND": "thread", "GGRS_TPU_NO_PARALLEL_DECODE": "1"}, "serial"),
    ({"GGRS_TPU_DECODE_BACKEND": "thread", "GGRS_TPU_DECODE_WORKERS": "3"}, "thread"),
])
def test_backend_resolution_equals_jax(env, backend):
    with plane_env(env):
        port, jax = tdecode.DecodePool(), jdecode.DecodePool()
    try:
        assert (port.backend, port.workers) == (jax.backend, jax.workers)
        if backend is not None:
            assert port.backend == backend
        if env.get("GGRS_TPU_DECODE_BACKEND") == "interp" and sys.version_info < (3, 14):
            assert port.backend == "serial"  # no InterpreterPoolExecutor before 3.14
        if "GGRS_TPU_DECODE_WORKERS" in env:
            assert port.workers == 3
        if not env and sys.version_info < (3, 14) and getattr(sys, "_is_gil_enabled", lambda: True)():
            assert port.backend == "serial"  # the default on a GIL build
    finally:
        port.close()
        jax.close()


def test_decode_slots_is_owned_by_one_thread():
    dp = DecodePool(backend="thread", workers=2)
    try:
        assert dp.decode_slots(b"", []) == []
        caught = []

        def foreign():
            try:
                dp.decode_slots(b"", [])
            except CrossThreadAccess as e:
                caught.append(e)

        t = threading.Thread(target=foreign)
        t.start()
        t.join()
        assert caught
    finally:
        dp.close()


def test_module_is_stdlib_only_apart_from_the_guard():
    import ast

    tree = ast.parse(open(tdecode.__file__).read())
    imported = {a.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
                for a in node.names}
    relative = {node.module for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.level}
    assert imported <= set(sys.stdlib_module_names)
    assert relative == {"utils.ownership"}
    assert (tdecode._EV_INTERRUPTED, tdecode._EV_CHECKSUM, tdecode._NULL_FRAME) == (
        jdecode._EV_INTERRUPTED, jdecode._EV_CHECKSUM, jdecode._NULL_FRAME)
