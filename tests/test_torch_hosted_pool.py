"""The port's descriptor plane and HostedPool against the JAX package's, on
the CPU.

Mirrors ``tests/test_descriptor_plane.py`` and the HostedPool cases of
``tests/test_session_bank.py``: the same seeded BoxGame(2) matches, on
identically seeded fault networks, through the JAX package's HostedPool (its
HostSessionPool feeding its BatchedRequestExecutor) and the port's must end
on bitwise equal live states, ring frame tags and ring checksums, with
rollback-resim rows (``_fill_resim``) and quiet rows taken, with checksums
on and off.  Beside it: ``_run_plan`` against ``run()`` on the materialized
lists, the RequestPlan's laziness, staleness guard and counters,
``stage_inputs`` against per-call staging, the outbound send table over
loopback UDP, and the digest's launches on the card's wrapper route
(emulated) against the count the descriptors predict.  Tolerance: exact
equality (integer game math, integer digest)."""

from __future__ import annotations

import select

import jax
import numpy as np
import pytest
import torch

import ggrs_tpu.games as jgames
import ggrs_tpu.parallel as jpar
import ggrs_tpu_torch.games as tgames
import ggrs_tpu_torch.parallel as tpar
from ggrs_tpu_torch.core.errors import InvalidRequest
from ggrs_tpu_torch.net.sockets import UdpNonBlockingSocket
from ggrs_tpu_torch.ops import digest as tdg

from chip_smoke import pool_predicted
from test_torch_checksum import _emulated_launch, _FakeCuda
from test_torch_host_bank import (
    LOSSY,
    PKGS,
    builder,
    fulfill_saves,
    match_builders,
    summary,
)

FAULTS = dict(seed=2026, loss=0.05, reorder=0.05, latency_ticks=3)


def to_arr(pairs):
    return np.asarray([p[0] for p in pairs], np.uint8)


def raw_to_arr(blobs, statuses):
    # boxgame_config(): one input byte per player
    return blobs[:, :, 0]


def pool_sched(i, idx):
    """``bench.py``'s ``_match_population`` schedule for session idx."""
    m, me = divmod(idx, 2)
    return ((i + 2 * m + me) // (2 + m % 3)) % 16


def _np(tree):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else jax.device_get(v))
            for k, v in tree.items()}


def hosted(pkg, n_matches=3, faults=FAULTS, with_checksums=True, raw=True, native=True):
    """A HostedPool over ``n_matches`` two-peer BoxGame matches, its host
    pool on the native bank (``native``) or on the Python fallback."""
    p = PKGS[pkg]
    clock = [0]
    net = p.net.InMemoryNetwork(**(faults or {}))
    cfg = (jgames if pkg == "jax" else tgames).boxgame_config
    bs = []
    for m in range(n_matches):
        names = (f"A{m}", f"B{m}")
        for me in (0, 1):
            bs.append((builder(pkg, clock, 3 + 5 * m + me, me, names[1 - me], cfg=cfg()),
                       net.socket(names[me])))
    host = p.bank.HostSessionPool()
    for b, s in bs:
        host.add_session(b, s)
    assert host.native_active == native
    game = (jgames if pkg == "jax" else tgames).BoxGame(2)
    par = jpar if pkg == "jax" else tpar
    extra = {} if pkg == "jax" else {"device": "cpu"}
    init = game.init_state() if pkg == "jax" else game.init_state_np()
    ex = par.BatchedRequestExecutor(game.advance, init, to_arr, batch_size=len(bs),
                                    ring_length=10, max_burst=9, with_checksums=with_checksums,
                                    raw_inputs_to_array=raw_to_arr if raw else None, **extra)
    ex.warmup(np.zeros(2, np.uint8))
    return clock, net, host, ex, par.HostedPool(host, ex)


def run_hosted(pkg, ticks, **kw):
    clock, net, host, ex, hp = hosted(pkg, **kw)
    rows = {"quiet": 0, "resim": 0, "save_only": 0, "eager": 0}
    for i in range(ticks):
        clock[0] += 16
        hp.tick([(idx, idx % 2, pool_sched(i, idx)) for idx in range(len(host))])
        plan = host._plan
        if plan is not None:
            rows["quiet"] += int(plan.quiet_rows.size)
            rows["resim"] += len(plan.resim_rows)
            rows["save_only"] += len(plan.save_only_rows)
            rows["eager"] += len(plan.eager_rows)
        net.tick()
    hp.block_until_ready()
    return host, ex, rows


def assert_executors_equal(ea, eb, host, with_checksums):
    n = ea.batch_size
    for b in range(n):
        sa, sb = _np(ea.live_state(b)), _np(eb.live_state(b))
        assert sa.keys() == sb.keys()
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=f"session {b} leaf {k}")
    np.testing.assert_array_equal(ea._host_frames, eb._host_frames)
    if with_checksums:
        for b in range(n):
            for f in ea._host_frames[b][ea._host_frames[b] >= host.last_confirmed_frame(b) - 2]:
                assert ea.ring_checksum(b, int(f)) == eb.ring_checksum(b, int(f)), (b, f)


@pytest.mark.parametrize("with_checksums", [True, False], ids=["checksums", "no_checksums"])
@pytest.mark.parametrize("faults", [FAULTS, LOSSY], ids=["latency3", "lossy"])
def test_hosted_pool_matches_jax(with_checksums, faults):
    hj, ej, rows_j = run_hosted("jax", 90, faults=faults, with_checksums=with_checksums)
    ht, et, rows_t = run_hosted("port", 90, faults=faults, with_checksums=with_checksums)
    assert rows_t == rows_j
    assert rows_t["quiet"] > 0 and rows_t["resim"] > 0, rows_t
    assert [ht.current_frame(b) for b in range(len(ht))] == \
        [hj.current_frame(b) for b in range(len(hj))]
    assert ht.crossings == 90
    assert_executors_equal(et, ej, ht, with_checksums)


@pytest.mark.parametrize("leg", ["no_raw_converter", "materialized_lists"])
def test_run_plan_matches_run_on_materialized_lists(leg):
    """The descriptor path (flat columns, zero request objects) against the
    reference: the plan's lists materialized and parsed request by request,
    either inside ``_run_plan`` (no bulk converter) or through ``run()`` on
    a plain list of lists."""
    _, ea, _ = run_hosted("port", 80, faults=LOSSY)
    clock, net, host, ex, hp = hosted("port", faults=LOSSY, raw=(leg != "no_raw_converter"))
    for i in range(80):
        clock[0] += 16
        items = [(idx, idx % 2, pool_sched(i, idx)) for idx in range(len(host))]
        if leg == "materialized_lists":
            host.stage_inputs(items)
            plan = host.advance_all()
            ex.run([list(plan[b]) for b in range(len(plan))])
        else:
            hp.tick(items)
        net.tick()
    assert_executors_equal(ea, ex, host, True)


def _quiet_pool(n_matches=2):
    p = PKGS["port"]
    clock = [0]
    net = p.net.InMemoryNetwork()
    host = p.bank.HostSessionPool()
    for b, s in match_builders("port", net, clock, n_matches):
        host.add_session(b, s)
    assert host.native_active
    return host, net, clock


def _plan_tick(host, net, clock, value, fulfill=True):
    clock[0] += 16
    host.stage_inputs([(idx, idx % 2, value(idx)) for idx in range(len(host))])
    plan = host.advance_all()
    if fulfill:
        for reqs in plan:
            fulfill_saves(reqs)
    net.tick()
    return plan


def test_request_plan_materializes_lazily():
    host, net, clock = _quiet_pool()
    for i in range(20):
        _plan_tick(host, net, clock, lambda idx: (i + idx) % 16)
    plan = _plan_tick(host, net, clock, lambda idx: (20 + idx) % 16, fulfill=False)
    assert isinstance(plan, tpar.RequestPlan)
    assert all(lst is None for lst in plan.lists), "quiet slots materialized at plan build"
    reqs = plan[0]
    assert plan.lists[0] is reqs and plan.lists[1] is None
    assert host.requests_for(0) is reqs
    assert summary(reqs)[-1][0] == "AdvanceFrame"
    for reqs in plan:
        fulfill_saves(reqs)


def test_stale_plan_raises_on_both_consumers():
    host, net, clock = _quiet_pool()
    game = tgames.BoxGame(2)
    ex = tpar.BatchedRequestExecutor(game.advance, game.init_state_np(), to_arr,
                                     batch_size=len(host), ring_length=10, max_burst=9,
                                     raw_inputs_to_array=raw_to_arr, device="cpu")
    ex.warmup(np.zeros(2, np.uint8))
    # constant inputs: predictions are always right, so leaving one tick's
    # saves unfulfilled can never be loaded back by a rollback
    for _ in range(10):
        ex.run(_plan_tick(host, net, clock, lambda idx: 7, fulfill=False))
    stale = _plan_tick(host, net, clock, lambda idx: 7, fulfill=False)
    assert stale.lists[0] is None
    ex.run(_plan_tick(host, net, clock, lambda idx: 7, fulfill=False))
    with pytest.raises(InvalidRequest, match="stale"):
        stale[0]
    with pytest.raises(RuntimeError, match="stale RequestPlan"):
        ex.run(stale)


def test_request_plan_counters():
    host, net, clock = _quiet_pool()
    for i in range(30):
        _plan_tick(host, net, clock, lambda idx: (i + idx) % 16)
    assert host.plan_ticks == 30
    assert host.fast_slot_ticks > 0
    # tick 0 (the frame-0 double save) is an unclassified shape: eager
    assert host.desc_slow_slots >= len(host)


@pytest.mark.parametrize("other", ["port_add_local_input", "jax_stage_inputs"])
def test_stage_inputs_parity(other):
    """One ``ggrs_bank_stage_inputs`` crossing per tick: the same requests,
    events, frames and wire bytes as per-call staging and as the JAX
    package's batched staging."""
    runs = {}
    for leg in ("port_stage_inputs", other):
        pkg = "jax" if leg.startswith("jax") else "port"
        p = PKGS[pkg]
        clock = [0]
        net = p.net.InMemoryNetwork(**LOSSY)
        bs = match_builders(pkg, net, clock, 3)
        pool = p.bank.HostSessionPool()
        for b, s in bs:
            pool.add_session(b, s)
        trace = []
        for i in range(60):
            clock[0] += 16
            items = [(idx, idx % 2, pool_sched(i, idx)) for idx in range(len(bs))]
            if leg.endswith("stage_inputs"):
                pool.stage_inputs(items)
            else:
                for idx, h, v in items:
                    pool.add_local_input(idx, h, v)
            reqs = pool.advance_all()
            trace.append([(summary(reqs[k]), [repr(e) for e in pool.events(k)],
                           pool.current_frame(k)) for k in range(len(bs))])
            for r in reqs:
                fulfill_saves(r)
            net.tick()
        assert pool.crossings == 60
        runs[leg] = (trace, [s.sent for _, s in bs])
    assert runs["port_stage_inputs"] == runs[other]


def test_stage_inputs_rejects_atomically_and_harvest_keeps_staged():
    host, net, clock = _quiet_pool(1)
    for i in range(5):
        _plan_tick(host, net, clock, lambda idx: i % 16)
    with pytest.raises(InvalidRequest):
        host.stage_inputs([(0, 0, 3), (1, 0, 4)])  # slot 1's local handle is 1
    assert all(not m.staged_native for m in host._mirrors)
    host.stage_inputs([(0, 0, 3)])
    h = host._harvest(0)
    assert h["staged_inputs"] == {0: bytes([3, 0])}


class TeeSocket:
    """Records every datagram the peer RECEIVES (the pool's outbound as
    observed on the wire) without stealing them."""

    def __init__(self, inner):
        self.inner = inner
        self.tape = []

    def send_to(self, msg, addr):
        self.inner.send_to(msg, addr)

    def send_datagram(self, data, addr):
        self.inner.send_datagram(data, addr)

    def receive_all_datagrams(self):
        got = self.inner.receive_all_datagrams()
        self.tape.extend(data for _, data in got)
        return got

    def receive_all_messages(self):
        return self.inner.receive_all_messages()


def _loopback_leg(fastpath: bool, monkeypatch):
    if fastpath:
        monkeypatch.delenv("GGRS_TPU_NO_FASTPATH", raising=False)
    else:
        monkeypatch.setenv("GGRS_TPU_NO_FASTPATH", "1")
    clock = [0]
    pool = tpar.HostSessionPool()
    host_sock = UdpNonBlockingSocket(0)
    peer_inner = UdpNonBlockingSocket(0)
    peer_sock = TeeSocket(peer_inner)
    peer_addr = ("127.0.0.1", peer_inner.local_port())
    host_addr = ("127.0.0.1", host_sock.local_port())
    python_sends = []
    real_send = host_sock.send_datagram
    host_sock.send_datagram = lambda data, addr: (python_sends.append(addr),
                                                  real_send(data, addr))
    pool.add_session(builder("port", clock, 11, 0, peer_addr), host_sock)
    peer = builder("port", clock, 12, 1, host_addr).start_p2p_session(peer_sock)
    assert pool.native_active
    # the slot qualifies for the send table; only the descriptor-plane
    # decode uses it (the reference decoder sends per datagram)
    assert pool._send_fds[0] is not None
    sent = 0
    try:
        for i in range(100):
            clock[0] += 16
            # the peer polls first; before that, wait (bounded) until the
            # pool's datagrams of the last tick have landed on loopback
            if sent:
                select.select([peer_inner._sock], [], [], 0.5)
            peer.add_local_input(1, i % 16)
            fulfill_saves(peer.advance_frame())
            pool.stage_inputs([(0, 0, i % 16)])
            for reqs in pool.advance_all():
                fulfill_saves(reqs)
            sent += 1
        # the descriptor plane flushes fast slots through the native send
        # table; only slow slots (the frame-0 tick) send from Python
        if fastpath:
            assert len(python_sends) < 5, len(python_sends)
        else:
            assert len(python_sends) >= 100
        return list(peer_sock.tape), pool.current_frame(0)
    finally:
        host_sock.close()
        peer_inner.close()


def test_send_table_over_loopback_udp(monkeypatch):
    """A plain UDP socket's outbound rides the one-crossing send table; the
    peer-observed stream equals the per-datagram reference leg's."""
    ref_stream, ref_frame = _loopback_leg(False, monkeypatch)
    fast_stream, fast_frame = _loopback_leg(True, monkeypatch)
    assert fast_stream == ref_stream, (len(fast_stream), len(ref_stream))
    assert fast_frame == ref_frame >= 90


def test_digest_launches_on_the_card_route_match_descriptors(monkeypatch):
    # the card's wrapper route, emulated: each masked write some row takes
    # is one launch over the B rows, whatever fills the descriptor
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    clock, net, host, ex, hp = hosted("port", faults=LOSSY)
    predicted = {"n": 0}
    real_tick = ex._tick

    def tick(desc):
        predicted["n"] += pool_predicted(desc)
        return real_tick(desc)

    ex._tick = tick
    before = tdg.state_digest.launches
    calls.clear()  # the warmup's digest
    for i in range(40):
        clock[0] += 16
        hp.tick([(idx, idx % 2, pool_sched(i, idx)) for idx in range(len(host))])
        net.tick()
    assert tdg.state_digest.launches - before == predicted["n"] == len(calls) > 40
    assert set(calls) == {len(host)}


def test_size_mismatch_refused():
    host, _, _ = _quiet_pool(1)
    game = tgames.BoxGame(2)
    ex = tpar.BatchedRequestExecutor(game.advance, game.init_state_np(), to_arr,
                                     batch_size=4, ring_length=10, max_burst=9, device="cpu")
    with pytest.raises(ValueError):
        tpar.HostedPool(host, ex)


def test_hosted_pool_on_the_python_fallback_matches_the_bank(monkeypatch):
    # a fallback host pool hands the executor plain lists: same device state
    host_b, ex_b, _ = run_hosted("port", 60, faults=LOSSY)
    monkeypatch.setenv("GGRS_TPU_NO_NATIVE", "1")
    host_f, ex_f, rows = run_hosted("port", 60, faults=LOSSY, native=False)
    assert rows == {"quiet": 0, "resim": 0, "save_only": 0, "eager": 0}
    assert host_f.crossings == 0
    assert_executors_equal(ex_b, ex_f, host_b, True)


def test_run_plan_keeps_no_view_of_the_reused_output_buffer():
    """The plan's columns view the host pool's output buffer, which the
    next ``advance_all`` overwrites: ``run`` copies what it reads.  Scribbling
    over the buffer after every tick changes nothing on the device or in
    the saved checksums."""
    import ctypes

    _, ea, _ = run_hosted("port", 60, faults=LOSSY)
    clock, net, host, ex, hp = hosted("port", faults=LOSSY)
    for i in range(60):
        clock[0] += 16
        hp.tick([(idx, idx % 2, pool_sched(i, idx)) for idx in range(len(host))])
        ctypes.memset(host._out_buf, 0xFF, len(host._out_buf))
        net.tick()
    assert_executors_equal(ea, ex, host, True)
