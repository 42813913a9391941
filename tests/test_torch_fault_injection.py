"""The port's P2P convergence under injected network faults, and its
spectator pending-overflow disconnect, held against the JAX package's: the
twin of tests/test_fault_injection.py.

Each scenario runs on both packages' sessions over both packages'
``InMemoryNetwork`` at the same seeds: every request list, the final game
states and connection statuses, and the disconnect events must be equal.
Then the JAX file's checks hold on the port's run: the peers converge bit
for bit under each fault class (loss, duplication, reordering, latency), all
of them combined, and with input delay, and a spectator that never acks is
force-disconnected at the 128-unacked-input cap while the game goes on.
Tolerance: exact equality.
"""

import random
from types import SimpleNamespace

import pytest

import ggrs_tpu.core as jcore
import ggrs_tpu.net as jnet
import ggrs_tpu.sessions as jsessions

import ggrs_tpu_torch.core as tcore
import ggrs_tpu_torch.net as tnet
import ggrs_tpu_torch.sessions as tsessions

from test_torch_sessions import _describe, _Stub

PKGS = {
    "jax": SimpleNamespace(core=jcore, net=jnet, sessions=jsessions),
    "port": SimpleNamespace(core=tcore, net=tnet, sessions=tsessions),
}


def make_pair(m, net, clock, input_delay=0, spectator=False):
    sessions = []
    for me, other, local_handle in (("A", "B", 0), ("B", "A", 1)):
        b = (
            m.sessions.SessionBuilder(m.core.Config.for_uint(32))
            .with_clock(clock)
            .with_rng(random.Random((51 if spectator else 41) + local_handle))
        )
        if input_delay:
            b = b.with_input_delay(input_delay)
        if spectator and me == "A":
            b = b.add_player(m.core.Spectator("S"), 2)  # never pumped: dead weight
        sessions.append(
            b.add_player(m.core.Local(), local_handle)
            .add_player(m.core.Remote(other), 1 - local_handle)
            .start_p2p_session(net.socket(me))
        )
    return sessions


def drive(pkg, faults, frames, drain, inputs, input_delay=0):
    """``frames`` frames of ``inputs(i)`` per peer, then ``drain`` frames of
    the drain input so every prediction settles; the net ticks each frame."""
    m = PKGS[pkg]
    net = m.net.InMemoryNetwork(**faults)
    now = [0]
    sessions = make_pair(m, net, lambda: now[0], input_delay)
    stubs = [_Stub(m.core), _Stub(m.core)]
    lists = []
    for i in range(frames + drain):
        now[0] += 16
        net.tick()  # advances latency delivery time
        for s in sessions:
            s.poll_remote_clients()
        for h, (s, stub) in enumerate(zip(sessions, stubs)):
            s.add_local_input(h, inputs(i, h))
            reqs = s.advance_frame()
            lists.append(_describe(m.core, reqs))
            stub.handle(reqs)
    return {
        "states": [(st.frame, st.value) for st in stubs],
        "disconnected": [sessions[0].local_connect_status[1].disconnected,
                         sessions[1].local_connect_status[0].disconnected],
        "lists": lists,
    }


FAULT_CONFIGS = [
    pytest.param(dict(seed=7, loss=0.25), id="loss"),
    pytest.param(dict(seed=8, duplicate=0.4), id="duplicate"),
    pytest.param(dict(seed=9, reorder=0.5), id="reorder"),
    pytest.param(dict(seed=10, latency_ticks=3), id="latency"),
    pytest.param(
        dict(seed=11, loss=0.15, duplicate=0.2, reorder=0.3, latency_ticks=2),
        id="combined",
    ),
]


def _faults_inputs(i, h):
    # the JAX file's schedule, then constant inputs for the 40-frame drain
    if i >= 150:
        return 0
    return i % 5 if h == 0 else (i * 3) % 7


def _delay_inputs(i, h):
    if i >= 120:
        return 1
    return i % 4 if h == 0 else (i * 5) % 9


@pytest.mark.parametrize("faults", FAULT_CONFIGS)
def test_p2p_converges_bit_exact_under_faults(faults):
    port = drive("port", faults, 150, 40, _faults_inputs)
    assert port == drive("jax", faults, 150, 40, _faults_inputs)
    assert port["disconnected"] == [False, False]
    (fa, va), (fb, vb) = port["states"]
    assert fa == fb and va == vb


def test_faults_with_input_delay_converge():
    faults = dict(seed=13, loss=0.2, reorder=0.3)
    port = drive("port", faults, 120, 40, _delay_inputs, input_delay=2)
    assert port == drive("jax", faults, 120, 40, _delay_inputs, input_delay=2)
    (fa, va), (fb, vb) = port["states"]
    assert fa == fb and va == vb


def spectator_overflow(pkg):
    """A spectator that never acks accumulates >128 unacked inputs on the
    host's endpoint; the host must force-disconnect it
    (GGRS src/network/protocol.rs:441-445).  Returns the disconnected
    addresses, the host's game frame then, and after five more frames."""
    m = PKGS[pkg]
    net = m.net.InMemoryNetwork()
    now = [0]
    sess_a, sess_b = make_pair(m, net, lambda: now[0], spectator=True)
    net.socket("S")  # the address exists; nobody ever reads or acks
    stub_a, stub_b = _Stub(m.core), _Stub(m.core)
    gone = []

    def frame(i, value=None):
        now[0] += 16
        sess_a.poll_remote_clients()
        sess_b.poll_remote_clients()
        gone.extend(e.addr for e in sess_a.events() if isinstance(e, m.core.Disconnected))
        sess_a.add_local_input(0, i % 3 if value is None else value)
        stub_a.handle(sess_a.advance_frame())
        sess_b.add_local_input(1, i % 3 if value is None else value)
        stub_b.handle(sess_b.advance_frame())

    for i in range(170):
        frame(i)
        if gone:
            break
    at_disconnect = stub_a.frame
    for i in range(5):
        frame(i, 0)
    return {"gone": gone, "at_disconnect": at_disconnect, "after": stub_a.frame,
            "states": [(stub_a.frame, stub_a.value), (stub_b.frame, stub_b.value)]}


def test_spectator_overflow_force_disconnects():
    port = spectator_overflow("port")
    assert port == spectator_overflow("jax")
    assert port["gone"] == ["S"]
    # the overflow trips right at the 128-unacked-input cap (the game frame
    # trails the forwarded confirmed frames by the prediction window)
    assert port["at_disconnect"] > 120
    # the game itself is unaffected by losing a spectator
    assert port["after"] > port["at_disconnect"]
