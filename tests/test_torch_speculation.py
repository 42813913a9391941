"""The port's speculative rollback against the JAX package's, on the CPU.

Mirrors ``tests/test_spec_rollback.py``, ``tests/test_spec_integration.py``,
``tests/test_parallel.py::TestSpeculation`` and the speculation tests of
``tests/test_lazy_checksum.py``: each case runs in both packages on the same
numpy inputs, and the port's states, digests and hit and miss counters must
equal the JAX package's.  Then the cross-package drive: the same seeded P2P
match (BASELINE config 3's shape) in both packages with speculation on, the
executor states compared every tick.  Tolerance: exact equality (integer
game math, integer digest)."""

import contextlib
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ggrs_tpu.core as jcore
import ggrs_tpu.games as jgames
import ggrs_tpu.net as jnet
import ggrs_tpu.ops as jops
import ggrs_tpu.ops.checksum as jck
import ggrs_tpu.parallel as jpar
import ggrs_tpu.sessions as jsessions

import ggrs_tpu_torch.core as tcore
import ggrs_tpu_torch.games as tgames
import ggrs_tpu_torch.net as tnet
import ggrs_tpu_torch.ops as tops
import ggrs_tpu_torch.ops.checksum as tck
import ggrs_tpu_torch.parallel as tpar
import ggrs_tpu_torch.sessions as tsessions
from ggrs_tpu_torch.ops import digest as tdg

from chip_smoke import predicted_digest_launches
from test_torch_checksum import _emulated_launch, _FakeCuda

PKGS = {
    "jax": SimpleNamespace(core=jcore, games=jgames, net=jnet, ops=jops, ck=jck, par=jpar,
                           sessions=jsessions),
    "port": SimpleNamespace(core=tcore, games=tgames, net=tnet, ops=tops, ck=tck, par=tpar,
                            sessions=tsessions),
}
CANDIDATES = np.array([0, 1, 4, 8], np.uint8)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(jax.device_get(tree))


def _assert_states_equal(a, b, msg=""):
    a, b = _np(a), _np(b)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{msg} {k}")


def _init(pkg, game):
    return game.init_state() if pkg == "jax" else game.init_state("cpu")


def _branch_inputs(k, frame, local_inputs):
    out = np.array(np.asarray(local_inputs), np.uint8, copy=True)
    out[1] = CANDIDATES[k]
    return out


def _mk_spec(pkg, game, K=4, **kw):
    extra = {} if pkg == "jax" else {"device": "cpu"}
    return PKGS[pkg].par.SpeculativeRollback(game.advance, K, _branch_inputs, max_window=8,
                                             **kw, **extra)


def _both():
    return {pkg: PKGS[pkg].games.BoxGame(2) for pkg in PKGS}


def _advance1(pkg, game, state, inputs):
    """One step of one unbatched state in either package."""
    if pkg == "jax":
        return game.advance(state, jnp.asarray(inputs))
    st = {k: v.unsqueeze(0) for k, v in state.items()}
    out = game.advance(st, torch.from_numpy(np.asarray(inputs)[None]))
    return {k: v[0] for k, v in out.items()}


# -- SpeculativeRollback (tests/test_spec_rollback.py) ----------------------


def test_hit_matches_replay_bitwise():
    out = {}
    for pkg, game in _both().items():
        state = _init(pkg, game)
        spec = _mk_spec(pkg, game)
        spec.root(10, state)
        local = [1, 9, 5]
        for li in local:
            spec.extend(np.asarray([li, 0], np.uint8))
        confirmed = [np.asarray([li, 4], np.uint8) for li in local]  # candidate 2
        traj = spec.resolve(10, confirmed)
        assert traj is not None and len(traj) == 3
        truth = state
        for c in confirmed:
            truth = _advance1(pkg, game, truth, c)
        _assert_states_equal(traj[-1], truth, pkg)
        out[pkg] = traj
    for t in range(3):
        _assert_states_equal(out["port"][t], out["jax"][t], f"step {t}")


def test_miss_returns_none():
    for pkg, game in _both().items():
        spec = _mk_spec(pkg, game)
        spec.root(0, _init(pkg, game))
        spec.extend(np.asarray([1, 0], np.uint8))
        assert spec.resolve(0, [np.asarray([1, 15], np.uint8)]) is None, pkg


def test_wrong_root_or_window_returns_none():
    for pkg, game in _both().items():
        spec = _mk_spec(pkg, game)
        spec.root(5, _init(pkg, game))
        spec.extend(np.asarray([0, 0], np.uint8))
        conf = [np.asarray([0, 0], np.uint8)]
        assert spec.resolve(4, conf) is None, pkg  # wrong anchor
        assert spec.resolve(5, conf * 3) is None, pkg  # window longer than traj


def test_intermediate_states_fulfill_saves():
    out = {}
    for pkg, game in _both().items():
        state = _init(pkg, game)
        spec = _mk_spec(pkg, game)
        spec.root(0, state)
        seq = [np.asarray([2, 1], np.uint8), np.asarray([3, 1], np.uint8)]
        for c in seq:
            spec.extend(c)
        traj = spec.resolve(0, seq)
        assert traj is not None
        truth = state
        for step, c in enumerate(seq):
            truth = _advance1(pkg, game, truth, c)
            _assert_states_equal(traj[step], truth, f"{pkg} step {step}")
        out[pkg] = traj
    for t in range(2):
        _assert_states_equal(out["port"][t], out["jax"][t], f"step {t}")


def test_max_window_caps_extension():
    for pkg, game in _both().items():
        spec = _mk_spec(pkg, game)
        spec.root(0, _init(pkg, game))
        for _ in range(12):
            spec.extend(np.asarray([0, 0], np.uint8))
        assert spec.window == 8, pkg


def test_first_matching_branch_is_selected():
    # candidates 1 and 3 both hypothesize what the session confirms, but
    # their trajectories differ (branch 1's hypothesis differs off the
    # compared frames): both packages take branch 1, the first match
    def branch_inputs(k, frame, local_inputs):
        out = np.array(np.asarray(local_inputs), np.uint8, copy=True)
        out[1] = 4 if k in (1, 3) else 9
        return out

    out = {}
    for pkg, game in _both().items():
        extra = {} if pkg == "jax" else {"device": "cpu"}
        spec = PKGS[pkg].par.SpeculativeRollback(game.advance, 4, branch_inputs,
                                                 max_window=8, **extra)
        state = _init(pkg, game)
        spec.root(0, state)
        for li in (1, 2):
            spec.extend(np.asarray([li, 0], np.uint8))
        # perturb branch 3's stored trajectory so a wrong pick would show
        if pkg == "jax":
            spec._traj_buf = {k: v.at[:, 3].add(1) for k, v in spec._traj_buf.items()}
        else:
            for v in spec._traj_buf.values():
                v[:, 3] += 1
        conf = [np.asarray([1, 4], np.uint8), np.asarray([2, 4], np.uint8)]
        traj = spec.resolve(0, conf)
        steps, _ = spec.fulfill(0, conf, state, with_checksums=False)
        truth = state
        for t, c in enumerate(conf):
            truth = _advance1(pkg, game, truth, c)
            _assert_states_equal(traj[t], truth, f"{pkg} resolve {t}")
            _assert_states_equal(steps[t], truth, f"{pkg} fulfill {t}")
        assert spec.hits == 1
        out[pkg] = steps
    for t in range(2):
        _assert_states_equal(out["port"][t], out["jax"][t], f"step {t}")


# -- build_speculation_programs (tests/test_parallel.py::TestSpeculation) ---


def _programs():
    return {pkg: (game, PKGS[pkg].par.build_speculation_programs(game.advance, num_branches=4))
            for pkg, game in _both().items()}


def _inputs_kw(w, seed):
    return np.random.default_rng(seed).integers(0, 16, size=(4, w, 2)).astype(np.uint8)


def test_matching_branch_selected():
    inputs_kw = _inputs_kw(6, seed=3)
    out = {}
    for pkg, (game, spec) in _programs().items():
        base = _init(pkg, game)
        branches = spec.speculate_window(base, inputs_kw)
        state, idx, found = spec.resolve(branches, inputs_kw, inputs_kw[2])
        assert bool(found) and int(idx) == 2
        _assert_states_equal(state, spec.replay_window(base, inputs_kw[2]), pkg)
        out[pkg] = state
    _assert_states_equal(out["port"], out["jax"])


def test_no_match_reports_not_found():
    inputs_kw = _inputs_kw(4, seed=5)
    for pkg, (game, spec) in _programs().items():
        branches = spec.speculate_window(_init(pkg, game), inputs_kw)
        _, idx, found = spec.resolve(branches, inputs_kw, np.full((4, 2), 255, np.uint8))
        assert not bool(found) and int(idx) == 0, pkg


def test_branches_diverge():
    inputs_kw = _inputs_kw(8, seed=7)
    out = {}
    for pkg, (game, spec) in _programs().items():
        branches = spec.speculate_window(_init(pkg, game), inputs_kw)
        pos = _np(branches)["pos"]
        assert not np.array_equal(pos[0], pos[1])
        out[pkg] = branches
    _assert_states_equal(out["port"], out["jax"])


def test_collapse_picks_branch():
    inputs_kw = _inputs_kw(3, seed=9)
    for pkg, (game, spec) in _programs().items():
        branches = spec.speculate_window(_init(pkg, game), inputs_kw)
        picked = spec.collapse(branches, 1)
        _assert_states_equal(picked, {k: v[1] for k, v in _np(branches).items()}, pkg)


def test_resolve_takes_the_first_of_two_matching_branches():
    inputs_kw = _inputs_kw(5, seed=11)
    inputs_kw[3] = inputs_kw[1]  # branches 1 and 3 both match
    for pkg, (game, spec) in _programs().items():
        branches = spec.speculate_window(_init(pkg, game), inputs_kw)
        _, idx, found = spec.resolve(branches, inputs_kw, inputs_kw[1])
        assert bool(found) and int(idx) == 1, pkg


# -- fused speculation (tests/test_lazy_checksum.py:60-160) ------------------


def test_advance_and_extend_matches_separate_calls():
    for pkg, game in _both().items():
        state = _init(pkg, game)
        spec_a, spec_b = _mk_spec(pkg, game), _mk_spec(pkg, game)
        spec_a.root(0, state)
        spec_b.root(0, state)
        live_a = live_b = state
        for i in range(4):
            inp = np.asarray([i % 3, 4], np.uint8)
            live_a = spec_a.advance_and_extend(live_a, inp)
            assert live_a is not None
            live_b = _advance1(pkg, game, live_b, inp)
            spec_b.extend(inp)
        assert spec_a.window == spec_b.window == 4
        _assert_states_equal(live_a, live_b, pkg)
        confirmed = [np.asarray([i % 3, 4], np.uint8) for i in range(4)]
        ta, tb = spec_a.resolve(0, confirmed), spec_b.resolve(0, confirmed)
        assert ta is not None and tb is not None
        _assert_states_equal(ta[-1], tb[-1], pkg)


def test_advance_and_extend_none_when_unrooted_or_full():
    for pkg, game in _both().items():
        state = _init(pkg, game)
        spec = _mk_spec(pkg, game)
        inp = np.asarray([1, 4], np.uint8)
        assert spec.advance_and_extend(state, inp) is None  # unrooted
        spec.root(0, state)
        for _ in range(8):
            assert spec.advance_and_extend(state, inp) is not None
        assert spec.window == 8
        assert spec.advance_and_extend(state, inp) is None  # window full


def test_fulfill_hit_matches_replay_and_counts():
    sums_by = {}
    for pkg, game in _both().items():
        state = _init(pkg, game)
        spec = _mk_spec(pkg, game)
        spec.root(0, state)
        seq = [np.asarray([i, 4], np.uint8) for i in (1, 2, 3)]
        for s in seq:
            spec.extend(s)
        assert spec.window_valid(0, 3)
        steps, sums = spec.fulfill(0, seq, state, with_checksums=True)
        assert len(steps) == 3 and len(sums) == 3
        truth = state
        ops = PKGS[pkg].ck
        for t, s in enumerate(seq):
            truth = _advance1(pkg, game, truth, s)
            _assert_states_equal(steps[t], truth, f"{pkg} {t}")
            assert ops.DeviceChecksum(sums[t]) == ops.pytree_checksum(truth)
        assert spec.hits == 1
        sums_by[pkg] = [int(ops.DeviceChecksum(x)) for x in sums]
    assert sums_by["port"] == sums_by["jax"]


def test_fulfill_miss_replays_from_load_state():
    for pkg, game in _both().items():
        state = _init(pkg, game)
        spec = _mk_spec(pkg, game)
        spec.root(0, state)
        spec.extend(np.asarray([1, 4], np.uint8))
        confirmed = [np.asarray([1, 15], np.uint8)]
        steps, sums = spec.fulfill(0, confirmed, state, with_checksums=False)
        assert sums is None
        _assert_states_equal(steps[0], _advance1(pkg, game, state, confirmed[0]), pkg)
        assert spec.hits == 0


def test_refill_reanchors_window():
    for pkg, game in _both().items():
        state = _init(pkg, game)
        spec = _mk_spec(pkg, game)
        spec.root(0, state)
        seq = [np.asarray([i, 4], np.uint8) for i in (1, 2, 3)]
        for s in seq:
            spec.extend(s)
        steps, _ = spec.fulfill(0, seq, state, with_checksums=False)
        spec.refill(1, steps[0], seq[1:])
        assert spec.root_frame == 1 and spec.window == 2
        traj = spec.resolve(1, seq[1:])
        assert traj is not None
        truth = state
        for s in seq:
            truth = _advance1(pkg, game, truth, s)
        _assert_states_equal(traj[-1], truth, pkg)


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("n", [1, 3])
def test_fulfill_and_refill_equals_fulfill_then_refill(n, live):
    # the fused call's window afterwards equals refill(frame + 1, steps[0],
    # confirmed[1:]) (plus one frame for the live advance), in both packages
    results = {}
    for pkg, game in _both().items():
        state = _init(pkg, game)
        seq = [np.asarray([i, 4 if i % 2 else 1], np.uint8) for i in range(1, n + 2)]
        confirmed, live_in = seq[:n], (seq[n] if live else None)
        fused, split = _mk_spec(pkg, game), _mk_spec(pkg, game)
        for spec in (fused, split):
            spec.root(0, state)
            for s in seq:
                spec.extend(s)
        out = fused.fulfill_and_refill(0, confirmed, state, True, live_inputs=live_in)
        steps, _ = split.fulfill(0, confirmed, state, True)
        split.refill(1, steps[0], confirmed[1:] + ([live_in] if live else []))
        assert fused.root_frame == split.root_frame == 1
        assert fused.window == split.window == n - 1 + live
        for t in range(n):
            _assert_states_equal(out[0][t], steps[t], f"{pkg} step {t}")
        if live:
            _assert_states_equal(out[2], _advance1(pkg, game, steps[-1], live_in), pkg)
        assert fused.hits == split.hits
        tail = confirmed[1:] + ([live_in] if live else [])
        if tail:
            a, b = fused.resolve(1, tail), split.resolve(1, tail)
            assert (a is None) == (b is None)
            if a is not None:
                _assert_states_equal(a[-1], b[-1], pkg)
        results[pkg] = (out, fused.hits)
    for t in range(n):
        _assert_states_equal(results["port"][0][0][t], results["jax"][0][0][t])
    assert results["port"][1] == results["jax"][1]


def test_warmup_leaves_the_window_and_counter_alone():
    game = tgames.BoxGame(2)
    state = game.init_state("cpu")
    spec = _mk_spec("port", game)
    spec.root(0, state)
    seq = [np.asarray([i, 4], np.uint8) for i in (1, 2)]
    for s in seq:
        spec.extend(s)
    spec.fulfill(0, seq[:1], state, with_checksums=False)
    bufs = [v.clone() for v in spec._traj_buf.values()]
    before = (spec.root_frame, spec.window, spec.hits)
    spec.warmup(state, seq[0], range(1, 9), with_checksums=True)
    assert (spec.root_frame, spec.window, spec.hits) == before
    for a, b in zip(bufs, spec._traj_buf.values()):
        assert torch.equal(a, b)


# -- speculation on the live P2P path (tests/test_spec_integration.py) -------


def _a_sched(i):
    return (i // 4) % 16


def _b_sched(i):
    return (i // 3) % 16


def _oracle(k, frame, arr):
    out = np.array(arr, np.uint8, copy=True)
    if k == 1:
        out[1] = _b_sched(frame)
    return out


def _hopeless(k, frame, arr):
    out = np.array(arr, np.uint8, copy=True)
    if k == 1:
        out[1] = 9
    return out


def _flaky(k, frame, arr):
    out = np.array(arr, np.uint8, copy=True)
    if k == 1:
        out[1] = _b_sched(frame) ^ (0 if frame % 5 else 1)
    return out


def _inputs_np(pairs):
    return np.asarray([p[0] for p in pairs], np.uint8)


def _executor(pkg, game, spec=None, with_checksums=True):
    if pkg == "jax":
        return jops.DeviceRequestExecutor(game.advance, game.init_state(),
                                          lambda pairs: jnp.asarray(_inputs_np(pairs)),
                                          with_checksums=with_checksums, speculation=spec)
    return tops.DeviceRequestExecutor(game.advance, game.init_state_np(), _inputs_np,
                                      with_checksums=with_checksums, speculation=spec,
                                      device="cpu")


def _spec_for(pkg, game, branch_inputs, K=2, **kw):
    extra = {} if pkg == "jax" else {"device": "cpu"}
    if pkg == "jax":
        inner = branch_inputs
        branch_inputs = lambda k, f, arr: jnp.asarray(inner(k, f, np.asarray(arr)))
    return PKGS[pkg].par.SpeculativeRollback(game.advance, K, branch_inputs, max_window=8,
                                             **kw, **extra)


def _count(obj, name, counter, key):
    original = getattr(obj, name)

    def counting(*args, **kwargs):
        counter[key] += 1
        return original(*args, **kwargs)

    setattr(obj, name, counting)


def _pair(pkg, branch_inputs, net_kw=None, sparse=False, seed=3, desync=False):
    p = PKGS[pkg]
    net = p.net.InMemoryNetwork(**(net_kw or {}))
    game = p.games.BoxGame(2)
    sessions, executors = [], []
    for me, other, h in (("A", "B", 0), ("B", "A", 1)):
        b = (p.sessions.SessionBuilder(p.games.boxgame_config()).with_clock(lambda: 0)
             .with_rng(random.Random(seed + h)).with_sparse_saving_mode(sparse))
        if desync:
            b = b.with_desync_detection_mode(p.core.DesyncDetection(True, 1))
        sessions.append(b.add_player(p.core.Local(), h).add_player(p.core.Remote(other), 1 - h)
                        .start_p2p_session(net.socket(me)))
        spec = _spec_for(pkg, game, branch_inputs) if me == "A" else None
        executors.append(_executor(pkg, game, spec))
    return sessions, executors


def _drive(pkg, sessions, executors, ticks, drain=12, on_tick=None):
    loads = 0
    Load = PKGS[pkg].core.LoadGameState
    for i in range(ticks + drain):
        sa, sb = sessions
        sa.poll_remote_clients()
        sb.poll_remote_clients()
        sa.add_local_input(0, _a_sched(min(i, ticks - 1)))
        reqs = sa.advance_frame()
        loads += sum(1 for r in reqs if isinstance(r, Load))
        executors[0].run(reqs)
        sb.add_local_input(1, _b_sched(min(i, ticks - 1)))
        executors[1].run(sb.advance_frame())
        if on_tick is not None:
            on_tick(i, executors)
    return loads


def _assert_peers_identical(sessions, executors):
    assert sessions[0].current_frame == sessions[1].current_frame
    _assert_states_equal(executors[0].state, executors[1].state)


def _both_drives(branch_inputs, ticks, drain=12, **kw):
    out = {}
    for pkg in PKGS:
        sessions, executors = _pair(pkg, branch_inputs, **kw)
        bursts = {"n": 0}
        _count(executors[0], "_do_burst", bursts, "n")
        per_tick = []
        loads = _drive(pkg, sessions, executors, ticks, drain,
                       on_tick=lambda i, exs: per_tick.append(_np(exs[0].state)))
        _assert_peers_identical(sessions, executors)
        out[pkg] = SimpleNamespace(sessions=sessions, executors=executors, loads=loads,
                                   bursts=bursts["n"], per_tick=per_tick,
                                   hits=executors[0].spec_hits, misses=executors[0].spec_misses)
    for i, (a, b) in enumerate(zip(out["port"].per_tick, out["jax"].per_tick)):
        _assert_states_equal(a, b, f"tick {i}")
    assert (out["port"].hits, out["port"].misses) == (out["jax"].hits, out["jax"].misses)
    assert out["port"].loads == out["jax"].loads
    assert out["port"].bursts == out["jax"].bursts
    return out


def test_branch_hit_fulfills_rollback_without_replay():
    out = _both_drives(_oracle, 40)
    for run in out.values():
        assert run.loads > 5
        assert run.hits == run.loads and run.misses == 0
        assert run.bursts == 0, "a hit must not run the replay burst"


def test_rollback_tick_is_one_fused_call():
    sessions, executors = _pair("port", _oracle)
    ex_a = executors[0]
    calls = {"fused_live": 0, "unfused": 0, "advances": 0, "adv_ext": 0, "bursts": 0}
    spec = ex_a._spec
    orig_fulfill, orig_adv_ext = spec.fulfill_and_refill, spec.advance_and_extend
    orig_advance = ex_a._programs.advance

    def spy_fulfill(frame, confirmed, load_state, wc, live_inputs=None):
        calls["fused_live" if live_inputs is not None else "unfused"] += 1
        return orig_fulfill(frame, confirmed, load_state, wc, live_inputs=live_inputs)

    def spy_adv_ext(state, inputs):
        out = orig_adv_ext(state, inputs)
        calls["adv_ext"] += out is not None
        return out

    def spy_advance(state, inputs):
        calls["advances"] += 1
        return orig_advance(state, inputs)

    spec.fulfill_and_refill, spec.advance_and_extend = spy_fulfill, spy_adv_ext
    ex_a._programs.advance = spy_advance
    _count(ex_a, "_do_burst", calls, "bursts")
    loads = _drive("port", sessions, executors, 40)
    assert loads > 5 and calls["fused_live"] > 0 and calls["bursts"] == 0
    assert calls["fused_live"] + calls["unfused"] == loads
    assert (calls["advances"] + calls["adv_ext"] + calls["fused_live"] + calls["unfused"]
            == 52), "a tick must be exactly one advance, one advance_and_extend or one fulfill"
    _assert_peers_identical(sessions, executors)


def test_miss_falls_back_to_replay():
    out = _both_drives(_hopeless, 40)
    for run in out.values():
        assert run.loads > 5 and run.misses > 0


def test_sparse_saving_with_speculation_stays_correct():
    _both_drives(_oracle, 40, seed=29, sparse=True)


def test_speculation_under_packet_loss_mixes_hits_and_fallbacks():
    out = _both_drives(_flaky, 120, drain=40, net_kw=dict(loss=0.25, seed=37))
    for run in out.values():
        assert run.hits > 0 and run.misses > 0


_nothing = contextlib.nullcontext


def _four_peer_drive(pkg, ticks=48, scheduled=36, device_read_spy=None):
    """BASELINE config 3's shape: 4 players, 8-frame prediction, 8 branches
    (bench.py's branch_inputs_all: 7 held-button guesses and the oracle);
    peer 0 speculates, the other three replay.  Desync detection at
    interval 1, so the fused window's digests run."""
    p = PKGS[pkg]
    net = p.net.InMemoryNetwork()
    game = p.games.BoxGame(4)
    peers = ["P0", "P1", "P2", "P3"]
    sched = lambda player, i: ((i + player) // 3) % 16
    hyp_base = np.zeros((8, 4), np.uint8)
    hyp_base[:7, 1:] = np.arange(7, dtype=np.uint8)[:, None]

    def branch_inputs_all(frame, arr):
        out = hyp_base.copy()
        out[:, 0] = np.asarray(arr)[0]
        out[7, 1:] = [sched(q, frame) for q in (1, 2, 3)]
        return out if pkg == "port" else jnp.asarray(out)

    def branch_inputs(k, frame, arr):
        return branch_inputs_all(frame, arr)[k]

    sessions, executors = [], []
    for me in range(4):
        b = (p.sessions.SessionBuilder(p.games.boxgame_config()).with_num_players(4)
             .with_max_prediction_window(8).with_clock(lambda: 0)
             .with_rng(random.Random(91 + me))
             .with_desync_detection_mode(p.core.DesyncDetection(True, 1)))
        for q in range(4):
            b = b.add_player(p.core.Local() if q == me else p.core.Remote(peers[q]), q)
        sessions.append(b.start_p2p_session(net.socket(peers[me])))
        spec = None
        if me == 0:
            extra = {} if pkg == "jax" else {"device": "cpu"}
            spec = p.par.SpeculativeRollback(game.advance, 8, branch_inputs, max_window=8,
                                             branch_inputs_all=branch_inputs_all, **extra)
        executors.append(_executor(pkg, game, spec))
    Load, Desync = p.core.LoadGameState, p.core.DesyncDetected
    loads, desyncs, per_tick, predicted, launched = 0, 0, [], 0, 0
    for i in range(ticks):
        for s in sessions:
            s.poll_remote_clients()
        for q, (s, ex) in enumerate(zip(sessions, executors)):
            s.add_local_input(q, sched(q, min(i, scheduled - 1)))
            reqs = s.advance_frame()
            if q == 0:
                loads += sum(1 for r in reqs if isinstance(r, Load))
                predicted += predicted_digest_launches(reqs) if pkg == "port" else 0
                before = tdg.state_digest.launches
                with device_read_spy() if device_read_spy is not None else _nothing():
                    ex.run(reqs)
                launched += tdg.state_digest.launches - before
            else:
                ex.run(reqs)
            desyncs += sum(1 for e in s.events() if isinstance(e, Desync))
        per_tick.append(_np(executors[0].state))
    return SimpleNamespace(sessions=sessions, executors=executors, loads=loads,
                           desyncs=desyncs, per_tick=per_tick, predicted=predicted,
                           launched=launched)


def test_four_players_eight_branches_match_jax_every_tick():
    runs = {pkg: _four_peer_drive(pkg) for pkg in PKGS}
    for run in runs.values():
        assert run.loads > 0 and run.desyncs == 0
        assert run.executors[0].spec_hits > 0
        assert len({s.current_frame for s in run.sessions}) == 1
        for other in (1, 2, 3):
            _assert_states_equal(run.executors[0].state, run.executors[other].state, f"peer {other}")
    port, jx = runs["port"], runs["jax"]
    assert port.loads == jx.loads
    for i, (a, b) in enumerate(zip(port.per_tick, jx.per_tick)):
        _assert_states_equal(a, b, f"tick {i}")
    for name in ("spec_hits", "spec_misses"):
        assert getattr(port.executors[0], name) == getattr(jx.executors[0], name), name
    assert port.executors[0].spec_hits + port.executors[0].spec_misses == port.loads
    # every peer's saved checksums agree across packages (desync interval 1)
    for ps, js in zip(port.sessions, jx.sessions):
        assert ps._local_checksum_history == js._local_checksum_history


class _DeviceRead(AssertionError):
    pass


def _no_device_reads(monkeypatch):
    """A context in which every tensor read to the host raises."""

    def refuse(*args, **kwargs):
        raise _DeviceRead("a tensor was read to the host")

    @contextlib.contextmanager
    def spy():
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__index__",
                         "__float__"):
                m.setattr(torch.Tensor, name, refuse)
            yield

    return spy


def test_live_speculation_reads_nothing_from_the_device(monkeypatch):
    spy = _no_device_reads(monkeypatch)
    with pytest.raises(_DeviceRead):
        with spy():
            bool(torch.ones(1))
    run = _four_peer_drive("port", ticks=30, scheduled=24, device_read_spy=spy)
    assert run.loads > 0 and run.executors[0].spec_hits > 0


def test_speculating_peer_digest_launches_are_predicted(monkeypatch):
    # the card's wrapper route, emulated: one digest launch per saving burst
    # or fused window and one per lone Save -- the plain path's count
    calls = []
    monkeypatch.setattr(tdg, "_launch", _emulated_launch(calls))
    monkeypatch.setattr(tdg, "_device_of", lambda tensors, what: _FakeCuda())
    run = _four_peer_drive("port", ticks=40, scheduled=30)
    assert run.loads > 0 and run.desyncs == 0
    assert run.launched == run.predicted > 0
