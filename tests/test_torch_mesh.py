"""The port's mesh batching against the JAX package's, on the CPU.

``BatchedSessions(mesh=...)`` shards its session axis over every mesh axis,
host-major, each shard's carry on its own device, and combines the health
reduction (``psum`` / ``pmin`` in the JAX package) as a per-shard sum / min
and, across processes, ``torch.distributed.all_reduce``.  On the CPU,
``make_mesh(8, device="cpu")`` is the analogue of the JAX tests' virtual
8-device CPU mesh (``tests/conftest.py``).  Pinned here:

- 1-D 8-shard and 2-D ``(2, 4)`` meshes bitwise equal to the unsharded
  batch and to ``ggrs_tpu``'s ``make_mesh(8)`` / ``make_mesh2d(2, 4)`` runs
  on the same seeded inputs (every carry leaf), with the same global stats;
- a corrupted session found across shards (and across the host row of the
  2-D mesh) with the JAX package's stats; an uneven batch rejected;
- ``make_distributed_mesh`` on one process: the ``(1, n)`` degenerate form;
- the pool's ``mesh=`` against the same sessions unsharded, and against the
  JAX package's sharded pool;
- checkpoints saved from one mesh shape and resumed on another (and by the
  JAX package), equal to the uninterrupted run;
- one two-process gloo run of ``make_distributed_mesh``: the all-reduce
  finds a corruption on the other process, and the gathered states and the
  checkpoint equal the unsharded run.

The oracle is ``tests/test_parallel.py`` (and ``tests/test_session_pool.py``
for the pool).  Tolerance: exact equality.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ggrs_tpu.games as jgames
import ggrs_tpu.parallel as jpar

import ggrs_tpu_torch.games as tgames
import ggrs_tpu_torch.parallel as tpar
from ggrs_tpu_torch import to_numpy
from ggrs_tpu_torch.utils.tree import tree_leaves

from test_torch_session_pool import _drive, _make_matches, _np_state, _to_arr

ROOT = Path(__file__).resolve().parents[1]
B = 16


def _inputs(shape, seed):
    return np.random.default_rng(seed).integers(0, 16, size=shape).astype(np.uint8)


def _port_batch(mesh=None, batch_size=B, game=None, d=2):
    game = game or tgames.BoxGame(2)
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    return tpar.BatchedSessions(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                batch_size=batch_size, check_distance=d, **kw)


def _jax_batch(mesh, batch_size=B, d=2):
    game = jgames.BoxGame(2)
    return jpar.BatchedSessions(game.advance, game.init_state(), jnp.zeros((2,), jnp.uint8),
                                batch_size=batch_size, mesh=mesh, check_distance=d)


def _assert_trees_equal(got, want):
    lg, lw = tree_leaves(got), tree_leaves(want)
    assert len(lg) == len(lw)
    for g, w in zip(lg, lw):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


MESHES = {
    "1d_8": (lambda: tpar.make_mesh(8, device="cpu"), lambda: jpar.make_mesh(8)),
    "2d_2x4": (lambda: tpar.make_mesh2d(2, 4, device="cpu"), lambda: jpar.make_mesh2d(2, 4)),
}


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_mesh_equals_unsharded_and_jax(shape):
    port_mesh, jax_mesh = (f() for f in MESHES[shape])
    assert port_mesh.devices.shape == jax_mesh.devices.shape
    assert port_mesh.axis_names == jax_mesh.axis_names
    inputs = _inputs((B, 30, 2), seed=11)
    sharded, flat, ref = _port_batch(port_mesh), _port_batch(), _jax_batch(jax_mesh)
    stats = [sharded.run_ticks(inputs[:, :12]), flat.run_ticks(inputs[:, :12]),
             ref.run_ticks(inputs[:, :12])]
    stats += [sharded.run_ticks(inputs[:, 12:]), flat.run_ticks(inputs[:, 12:]),
              ref.run_ticks(inputs[:, 12:])]
    assert stats[0] == stats[1] == stats[2] and stats[3] == stats[4] == stats[5]
    assert stats[3]["mismatches"] == 0
    assert len(sharded.shard_carries) == 8
    assert all(tree_leaves(c)[0].shape[0] == B // 8 for c in sharded.shard_carries)
    _assert_trees_equal(to_numpy(sharded.carry), to_numpy(flat.carry))
    _assert_trees_equal(to_numpy(sharded.carry), jax.device_get(ref._carry))
    _assert_trees_equal(sharded.live_states(), ref.live_states())
    # session 5 equals the NumPy oracle, as in tests/test_parallel.py
    game = tgames.BoxGame(2)
    s = game.init_state_np()
    for i in range(30):
        s = game.advance_np(s, inputs[5, i])
    for k in s:
        np.testing.assert_array_equal(sharded.live_states()[k][5], s[k])


@pytest.mark.parametrize("shape,session", [("1d_8", 3), ("2d_2x4", 12)])
def test_corruption_found_across_shards(shape, session):
    """Corrupt one session's saved frame-8 slot (the second host row's, on
    the 2-D mesh): the global stats find it, as the JAX package's do."""
    port_mesh, jax_mesh = (f() for f in MESHES[shape])
    sharded, ref = _port_batch(port_mesh), _jax_batch(jax_mesh)
    sharded.run_ticks(_inputs((B, 10, 2), seed=3))
    ref.run_ticks(_inputs((B, 10, 2), seed=3))
    slot = 8 % sharded._programs.ring.length
    rows = B // port_mesh.size
    sharded.shard_carries[session // rows]["ring"]["states"]["pos"][session % rows, slot, 0, 0] += 1
    states = ref._carry["ring"]["states"]
    states["pos"] = states["pos"].at[session, slot, 0, 0].add(1)
    got = sharded.run_ticks(_inputs((B, 5, 2), seed=4))
    want = ref.run_ticks(_inputs((B, 5, 2), seed=4))
    assert got == want
    assert got["mismatches"] >= 1 and got["first_bad"] == 9


def test_uneven_batch_rejected():
    with pytest.raises(AssertionError):
        _port_batch(tpar.make_mesh(8, device="cpu"), batch_size=9)
    with pytest.raises(ValueError, match="not both"):
        game = tgames.BoxGame(2)
        tpar.BatchedSessions(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                             batch_size=8, mesh=tpar.make_mesh(2, device="cpu"), device="cpu")


def test_distributed_mesh_single_process_degenerate_form():
    mesh = tpar.make_distributed_mesh(device="cpu", devices_per_process=8)
    assert mesh.devices.shape == (1, 8) and mesh.axis_names == ("hosts", "sessions")
    assert mesh.group is None and mesh.world_size == 1
    assert tpar.make_distributed_mesh(device="cpu").devices.shape == (1, 1)
    inputs = _inputs((B, 12, 2), seed=5)
    a, b = _port_batch(tpar.make_mesh(8, device="cpu")), _port_batch(mesh)
    assert a.run_ticks(inputs) == b.run_ticks(inputs)
    _assert_trees_equal(a.live_states(), b.live_states())


def test_mesh_defaults_to_the_cards():
    import torch

    if torch.cuda.is_available():
        assert tpar.make_mesh().devices.flat[0].type == "cuda"
        return
    for make in (tpar.make_mesh, lambda: tpar.make_mesh2d(1, 1), tpar.make_distributed_mesh):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_pool_mesh_equals_unsharded_pool():
    """64 sessions through one pool sharded 8 ways and through one unsharded
    pool (tests/test_session_pool.py's sharded case, at 64 sessions)."""
    game = tgames.BoxGame(2)
    runs = []
    for kw in ({"device": "cpu"}, {"mesh": tpar.make_mesh(8, device="cpu")}):
        sessions, schedules = _make_matches("port", 32, seed=11, desync_interval=8)
        pool = tpar.BatchedRequestExecutor(game.advance, game.init_state_np(), _to_arr,
                                           batch_size=64, ring_length=10, max_burst=9, **kw)
        pool.warmup(np.zeros((2,), np.uint8))
        last = []
        _drive(sessions, schedules, pool.run, 30, on_tick=lambda i, reqs: last.append(reqs))
        saved = [(b, r.frame) for b, rs in enumerate(last[-1])
                 for r in rs if type(r).__name__ == "SaveGameState"]
        runs.append(dict(
            states=[_np_state(pool.live_state(b)) for b in range(64)],
            frames=[s.current_frame for s in sessions],
            checksums={k: pool.ring_checksum(*k) for k in saved},
            sent=[s._local_checksum_history for s in sessions],
            live=to_numpy(pool.live_states),
        ))
    flat, sharded = runs
    assert sharded["frames"] == flat["frames"]
    for g, w in zip(sharded["states"], flat["states"]):
        _assert_trees_equal(g, w)
    assert sharded["checksums"] == flat["checksums"] and flat["checksums"]
    assert sharded["sent"] == flat["sent"]
    _assert_trees_equal(sharded["live"], flat["live"])


def test_pool_mesh_equals_jax_sharded_pool():
    states = {}
    for pkg in ("jax", "port"):
        sessions, schedules = _make_matches(pkg, 4, seed=11)
        if pkg == "jax":
            game = jgames.BoxGame(2)
            pool = jpar.BatchedRequestExecutor(game.advance, game.init_state(), _to_arr,
                                               batch_size=8, ring_length=10, max_burst=9,
                                               mesh=jpar.make_mesh(8))
        else:
            game = tgames.BoxGame(2)
            pool = tpar.BatchedRequestExecutor(game.advance, game.init_state_np(), _to_arr,
                                               batch_size=8, ring_length=10, max_burst=9,
                                               mesh=tpar.make_mesh2d(2, 4, device="cpu"))
        pool.warmup(np.zeros((2,), np.uint8))
        _drive(sessions, schedules, pool.run, 40)
        states[pkg] = [_np_state(pool.live_state(b)) for b in range(8)]
    for g, w in zip(states["port"], states["jax"]):
        _assert_trees_equal(g, w)


def test_checkpoints_cross_mesh_shapes(tmp_path):
    inputs = _inputs((B, 24, 2), seed=21)
    whole = _port_batch()
    whole.run_ticks(inputs)
    src = _port_batch(tpar.make_mesh2d(2, 4, device="cpu"))
    src.run_ticks(inputs[:, :10])
    path = tmp_path / "mesh.npz"
    src.save_checkpoint(path)
    targets = [_port_batch(), _port_batch(tpar.make_mesh(8, device="cpu")),
               _port_batch(tpar.make_mesh(2, device="cpu"))]
    for dst in targets:
        dst.load_checkpoint(path)
        assert dst.current_frame == 10
        assert dst.run_ticks(inputs[:, 10:])["mismatches"] == 0
        _assert_trees_equal(to_numpy(dst.carry), to_numpy(whole.carry))
    # the JAX package resumes the port mesh's file on its own mesh
    ref = _jax_batch(jpar.make_mesh(8))
    ref.load_checkpoint(str(path))
    ref.run_ticks(inputs[:, 10:])
    _assert_trees_equal(jax.device_get(ref._carry), to_numpy(whole.carry))


_WORKER = r"""
import json, sys
sys.modules['jax'] = None
sys.modules['ggrs_tpu'] = None
import numpy as np
import torch.distributed as dist
from ggrs_tpu_torch import to_numpy
from ggrs_tpu_torch.games import BoxGame
from ggrs_tpu_torch.parallel import BatchedSessions, make_distributed_mesh

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
mesh = make_distributed_mesh(coordinator_address='file://' + store, num_processes=2,
                             process_id=rank, device='cpu', devices_per_process=2)
assert mesh.devices.shape == (2, 2) and mesh.world_size == 2 and mesh.rank == rank
game = BoxGame(2)
batch = BatchedSessions(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                        batch_size=8, check_distance=2, mesh=mesh)
inputs = np.random.default_rng(3).integers(0, 16, size=(8, 15, 2)).astype(np.uint8)
assert [k for k, _ in mesh.local_shards()] == [2 * rank, 2 * rank + 1]
clean = batch.run_ticks(inputs[:, :10])
batch.save_checkpoint(out + '/ckpt.npz')
if rank == 1:  # session 6: process 1's second shard, row 0
    slot = 8 % batch._programs.ring.length
    batch.shard_carries[1]['ring']['states']['pos'][0, slot, 0, 0] += 1
bad = batch.run_ticks(inputs[:, 10:])
live = batch.live_states()
np.savez(f'{out}/live{rank}.npz', **live)
json.dump({'clean': clean, 'bad': bad}, open(f'{out}/stats{rank}.json', 'w'))
dist.destroy_process_group()
print('ok')
"""


def test_two_process_gloo_mesh(tmp_path):
    store = tmp_path / "store"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(store), str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=90))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "ok", err
    stats = [json.loads((tmp_path / f"stats{r}.json").read_text()) for r in range(2)]
    assert stats[0] == stats[1]
    assert stats[0]["clean"]["mismatches"] == 0
    assert stats[0]["bad"]["mismatches"] >= 1 and stats[0]["bad"]["first_bad"] == 9
    # the unsharded run of the same inputs: the gathered live states (both
    # processes see all 8) and the checkpoint rank 0 wrote
    inputs = np.random.default_rng(3).integers(0, 16, size=(8, 15, 2)).astype(np.uint8)
    whole = _port_batch(batch_size=8)
    whole.run_ticks(inputs[:, :10])
    ckpt = _port_batch(batch_size=8)
    ckpt.load_checkpoint(tmp_path / "ckpt.npz")
    _assert_trees_equal(to_numpy(ckpt.carry), to_numpy(whole.carry))
    whole.shard_carries[0]["ring"]["states"]["pos"][6, 8 % whole._programs.ring.length, 0, 0] += 1
    assert whole.run_ticks(inputs[:, 10:]) == stats[0]["bad"]
    for r in range(2):
        with np.load(tmp_path / f"live{r}.npz") as live:
            _assert_trees_equal({k: live[k] for k in live.files}, whole.live_states())
