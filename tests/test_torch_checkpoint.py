"""Durable checkpoints of the port, in the JAX package's file format.

A resumed session must be bitwise the session that never stopped, and a
checkpoint written by either package must load into the other and continue
bit-exactly (tolerance exactly 0: every leaf is integer).  The cases of
``tests/test_checkpoint.py`` run against the port too."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ggrs_tpu.core.errors import InvalidRequest as JaxInvalidRequest
from ggrs_tpu.games import BoxGame as JaxBoxGame
from ggrs_tpu.games.chipvm import ChipVM as JaxChipVM
from ggrs_tpu.parallel import BatchedSessions as JaxBatchedSessions
from ggrs_tpu.parallel import make_mesh
from ggrs_tpu.sessions import DeviceSyncTestSession as JaxSession
from ggrs_tpu.utils import checkpoint as jckpt

from ggrs_tpu_torch import BatchedSessions, BoxGame, ChipVM, DeviceSyncTestSession, InvalidRequest, to_numpy
from ggrs_tpu_torch.utils import checkpoint as tckpt
from ggrs_tpu_torch.utils.tree import tree_leaves


def _box_inputs(n, seed):
    return np.random.default_rng(seed).integers(0, 16, size=(n, 2)).astype(np.uint8)


def _vm_inputs(b, n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(b, n, 2)).astype(np.uint8)


def _port_session(d=2):
    game = BoxGame(2)
    return DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8),
                                 check_distance=d, device="cpu")


def _jax_session(d=2):
    game = JaxBoxGame(2)
    return JaxSession(game.advance, game.init_state(), jnp.zeros((2,), jnp.uint8),
                      check_distance=d)


def _port_batch(b=4, d=2):
    vm = ChipVM(2)
    return BatchedSessions(vm.advance, vm.init_state_np(), np.zeros(2, np.uint8),
                           batch_size=b, check_distance=d, max_prediction=4, device="cpu")


def _jax_batch(b=4, d=2):
    vm = JaxChipVM(2)
    return JaxBatchedSessions(vm.advance, vm.init_state(), jnp.zeros((2,), jnp.uint8),
                              batch_size=b, mesh=make_mesh(1), check_distance=d, max_prediction=4)


def _assert_trees_equal(got, want):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# -- the port resumes its own checkpoints ------------------------------------


def test_device_synctest_resumes_bit_exactly(tmp_path):
    path = tmp_path / "sess.npz"
    head, tail = _box_inputs(10, 1), _box_inputs(10, 2)
    a = _port_session()
    a.run_ticks(head)
    a.save_checkpoint(path)
    a.run_ticks(tail)
    b = _port_session()
    ptrs = [t.data_ptr() for t in tree_leaves(b.carry)]
    b.load_checkpoint(path)
    assert [t.data_ptr() for t in tree_leaves(b.carry)] == ptrs  # preallocated carry kept
    assert b.current_frame == 10
    b.run_ticks(tail)
    _assert_trees_equal(to_numpy(b.carry), to_numpy(a.carry))


def test_batched_sessions_resume_bit_exactly(tmp_path):
    path = tmp_path / "batch.npz"
    head, tail = _vm_inputs(4, 10, 3), _vm_inputs(4, 10, 4)
    a = _port_batch()
    assert a.run_ticks(head)["mismatches"] == 0
    a.save_checkpoint(path)
    assert a.run_ticks(tail)["mismatches"] == 0
    b = _port_batch()
    b.load_checkpoint(path)
    assert b.current_frame == 10
    assert b.run_ticks(tail)["mismatches"] == 0
    _assert_trees_equal(to_numpy(b.carry), to_numpy(a.carry))


def test_loading_restores_the_desync_state(tmp_path):
    # a checkpoint taken before a corruption resumes clean, and one taken
    # after it carries the mismatch count with it
    clean, dirty = tmp_path / "clean", tmp_path / "dirty"
    a = _port_batch()
    a.run_ticks(_vm_inputs(4, 10, 5))
    a.save_checkpoint(clean)
    a.carry["hist"][1, 9 % 5] = 1
    assert a.run_ticks(_vm_inputs(4, 1, 6))["mismatches"] == 1
    a.save_checkpoint(dirty)
    a.load_checkpoint(clean)
    assert a.verify() == {"mismatches": 0, "first_bad": 2**31 - 1}
    assert a.run_ticks(_vm_inputs(4, 1, 6))["mismatches"] == 0
    a.load_checkpoint(dirty)
    assert a.run_ticks(_vm_inputs(4, 1, 7)) == {"mismatches": 1, "first_bad": 9}


def test_extensionless_path_round_trips(tmp_path):
    a = _port_session()
    a.run_ticks(_box_inputs(6, 9))
    a.save_checkpoint(str(tmp_path / "ckpt"))
    assert (tmp_path / "ckpt.npz").exists()
    b = _port_session()
    b.load_checkpoint(str(tmp_path / "ckpt"))
    assert b.current_frame == 6


# -- across packages -------------------------------------------------------------


def test_jax_session_checkpoint_loads_into_the_port(tmp_path):
    path = tmp_path / "jax.npz"
    head, tail = _box_inputs(10, 11), _box_inputs(10, 12)
    jx = _jax_session()
    jx.run_ticks(head)
    jx.save_checkpoint(str(path))
    jx.run_ticks(tail)
    port = _port_session()
    port.load_checkpoint(path)
    assert port.current_frame == 10
    port.run_ticks(tail)
    _assert_trees_equal(to_numpy(port.carry), jax.device_get(jx._carry))


def test_port_session_checkpoint_loads_into_jax(tmp_path):
    path = tmp_path / "port.npz"
    head, tail = _box_inputs(10, 13), _box_inputs(10, 14)
    port = _port_session()
    port.run_ticks(head)
    port.save_checkpoint(path)
    port.run_ticks(tail)
    jx = _jax_session()
    jx.load_checkpoint(str(path))
    assert jx.current_frame == 10
    jx.run_ticks(jnp.asarray(tail))
    _assert_trees_equal(to_numpy(port.carry), jax.device_get(jx._carry))


def test_jax_batch_checkpoint_loads_into_the_port(tmp_path):
    path = tmp_path / "jax_batch.npz"
    head, tail = _vm_inputs(4, 10, 15), _vm_inputs(4, 10, 16)
    jx = _jax_batch()
    jx.run_ticks(jnp.asarray(head))
    jx.save_checkpoint(str(path))
    jx.run_ticks(jnp.asarray(tail))
    port = _port_batch()
    port.load_checkpoint(path)
    assert port.run_ticks(tail)["mismatches"] == 0
    _assert_trees_equal(to_numpy(port.carry), jax.device_get(jx._carry))


def test_port_batch_checkpoint_loads_into_jax(tmp_path):
    path = tmp_path / "port_batch.npz"
    head, tail = _vm_inputs(4, 10, 17), _vm_inputs(4, 10, 18)
    port = _port_batch()
    port.run_ticks(head)
    port.save_checkpoint(path)
    port.run_ticks(tail)
    jx = _jax_batch()
    jx.load_checkpoint(str(path))
    assert jx.current_frame == 10
    assert jx.run_ticks(jnp.asarray(tail))["mismatches"] == 0
    _assert_trees_equal(to_numpy(port.carry), jax.device_get(jx._carry))


def test_files_hold_digest_leaves_as_uint32(tmp_path):
    path = tmp_path / "f.npz"
    port = _port_session()
    port.run_ticks(_box_inputs(5, 19))
    port.save_checkpoint(path)
    jpath = tmp_path / "j.npz"
    jx = _jax_session()
    jx.run_ticks(_box_inputs(5, 19))
    jx.save_checkpoint(str(jpath))
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__meta__":
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k])
        assert str(a["__meta__"][()]) == str(b["__meta__"][()])
        assert sum(a[k].dtype == np.uint32 for k in a.files) == 2  # hist, ring checksums


# -- dumps / loads -----------------------------------------------------------------


def test_dumps_loads_round_trip():
    port = _port_batch()
    port.run_ticks(_vm_inputs(4, 7, 20))
    blob = tckpt.dumps_pytree(port.carry, {"ticks_run": 7})
    tree, meta = tckpt.loads_pytree(blob, port.carry)
    assert meta == {"ticks_run": 7}
    _assert_trees_equal(tree, to_numpy(port.carry))


def test_dumps_loads_cross_packages():
    port = _port_batch()
    port.run_ticks(_vm_inputs(4, 7, 21))
    jx = _jax_batch()
    jx.run_ticks(jnp.asarray(_vm_inputs(4, 7, 21)))
    from_port, _ = jckpt.loads_pytree(tckpt.dumps_pytree(port.carry, {}), jx._carry)
    from_jax, _ = tckpt.loads_pytree(jckpt.dumps_pytree(jx._carry, {}), port.carry)
    _assert_trees_equal(tree_leaves(from_jax), jax.device_get(from_port))
    _assert_trees_equal(to_numpy(port.carry), jax.device_get(jx._carry))


# -- wrong files are refused --------------------------------------------------------


def test_wrong_check_distance_rejected(tmp_path):
    path = tmp_path / "sess.npz"
    a = _port_session(d=3)
    a.run_ticks(_box_inputs(8, 3))
    a.save_checkpoint(path)
    with pytest.raises(ValueError, match="session expects"):
        DeviceSyncTestSession(BoxGame(2).advance, BoxGame(2).init_state_np(),
                              np.zeros(2, np.uint8), check_distance=3, max_prediction=9,
                              device="cpu").load_checkpoint(path)  # ring 10: leaf shapes differ
    # same ring length, other check_distance: the meta check fires
    with pytest.raises(InvalidRequest, match="check_distance=3, session uses 2"):
        _port_session(d=2).load_checkpoint(path)


def test_wrong_batch_size_rejected(tmp_path):
    path = tmp_path / "batch.npz"
    _port_batch(b=4).save_checkpoint(path)
    with pytest.raises((InvalidRequest, ValueError)):
        _port_batch(b=2).load_checkpoint(path)


def test_wrong_game_or_leaf_count_rejected(tmp_path):
    path = tmp_path / "boxgame.npz"
    _port_session().save_checkpoint(path)
    vm = ChipVM(2)  # three state leaves too, of other shapes and dtypes
    other = DeviceSyncTestSession(vm.advance, vm.init_state_np(), np.zeros(2, np.uint8),
                                  check_distance=2, device="cpu")
    with pytest.raises(ValueError, match="session expects uint8"):
        other.load_checkpoint(path)
    with pytest.raises(ValueError, match="holds 1 leaves, template expects 2"):
        tckpt.loads_pytree(tckpt.dumps_pytree({"a": np.zeros(2)}, {}), {"a": 0, "b": 0})
    with pytest.raises(ValueError, match="holds 1 leaves, session expects 2"):
        tckpt.save_pytree(tmp_path / "one", {"a": np.zeros(2)}, {})
        tckpt.load_pytree(tmp_path / "one", {"a": 0, "b": 0})


def test_meta_mismatch_raises_as_jax_does(tmp_path):
    path = tmp_path / "sess.npz"
    port = _port_session(d=2)
    port.save_checkpoint(path)
    jx = JaxSession(JaxBoxGame(2).advance, JaxBoxGame(2).init_state(),
                    jnp.zeros((2,), jnp.uint8), check_distance=1, max_prediction=8)
    with pytest.raises(JaxInvalidRequest) as je:
        jx.load_checkpoint(str(path))
    tx = DeviceSyncTestSession(BoxGame(2).advance, BoxGame(2).init_state_np(),
                               np.zeros(2, np.uint8), check_distance=1, device="cpu")
    with pytest.raises(InvalidRequest) as te:
        tx.load_checkpoint(path)
    assert str(te.value) == str(je.value)


def test_uint32_file_leaf_needs_an_int32_template():
    blob = tckpt.dumps_pytree({"hist": np.arange(4, dtype=np.uint32)}, {})
    tree, _ = tckpt.loads_pytree(blob, {"hist": np.zeros(4, np.int32)})
    assert tree["hist"].dtype == np.uint32
    with pytest.raises(ValueError, match="template expects"):
        tckpt.loads_pytree(blob, {"hist": np.zeros(4, np.int16)})
    with pytest.raises(ValueError, match="template expects"):
        tckpt.loads_pytree(blob, {"hist": np.zeros(5, np.int32)})
