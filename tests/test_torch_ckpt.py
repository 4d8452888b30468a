"""The port's checkpoints on the CPU: the counterparts of
``test_checkpoint.py`` (round trip, atomic publish, GC, resume,
restore-or-init, a CG state), and checkpoints crossing between the
packages in both directions with their values in the right leaves
(dicts by sorted key, ``None`` an empty subtree, as JAX flattens)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro_torch.ckpt.checkpoint import (
    CheckpointManager,
    latest_step,
    restore,
    save,
)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.normal(size=(8, 8)).astype(np.float32),
                   "b": np.zeros((8,), np.float32)},
        "opt": {"m": torch.ones((8, 8)), "count": np.int32(7)},
    }


def test_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 10, t)
    r = restore(str(tmp_path), 10, _tree(99))
    np.testing.assert_array_equal(r["params"]["w"], t["params"]["w"])
    np.testing.assert_array_equal(r["params"]["b"], t["params"]["b"])
    np.testing.assert_array_equal(r["opt"]["m"], t["opt"]["m"].numpy())
    assert r["opt"]["count"] == 7
    on = restore(str(tmp_path), 10, _tree(99), device="cpu")
    assert isinstance(on["opt"]["m"], torch.Tensor)
    assert torch.equal(on["opt"]["m"], t["opt"]["m"])


def test_atomic_publish_no_tmp_visible(tmp_path):
    save(str(tmp_path), 3, _tree())
    entries = os.listdir(tmp_path)
    assert not any(e.endswith(".tmp") for e in entries)
    assert latest_step(str(tmp_path)) == 3
    assert latest_step(str(tmp_path / "absent")) is None


def test_gc_keeps_last_k(tmp_path):
    for s in range(6):
        save(str(tmp_path), s, _tree(), keep=2)
    steps = sorted(os.listdir(tmp_path))
    assert len(steps) == 2 and steps[-1] == "step_000000005"


def test_manager_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=2)
    state = _tree(1)
    assert not mgr.maybe_save(1, state)
    assert mgr.maybe_save(2, state)
    restored, step = mgr.restore_or_init(lambda: _tree(99))
    assert step == 2
    np.testing.assert_array_equal(restored["params"]["w"],
                                  state["params"]["w"])


def test_restore_or_init_fresh(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1)
    state, step = mgr.restore_or_init(lambda: _tree(5))
    assert step == 0
    assert state["opt"]["count"] == 7


def test_solver_state_roundtrip_and_shape_guard(tmp_path):
    """CG state (x, r, p, iteration) resumes mid-solve; a restore into
    another shape is an error."""
    cg_state = {
        "x": torch.ones((16, 4)), "r": torch.full((16, 4), 0.5),
        "p": torch.zeros((16, 4)), "iter": np.int32(12),
    }
    save(str(tmp_path), 12, cg_state)
    r = restore(str(tmp_path), 12, cg_state)
    assert int(r["iter"]) == 12
    np.testing.assert_array_equal(r["r"], np.full((16, 4), 0.5, np.float32))
    with pytest.raises(ValueError, match="leaf"):
        restore(str(tmp_path), 12, dict(cg_state, x=np.zeros((15, 4))))


# a tree whose leaf order depends on the flattening rules: keys out of
# insertion order, a None subtree, a tuple and a list
def _mixed(seed):
    rng = np.random.default_rng(seed)
    return {
        "zeta": rng.normal(size=(3,)).astype(np.float32),
        "alpha": (np.arange(4, dtype=np.int32), None,
                  [rng.normal(size=(2, 2)).astype(np.float32), np.uint8(5)]),
        "mid": {"y": np.float32(2.5), "b": None,
                "a": np.zeros((0, 2), np.float32)},
    }


def _jax_like(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _mixed(1)
    save(str(tmp_path), 4, tree)
    got = jckpt.restore(str(tmp_path), 4,
                        jax.eval_shape(lambda: _jax_like(_mixed(2))))
    assert jax.tree.structure(got) == jax.tree.structure(_jax_like(tree))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _mixed(3)
    jckpt.save(str(tmp_path), 9, _jax_like(tree))
    assert latest_step(str(tmp_path)) == 9
    got = restore(str(tmp_path), 9, _mixed(4))
    np.testing.assert_array_equal(got["zeta"], tree["zeta"])
    np.testing.assert_array_equal(got["alpha"][0], tree["alpha"][0])
    assert got["alpha"][1] is None and isinstance(got["alpha"], tuple)
    np.testing.assert_array_equal(got["alpha"][2][0], tree["alpha"][2][0])
    assert got["alpha"][2][1] == 5 and isinstance(got["alpha"][2], list)
    assert got["mid"]["y"] == np.float32(2.5) and got["mid"]["b"] is None
    assert got["mid"]["a"].shape == (0, 2)
    # the stream driver's resume manifest, written by the reference
    manifest = {"done": np.array([1, 0, 1], np.uint8),
                "failed": np.array([0, 1, 0], np.uint8),
                "res": np.arange(12, dtype=np.float32).reshape(2, 6),
                "y_slab": np.asarray(2, np.int64)}
    jckpt.save(str(tmp_path / "m"), 2, _jax_like(manifest))
    like = {k: np.zeros_like(v) for k, v in manifest.items()}
    back = restore(str(tmp_path / "m"), 2, like)
    for k, v in manifest.items():
        np.testing.assert_array_equal(back[k], v)
