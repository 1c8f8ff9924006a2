"""Checkpoints (votenet_tpu/utils/checkpoint.py): np.savez of key paths,
atomic publish, pruning and restore into a template."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from votenet_tpu.utils import checkpoint as ckpt


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "step": 0,
        "params": {"a": {"kernel": jnp.asarray(rng.randn(3, 4), jnp.float32)},
                   "b": jnp.asarray(rng.randn(5), jnp.bfloat16)},
        "opt": (jnp.asarray(rng.randint(0, 9, (2,)), jnp.int32),),
    }


class TestCheckpoint:
    def test_roundtrip_bit_equal(self, tmp_path):
        state = _state(0)
        state["step"] = 7
        ckpt.save_checkpoint(str(tmp_path), state, 3)
        restored, step = ckpt.restore_checkpoint(str(tmp_path), _state(1))
        assert step == 3 and restored["step"] == 7 and isinstance(restored["step"], int)
        for a, b in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(restored)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert isinstance(restored["params"]["b"], jax.Array)

    def test_train_state_roundtrip(self, tmp_path):
        from votenet_tpu.config import tiny_config
        from votenet_tpu.train.state import create_train_state

        cfg = tiny_config()
        state = create_train_state(jax.random.PRNGKey(0), cfg, 2)
        grads = jax.tree_util.tree_map(jnp.ones_like, state.params)
        state = state.apply_gradients(grads=grads)
        ckpt.save_checkpoint(str(tmp_path), state, 1)
        template = create_train_state(jax.random.PRNGKey(5), cfg, 2)
        restored, _ = ckpt.restore_checkpoint(str(tmp_path), template)
        assert int(restored.step) == 1
        for a, b in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(restored)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_prune_keeps_latest(self, tmp_path):
        for s in range(1, 6):
            ckpt.save_checkpoint(str(tmp_path), _state(s), s, keep=2)
        assert sorted(ckpt.all_checkpoint_steps(str(tmp_path))) == [4, 5]
        assert ckpt.latest_checkpoint_step(str(tmp_path)) == 5
        assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]

    def test_nothing_to_resume(self, tmp_path):
        target = _state(0)
        got, step = ckpt.restore_checkpoint(str(tmp_path / "absent"), target)
        assert step is None and got is target

    def test_missing_leaf_raises(self, tmp_path):
        ckpt.save_checkpoint(str(tmp_path), {"params": {"a": jnp.zeros(2)}}, 1)
        with pytest.raises(KeyError, match="params"):
            ckpt.restore_checkpoint(str(tmp_path), {"params": {"z": jnp.zeros(2)}})

    def test_shape_mismatch_raises(self, tmp_path):
        ckpt.save_checkpoint(str(tmp_path), {"w": jnp.zeros(2)}, 1)
        with pytest.raises(ValueError, match="shape"):
            ckpt.restore_checkpoint(str(tmp_path), {"w": jnp.zeros(3)})
