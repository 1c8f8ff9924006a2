"""The functional layer library (votenet_tpu/models/layers.py): variable
tree layout, Dense, BatchNorm train/eval and running statistics, remat."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from votenet_tpu.models.layers import BatchNorm, Dense, Module, relu, remat


class Stack(Module):
    width: int
    momentum: float = 0.9

    def __call__(self, x, train: bool):
        x = Dense(self.width, name="dense0")(x)
        x = BatchNorm(use_running_average=not train, momentum=self.momentum,
                      epsilon=1e-5, name="bn0")(x)
        return Dense(2, name="dense1")(relu(x))


class Outer(Module):
    use_remat: bool = False

    def __call__(self, x, train: bool):
        cls = remat(Stack, static_argnums=(1,)) if self.use_remat else Stack
        return cls(8, name="inner")(x, train)


def _x(rng, shape=(4, 6, 5)):
    return jnp.asarray(rng.randn(*shape).astype(np.float32))


class TestVariables:
    def test_param_tree_layout(self, rng):
        v = Stack(8).init(jax.random.PRNGKey(0), _x(rng), train=False)
        assert set(v) == {"params", "batch_stats"}
        p = v["params"]
        assert set(p) == {"dense0", "bn0", "dense1"}
        assert p["dense0"]["kernel"].shape == (5, 8) and p["dense0"]["bias"].shape == (8,)
        assert set(p["bn0"]) == {"scale", "bias"}
        assert set(v["batch_stats"]["bn0"]) == {"mean", "var"}
        np.testing.assert_array_equal(v["batch_stats"]["bn0"]["mean"], 0.0)
        np.testing.assert_array_equal(v["batch_stats"]["bn0"]["var"], 1.0)

    def test_votenet_tree_names(self, rng):
        from votenet_tpu.config import tiny_config
        from votenet_tpu.models.votenet import VoteNet

        cfg = tiny_config()
        pts = jnp.asarray(rng.uniform(-3, 3, (1, cfg.point_num, 3)), jnp.float32)
        v = VoteNet(cfg).init(jax.random.PRNGKey(0), pts, train=False)
        assert list(v["params"]) == [
            "sa1", "sa2", "sa3", "sa4", "fp1", "fp2", "voting", "proposal"
        ]
        assert set(v["params"]["proposal"]) == {"mlp", "mlp2"}
        assert set(v["params"]["voting"]) == {
            "voting0", "voting0_bn", "voting1", "voting1_bn", "voting2"
        }
        assert v["params"]["sa1"]["mlp"]["dense0"]["kernel"].shape == (6, 16)

    def test_init_depends_on_path_only(self, rng):
        a = Stack(8).init(jax.random.PRNGKey(0), _x(rng), train=False)
        b = Outer().init(jax.random.PRNGKey(0), _x(rng), train=False)["params"]["inner"]
        assert not np.array_equal(a["params"]["dense0"]["kernel"], b["dense0"]["kernel"])
        c = Stack(8).init(jax.random.PRNGKey(0), _x(rng), train=False)
        np.testing.assert_array_equal(a["params"]["dense0"]["kernel"], c["params"]["dense0"]["kernel"])

    def test_init_keys_follow_the_flax_scheme(self):
        """Seeds reproduce the weights of the earlier flax.linen model: the
        first row of a Dense kernel named "d0" under init key 0 (flax's
        lecun_normal values [0.5508253, 0.11111576, -0.14312194], times
        sqrt(2) for He scaling)."""

        class Outer(Module):
            def __call__(self, x):
                return Dense(3, name="d0")(x)

        v = Outer().init(jax.random.PRNGKey(0), jnp.ones((2, 4)))
        want = np.array([0.5508253, 0.11111576, -0.14312194]) * np.sqrt(2.0)
        np.testing.assert_allclose(v["params"]["d0"]["kernel"][0], want, rtol=1e-5)

    def test_he_normal_kernel_scale(self):
        v = Dense(256, name="d").init(jax.random.PRNGKey(0), jnp.zeros((1, 512)))
        k = np.asarray(v["params"]["kernel"])
        assert abs(k.std() - np.sqrt(2.0 / 512)) < 0.1 * np.sqrt(2.0 / 512)
        np.testing.assert_array_equal(v["params"]["bias"], 0.0)

    def test_missing_param_raises(self, rng):
        with pytest.raises(KeyError, match="dense0"):
            Stack(8).apply({"params": {}, "batch_stats": {}}, _x(rng), train=False)

    def test_unnamed_submodule_raises(self, rng):
        class Bad(Module):
            def __call__(self, x):
                return Dense(3)(x)

        with pytest.raises(ValueError, match="needs a name"):
            Bad().init(jax.random.PRNGKey(0), _x(rng))


class TestDense:
    def test_matches_matmul(self, rng):
        x = _x(rng)
        v = Dense(3, name="d").init(jax.random.PRNGKey(1), x)
        got = Dense(3).apply(v, x)
        want = np.asarray(x) @ np.asarray(v["params"]["kernel"]) + np.asarray(v["params"]["bias"])
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)

    def test_dtype_casts_compute(self, rng):
        x = _x(rng)
        v = Dense(3).init(jax.random.PRNGKey(1), x)
        assert Dense(3, dtype=jnp.bfloat16).apply(v, x).dtype == jnp.bfloat16


class TestBatchNorm:
    def _vars(self, x, momentum=0.9):
        return BatchNorm(use_running_average=False, momentum=momentum).init(
            jax.random.PRNGKey(0), x
        )

    def test_train_mode_normalises_with_batch_stats(self, rng):
        x = _x(rng) * 3.0 + 1.5
        v = self._vars(x)
        y, _ = BatchNorm(use_running_average=False).apply(v, x, mutable=["batch_stats"])
        y = np.asarray(y).reshape(-1, 5)
        np.testing.assert_allclose(y.mean(0), 0.0, atol=1e-5)
        np.testing.assert_allclose(y.var(0), 1.0, rtol=1e-3)

    def test_running_stat_update(self, rng):
        x = _x(rng) * 2.0 + 0.5
        v = self._vars(x, momentum=0.9)
        _, new = BatchNorm(use_running_average=False, momentum=0.9).apply(
            v, x, mutable=["batch_stats"]
        )
        flat = np.asarray(x, np.float64).reshape(-1, 5)
        np.testing.assert_allclose(new["batch_stats"]["mean"], 0.1 * flat.mean(0), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            new["batch_stats"]["var"], 0.9 + 0.1 * flat.var(0), rtol=1e-5
        )

    def test_eval_mode_uses_running_stats(self, rng):
        x = _x(rng)
        v = self._vars(x)
        v = {"params": v["params"], "batch_stats": {
            "mean": jnp.full((5,), 2.0), "var": jnp.full((5,), 4.0)}}
        y = BatchNorm(use_running_average=True, epsilon=0.0).apply(v, x)
        np.testing.assert_allclose(np.asarray(y), (np.asarray(x) - 2.0) / 2.0, rtol=1e-6)

    def test_init_leaves_running_stats(self, rng):
        v = self._vars(_x(rng) + 5.0)
        np.testing.assert_array_equal(v["batch_stats"]["mean"], 0.0)

    def test_train_without_mutable_raises(self, rng):
        x = _x(rng)
        with pytest.raises(ValueError, match="immutable"):
            BatchNorm(use_running_average=False).apply(self._vars(x), x)


class TestRemat:
    def test_forward_and_grads_equal(self, rng):
        x = _x(rng)
        v = Outer().init(jax.random.PRNGKey(0), x, train=False)

        def loss(params, use_remat):
            out, new = Outer(use_remat=use_remat).apply(
                {"params": params, "batch_stats": v["batch_stats"]}, x, True,
                mutable=["batch_stats"],
            )
            return jnp.sum(out ** 2), new

        (l0, s0), g0 = jax.value_and_grad(loss, has_aux=True)(v["params"], False)
        (l1, s1), g1 = jax.value_and_grad(loss, has_aux=True)(v["params"], True)
        np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves((g0, s0)), jax.tree_util.tree_leaves((g1, s1))):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5)
