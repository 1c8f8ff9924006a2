"""group_point and its gradient: XLA's gather and scatter-add.

The reference computes the gradient with atomicAdd (tf_grouping_g.cu:61-78);
here the VJP of the plain gather is XLA's scatter-add, checked against
``np.add.at`` at the shapes the kernels' tests used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import oracles
from votenet_tpu.ops.grouping import group_point

SHAPES = [
    (2, 20, 5, 7, 40),
    (1, 30, 13, 130, 64),   # 130 channels: one past a power of two
    (3, 8, 64, 3, 200),     # coordinate-only rows
    (2, 16, 8, 128, 48),
    (1, 64, 64, 259, 256),  # the fused [xyz || feat] width at sa2+
    (2, 10, 4, 6, 30),
]


def _add_at(g, idx, N):
    B, C = g.shape[0], g.shape[-1]
    want = np.zeros((B, N, C), np.float32)
    for b in range(B):
        np.add.at(want[b], idx[b].reshape(-1), g[b].reshape(-1, C))
    return want


class TestGroupPointGrad:
    @pytest.mark.parametrize("B,M,S,C,N", SHAPES)
    def test_grad_matches_numpy_add_at(self, rng, B, M, S, C, N):
        pts = jnp.asarray(rng.randn(B, N, C).astype(np.float32))
        idx = rng.randint(0, N, (B, M, S)).astype(np.int32)
        g = rng.randn(B, M, S, C).astype(np.float32)
        got = jax.grad(lambda p: jnp.vdot(group_point(p, jnp.asarray(idx)), g))(pts)
        np.testing.assert_allclose(np.asarray(got), _add_at(g, idx, N), rtol=1e-5, atol=1e-5)

    def test_duplicate_indices_accumulate(self):
        pts = jnp.zeros((1, 8, 4), jnp.float32)
        idx = jnp.zeros((1, 5, 2), jnp.int32)
        got = np.asarray(jax.grad(lambda p: group_point(p, idx).sum())(pts))
        np.testing.assert_allclose(got[0, 0], 10.0)
        np.testing.assert_allclose(got[0, 1:], 0.0)

    def test_forward_matches_oracle(self, rng):
        pts = rng.randn(2, 50, 6).astype(np.float32)
        idx = rng.randint(0, 50, (2, 10, 4)).astype(np.int32)
        np.testing.assert_array_equal(
            np.asarray(group_point(jnp.asarray(pts), jnp.asarray(idx))),
            oracles.group_point_oracle(pts, idx),
        )

    def test_grad_keeps_primal_dtype(self, rng):
        pts = jnp.asarray(rng.randn(1, 20, 4).astype(np.float32)).astype(jnp.bfloat16)
        idx = jnp.asarray(rng.randint(0, 20, (1, 5, 3)).astype(np.int32))
        g = jax.grad(lambda p: group_point(p, idx).astype(jnp.float32).sum())(pts)
        assert g.dtype == jnp.bfloat16

    def test_stop_gradient_columns_get_zero(self, rng):
        """The SA layers gather [stop_gradient(xyz) || feat]: the coordinate
        columns get no gradient, the features the exact scatter."""
        xyz = jnp.asarray(rng.randn(2, 50, 3).astype(np.float32))
        feat = jnp.asarray(rng.randn(2, 50, 6).astype(np.float32))
        idx = rng.randint(0, 50, (2, 10, 4)).astype(np.int32)
        g = rng.randn(2, 10, 4, 9).astype(np.float32)

        def f(x, p):
            both = jnp.concatenate([jax.lax.stop_gradient(x), p], axis=-1)
            return jnp.vdot(group_point(both, jnp.asarray(idx)), g)

        gx, gp = jax.grad(f, argnums=(0, 1))(xyz, feat)
        np.testing.assert_array_equal(np.asarray(gx), 0.0)
        np.testing.assert_allclose(
            np.asarray(gp), _add_at(g[..., 3:], idx, 50), rtol=1e-5, atol=1e-5
        )
