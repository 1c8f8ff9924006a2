"""Point-count scaling: streaming ball query vs the dense twin.

SURVEY §5 names point count as this model's "long-context" axis; the
streaming query is the O(B*M*block)-memory path for N >> 20480. Its results
must be EXACTLY equal to the dense hierarchical query (same first-k-in-index-
order, fill-with-first-hit and saturated-count semantics)."""

import jax.numpy as jnp
import numpy as np
import pytest

from votenet_tpu.ops import query_ball_point, query_ball_point_streaming


def _dense(radius, nsample, xyz1, xyz2):
    idx, cnt = query_ball_point(radius, nsample, jnp.asarray(xyz1), jnp.asarray(xyz2))
    return np.asarray(idx), np.asarray(cnt)


def _stream(radius, nsample, xyz1, xyz2, block):
    idx, cnt = query_ball_point_streaming(
        radius, nsample, jnp.asarray(xyz1), jnp.asarray(xyz2), block
    )
    return np.asarray(idx), np.asarray(cnt)


class TestStreamingBallQuery:
    @pytest.mark.parametrize("block", [128, 256, 1024])
    def test_matches_dense(self, rng, block):
        xyz1 = rng.uniform(-3, 3, (2, 1024, 3)).astype(np.float32)
        xyz2 = rng.uniform(-3, 3, (2, 64, 3)).astype(np.float32)
        di, dc = _dense(0.8, 16, xyz1, xyz2)
        si, sc = _stream(0.8, 16, xyz1, xyz2, block)
        np.testing.assert_array_equal(sc, dc)
        np.testing.assert_array_equal(si, di)

    def test_block_not_dividing_n(self, rng):
        xyz1 = rng.uniform(-3, 3, (1, 1000, 3)).astype(np.float32)
        xyz2 = xyz1[:, :32]
        di, dc = _dense(0.5, 8, xyz1, xyz2)
        si, sc = _stream(0.5, 8, xyz1, xyz2, 384)
        np.testing.assert_array_equal(sc, dc)
        np.testing.assert_array_equal(si, di)

    def test_overfull_balls_cross_block_boundary(self, rng):
        # one dense cluster spanning several blocks: > nsample hits per query
        cluster = rng.uniform(-0.05, 0.05, (1, 512, 3)).astype(np.float32)
        xyz2 = cluster[:, :8]
        di, dc = _dense(0.3, 16, cluster, xyz2)
        si, sc = _stream(0.3, 16, cluster, xyz2, 128)
        assert (dc == 16).all()  # saturated counts
        np.testing.assert_array_equal(sc, dc)
        np.testing.assert_array_equal(si, di)

    def test_empty_and_underfull_balls(self, rng):
        xyz1 = rng.uniform(-3, 3, (1, 256, 3)).astype(np.float32)
        far = np.full((1, 4, 3), 50.0, np.float32)  # empty balls
        xyz2 = np.concatenate([xyz1[:, :4], far], axis=1)
        di, dc = _dense(0.4, 8, xyz1, xyz2)
        si, sc = _stream(0.4, 8, xyz1, xyz2, 64)
        assert (sc[:, 4:] == 0).all()
        np.testing.assert_array_equal(sc, dc)
        np.testing.assert_array_equal(si, di)

    @pytest.mark.slow
    def test_large_n(self, rng):
        # N = 4x the model default; dense twin still fits on CPU for checking
        xyz1 = rng.uniform(-4, 4, (1, 81920, 3)).astype(np.float32)
        xyz2 = xyz1[:, :128]
        di, dc = _dense(0.2, 32, xyz1, xyz2)
        si, sc = _stream(0.2, 32, xyz1, xyz2, 8192)
        np.testing.assert_array_equal(sc, dc)
        np.testing.assert_array_equal(si, di)


class TestStreamingThreeNN:
    @pytest.mark.parametrize("block", [128, 384, 1024])
    def test_matches_dense(self, rng, block):
        from votenet_tpu.ops import three_nn_dense, three_nn_streaming

        xyz1 = rng.uniform(-3, 3, (2, 1000, 3)).astype(np.float32)
        xyz2 = rng.uniform(-3, 3, (2, 64, 3)).astype(np.float32)
        dd, di = three_nn_dense(jnp.asarray(xyz1), jnp.asarray(xyz2))
        sd, si = three_nn_streaming(jnp.asarray(xyz1), jnp.asarray(xyz2), block)
        np.testing.assert_array_equal(np.asarray(si), np.asarray(di))
        np.testing.assert_array_equal(np.asarray(sd), np.asarray(dd))

    def test_duplicate_source_ties(self, rng):
        # equal-distance neighbors must come out in index order in every slab
        from votenet_tpu.ops import three_nn_dense, three_nn_streaming

        xyz2 = np.repeat(rng.uniform(-1, 1, (1, 8, 3)), 3, axis=1).astype(np.float32)
        xyz1 = rng.uniform(-1, 1, (1, 300, 3)).astype(np.float32)
        dd, di = three_nn_dense(jnp.asarray(xyz1), jnp.asarray(xyz2))
        sd, si = three_nn_streaming(jnp.asarray(xyz1), jnp.asarray(xyz2), 128)
        np.testing.assert_array_equal(np.asarray(si), np.asarray(di))
        np.testing.assert_array_equal(np.asarray(sd), np.asarray(dd))


class TestLargeNDispatch:
    def test_ball_query_routes_streaming(self, rng, monkeypatch):
        import votenet_tpu.ops.grouping as G

        xyz1 = rng.uniform(-3, 3, (1, 700, 3)).astype(np.float32)
        xyz2 = xyz1[:, :16]
        di, dc = G.query_ball_point_dense(0.5, 8, jnp.asarray(xyz1), jnp.asarray(xyz2))
        # shrink the byte budget below this shape's dense footprint
        monkeypatch.setattr(G.common, "dense_bytes_budget", lambda: 1 * 16 * 512 * 6)
        streamed = []
        orig = G.query_ball_point_streaming
        monkeypatch.setattr(
            G, "query_ball_point_streaming",
            lambda *a: streamed.append(1) or orig(*a),
        )
        si, sc = G.query_ball_point(0.5, 8, jnp.asarray(xyz1), jnp.asarray(xyz2))
        assert streamed
        np.testing.assert_array_equal(np.asarray(si), np.asarray(di))
        np.testing.assert_array_equal(np.asarray(sc), np.asarray(dc))

    def test_three_nn_routes_streaming(self, rng, monkeypatch):
        import votenet_tpu.ops.interpolate as I

        xyz1 = rng.uniform(-3, 3, (1, 700, 3)).astype(np.float32)
        xyz2 = rng.uniform(-3, 3, (1, 32, 3)).astype(np.float32)
        dd, di = I.three_nn_dense(jnp.asarray(xyz1), jnp.asarray(xyz2))
        # shrink the byte budget below this shape's dense footprint
        monkeypatch.setattr(I.common, "dense_bytes_budget", lambda: 1 * 512 * 32 * 4)
        sd, si = I.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2))
        np.testing.assert_array_equal(np.asarray(si), np.asarray(di))
        np.testing.assert_array_equal(np.asarray(sd), np.asarray(dd))
