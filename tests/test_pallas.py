"""GPU kernel tests (Pallas-Triton kernels in interpret mode on the CPU,
compiled on a GPU under the ``chip`` marker) + IoU implementation
cross-validation."""

import numpy as np
import pytest

from tests import oracles

FPS_CASES = [
    (2, 128, 32),
    (3, 300, 64),     # N not a power of two: padded chunk
    (8, 512, 128),
    (1, 64, 1),       # npoint=1: only the seed
    (1, 2000, 300),
    (5, 1111, 97),    # odd N and npoint
    (1, 5000, 40),    # two chunks, the second partly padding
    (2, 70000, 8),    # more chunks than unroll: the device chunk loop
]


class TestPallasFPS:
    @pytest.mark.parametrize("B,N,m", FPS_CASES)
    def test_matches_oracle(self, rng, B, N, m):
        from votenet_tpu.ops.pallas.fps import farthest_point_sample_gpu

        xyz = rng.randn(B, N, 3).astype(np.float32)
        got = np.asarray(farthest_point_sample_gpu(m, xyz, True))
        np.testing.assert_array_equal(got, oracles.fps_oracle(m, xyz))

    def test_matches_xla_twin(self, rng):
        from votenet_tpu.ops.pallas.fps import farthest_point_sample_gpu
        from votenet_tpu.ops.sampling import farthest_point_sample_xla

        xyz = rng.randn(4, 400, 3).astype(np.float32)
        a = np.asarray(farthest_point_sample_gpu(96, xyz, True))
        b = np.asarray(farthest_point_sample_xla(96, xyz))
        np.testing.assert_array_equal(a, b)

    def test_ties_pick_lowest_index(self):
        """Duplicate points give equal distances: the lowest index wins,
        as in the reference's strictly-greater scan."""
        from votenet_tpu.ops.pallas.fps import farthest_point_sample_gpu

        base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        got = np.asarray(farthest_point_sample_gpu(3, base[None], True))
        np.testing.assert_array_equal(got, oracles.fps_oracle(3, base[None]))
        np.testing.assert_array_equal(got, [[0, 1, 2]])

    @pytest.mark.parametrize("n,chunk", [(1, 16), (64, 64), (300, 512), (20480, 4096)])
    def test_chunk_width(self, n, chunk):
        from votenet_tpu.ops.pallas.fps import fps_chunk

        assert fps_chunk(n) == chunk

    def test_compiled_matches_oracle(self, chip, rng):
        from votenet_tpu.ops.pallas.fps import farthest_point_sample_gpu

        xyz = rng.randn(2, 20480, 3).astype(np.float32)
        got = np.asarray(farthest_point_sample_gpu(256, xyz))
        np.testing.assert_array_equal(got, oracles.fps_oracle(256, xyz))


class TestIoUImplementations:
    def test_four_formulations_agree(self, rng):
        """rank vs angular-sort vs Sutherland–Hodgman vs edge-clip agree."""
        import jax.numpy as jnp

        from votenet_tpu.ops.iou3d import (
            convex_quad_intersection_area,
            convex_quad_intersection_area_edgeclip,
            convex_quad_intersection_area_sh,
            convex_quad_intersection_area_sort,
        )

        boxes1 = oracles.random_boxes(rng, (64,))
        boxes2 = oracles.random_boxes(rng, (64,))
        q1 = jnp.stack([boxes1[:, :4, 0], boxes1[:, :4, 2]], axis=-1)
        q2 = jnp.stack([boxes2[:, :4, 0], boxes2[:, :4, 2]], axis=-1)
        a = np.asarray(convex_quad_intersection_area(q1, q2))
        b = np.asarray(convex_quad_intersection_area_sort(q1, q2))
        c = np.asarray(convex_quad_intersection_area_sh(q1, q2))
        d = np.asarray(convex_quad_intersection_area_edgeclip(q1, q2))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a, d, rtol=1e-4, atol=1e-5)

    def test_edgeclip_containment_and_degenerate(self):
        import jax.numpy as jnp

        from votenet_tpu.ops.iou3d import convex_quad_intersection_area_edgeclip

        big = jnp.asarray([[-2, -2], [2, -2], [2, 2], [-2, 2]], jnp.float32)
        small = jnp.asarray([[-1, -1], [1, -1], [1, 1], [-1, 1]], jnp.float32)
        assert float(
            convex_quad_intersection_area_edgeclip(small, big)
        ) == pytest.approx(4.0, rel=1e-5)
        assert float(
            convex_quad_intersection_area_edgeclip(big, small)
        ) == pytest.approx(4.0, rel=1e-5)
        # zero-area (collinear) quad has no interior: clamp keeps inter at 0
        line = jnp.asarray([[0, 0], [1, 0], [2, 0], [3, 0]], jnp.float32)
        assert float(convex_quad_intersection_area_edgeclip(line, big)) == 0.0
        # disjoint
        assert float(convex_quad_intersection_area_edgeclip(big, big + 10.0)) == 0.0

    def test_contained_quad(self):
        import jax.numpy as jnp

        from votenet_tpu.ops.iou3d import convex_quad_intersection_area

        big = jnp.asarray([[-2, -2], [2, -2], [2, 2], [-2, 2]], jnp.float32)
        small = jnp.asarray([[-1, -1], [1, -1], [1, 1], [-1, 1]], jnp.float32)
        got = float(convex_quad_intersection_area(small, big))
        assert got == pytest.approx(4.0, rel=1e-5)
        got2 = float(convex_quad_intersection_area(big, small))
        assert got2 == pytest.approx(4.0, rel=1e-5)

    def test_disjoint(self):
        import jax.numpy as jnp

        from votenet_tpu.ops.iou3d import convex_quad_intersection_area

        a = jnp.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], jnp.float32)
        b = a + 5.0
        assert float(convex_quad_intersection_area(a, b)) == 0.0


class TestPallasBallQuery:
    """ops/pallas/ballquery.py vs the numpy oracle (interpret mode on CPU;
    chip_smoke.py checks the compiled kernel at the live shapes)."""

    def _clouds(self, rng, B, N, M):
        # clustered clouds: the adversarial case for selection semantics
        centers = rng.randn(B, 8, 3).astype(np.float32)
        pts = centers[:, rng.randint(0, 8, N)] + rng.randn(B, N, 3).astype(
            np.float32
        ) * 0.15
        q = pts[:, rng.choice(N, M, replace=False)]
        return pts, q

    @pytest.mark.parametrize(
        "B,N,M,S,r",
        [
            (2, 512, 128, 8, 0.3),
            (1, 300, 70, 16, 0.5),   # unaligned N/M (padding paths)
            (2, 1024, 256, 64, 0.2),
            (1, 129, 1, 4, 0.4),     # one query; N one past a chunk
            (1, 2000, 40, 64, 1.5),  # every ball saturates: early exit
        ],
    )
    def test_matches_oracle(self, rng, B, N, M, S, r):
        from votenet_tpu.ops.pallas.ballquery import query_ball_point_gpu

        pts, q = self._clouds(rng, B, N, M)
        ia, ca = query_ball_point_gpu(r, S, pts, q, True)
        ib, cb = oracles.query_ball_oracle(r, S, pts, q)
        np.testing.assert_array_equal(np.asarray(ia), ib)
        np.testing.assert_array_equal(np.asarray(ca), cb)

    def test_empty_and_saturated_balls(self, rng):
        from votenet_tpu.ops.pallas.ballquery import query_ball_point_gpu

        # one dense blob + far-away queries: rows saturate AND rows are empty
        pts = rng.randn(1, 256, 3).astype(np.float32) * 0.05
        q = np.concatenate(
            [np.zeros((1, 4, 3), np.float32), np.full((1, 4, 3), 50.0, np.float32)],
            axis=1,
        )
        ia, ca = query_ball_point_gpu(0.5, 8, pts, q, True)
        ib, cb = oracles.query_ball_oracle(0.5, 8, pts, q)
        np.testing.assert_array_equal(np.asarray(ia), ib)
        np.testing.assert_array_equal(np.asarray(ca), cb)
        assert np.asarray(ca)[0, :4].max() == 8  # saturated
        assert np.asarray(ca)[0, 4:].max() == 0  # empty -> index 0 rows
        assert np.asarray(ia)[0, 4:].max() == 0

    def test_vectorised_oracle_matches_loop_oracle(self, rng):
        pts, q = self._clouds(rng, 2, 300, 70)
        q[:, :3] = 50.0  # empty balls too
        a = oracles.query_ball_oracle(0.4, 16, pts, q)
        b = oracles.query_ball_oracle_vec(0.4, 16, pts, q, block=32)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])

    @pytest.mark.parametrize("r", [0.2, 0.3, 0.4, 0.8, 1.2])
    def test_radius_threshold_is_the_sqrt_test(self, r):
        """d2 < radius_sq_threshold(r) exactly when max(sqrt(d2), 1e-20) < r
        in f32, for every d2 within 64 ulps of r*r."""
        from votenet_tpu.ops.common import radius_sq_threshold

        t = np.float32(radius_sq_threshold(r))
        r32 = np.float32(r)
        base = np.array([r32 * r32], np.float32).view(np.int32)[0]
        d2 = (base + np.arange(-64, 65, dtype=np.int32)).view(np.float32)
        want = np.maximum(np.sqrt(d2), np.float32(1e-20)) < r32
        np.testing.assert_array_equal(d2 < t, want)

    def test_compiled_matches_oracle(self, chip, rng):
        from votenet_tpu.ops.pallas.ballquery import query_ball_point_gpu

        pts, q = self._clouds(rng, 2, 20480, 256)
        ia, ca = query_ball_point_gpu(0.2, 64, pts, q)
        ib, cb = oracles.query_ball_oracle_vec(0.2, 64, pts, q)
        np.testing.assert_array_equal(np.asarray(ia), ib)
        np.testing.assert_array_equal(np.asarray(ca), cb)
