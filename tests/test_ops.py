"""Golden-value tests of the XLA ops against pure-numpy oracles."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from votenet_tpu import ops
from tests import oracles


class TestFPS:
    def test_matches_oracle(self, rng):
        xyz = rng.randn(2, 128, 3).astype(np.float32)
        got = np.asarray(ops.farthest_point_sample(32, xyz))
        want = oracles.fps_oracle(32, xyz)
        np.testing.assert_array_equal(got, want)

    def test_seed_is_zero(self, rng):
        xyz = rng.randn(3, 64, 3).astype(np.float32)
        got = np.asarray(ops.farthest_point_sample(16, xyz))
        assert (got[:, 0] == 0).all()

    def test_unique_indices(self, rng):
        xyz = rng.randn(1, 256, 3).astype(np.float32)
        got = np.asarray(ops.farthest_point_sample(64, xyz))[0]
        assert len(set(got.tolist())) == 64


class TestGatherPoint:
    def test_forward(self, rng):
        pts = rng.randn(2, 50, 3).astype(np.float32)
        idx = rng.randint(0, 50, (2, 10)).astype(np.int32)
        got = np.asarray(ops.gather_point(pts, idx))
        want = np.stack([pts[b][idx[b]] for b in range(2)])
        np.testing.assert_allclose(got, want)

    def test_gradient_is_scatter_add(self, rng):
        pts = rng.randn(1, 8, 3).astype(np.float32)
        idx = np.array([[1, 1, 3]], dtype=np.int32)  # duplicate index

        def f(p):
            return jnp.sum(ops.gather_point(p, idx))

        g = np.asarray(jax.grad(f)(pts))[0]
        want = np.zeros((8, 3))
        want[1] = 2.0  # two gathers accumulate
        want[3] = 1.0
        np.testing.assert_allclose(g, want)


class TestQueryBall:
    @pytest.mark.parametrize("radius,nsample", [(0.4, 8), (0.2, 4), (1.0, 16)])
    def test_matches_oracle(self, rng, radius, nsample):
        xyz1 = rng.randn(2, 64, 3).astype(np.float32)
        # query points drawn from the dataset (like the model: FPS-gathered)
        xyz2 = xyz1[:, :16].copy()
        got_idx, got_cnt = ops.query_ball_point(radius, nsample, xyz1, xyz2)
        want_idx, want_cnt = oracles.query_ball_oracle(radius, nsample, xyz1, xyz2)
        np.testing.assert_array_equal(np.asarray(got_cnt), want_cnt)
        np.testing.assert_array_equal(np.asarray(got_idx), want_idx)

    def test_self_always_hit(self, rng):
        xyz = rng.randn(1, 32, 3).astype(np.float32)
        idx, cnt = ops.query_ball_point(0.1, 4, xyz, xyz)
        assert (np.asarray(cnt) >= 1).all()
        # every query hits itself; first slot is the lowest-index hit <= self
        first = np.asarray(idx)[0, :, 0]
        assert (first <= np.arange(32)).all()


from votenet_tpu.ops.grouping import (
    query_ball_point_dense,
    query_ball_point_topk,
)


class TestQueryBallBoundary:
    """Pins the precision contract in ops/grouping.py: in the default
    "exact" mode the production query's mm-expansion distances (HIGHEST-
    precision cross-term) may flip membership only within a few-ulp band of
    the radius boundary; chip_smoke.py checks the GPU kernel and the XLA
    twin bit-equal to the oracle at every live shape. The opt-in
    "fast_bf16" mode has a much wider (cm-scale) band and is not exercised
    here."""

    RADIUS = 0.5

    def _constructed_cloud(self):
        # one query at a known offset origin plus points at controlled radii
        q = np.array([[0.37, -1.21, 2.83]], np.float32)  # awkward mantissas
        r = self.RADIUS
        # distances well inside, 4-ulp inside, exactly at, 4-ulp outside,
        # well outside (ulp measured at the r^2 = 0.25 scale)
        eps = 4 * np.spacing(np.float32(r * r)) / (2 * r)  # distance-space
        dists = [0.1, r - 5e-4, r - eps, r, r + eps, r + 5e-4, 1.0,
                 2.0, 3.0, 4.0]  # padding: clearly outside (N > nsample)
        dirs = np.array([
            [1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0],
            [0, -1, 0], [0, 0, -1], [0.6, 0.8, 0],
            [0, 0.6, 0.8], [0.8, 0, 0.6], [-0.6, -0.8, 0],
        ], np.float64)
        pts = (q.astype(np.float64) + dirs * np.asarray(dists)[:, None]).astype(np.float32)
        return pts[None], q[None]

    def test_clear_points_match_exact_oracle(self):
        """Points >= 4 ulps from the boundary classify identically to the
        exact-distance oracle (the deviation band is narrower than that)."""
        xyz1, q = self._constructed_cloud()
        got_idx, got_cnt = query_ball_point_dense(self.RADIUS, 8, xyz1, q)
        ref_idx, ref_cnt = query_ball_point_topk(self.RADIUS, 8, xyz1, q)
        # recompute membership for the CLEAR points only (0, 1, 5, 6 are
        # well inside/outside; 2-4 sit inside the allowed deviation band)
        got_set = set(np.asarray(got_idx)[0, 0, : int(got_cnt[0, 0])].tolist())
        ref_set = set(np.asarray(ref_idx)[0, 0, : int(ref_cnt[0, 0])].tolist())
        for clear_in in (0, 1):
            assert clear_in in got_set and clear_in in ref_set
        for clear_out in (5, 6):
            assert clear_out not in got_set and clear_out not in ref_set

    def test_oracle_is_exact_and_strict(self):
        """The topk oracle (exact distances) implements the reference's
        strict comparison: a point exactly AT the radius is NOT a hit."""
        xyz1, q = self._constructed_cloud()
        # exact-at-radius point is index 3; but float32 representation of
        # q + r*dir may not land exactly at distance r — check against the
        # true f32 distance instead of assuming
        d = np.linalg.norm(
            xyz1[0].astype(np.float64) - q[0].astype(np.float64), axis=-1
        )
        ref_idx, ref_cnt = query_ball_point_topk(self.RADIUS, 8, xyz1, q)
        ref_set = set(np.asarray(ref_idx)[0, 0, : int(ref_cnt[0, 0])].tolist())
        # strictness on the exact form: membership == (f32 dist2 < r2)
        d2_f32 = np.sum(
            (xyz1[0] - q[0]) ** 2, axis=-1, dtype=np.float32
        ).astype(np.float32)
        want = {i for i in range(len(d)) if d2_f32[i] < np.float32(self.RADIUS) ** 2}
        assert ref_set == want


class TestGroupPoint:
    def test_forward(self, rng):
        pts = rng.randn(2, 40, 6).astype(np.float32)
        idx = rng.randint(0, 40, (2, 10, 4)).astype(np.int32)
        got = np.asarray(ops.group_point(pts, idx))
        np.testing.assert_allclose(got, oracles.group_point_oracle(pts, idx))

    def test_gradient(self, rng):
        pts = rng.randn(1, 6, 2).astype(np.float32)
        idx = np.array([[[0, 0], [2, 3]]], dtype=np.int32)

        def f(p):
            return jnp.sum(ops.group_point(p, idx) * 2.0)

        g = np.asarray(jax.grad(f)(pts))[0]
        want = np.zeros((6, 2))
        want[0] = 4.0
        want[2] = 2.0
        want[3] = 2.0
        np.testing.assert_allclose(g, want)


class TestThreeNN:
    def test_matches_oracle(self, rng):
        xyz1 = rng.randn(2, 32, 3).astype(np.float32)
        xyz2 = rng.randn(2, 16, 3).astype(np.float32)
        got_d, got_i = ops.three_nn(xyz1, xyz2)
        want_d, want_i = oracles.three_nn_oracle(xyz1, xyz2)
        np.testing.assert_allclose(np.asarray(got_d), want_d, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(got_i), want_i)

    def test_no_gradient_through_dist(self, rng):
        xyz1 = rng.randn(1, 8, 3).astype(np.float32)
        xyz2 = rng.randn(1, 4, 3).astype(np.float32)

        def f(x2):
            d, _ = ops.three_nn(xyz1, x2)
            return jnp.sum(d)

        g = np.asarray(jax.grad(f)(xyz2))
        np.testing.assert_allclose(g, 0.0)  # reference three_nn has no grad


class TestThreeInterpolate:
    def test_matches_oracle(self, rng):
        pts = rng.randn(2, 16, 8).astype(np.float32)
        idx = rng.randint(0, 16, (2, 32, 3)).astype(np.int32)
        w = rng.rand(2, 32, 3).astype(np.float32)
        w /= w.sum(-1, keepdims=True)
        got = np.asarray(ops.three_interpolate(pts, idx, w))
        want = oracles.three_interpolate_oracle(pts, idx, w)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_gradient_wrt_points(self, rng):
        pts = rng.randn(1, 4, 2).astype(np.float32)
        idx = np.array([[[0, 1, 1]]], dtype=np.int32)
        w = np.array([[[0.5, 0.25, 0.25]]], dtype=np.float32)

        def f(p):
            return jnp.sum(ops.three_interpolate(p, idx, w))

        g = np.asarray(jax.grad(f)(pts))[0]
        want = np.zeros((4, 2))
        want[0] = 0.5
        want[1] = 0.5  # 0.25 + 0.25
        np.testing.assert_allclose(g, want)


class TestKNNAndExtras:
    def test_knn_point(self, rng):
        xyz1 = rng.randn(1, 32, 3).astype(np.float32)
        xyz2 = rng.randn(1, 8, 3).astype(np.float32)
        d, i = ops.knn_point(4, xyz1, xyz2)
        d, i = np.asarray(d), np.asarray(i)
        d2 = np.sum((xyz2[0][:, None] - xyz1[0][None]) ** 2, -1)
        want_i = np.argsort(d2, -1, kind="stable")[:, :4]
        np.testing.assert_array_equal(i[0], want_i)
        np.testing.assert_allclose(d[0], np.take_along_axis(d2, want_i, -1), rtol=1e-5)

    def test_select_top_k(self, rng):
        dist = rng.rand(1, 4, 16).astype(np.float32)
        idx, out = ops.select_top_k(5, dist)
        idx, out = np.asarray(idx), np.asarray(out)
        for m in range(4):
            want = np.sort(dist[0, m])[:5]
            np.testing.assert_allclose(out[0, m, :5], want)

    def test_prob_sample(self, rng):
        p = np.ones((1, 10), dtype=np.float32)
        r = np.array([[0.05, 1.5, 9.99]], dtype=np.float32)
        got = np.asarray(ops.prob_sample(p, r))
        np.testing.assert_array_equal(got, [[0, 1, 9]])


class TestIoU3D:
    def test_matches_shapely(self, rng):
        boxes1 = oracles.random_boxes(rng, (32,))
        boxes2 = oracles.random_boxes(rng, (32,))
        got = np.asarray(ops.box3d_iou_pairwise(boxes1, boxes2))
        for k in range(32):
            want = oracles.shapely_iou3d(boxes1[k], boxes2[k])
            np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-5)

    def test_identical_boxes(self, rng):
        boxes = oracles.random_boxes(rng, (8,))
        got = np.asarray(ops.box3d_iou_pairwise(boxes, boxes))
        np.testing.assert_allclose(got, 1.0, rtol=1e-4)

    def test_disjoint_boxes(self):
        from votenet_tpu.data.geometry import box_corners_votenet

        b1 = box_corners_votenet([1, 1, 1], 0.3, [0, 0, 0]).astype(np.float32)
        b2 = box_corners_votenet([1, 1, 1], 0.9, [10, 0, 0]).astype(np.float32)
        got = np.asarray(ops.box3d_iou_pairwise(b1, b2))
        np.testing.assert_allclose(got, 0.0, atol=1e-7)

    def test_matrix_shape(self, rng):
        b1 = oracles.random_boxes(rng, (2, 5))
        b2 = oracles.random_boxes(rng, (2, 7))
        got = np.asarray(ops.box3d_iou_matrix(b1, b2))
        assert got.shape == (2, 5, 7)


class TestNMS3D:
    def test_matches_oracle(self, rng):
        B, N = 2, 24
        corners = oracles.random_boxes(rng, (B, N))
        scores = rng.rand(B, N).astype(np.float32)
        objectness = rng.randn(B, N, 2).astype(np.float32)
        got = np.asarray(ops.nms3d(corners, scores, objectness, 0.25))
        want = oracles.nms3d_oracle(corners, scores, objectness, 0.25)
        np.testing.assert_array_equal(got, want)

    def test_non_candidates_never_kept(self, rng):
        corners = oracles.random_boxes(rng, (1, 8))
        scores = rng.rand(1, 8).astype(np.float32)
        objectness = np.zeros((1, 8, 2), dtype=np.float32)
        objectness[..., 0] = 1.0  # logit0 > logit1 everywhere -> no candidates
        got = np.asarray(ops.nms3d(corners, scores, objectness, 0.25))
        assert not got.any()

    def test_indices_wrapper_order(self, rng):
        B, N = 2, 16
        corners = oracles.random_boxes(rng, (B, N))
        scores = rng.rand(B, N).astype(np.float32)
        objectness = rng.randn(B, N, 2).astype(np.float32)
        pairs = ops.nms3d_indices(corners, scores, objectness, 0.25)
        assert pairs.ndim == 2 and pairs.shape[1] == 2
        sel = scores[pairs[:, 0], pairs[:, 1]]
        assert (np.diff(sel) <= 1e-7).all()  # globally descending


class TestNMS3DCompaction:
    """The tiered candidate compaction must be invisible in the keep mask."""

    def _run(self, rng, n_cand_per_row, B=3, N=256):
        corners = oracles.random_boxes(rng, (B, N))
        scores = rng.rand(B, N).astype(np.float32)
        objectness = np.zeros((B, N, 2), dtype=np.float32)
        objectness[..., 0] = 1.0  # default: not a candidate
        for b in range(B):
            sel = rng.choice(N, n_cand_per_row, replace=False)
            objectness[b, sel, 0] = 0.0
            objectness[b, sel, 1] = 1.0  # candidate
        got = np.asarray(ops.nms3d(corners, scores, objectness, 0.25))
        want = oracles.nms3d_oracle(corners, scores, objectness, 0.25)
        np.testing.assert_array_equal(got, want)
        return got

    def test_tier64(self, rng):
        self._run(rng, 40)

    def test_tier64_boundary(self, rng):
        self._run(rng, 64)

    def test_tier160(self, rng):
        self._run(rng, 120)

    def test_dense_fallback(self, rng):
        self._run(rng, 220)

    def test_equal_scores_tiebreak(self, rng):
        # overlapping equal-score candidates: lower index must win in every
        # tier (the deterministic refinement of the reference's heap order)
        B, N = 1, 256
        corners = np.broadcast_to(
            oracles.random_boxes(rng, (B, 1)), (B, N, 8, 3)
        ).copy()  # all identical -> everything overlaps everything
        scores = np.full((B, N), 0.5, np.float32)
        objectness = np.zeros((B, N, 2), dtype=np.float32)
        objectness[..., 0] = 1.0
        objectness[0, :30, 0] = 0.0
        objectness[0, :30, 1] = 1.0
        got = np.asarray(ops.nms3d(corners, scores, objectness, 0.25))
        want = np.zeros((B, N), bool)
        want[0, 0] = True  # lowest-index candidate survives, suppresses rest
        np.testing.assert_array_equal(got, want)
