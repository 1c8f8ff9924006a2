"""Tests for IoU, AP math, and the batched evaluator."""

import numpy as np
import pytest

from votenet_tpu.eval.ap import eval_det, eval_det_cls, voc_ap
from votenet_tpu.eval.iou import iou_3d
from tests import oracles


class TestHostIoU:
    def test_matches_device_iou(self, rng):
        """Host Sutherland–Hodgman vs device angular-sort — different
        algorithms, same value."""
        from votenet_tpu.ops import box3d_iou_pairwise

        b1 = oracles.random_boxes(rng, (16,))
        b2 = oracles.random_boxes(rng, (16,))
        dev = np.asarray(box3d_iou_pairwise(b1, b2))
        for k in range(16):
            host = iou_3d(b1[k], b2[k])
            np.testing.assert_allclose(dev[k], host, rtol=1e-4, atol=1e-5)

    def test_self_iou(self, rng):
        b = oracles.random_boxes(rng, (4,))
        for k in range(4):
            np.testing.assert_allclose(iou_3d(b[k], b[k]), 1.0, rtol=1e-6)


class TestVocAP:
    def test_perfect_detector(self):
        rec = np.array([0.5, 1.0])
        prec = np.array([1.0, 1.0])
        assert voc_ap(rec, prec) == pytest.approx(1.0)

    def test_11pt_metric(self):
        rec = np.array([0.5, 1.0])
        prec = np.array([1.0, 1.0])
        assert voc_ap(rec, prec, use_07_metric=True) == pytest.approx(1.0)

    def test_half(self):
        # one TP then one FP: precision envelope 1.0 up to rec 0.5
        rec = np.array([0.5, 0.5])
        prec = np.array([1.0, 0.5])
        assert voc_ap(rec, prec) == pytest.approx(0.5)


class TestEvalDet:
    def _setup(self, rng):
        boxes = oracles.random_boxes(rng, (6,))
        gt = {1: [boxes[0], boxes[1]], 2: [boxes[2]]}
        # perfect predictions + one false positive in img 2
        pred = {
            1: [(boxes[0], 0.9), (boxes[1], 0.8)],
            2: [(boxes[2], 0.95), (boxes[3] + 50.0, 0.1)],
        }
        return pred, gt

    def test_perfect_plus_fp(self, rng):
        pred, gt = self._setup(rng)
        rec, prec, ap = eval_det_cls(pred, gt, ovthresh=0.25)
        assert rec[-1] == pytest.approx(1.0)  # all GTs found
        assert ap == pytest.approx(1.0)  # FP ranked last doesn't hurt AP

    def test_duplicate_detection_is_fp(self, rng):
        boxes = oracles.random_boxes(rng, (1,))
        gt = {1: [boxes[0]]}
        pred = {1: [(boxes[0], 0.9), (boxes[0], 0.8)]}  # duplicate
        rec, prec, ap = eval_det_cls(pred, gt, ovthresh=0.25)
        assert rec[-1] == pytest.approx(1.0)
        assert prec[-1] == pytest.approx(0.5)  # second det is a FP

    def test_eval_det_multiclass(self, rng):
        boxes = oracles.random_boxes(rng, (4,))
        gt_all = {1: [("chair", boxes[0]), ("bed", boxes[1])]}
        pred_all = {1: [("chair", boxes[0], 0.9), ("bed", boxes[1], 0.8)]}
        _, _, ap = eval_det(pred_all, gt_all)
        assert ap["chair"] == pytest.approx(1.0)
        assert ap["bed"] == pytest.approx(1.0)

    def test_missed_class_zero_ap(self, rng):
        boxes = oracles.random_boxes(rng, (2,))
        gt_all = {1: [("chair", boxes[0])]}
        pred_all = {1: []}
        _, _, ap = eval_det(pred_all, gt_all)
        assert ap["chair"] == pytest.approx(0.0)


class TestEvaluatorEndToEnd:
    def test_oracle_predictor_gets_full_map(self, rng):
        """Feeding GT boxes as predictions must give mAP == 1."""
        from votenet_tpu.config import Config
        from votenet_tpu.data.synthetic import synthetic_gt_all, synthetic_scenes
        from votenet_tpu.eval.evaluator import Evaluator
        from votenet_tpu.data.geometry import TYPE2CLASS, box_corners_votenet

        cfg = Config(point_num=256, proposal_num=8, max_gt_boxes=8)
        scenes = synthetic_scenes(0, cfg, 6)
        gt_all = synthetic_gt_all(scenes)
        by_id = {int(s["data_idx"]): s for s in scenes}
        order = [int(s["data_idx"]) for s in scenes]
        P = cfg.proposal_num

        def oracle_predict(points_batch):
            # match scenes by position in the batched call sequence
            B = points_batch.shape[0]
            ids = [order.pop(0) if order else None for _ in range(B)]
            bboxes = np.zeros((B, P, 8, 3), np.float32)
            scores = np.full((B, P, cfg.num_class), -10.0, np.float32)
            keep = np.zeros((B, P), bool)
            for bi, img_id in enumerate(ids):
                if img_id is None:
                    continue
                sc = by_id[img_id]
                for j in range(min(len(sc["bboxes_xyz"]), P)):
                    bboxes[bi, j] = box_corners_votenet(
                        sc["bboxes_lwh"][j], sc["bboxes_roty"][j], sc["bboxes_xyz"][j]
                    )
                    scores[bi, j, int(sc["semantic_labels"][j])] = 5.0
                    keep[bi, j] = True
            return {"bboxes": bboxes, "class_scores": scores, "keep": keep}

        ev = Evaluator(cfg, gt_all, batch_size=4)
        result = ev.evaluate(
            oracle_predict, [(int(s["data_idx"]), s["points"]) for s in scenes]
        )
        assert result["mAP"] == pytest.approx(1.0)

    def test_device_cache_matches_host_path(self, rng):
        """DeviceSceneCache (device-resident val set) must produce identical
        predictions to the per-batch host-upload path, including the
        padded-last-batch masking."""
        from votenet_tpu.config import Config
        from votenet_tpu.data.synthetic import synthetic_gt_all, synthetic_scenes
        from votenet_tpu.eval.evaluator import DeviceSceneCache, Evaluator

        cfg = Config(point_num=64, proposal_num=4, max_gt_boxes=4)
        scenes = synthetic_scenes(0, cfg, 6)  # 6 scenes, batch 4 -> pad 2
        gt_all = synthetic_gt_all(scenes)
        pairs = [(int(s["data_idx"]), s["points"]) for s in scenes]
        P = cfg.proposal_num

        def fake_predict(points_batch):
            # deterministic function of the points so both paths must agree
            pts = np.asarray(points_batch)
            B = pts.shape[0]
            bboxes = np.tile(
                np.mean(pts, axis=1)[:, None, None, :], (1, P, 8, 1)
            ).astype(np.float32)
            scores = np.tile(
                np.sum(pts, axis=(1, 2))[:, None, None], (1, P, cfg.num_class)
            ).astype(np.float32)
            keep = np.ones((B, P), bool)
            return {"bboxes": bboxes, "class_scores": scores, "keep": keep}

        ev = Evaluator(cfg, gt_all, batch_size=4)
        host = ev.predictions_for_scenes(fake_predict, pairs)
        cache = DeviceSceneCache(pairs, batch_size=4)
        dev = ev.predictions_for_scenes(fake_predict, cache)
        assert set(host) == set(dev) == {i for i, _ in pairs}
        for img_id in host:
            assert len(host[img_id]) == len(dev[img_id])
            for (c1, b1, s1), (c2, b2, s2) in zip(host[img_id], dev[img_id]):
                assert c1 == c2 and s1 == pytest.approx(s2, rel=1e-6)
                np.testing.assert_allclose(b1, b2, rtol=1e-6)


class TestPackedPredictor:
    def test_packed_matches_plain_end_to_end(self, rng):
        """make_packed_predict_fn (device-compacted fetch) must produce
        byte-identical per-scene detection lists — and therefore identical
        mAP — to the plain dict predictor, on a real tiny model with
        partial/empty keep masks."""
        import jax

        from votenet_tpu.config import tiny_config
        from votenet_tpu.data.synthetic import synthetic_gt_all, synthetic_scenes
        from votenet_tpu.eval.evaluator import (
            Evaluator,
            make_packed_predict_fn,
            make_predict_fn,
        )
        from votenet_tpu.models.votenet import VoteNet

        cfg = tiny_config()
        scenes = synthetic_scenes(0, cfg, 6)
        gt_all = synthetic_gt_all(scenes)
        pairs = [(int(s["data_idx"]), s["points"]) for s in scenes]

        model = VoteNet(cfg)
        pts0 = np.zeros((1, cfg.point_num, 3), np.float32)
        variables = jax.jit(lambda r, p: model.init(r, p, train=False))(
            jax.random.PRNGKey(0), pts0
        )
        plain = make_predict_fn(model, variables, cfg)
        packed = make_packed_predict_fn(model, variables, cfg)

        ev = Evaluator(cfg, gt_all, batch_size=4)
        a = ev.predictions_for_scenes(plain, pairs)
        b = ev.predictions_for_scenes(packed, pairs)
        assert set(a) == set(b)
        n_dets = 0
        for img_id in a:
            assert len(a[img_id]) == len(b[img_id])
            n_dets += len(a[img_id])
            for (c1, b1, s1), (c2, b2, s2) in zip(a[img_id], b[img_id]):
                assert c1 == c2 and s1 == s2
                np.testing.assert_array_equal(b1, b2)
        ra = ev.evaluate(plain, pairs)
        rb = ev.evaluate(packed, pairs)
        assert ra["mAP"] == rb["mAP"]
