"""VOC-style average precision for 3D detection.

Rebuilds the reference's AP math (evaluator.py:42-205) with the same public
API — ``voc_ap`` / ``eval_det_cls`` / ``eval_det`` — and the same greedy
matching rules: detections sorted by confidence, each GT matchable once,
``iou > ovthresh`` (strict) counts a TP (evaluator.py:125-149).

Performance: the reference computes one shapely IoU per (det, GT) pair
inside the Python loop (SURVEY §3.3 marks it HOT). Here all pairwise IoUs of
a scene are computed in one vectorized device call
(:func:`votenet_tpu.ops.box3d_iou_matrix`) before the greedy pass, which
only does argmax bookkeeping.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """VOC AP from PR arrays (reference evaluator.py:42-73)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else float(np.max(prec[rec >= t]))
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def _pairwise_iou(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """(D,8,3) x (G,8,3) -> (D,G) IoU matrix.

    Prefers the native C++ clip kernel (votenet_tpu/native) — the eval
    matching runs on the host and per-pair dispatch to the device would pay
    dispatch latency; falls back to the vectorized device op.
    """
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), dtype=np.float32)
    from votenet_tpu import native

    if native.available():
        return native.iou3d_matrix(dets, gts)
    from votenet_tpu.ops import box3d_iou_matrix

    return np.asarray(
        box3d_iou_matrix(dets.astype(np.float32), gts.astype(np.float32))
    )


def eval_det_cls(
    pred: Dict, gt: Dict, ovthresh: float = 0.25, use_07_metric: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Precision/recall/AP for one class (reference evaluator.py:76-161).

    pred: {img_id: [(bbox (8,3), score)]}; gt: {img_id: [bbox]}.
    """
    class_recs = {}
    npos = 0
    for img_id in gt.keys():
        bbox = np.array(gt[img_id])
        class_recs[img_id] = {"bbox": bbox, "det": [False] * len(bbox)}
        npos += len(bbox)
    for img_id in pred.keys():
        if img_id not in gt:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids: List = []
    confidence: List[float] = []
    BB: List[np.ndarray] = []
    for img_id in pred.keys():
        for box, score in pred[img_id]:
            image_ids.append(img_id)
            confidence.append(score)
            BB.append(box)
    confidence = np.array(confidence)
    BB = np.array(BB)

    sorted_ind = np.argsort(-confidence)
    BB = BB[sorted_ind, ...] if len(BB) else BB
    image_ids = [image_ids[x] for x in sorted_ind]

    # group detections by image in one pass (positions stay in global
    # confidence order, so per-image greedy matching is equivalent to the
    # reference's single global loop — detections only interact with GT of
    # their own image, evaluator.py:125-149)
    img_rows: Dict = {}
    for d, img_id in enumerate(image_ids):
        img_rows.setdefault(img_id, []).append(d)

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    from votenet_tpu import native

    for img_id, rows in img_rows.items():
        gt_boxes = np.asarray(class_recs[img_id]["bbox"])
        if gt_boxes.size == 0:
            fp[rows] = 1.0
            continue
        iou = _pairwise_iou(BB[rows], gt_boxes)
        # native C++ matcher (votenet_native.cpp::vn_greedy_match) with a
        # numpy fallback inside; same strict `> ovthresh` / first-argmax /
        # each-GT-once rules as the reference
        tpi, fpi = native.greedy_match(iou, ovthresh)
        tp[rows] = tpi
        fp[rows] = fpi

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def eval_det(
    pred_all: Dict, gt_all: Dict, ovthresh: float = 0.25, use_07_metric: bool = False
):
    """Multi-class AP (reference evaluator.py:164-205).

    pred_all: {img_id: [(classname, bbox, score)]};
    gt_all: {img_id: [(classname, bbox)]}.
    Returns (rec, prec, ap) dicts keyed by classname.
    """
    pred: Dict = {}
    gt: Dict = {}
    for img_id in pred_all.keys():
        for classname, bbox, score in pred_all[img_id]:
            pred.setdefault(classname, {}).setdefault(img_id, []).append((bbox, score))
            gt.setdefault(classname, {}).setdefault(img_id, [])
    for img_id in gt_all.keys():
        for classname, bbox in gt_all[img_id]:
            gt.setdefault(classname, {})
            pred.setdefault(classname, {})
            gt[classname].setdefault(img_id, []).append(bbox)

    rec, prec, ap = {}, {}, {}
    for classname in gt.keys():
        rec[classname], prec[classname], ap[classname] = eval_det_cls(
            pred[classname], gt[classname], ovthresh, use_07_metric
        )
    return rec, prec, ap
