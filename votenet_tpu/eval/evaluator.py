"""Batched mAP evaluator.

Rebuilds the reference's ``Evaluator`` callback (evaluator.py:208-233) as a
framework-independent class. Differences by design (SURVEY §7 step 6):

- inference runs in fixed-size batches (the reference feeds batch-1 per val
  scene, evaluator.py:222), with the last batch padded by repetition and the
  padding masked out of the results;
- predictions come back as fixed-shape (boxes, scores, keep-mask) arrays and
  are converted to per-scene variable-length lists on the host;
- returns plain lists/dicts (the reference stored a one-shot ``zip``,
  evaluator.py:231 — a quirk noted in SURVEY §7).

Per-scene decode matches the reference: class = argmax of semantic logits,
confidence = that max logit (evaluator.py:224-226).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np

from votenet_tpu.config import Config
from votenet_tpu.data.geometry import CLASS2TYPE
from votenet_tpu.eval.ap import eval_det


class DeviceSceneCache:
    """Validation points uploaded to the device ONCE, reused every eval.

    The periodic evaluator used to re-stack and re-upload all val points on
    every trigger (~1.2 GB at the reference's 5050-scene val split — the
    dominant eval cost after pipelining, benchmarks/eval_scale.py). The val
    points never change across evals, so this stacks them once, pads to a
    batch multiple (repeating the last scene; masked out of results), and
    keeps the single (S, P, 3) array resident on the device. Batches are device
    slices — no host->device traffic per eval at all.

    The upload happens in slabs (``upload_slab`` scenes per transfer) and is
    concatenated on device, which bounds the size of any one transfer.
    """

    def __init__(self, scenes, batch_size: int, upload_slab: int = 256):
        import jax
        import jax.numpy as jnp

        scenes = list(scenes)
        self.ids = [int(i) for i, _ in scenes]
        self.n = len(scenes)
        self.batch_size = batch_size
        pad = (-self.n) % batch_size
        pts = [np.asarray(p, np.float32) for _, p in scenes]
        pts += [pts[-1]] * pad
        slabs = []
        for s in range(0, len(pts), upload_slab):
            slabs.append(jax.device_put(jnp.asarray(np.stack(pts[s : s + upload_slab]))))
        self.points = jnp.concatenate(slabs, axis=0) if len(slabs) > 1 else slabs[0]

    def batches(self):
        """Yield (img_ids_of_real_scenes, device_points (B, P, 3))."""
        B = self.batch_size
        for s in range(0, self.points.shape[0], B):
            yield self.ids[s : s + B], self.points[s : s + B]


def decode_batch_predictions(ids, out, pred_all: Dict) -> None:
    """Host decode of one fetched batch into per-scene detection lists.

    out: {"bboxes" (B,P,8,3), "class_scores" (B,P,NC), "keep" (B,P)} numpy.
    Writes pred_all[img_id] = [(classname, bbox (8,3), score)] — the same
    tuples as the reference's per-scene decode (evaluator.py:224-231), but
    with ONE fancy-index per scene instead of a Python loop of per-det
    `bboxes[bi, pi]` scalar indexing (phase attribution of the eval wall:
    benchmarks/eval_profile.py).

    Accepts either predictor output form: the plain per-proposal dict
    (bboxes/class_scores/keep) or the compacted form from
    :func:`make_packed_predict_fn` (packed/cnt) — the fetch-cost story
    lives there; the decoded lists are identical."""
    if "packed" in out:
        cnt = np.asarray(out["cnt"])
        kmax = int(cnt.max()) if cnt.size else 0
        # ONE fetch of only the detection rows: device-side slice (jit
        # caches one tiny executable per distinct kmax), then transfer
        rows = np.asarray(out["packed"][:, :kmax]) if kmax else None
        for bi, img_id in enumerate(ids):
            k = int(cnt[bi])
            if k == 0:
                pred_all[img_id] = []
                continue
            bb = rows[bi, :k, :24].reshape(k, 8, 3)
            sc = rows[bi, :k, 24:]
            ci = np.argmax(sc, axis=-1)
            best = sc[np.arange(k), ci]
            names = [CLASS2TYPE[c] for c in ci.tolist()]
            pred_all[img_id] = list(zip(names, list(bb), best.tolist()))
        return
    bboxes = np.asarray(out["bboxes"])
    class_scores = np.asarray(out["class_scores"])
    keep = np.asarray(out["keep"])
    cls_idx = np.argmax(class_scores, axis=-1)  # (B, P)
    best = np.take_along_axis(class_scores, cls_idx[..., None], axis=-1)[..., 0]
    for bi, img_id in enumerate(ids):
        k = np.nonzero(keep[bi])[0]
        names = [CLASS2TYPE[c] for c in cls_idx[bi, k].tolist()]
        pred_all[img_id] = list(
            zip(names, list(bboxes[bi, k]), best[bi, k].tolist())
        )


class Evaluator:
    """Runs batched VoteNet inference over a scene set and computes mAP."""

    def __init__(
        self,
        config: Config,
        gt_all: Dict,
        ovthresh: float = 0.25,
        batch_size: int = 8,
        pipeline_depth: int = 4,
    ):
        self.config = config
        self.gt_all = gt_all
        self.pipeline_depth = pipeline_depth
        self.ovthresh = ovthresh
        self.batch_size = batch_size

    def predictions_for_scenes(
        self,
        predict_fn: Callable[[np.ndarray], Dict[str, np.ndarray]],
        scenes: Iterable[Tuple[int, np.ndarray]],
    ) -> Dict[int, List[Tuple[str, np.ndarray, float]]]:
        """Run batched inference; returns {img_id: [(classname, bbox, score)]}.

        ``scenes`` is either an iterable of (img_id, points) pairs (stacked
        and uploaded per batch) or a :class:`DeviceSceneCache` (no uploads:
        batches are slices of the device-resident val array).

        Batches are kept in flight (JAX async dispatch) up to
        ``self.pipeline_depth`` deep, so device compute, device->host result
        fetches and host-side decoding of earlier batches overlap — at the
        5050-scene reference val-split scale the serial fetch-then-decode
        loop was host-bound, not device-bound (benchmarks/eval_scale.py).
        """
        from collections import deque

        pred_all: Dict[int, List] = {}
        B = self.batch_size
        pending: deque = deque()

        def drain(n_keep: int):
            while len(pending) > n_keep:
                ids, out = pending.popleft()
                decode_batch_predictions(ids, out, pred_all)

        if isinstance(scenes, DeviceSceneCache):
            assert scenes.batch_size == B, (
                f"cache built for batch {scenes.batch_size}, evaluator uses {B}"
            )
            batch_iter = scenes.batches()
        else:
            def _host_batches():
                all_scenes = list(scenes)
                for start in range(0, len(all_scenes), B):
                    chunk = all_scenes[start : start + B]
                    ids = [c[0] for c in chunk]
                    while len(chunk) < B:  # pad last batch by repeating
                        chunk.append(chunk[-1])
                    yield ids, np.stack([c[1] for c in chunk]).astype(np.float32)

            batch_iter = _host_batches()

        for ids, points in batch_iter:
            pending.append((ids, predict_fn(points)))
            drain(self.pipeline_depth)
        drain(0)
        return pred_all

    def evaluate(
        self,
        predict_fn: Callable[[np.ndarray], Dict[str, np.ndarray]],
        scenes: Iterable[Tuple[int, np.ndarray]],
    ) -> Dict:
        """Full evaluation: returns {'mAP': float, 'ap': {cls: float}, ...}."""
        pred_all = self.predictions_for_scenes(predict_fn, scenes)
        rec, prec, ap = eval_det(pred_all, self.gt_all, self.ovthresh)
        mAP = float(np.mean([ap[c] for c in ap])) if ap else 0.0
        return {"mAP": mAP, "ap": ap, "rec": rec, "prec": prec}


def make_predict_fn(model, variables, config: Config):
    """Build a jitted points -> {bboxes, class_scores, keep} function."""
    import jax

    from votenet_tpu.models.decode import predict_boxes

    @jax.jit
    def _predict(points):
        end_points = model.apply(variables, points, train=False)
        pred = predict_boxes(end_points, config)
        return {
            "bboxes": pred["bboxes"],
            "class_scores": pred["class_scores"],
            "keep": pred["keep"],
        }

    return _predict


def make_packed_predict_fn(model, variables, config: Config):
    """Fetch-optimized predictor: kept detections compacted ON DEVICE.

    The eval wall clock at the 5050-scene reference scale is ~entirely the
    device->host fetch of the per-PROPOSAL outputs — 552 MB and 3 transfer
    round trips per batch for results where only the ~2-5% kept rows
    matter (phase attribution: benchmarks/eval_profile.py — device+fetch
    78.4 s vs 0.9 s for ALL host math). This predictor stably partitions
    the kept rows to the front on device and returns

      {"packed": (B, P, 24+NC) f32  [bbox 24 ‖ class_scores NC],
       "cnt":    (B,) int32}

    so the evaluator fetches the tiny counts, then ONE slice of
    ``packed[:, :max(cnt)]`` — bytes scale with detections, not proposals.
    Kept rows stay in original proposal order (stable partition), so the
    decoded per-scene lists are IDENTICAL to the unpacked path's
    (tests/test_eval.py parity test).
    """
    import jax
    import jax.numpy as jnp

    from votenet_tpu.models.decode import predict_boxes

    @jax.jit
    def _predict(points):
        end_points = model.apply(variables, points, train=False)
        pred = predict_boxes(end_points, config)
        keep = pred["keep"]  # (B, P) bool
        B, P = keep.shape
        iota = jnp.arange(P, dtype=jnp.int32)[None, :]
        # stable partition: kept rows first, each side in original order
        order = jnp.argsort(jnp.where(keep, iota, iota + P), axis=1)
        flat = jnp.concatenate(
            [pred["bboxes"].reshape(B, P, 24), pred["class_scores"]], axis=-1
        )
        packed = jnp.take_along_axis(flat, order[:, :, None], axis=1)
        return {
            "packed": packed,
            "cnt": jnp.sum(keep, axis=1).astype(jnp.int32),
        }

    return _predict


def gt_dict_from_labels(scene_labels: Dict[int, Dict]) -> Dict[int, List]:
    """Build the eval GT structure from dataflow label dicts.

    scene_labels: {img_id: {'bboxes_xyz','bboxes_lwh','bboxes_roty',
    'semantic_labels'}} -> {img_id: [(classname, corners (8,3))]}.
    A convenience the reference lacks (it loads frustum-pointnets GT dumps,
    utils.py:249-263 — see :mod:`votenet_tpu.eval.gt_loader` for that format).
    """
    from votenet_tpu.data.geometry import box_corners_votenet

    gt_all: Dict[int, List] = {}
    for img_id, lab in scene_labels.items():
        entries = []
        for j in range(len(lab["bboxes_xyz"])):
            corners = box_corners_votenet(
                lab["bboxes_lwh"][j], lab["bboxes_roty"][j], lab["bboxes_xyz"][j]
            )
            entries.append((CLASS2TYPE[int(lab["semantic_labels"][j])], corners))
        gt_all[img_id] = entries
    return gt_all
