"""Phase attribution of the periodic-eval wall clock (VERDICT r4 #4).

eval_scale.py measures the steady-state total (65 s / 5050 scenes vs ~11 s
device compute). This splits one device-cache eval into its phases:

  device+fetch   predict dispatch + device->host result transfer, no decode
  decode         keep-mask -> per-scene (classname, bbox, score) lists
  eval_det       AP math, itself split into regroup / IoU / match / PR

Each phase is timed on the SAME prediction set, so the numbers add up to a
serial-equivalent wall clock; the production Evaluator pipelines device
work against host decode (pipeline_depth), so its total ~= max(device,
host) + tails. Run on the GPU:  python benchmarks/eval_profile.py [n]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(n: int = 5050):
    import jax

    from votenet_tpu.config import default_config
    from votenet_tpu.data.synthetic import synthetic_gt_all, synthetic_scenes
    from votenet_tpu.eval import ap as ap_mod
    from votenet_tpu.eval.evaluator import (
        DeviceSceneCache,
        Evaluator,
        make_predict_fn,
    )
    from votenet_tpu.models.votenet import VoteNet

    cfg = default_config()
    t0 = time.perf_counter()
    scenes = synthetic_scenes(7, cfg, n)
    gt_all = synthetic_gt_all(scenes)
    scene_iter = [(int(s["data_idx"]), s["points"]) for s in scenes]
    print(f"generated {n} scenes in {time.perf_counter() - t0:.1f}s", flush=True)

    model = VoteNet(cfg)
    pts0 = np.zeros((1, cfg.point_num, 3), np.float32)
    variables = jax.jit(lambda r, p: model.init(r, p, train=False))(
        jax.random.PRNGKey(0), pts0
    )
    predict = make_predict_fn(model, variables, cfg)
    ev = Evaluator(cfg, gt_all, batch_size=8)
    cache = DeviceSceneCache(scene_iter, batch_size=8)
    ev.evaluate(predict, cache)  # compile + warm; discard

    # ---- production total (pipelined), for reference ----
    t0 = time.perf_counter()
    result = ev.evaluate(predict, cache)
    total = time.perf_counter() - t0
    print(f"[total] pipelined evaluate: {total:.1f}s mAP={result['mAP']:.4f}",
          flush=True)

    # ---- phase 1: device + fetch (no decode) ----
    t0 = time.perf_counter()
    fetched = []
    for ids, points in cache.batches():
        out = predict(points)
        fetched.append((ids, {k: np.asarray(v) for k, v in out.items()}))
    t_fetch = time.perf_counter() - t0
    kept = sum(int(o["keep"].sum()) for _, o in fetched)
    print(f"[phase] device+fetch (serial): {t_fetch:.1f}s "
          f"({kept} kept dets)", flush=True)

    # ---- phase 2: decode (host arrays -> per-scene det lists) ----
    # Times both the production vectorized decode and the legacy per-det
    # scalar-indexing loop it replaced, so the speedup is on record.
    from votenet_tpu.data.geometry import CLASS2TYPE
    from votenet_tpu.eval.evaluator import decode_batch_predictions

    t0 = time.perf_counter()
    pred_all = {}
    for ids, out in fetched:
        decode_batch_predictions(ids, out, pred_all)
    t_decode = time.perf_counter() - t0
    print(f"[phase] decode (vectorized, production): {t_decode:.1f}s", flush=True)

    t0 = time.perf_counter()
    pred_legacy = {}
    for ids, out in fetched:
        bboxes, class_scores, keep = out["bboxes"], out["class_scores"], out["keep"]
        cls_idx = np.argmax(class_scores, axis=-1)
        best = np.take_along_axis(class_scores, cls_idx[..., None], axis=-1)[..., 0]
        for bi, img_id in enumerate(ids):
            dets = []
            for pi in np.nonzero(keep[bi])[0]:
                dets.append((
                    CLASS2TYPE[int(cls_idx[bi, pi])],
                    bboxes[bi, pi],
                    float(best[bi, pi]),
                ))
            pred_legacy[img_id] = dets
    t_legacy = time.perf_counter() - t0
    print(f"[phase] decode (legacy per-det loop): {t_legacy:.1f}s", flush=True)
    assert set(pred_legacy) == set(pred_all)
    for k in list(pred_legacy)[:50]:  # spot-check equivalence
        a, b = pred_legacy[k], pred_all[k]
        assert len(a) == len(b) and all(
            x[0] == y[0] and np.array_equal(x[1], y[1]) and x[2] == y[2]
            for x, y in zip(a, b)
        ), f"decode mismatch at scene {k}"

    # ---- phase 3: eval_det, with IoU/match split via instrumentation ----
    tm = {"iou": 0.0, "match": 0.0}
    orig_iou = ap_mod._pairwise_iou
    from votenet_tpu import native

    orig_match = native.greedy_match

    def timed_iou(d, g):
        t = time.perf_counter()
        r = orig_iou(d, g)
        tm["iou"] += time.perf_counter() - t
        return r

    def timed_match(iou, th):
        t = time.perf_counter()
        r = orig_match(iou, th)
        tm["match"] += time.perf_counter() - t
        return r

    ap_mod._pairwise_iou = timed_iou
    native.greedy_match = timed_match
    try:
        t0 = time.perf_counter()
        rec, prec, apd = ap_mod.eval_det(pred_all, gt_all, ev.ovthresh)
        t_ap = time.perf_counter() - t0
    finally:
        ap_mod._pairwise_iou = orig_iou
        native.greedy_match = orig_match
    mAP = float(np.mean([apd[c] for c in apd])) if apd else 0.0
    print(f"[phase] eval_det: {t_ap:.1f}s (iou {tm['iou']:.1f}s, match "
          f"{tm['match']:.1f}s, regroup/PR {t_ap - tm['iou'] - tm['match']:.1f}s) "
          f"mAP={mAP:.4f}", flush=True)
    print(f"[sum] serial phases: {t_fetch + t_decode + t_ap:.1f}s "
          f"vs pipelined total {total:.1f}s", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5050)
