"""Offline evaluation: checkpoint -> per-class AP / mAP table.

The working equivalent of the reference's dead ``evaluator.py.__main__``
(OfflinePredictor + eval_mAP at multiple IoU thresholds, evaluator.py:236-245).

  python run_eval.py --log_dir=train_log/run [--synthetic=32] [--ious 0.25 0.5]
"""

from __future__ import annotations

import argparse

import jax
import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--log_dir", default="train_log/run")
    parser.add_argument("--data_root", default="/data/mysunrgbd")
    parser.add_argument("--cache_dir", default=None)
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--ious", type=float, nargs="+", default=[0.25, 0.5])
    parser.add_argument("--batch_size", type=int, default=64,
                        help="eval batch (results are batch-independent)")
    parser.add_argument("--preset", default="full",
                        choices=["full", "tiny", "throughput"],
                        help="throughput = bf16 MLP compute for batch "
                             "evaluation (f32-trained checkpoints load "
                             "unchanged; not reference parity)")
    args, config_argv = parser.parse_known_args(argv)

    from votenet_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from votenet_tpu.config import config_from_args, default_config, tiny_config
    from votenet_tpu.ops.dispatch import apply_config
    from votenet_tpu.eval.evaluator import Evaluator, make_packed_predict_fn
    from votenet_tpu.models.votenet import VoteNet
    from votenet_tpu.train.state import create_train_state
    from votenet_tpu.utils import checkpoint as ckpt

    if args.preset == "tiny":
        cfg = tiny_config()
    elif args.preset == "throughput":
        cfg = default_config(compute_dtype="bfloat16")
    else:
        cfg = default_config()
    cfg = config_from_args(config_argv, base=cfg)
    apply_config(cfg)
    state = create_train_state(jax.random.PRNGKey(0), cfg, steps_per_epoch=1)
    state, step = ckpt.restore_checkpoint(args.log_dir, state)
    print(f"checkpoint: {'epoch %s' % step if step else 'NONE (random init)'}")

    model = VoteNet(cfg)
    predict = make_packed_predict_fn(
        model, {"params": state.params, "batch_stats": state.batch_stats}, cfg
    )

    if args.synthetic:
        from votenet_tpu.data.synthetic import synthetic_gt_all, synthetic_scenes

        scenes = synthetic_scenes(1, cfg, args.synthetic)
        gt_all = synthetic_gt_all(scenes)
        scene_iter = [(int(s["data_idx"]), s["points"]) for s in scenes]
    else:
        from votenet_tpu.data.dataflow import SunRGBDDataFlow
        from votenet_tpu.eval.evaluator import gt_dict_from_labels

        val_flow = SunRGBDDataFlow(
            args.data_root, "training", training=False, config=cfg,
            idx_list=list(range(*cfg.val_idx_range)), cache_dir=args.cache_dir,
        )
        cache = [(int(s["data_idx"]), s) for s in val_flow]
        gt_all = gt_dict_from_labels({i: s for i, s in cache})
        scene_iter = [(i, s["points"]) for i, s in cache]

    for iou in args.ious:
        ev = Evaluator(cfg, gt_all, ovthresh=iou, batch_size=args.batch_size)
        result = ev.evaluate(predict, scene_iter)
        print(f"\n=== IoU {iou} ===")
        for cls in sorted(result["ap"]):
            print(f"  {cls:12s} AP: {result['ap'][cls]:.4f}")
        print(f"  mAP{iou}: {result['mAP']:.4f}")


if __name__ == "__main__":
    main()
