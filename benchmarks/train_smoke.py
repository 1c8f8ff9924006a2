"""Full-model training smoke on a GPU: overfit synthetic scenes.

Trains the full-size VoteNet (20480 pts) on a small set of synthetic scenes
and evaluates mAP *on the training scenes* before/after — an end-to-end
check that the loss, gradients, optimizer, decode and AP stack all work on
hardware and that the model actually learns.

  python benchmarks/train_smoke.py [steps]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(steps: int = 150):
    import jax

    from votenet_tpu.config import default_config
    from votenet_tpu.data.dataflow import batch_scenes
    from votenet_tpu.data.synthetic import synthetic_gt_all, synthetic_scenes
    from votenet_tpu.eval.evaluator import Evaluator, make_predict_fn
    from votenet_tpu.models.votenet import VoteNet
    from votenet_tpu.train.loop import make_train_step
    from votenet_tpu.train.state import create_train_state

    cfg = default_config().replace(batch_size=8)
    print("backend:", jax.default_backend(), flush=True)

    scenes = synthetic_scenes(0, cfg, 16)
    gt_all = synthetic_gt_all(scenes)
    scene_iter = [(int(s["data_idx"]), s["points"]) for s in scenes]
    batches = list(batch_scenes(iter(scenes), cfg.batch_size, cfg.max_gt_boxes))

    state = create_train_state(jax.random.PRNGKey(0), cfg, steps_per_epoch=len(batches))
    model = VoteNet(cfg)
    step = jax.jit(make_train_step(model, cfg), donate_argnums=0)
    ev = Evaluator(cfg, gt_all, batch_size=8)

    def eval_map(state):
        predict = make_predict_fn(
            model, {"params": state.params, "batch_stats": state.batch_stats}, cfg
        )
        return ev.evaluate(predict, scene_iter)["mAP"]

    print(f"mAP@0.25 before training: {eval_map(state):.4f}", flush=True)

    t0 = time.perf_counter()
    losses = []
    k = 0
    while k < steps:
        for batch in batches:
            state, metrics = step(state, batch)
            k += 1
            # fetch metrics sparsely — each host fetch syncs the device
            if k % 100 == 0 or k == 1 or k >= steps:
                losses.append(float(metrics["total_cost"]))
                print(
                    f"step {k}: loss {losses[-1]:.4f} "
                    f"obj_acc {float(metrics['obj_accuracy']):.3f} "
                    f"sem_acc {float(metrics['sem_accuracy']):.3f}",
                    flush=True,
                )
            if k >= steps:
                break
    dt = time.perf_counter() - t0
    print(f"trained {steps} steps in {dt:.1f}s ({steps * cfg.batch_size / dt:.1f} scenes/s)")
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    print(f"mAP@0.25 after training (train scenes): {eval_map(state):.4f}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 150)
