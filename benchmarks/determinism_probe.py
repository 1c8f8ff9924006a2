"""Is the training step bit-reproducible on a GPU, and which ops break it?

At full width (``default_config()``, B=8, seeded synthetic scenes, random
weights), from one state, each pair below is computed twice in one process
and reported as bit-equal or not:

  gather grad   the VJP of the group gather at sa1's shape (B=8, 20480
                points, 2048 x 64 ball-query indices): XLA's scatter-add
  train step    one optimizer step, params compared leaf by leaf
  third loss    two steps, then the loss of a third (what a run that
                diverged early reads later)

Run it as is and with XLA's deterministic ops, each in its own process
(XLA_FLAGS is read when the backend starts):

  python benchmarks/determinism_probe.py
  XLA_FLAGS=--xla_gpu_deterministic_ops=true python benchmarks/determinism_probe.py

The Pallas kernels are the same in both runs; the flag changes only how
XLA lowers its own ops.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def bit_equal(a, b) -> tuple:
    import jax

    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    n_diff = sum(int(not np.array_equal(np.asarray(x), np.asarray(y))) for x, y in zip(la, lb))
    worst = max(float(np.max(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))))
                for x, y in zip(la, lb))
    return n_diff, len(la), worst


def main() -> None:
    import jax
    import jax.numpy as jnp

    from votenet_tpu.config import default_config
    from votenet_tpu.data.dataflow import batch_scenes
    from votenet_tpu.data.synthetic import synthetic_scenes
    from votenet_tpu.models.votenet import VoteNet
    from votenet_tpu.ops import farthest_point_sample, gather_point, group_point, query_ball_point
    from votenet_tpu.train.loop import make_train_step
    from votenet_tpu.train.state import create_train_state
    from votenet_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    dev = jax.devices()[0]
    print(f"device {dev.device_kind}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    cfg = default_config(batch_size=8)
    batch = next(batch_scenes(iter(synthetic_scenes(2, cfg, 8)), 8, cfg.max_gt_boxes))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def report(name, a, b):
        n_diff, n, worst = bit_equal(a, b)
        print(f"{name}: {'bit-equal' if n_diff == 0 else 'not bit-equal'} "
              f"({n_diff}/{n} leaves differ, max |diff| {worst:.3e})", flush=True)

    xyz = batch["points"]
    q = gather_point(xyz, farthest_point_sample(cfg.sa_npoints[0], xyz))
    idx, _ = query_ball_point(cfg.sa_radii[0], cfg.sa_nsamples[0], xyz, q)
    ct = jax.random.normal(jax.random.PRNGKey(1), idx.shape + (3,))
    gather_grad = jax.jit(lambda x, i, c: jax.vjp(lambda y: group_point(y, i), x)[1](c)[0])
    report("gather grad", gather_grad(xyz, idx, ct), gather_grad(xyz, idx, ct))

    state = create_train_state(jax.random.PRNGKey(0), cfg, 2)
    step = jax.jit(make_train_step(VoteNet(cfg), cfg))
    s_a, _ = step(state, batch)
    s_b, _ = step(state, batch)
    report("train step", s_a.params, s_b.params)
    s_a, _ = step(s_a, batch)
    s_b, _ = step(s_b, batch)
    l_a = float(step(s_a, batch)[1]["total_cost"])
    l_b = float(step(s_b, batch)[1]["total_cost"])
    print(f"third loss: {l_a:.6f} vs {l_b:.6f} "
          f"({'equal' if l_a == l_b else 'differ'})", flush=True)


if __name__ == "__main__":
    main()
