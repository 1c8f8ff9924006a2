"""Single-GPU point-count scaling: full forward at N far beyond 20480.

SURVEY §5 names point count as this model's "long-context" axis. On a GPU
FPS and the ball query are the Pallas-Triton kernels, which stream any N;
three_nn (and the ball query's XLA twin, ``--use_pallas=False``) stream in
blocks when their dense (B, M, N) intermediates exceed
``ops.common.dense_bytes_budget()`` (byte-based, so small batches keep the
dense path far longer). This measures forward scenes/s (and ms/scene) at
N = 20480 .. 163840, B=2, fixed proposal count.

Usage: python benchmarks/large_n_scaling.py [--use_pallas=False]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

B = int(os.environ.get("BENCH_BATCH", "2"))


def main(argv=None):
    from votenet_tpu.config import config_from_args
    from votenet_tpu.models.decode import predict_boxes
    from votenet_tpu.models.votenet import VoteNet
    from votenet_tpu.ops import common as C
    from votenet_tpu.ops.dispatch import apply_config
    from votenet_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    base = config_from_args(argv)
    apply_config(base)
    rng = np.random.RandomState(0)
    for n in (20480, 40960, 81920, 163840):
        cfg = base.replace(point_num=n)
        model = VoteNet(cfg)
        pts0 = jnp.zeros((1, n, 3), jnp.float32)
        variables = jax.jit(lambda r, p: model.init(r, p, train=False))(
            jax.random.PRNGKey(0), pts0
        )

        @jax.jit
        def predict(points):
            end_points = model.apply(variables, points, train=False)
            return predict_boxes(end_points, cfg)["keep"]

        pts = jnp.asarray(rng.uniform(-4, 4, (B, n, 3)).astype(np.float32))
        jax.block_until_ready(predict(pts))  # compile + warm
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(predict(pts))
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        mode = (
            "streaming"
            if C.bq_dense_bytes(B, cfg.sa_npoints[0], n) > C.dense_bytes_budget()
            else "dense"
        )
        print(
            f"N={n:6d} (twin bq {mode:9s}): {B/dt:7.2f} scenes/s, "
            f"{dt/B*1e3:7.2f} ms/scene, {dt*1e3:7.2f} ms/batch",
            flush=True,
        )


if __name__ == "__main__":
    main(sys.argv[1:])
