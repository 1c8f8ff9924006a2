#!/usr/bin/env python
"""Benchmark harness for one NVIDIA GPU. Default: end-to-end inference
scenes/s on full-size VoteNet (20480 points, backbone + voting + proposal +
decode + 3D NMS) at B=8, plus the B=8 train step, printed as ONE JSON line.

Sub-benchmarks:
  python bench.py sa_layer     # first SA layer (µs)
  python bench.py fps          # farthest-point sampling 20480 -> 2048 (µs)
  python bench.py ball_query   # ball query 20480 x 2048, r=0.2, K=64 (µs)
  python bench.py train_step   # full training step (scenes/s)

Every result names the device; a run that finds no GPU, or a GPU missing
from the peak table, fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BATCH = int(os.environ.get("BENCH_BATCH", "8"))

# Published dense peaks by jax device_kind (NVIDIA H100 data sheet, SXM
# part, at its 700 W limit): FLOP/s in bf16 and TF32 tensor-core math, and
# HBM bytes/s. MFU is model FLOP/s over the bf16 peak, the usual convention;
# the model's f32 matmuls run as TF32 at default precision.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12, "hbm": 3.35e12},
}


def _device():
    """(device_kind, peaks, card) of the default device; errors off-GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX sees {dev.platform} devices")
    if dev.device_kind not in _PEAKS:
        raise SystemExit(f"no peak table entry for device {dev.device_kind!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return dev.device_kind, _PEAKS[dev.device_kind], card


def _timeit(fn, iters=10, warmup=2):
    """Median seconds per call; each call ends in block_until_ready."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _cost_analysis(jitted, *args):
    """(flops, bytes accessed) of a compiled jit per XLA's own accounting."""
    compiled = jitted.lower(*args).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0] if ca else {}
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def _twin_cost_analysis(fn, *args):
    """Cost analysis of the pure-XLA twin of ``fn``: XLA cannot see inside
    the Pallas custom calls, so the model FLOPs are read off the same
    computation with every kernel replaced by its XLA twin."""
    import jax

    from votenet_tpu.ops.dispatch import pallas_disabled

    with pallas_disabled():
        # fresh lambda: jit's cache is keyed on the function object
        return _cost_analysis(jax.jit(lambda *a: fn(*a)), *args)


def _build_predict(batch_size: int):
    import jax
    import jax.numpy as jnp

    from votenet_tpu.config import default_config
    from votenet_tpu.models.decode import predict_boxes
    from votenet_tpu.models.votenet import VoteNet

    cfg = default_config()
    model = VoteNet(cfg)
    pts0 = jnp.zeros((1, cfg.point_num, 3), jnp.float32)
    variables = jax.jit(lambda r, p: model.init(r, p, train=False))(
        jax.random.PRNGKey(0), pts0
    )

    def predict_raw(points):
        end_points = model.apply(variables, points, train=False)
        pred = predict_boxes(end_points, cfg)
        return pred["bboxes"], pred["class_scores"], pred["keep"]

    rng = np.random.RandomState(0)
    pts = rng.uniform(-4, 4, (batch_size, cfg.point_num, 3)).astype(np.float32)
    return jax.jit(predict_raw), jnp.asarray(pts), predict_raw


def _measure_inference():
    predict, pts, predict_raw = _build_predict(BATCH)
    dt = _timeit(lambda: predict(pts))
    flops, _ = _twin_cost_analysis(predict_raw, pts)
    return BATCH / dt, dt, flops


def _measure_train_step():
    import jax
    import jax.numpy as jnp

    from votenet_tpu.config import default_config
    from votenet_tpu.data.dataflow import batch_scenes
    from votenet_tpu.data.synthetic import synthetic_scenes
    from votenet_tpu.models.votenet import VoteNet
    from votenet_tpu.ops.dispatch import apply_config
    from votenet_tpu.train.loop import make_train_step
    from votenet_tpu.train.state import create_train_state

    cfg = default_config(batch_size=BATCH)
    apply_config(cfg)
    state = create_train_state(jax.random.PRNGKey(0), cfg, steps_per_epoch=100)
    step_fn = make_train_step(VoteNet(cfg), cfg)
    batch = next(iter(batch_scenes(
        iter(synthetic_scenes(0, cfg, cfg.batch_size)), cfg.batch_size, cfg.max_gt_boxes
    )))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(step_fn)
    dt = _timeit(lambda: step(state, batch), iters=5, warmup=2)
    flops, _ = _twin_cost_analysis(step_fn, state, batch)
    return BATCH / dt, dt, flops


def bench_inference():
    kind, peaks, card = _device()
    scenes_per_sec, dt_inf, flops_inf = _measure_inference()
    train_sps, dt_tr, flops_tr = _measure_train_step()

    def _mfu(flops, dt):
        return round(flops / dt / peaks["bf16"], 4) if flops and dt else None

    print(json.dumps({
        "metric": "sunrgbd_inference_scenes_per_sec",
        "value": round(scenes_per_sec, 3),
        "unit": "scenes/s",
        "batch": BATCH,
        "train_step_scenes_per_sec": round(train_sps, 3),
        "device": kind,
        "card": card,  # nvidia-smi name, power limit
        "tflops": round(flops_inf / dt_inf / 1e12, 3) if flops_inf else None,
        "mfu": _mfu(flops_inf, dt_inf),
        "train_tflops": round(flops_tr / dt_tr / 1e12, 3) if flops_tr else None,
        "train_mfu": _mfu(flops_tr, dt_tr),
    }))


def bench_sa_layer():
    """First SA layer (FPS 20480->2048, ball query r=0.2 K=64, MLP, pool)."""
    import jax
    import jax.numpy as jnp

    from votenet_tpu.config import default_config
    from votenet_tpu.models.pointnet2 import PointNetSAModule

    kind, _, card = _device()
    cfg = default_config()
    mod = PointNetSAModule(
        npoint=2048, radius=0.2, nsample=64, mlp=(64, 64, 128), name="sa1"
    )
    rng = np.random.RandomState(0)
    xyz = jnp.asarray(rng.uniform(-4, 4, (BATCH, cfg.point_num, 3)), jnp.float32)
    variables = jax.jit(lambda r: mod.init(r, xyz, xyz, train=False))(jax.random.PRNGKey(0))
    fn = jax.jit(lambda x: mod.apply(variables, x, x, train=False)[1])
    dt = _timeit(lambda: fn(xyz))
    print(json.dumps({"metric": "sa_layer_us", "value": round(dt * 1e6, 1),
                      "unit": "us", "device": kind, "card": card}))


def bench_fps():
    import jax
    import jax.numpy as jnp

    from votenet_tpu.ops import farthest_point_sample

    kind, _, card = _device()
    rng = np.random.RandomState(0)
    xyz = jnp.asarray(rng.uniform(-4, 4, (BATCH, 20480, 3)), jnp.float32)
    fn = jax.jit(lambda x: farthest_point_sample(2048, x))
    dt = _timeit(lambda: fn(xyz))
    print(json.dumps({"metric": "fps_20480_to_2048_us", "value": round(dt * 1e6, 1),
                      "unit": "us", "device": kind, "card": card}))


def bench_ball_query():
    import jax
    import jax.numpy as jnp

    from votenet_tpu.ops import query_ball_point

    kind, _, card = _device()
    rng = np.random.RandomState(0)
    xyz = jnp.asarray(rng.uniform(-4, 4, (BATCH, 20480, 3)), jnp.float32)
    q = xyz[:, :2048]
    fn = jax.jit(lambda a, b: query_ball_point(0.2, 64, a, b))
    dt = _timeit(lambda: fn(xyz, q))
    print(json.dumps({"metric": "ball_query_20480x2048_us", "value": round(dt * 1e6, 1),
                      "unit": "us", "device": kind, "card": card}))


def bench_train_step():
    kind, peaks, card = _device()
    sps, dt, flops = _measure_train_step()
    tf = flops / dt if flops else None
    print(json.dumps({"metric": "train_step_scenes_per_sec", "value": round(sps, 3),
                      "unit": "scenes/s", "device": kind, "card": card,
                      "tflops": round(tf / 1e12, 3) if tf else None,
                      "mfu": round(tf / peaks["bf16"], 4) if tf else None}))


if __name__ == "__main__":
    from votenet_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    which = sys.argv[1] if len(sys.argv) > 1 else "inference"
    {
        "inference": bench_inference,
        "sa_layer": bench_sa_layer,
        "fps": bench_fps,
        "ball_query": bench_ball_query,
        "train_step": bench_train_step,
    }[which]()
