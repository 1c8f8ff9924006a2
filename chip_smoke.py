"""Smoke test of VoteNet's main path on NVIDIA GPUs, at full width.

Usage (from the repository root, on a machine with a GPU):

  python chip_smoke.py             # phases a-d on one GPU
  python chip_smoke.py --chips 4   # phase e only: the four-card paths

Phases (one process; every phase prints one line per result):

  a  device: JAX must see GPUs; prints the card's name and power limit,
     the JAX/CUDA versions and XLA_FLAGS.
  b  kernels: the Pallas-Triton FPS and ball-query kernels against the
     numpy oracles (tests/oracles.py) at the model's live shapes, indices
     and counts bit-equal, each timed against its XLA twin.
  c  inference: the full forward + decode + NMS through
     ``votenet_tpu.predictor`` at B=8 and B=1 on seeded synthetic scenes,
     kernels vs XLA twins (both at matmul precision "highest"), the wall
     time of each path at default precision, and NMS at the live shape on
     overlapping boxes against the numpy oracle.
  d  training: ``run_train.main`` in-process (--synthetic, B=8, two
     optimizer steps), checkpoint restore equals the trained state, the
     same step run twice from one state (bit-equal or not), and the step
     time with kernels vs twins.
  e  (--chips 4) a full-width data-parallel train step over four cards vs
     the same global batch on one card (loss and gradients), and the
     dp x sp point-sharded checks on a 2x2 mesh at full width: ball query
     and gather bit-equal, the train step's loss and gradients against
     the data-parallel step.

Any failure raises, so the process exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

SEED = 0
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_call(fn, *args, iters: int = 5) -> float:
    """Median seconds per call after one warm-up (compile) call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def scenes_points(cfg, count: int, seed: int = SEED) -> np.ndarray:
    from votenet_tpu.data.synthetic import synthetic_scenes

    return np.stack([s["points"] for s in synthetic_scenes(seed, cfg, count)])


# --------------------------------------------------------------------- a
def phase_device() -> dict:
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX sees {devices[0].platform} devices"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    for line in smi.splitlines():
        log("a", f"nvidia-smi: {line}")
    import jaxlib

    cuda = getattr(jax.devices()[0].client, "platform_version", "unknown")
    log("a", f"jax {jax.__version__} jaxlib {jaxlib.__version__} cuda {cuda}")
    log("a", f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log("a", f"devices: {len(devices)} x {devices[0].device_kind}")
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


# --------------------------------------------------------------------- b
def phase_kernels() -> None:
    import jax
    import jax.numpy as jnp

    from tests import oracles
    from votenet_tpu.config import default_config
    from votenet_tpu.ops.dispatch import pallas_disabled
    from votenet_tpu.ops.grouping import query_ball_point
    from votenet_tpu.ops.pallas.ballquery import query_ball_point_gpu
    from votenet_tpu.ops.pallas.fps import farthest_point_sample_gpu
    from votenet_tpu.ops.sampling import farthest_point_sample_xla, gather_point

    cfg = default_config()
    pts = scenes_points(cfg, 8)  # (8, 20480, 3) clustered synthetic scenes

    def twin_bq(r, k):
        def f(x1, x2):
            with pallas_disabled():
                return query_ball_point(r, k, x1, x2)
        return f

    # FPS 20480 -> 2048 at B=8 and B=1
    for B in (8, 1):
        x = jnp.asarray(pts[:B])
        npoint = cfg.sa_npoints[0]
        got = np.asarray(farthest_point_sample_gpu(npoint, x))
        want = oracles.fps_oracle(npoint, pts[:B])
        twin = np.asarray(farthest_point_sample_xla(npoint, x))
        if not np.array_equal(got, want):
            raise AssertionError(
                f"FPS B={B}: {int((got != want).sum())} indices differ from the oracle"
            )
        t_k = time_call(lambda a: farthest_point_sample_gpu(npoint, a), x)
        t_x = time_call(lambda a: farthest_point_sample_xla(npoint, a), x)
        log("b", f"fps B={B} N={x.shape[1]}->{npoint}: kernel == oracle (bit-equal); "
                 f"twin mismatches={int((twin != want).sum())}; "
                 f"kernel {t_k * 1e3:.3f} ms, xla twin {t_x * 1e3:.3f} ms")

    # ball query at every live layer, inputs chained through FPS like the model
    layers = []
    xyz = jnp.asarray(pts)
    for i, (m, r, k) in enumerate(zip(cfg.sa_npoints, cfg.sa_radii, cfg.sa_nsamples)):
        q = gather_point(xyz, farthest_point_sample_gpu(m, xyz))
        layers.append((f"sa{i + 1}", r, k, xyz, q))
        xyz = q
    seeds = layers[1][4]  # sa2 output: the 1024 seeds
    votes = seeds + 0.1 * jax.random.normal(jax.random.PRNGKey(SEED), seeds.shape)
    pq = gather_point(votes, farthest_point_sample_gpu(cfg.proposal_num, seeds))
    layers.append(("proposal", cfg.proposal_radius, cfg.proposal_nsample, votes, pq))
    for name, r, k, x1, x2 in layers:
        gi, gc = (np.asarray(a) for a in query_ball_point_gpu(r, k, x1, x2))
        wi, wc = oracles.query_ball_oracle_vec(r, k, np.asarray(x1), np.asarray(x2))
        ti, tc = (np.asarray(a) for a in twin_bq(r, k)(x1, x2))
        if not (np.array_equal(gi, wi) and np.array_equal(gc, wc)):
            raise AssertionError(
                f"ball query {name}: {int((gi != wi).sum())} indices / "
                f"{int((gc != wc).sum())} counts differ from the oracle"
            )
        t_k = time_call(lambda a, b: query_ball_point_gpu(r, k, a, b), x1, x2)
        t_x = time_call(jax.jit(twin_bq(r, k)), x1, x2)
        log("b", f"ball query {name} B={x1.shape[0]} N={x1.shape[1]} M={x2.shape[1]} "
                 f"r={r} K={k}: kernel == oracle (bit-equal), mean count "
                 f"{gc.mean():.2f}; twin mismatches idx={int((ti != wi).sum())} "
                 f"cnt={int((tc != wc).sum())}; kernel {t_k * 1e3:.3f} ms, "
                 f"xla twin {t_x * 1e3:.3f} ms")


# --------------------------------------------------------------------- c
def phase_inference() -> None:
    import jax
    import jax.numpy as jnp

    from votenet_tpu.config import default_config
    from votenet_tpu.models.votenet import VoteNet
    from votenet_tpu.predictor import VoteNetPredictor

    cfg = default_config()
    variables = jax.jit(lambda r, p: VoteNet(cfg).init(r, p, train=False))(
        jax.random.PRNGKey(SEED), jnp.zeros((1, cfg.point_num, 3), jnp.float32)
    )
    # random weights score every proposal as background, which leaves NMS
    # nothing to do: raise the head's objectness logit so all 256
    # proposals are NMS candidates
    head = variables["params"]["proposal"]["mlp2"]
    last = f"dense{len(cfg.proposal_mlp2_hidden)}"
    head[last]["bias"] = head[last]["bias"].at[1].add(20.0)
    for B in (8, 1):
        pts = scenes_points(cfg, B, seed=SEED + 1)
        outs = {}
        for use_pallas in (True, False):
            kw = dict(config=cfg.replace(use_pallas=use_pallas), variables=variables,
                      batch_size=B)
            pred = VoteNetPredictor(**kw)
            with jax.default_matmul_precision("highest"):
                outs[use_pallas] = {k: np.asarray(v) for k, v in pred(pts).items()}
            pred = VoteNetPredictor(**kw)
            t = time_call(pred, pts)
            log("c", f"forward+decode+NMS B={B} {'kernels' if use_pallas else 'xla twins'}: "
                     f"{t * 1e3:.2f} ms/batch, {B / t:.1f} scenes/s (default precision)")
        got, want = outs[True], outs[False]
        for k in ("bboxes", "class_scores", "objectness"):
            if not np.all(np.isfinite(got[k])):
                raise AssertionError(f"B={B}: non-finite {k}")
            # identical indices leave only float reassociation between the
            # two compiled programs, amplified through ~20 f32 layers
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"B={B} {k}")
        bad = int((got["keep"] != want["keep"]).sum())
        if bad:
            raise AssertionError(f"B={B}: {bad} NMS keep-mask entries differ")
        log("c", f"B={B}: kernels vs xla twins at precision=highest: bboxes, "
                 f"class_scores, objectness within rtol=atol=1e-4; keep masks equal "
                 f"({int(got['keep'].sum())} kept); shapes "
                 f"{ {k: v.shape for k, v in got.items()} }")
    nms_vs_oracle(cfg)


def nms_vs_oracle(cfg) -> None:
    """NMS at the live shape (B=8, 256 proposals) against the numpy oracle.

    Random-weight proposals hardly overlap, so the forward's keep masks say
    little about NMS itself; random overlapping boxes do. A keep decision
    may differ from the f64 oracle only through an IoU within 1e-4 of the
    threshold: per scene, the highest-scored differing box must have one,
    and the differences after it are its cascade.
    """
    import jax

    from tests import oracles
    from votenet_tpu.ops import nms3d

    rng = np.random.RandomState(SEED)
    B, N = 8, cfg.proposal_num
    corners = oracles.random_boxes(rng, (B, N))
    scores = rng.rand(B, N).astype(np.float32)
    obj = rng.randn(B, N, 2).astype(np.float32)
    keep = np.asarray(jax.jit(lambda c, s, o: nms3d(c, s, o, cfg.nms_iou))(corners, scores, obj))
    want = oracles.nms3d_oracle(corners, scores, obj, cfg.nms_iou)
    bad_scenes = 0
    for b in range(B):
        diff = np.flatnonzero(keep[b] != want[b])
        if not diff.size:
            continue
        first = diff[np.argmax(scores[b, diff])]
        near = any(
            abs(oracles.shapely_iou3d(corners[b, first], corners[b, j]) - cfg.nms_iou) < 1e-4
            for j in np.flatnonzero(want[b] | keep[b]) if j != first
        )
        if not near:
            raise AssertionError(f"NMS scene {b}: box {first} differs from the oracle "
                                 f"with no IoU near the threshold")
        bad_scenes += 1
    log("c", f"nms3d B={B} N={N} random overlapping boxes vs numpy oracle: "
             f"{int(keep.sum())} of {int((obj[..., 1] > obj[..., 0]).sum())} candidates "
             f"kept, {int((keep != want).sum())} keep entries differ "
             f"({bad_scenes} scenes, each led by an IoU within 1e-4 of {cfg.nms_iou})")


# --------------------------------------------------------------------- d
def phase_training() -> None:
    import jax
    import jax.numpy as jnp

    import run_train
    from votenet_tpu.config import default_config
    from votenet_tpu.data.dataflow import batch_scenes
    from votenet_tpu.data.synthetic import synthetic_scenes
    from votenet_tpu.models.votenet import VoteNet
    from votenet_tpu.ops.dispatch import set_use_pallas
    from votenet_tpu.train.loop import make_train_step
    from votenet_tpu.train.state import create_train_state
    from votenet_tpu.utils import checkpoint as ckpt

    log_dir = os.path.join(OUT_DIR, "smoke_train")
    shutil.rmtree(log_dir, ignore_errors=True)
    final = run_train.main([
        "--synthetic=16", "--batch_size=8", "--max_epoch=1",
        f"--log_dir={log_dir}", f"--seed={SEED}",
    ])
    cfg = default_config(batch_size=8)
    log("d", f"run_train: step {int(final.step)} (2 optimizer steps at B=8, "
             f"N={cfg.point_num})")
    template = create_train_state(jax.random.PRNGKey(SEED + 7), cfg, 2)
    restored, step = ckpt.restore_checkpoint(log_dir, template)
    if step != 1:
        raise AssertionError(f"expected the epoch-1 checkpoint, found {step}")
    for a, b in zip(jax.tree_util.tree_leaves(final), jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    log("d", f"checkpoint round trip: {len(jax.tree_util.tree_leaves(final))} "
             f"leaves bit-equal after restore")
    shutil.rmtree(log_dir, ignore_errors=True)

    batch = next(batch_scenes(iter(synthetic_scenes(SEED + 2, cfg, 8)), 8, cfg.max_gt_boxes))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = VoteNet(cfg)
    step_fn = jax.jit(make_train_step(model, cfg))
    s1, m1 = step_fn(restored, batch)
    s2, m2 = step_fn(restored, batch)
    loss = float(m1["total_cost"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite training loss {loss}")
    leaves1, leaves2 = jax.tree_util.tree_leaves(s1.params), jax.tree_util.tree_leaves(s2.params)
    n_diff = sum(int(not np.array_equal(np.asarray(a), np.asarray(b)))
                 for a, b in zip(leaves1, leaves2))
    max_diff = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(leaves1, leaves2))
    log("d", f"train step loss={loss:.6f} (finite); same step twice from one state: "
             f"{'bit-equal' if n_diff == 0 else 'not bit-equal'}, {n_diff}/"
             f"{len(leaves1)} param leaves differ, max |diff| {max_diff:.3e}")
    for use_pallas in (True, False):
        set_use_pallas(use_pallas)
        fn = jax.jit(make_train_step(model, cfg))
        t = time_call(fn, restored, batch, iters=3)
        log("d", f"train step B=8 {'kernels' if use_pallas else 'xla twins'}: "
                 f"{t * 1e3:.2f} ms, {8 / t:.1f} scenes/s")
    set_use_pallas(True)


# --------------------------------------------------------------------- e
def phase_four_cards() -> None:
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import compare_grads, dp_sp_spot_checks, grad_probe
    from votenet_tpu.config import default_config
    from votenet_tpu.data.dataflow import batch_scenes
    from votenet_tpu.data.synthetic import synthetic_scenes
    from votenet_tpu.models.votenet import VoteNet
    from votenet_tpu.train.loop import make_train_step
    from votenet_tpu.train.state import create_train_state

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--chips 4 needs four GPUs, JAX sees {len(devices)}")
    devices = devices[:4]
    cfg = default_config(batch_size=8)
    state = create_train_state(jax.random.PRNGKey(SEED), cfg, 2)
    batch = next(batch_scenes(iter(synthetic_scenes(SEED + 2, cfg, 8)), 8, cfg.max_gt_boxes))
    pts = scenes_points(cfg, 2, seed=SEED + 3)
    # every step at precision "highest": what is left between them is the
    # order of the batch-norm and gradient sums across cards
    with jax.default_matmul_precision("highest"):
        # the data-parallel step over 4 cards (2 scenes each) is the
        # reference of the dp x sp step on the 2x2 mesh (4 scenes per data
        # row, sa1's cloud split over 2 cards), both at full width
        checks, (s4, m4) = dp_sp_spot_checks(
            devices, cfg, pts, cfg.sa_npoints[0], cfg.sa_radii[0],
            cfg.sa_nsamples[0], state, batch,
        )
        one = jax.device_put(grad_probe(state), devices[0])
        s1, m1 = jax.jit(make_train_step(VoteNet(cfg), cfg))(
            one, {k: jax.device_put(jnp.asarray(v), devices[0]) for k, v in batch.items()}
        )
    l1, l4 = float(m1["total_cost"]), float(m4["total_cost"])
    if not abs(l1 - l4) <= 1e-4 * max(1.0, abs(l1)):
        raise AssertionError(f"DP loss {l4} vs one-card loss {l1}")
    # Adam's first step moves each entry by about lr * sign(grad), whatever
    # the gradient's size: the gradients carry the check, the params only
    # show that both updates ran (max |diff| <= 2*lr, mean |diff| <= 0.1*lr)
    grads = compare_grads(s1.opt_state[1], s4.opt_state[1])
    lr = cfg.base_lr
    d = np.concatenate([
        np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
        for a, b in zip(jax.tree_util.tree_leaves(s1.params),
                        jax.tree_util.tree_leaves(s4.params))
    ])
    if d.max() > 2 * lr * 1.01 or d.mean() > 0.1 * lr:
        raise AssertionError(f"DP params: max |diff| {d.max():.3e}, mean {d.mean():.3e}")
    log("e", f"DP train step on 4 cards (2 scenes each) vs 1 card, B=8 "
             f"N={cfg.point_num}, precision=highest: loss {l4:.6f} vs {l1:.6f} "
             f"(bound 1e-4 rel); {grads}; params after Adam max |diff| "
             f"{d.max():.3e}, mean {d.mean():.3e}")
    for line in checks:
        log("e", line)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = parser.parse_args(argv)

    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.getcwd())
    from votenet_tpu.utils.compile_cache import setup_compile_cache

    log("a", f"compile cache: {setup_compile_cache()}")
    device = phase_device()
    if args.chips == 4:
        phase_four_cards()
    else:
        phase_kernels()
        phase_inference()
        phase_training()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
