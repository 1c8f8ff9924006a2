"""gather_packing="bf16_hilo": packed SA-layer gather transport tests.

The opt-in packs the train-path fused [xyz ‖ feat] gather table as bf16 —
coordinates as Dekker-style hi+lo bf16 pairs, features bf16-rounded — to
halve the sa2+ grouped-tensor bytes (ops/dispatch.py gather_packing).
Compute stays f32; these tests pin the contract:

- hi+lo reconstruction is sub-0.1 mm exact at room scale,
- the eval path is UNTOUCHED (bit-identical to default mode),
- checkpoints interchange (identical param trees),
- the train step runs with finite loss and f32 params, outputs close to
  the unpacked path (bf16 feature transport only),
- bf16 cotangents take the single-pass scatter (exact for bf16 payloads).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from votenet_tpu.models.votenet import VoteNet
from votenet_tpu.ops import dispatch
from tests.test_end2end import tiny_config

pytestmark = pytest.mark.slow  # see pytest.ini; fast lane = -m 'not slow'


@contextlib.contextmanager
def packing(mode):
    prev = dispatch.gather_packing()
    dispatch.set_gather_packing(mode)
    try:
        yield
    finally:
        dispatch.set_gather_packing(prev)


def test_hilo_reconstruction_submillimeter(rng):
    x = jnp.asarray(rng.uniform(-8.0, 8.0, size=(4096, 3)), jnp.float32)
    hi = x.astype(jnp.bfloat16)
    lo = (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    rec = hi.astype(jnp.float32) + lo.astype(jnp.float32)
    # two bf16 terms carry ~17 mantissa bits: |err| <= 2^-18 * |x| ~ 3e-5 m
    assert float(jnp.max(jnp.abs(rec - x))) < 1e-4


def test_config_validation():
    with pytest.raises(ValueError):
        dispatch.set_gather_packing("bogus")


def test_param_tree_identical(rng):
    cfg = tiny_config()
    pts = jnp.zeros((1, cfg.point_num, 3), jnp.float32)
    v0 = VoteNet(cfg).init(jax.random.PRNGKey(0), pts, train=False)
    with packing("bf16_hilo"):
        v1 = VoteNet(cfg).init(jax.random.PRNGKey(0), pts, train=False)
    p0 = jax.tree_util.tree_leaves_with_path(v0["params"])
    p1 = jax.tree_util.tree_leaves_with_path(v1["params"])
    assert [(jax.tree_util.keystr(k), l.shape, l.dtype) for k, l in p0] == [
        (jax.tree_util.keystr(k), l.shape, l.dtype) for k, l in p1
    ]


def test_eval_path_bit_identical(rng):
    """Packing is a TRAIN transport lever; inference must not change."""
    cfg = tiny_config()
    pts = jnp.asarray(rng.randn(2, cfg.point_num, 3), jnp.float32)
    m = VoteNet(cfg)
    v = m.init(jax.random.PRNGKey(0), pts, train=False)
    out0 = m.apply(v, pts, train=False)
    with packing("bf16_hilo"):
        out1 = m.apply(v, pts, train=False)
    for k in out0:
        np.testing.assert_array_equal(np.asarray(out0[k]), np.asarray(out1[k]))


def test_train_forward_close_xyz_chain_exact(rng):
    """Same params: the packed train forward agrees loosely on features
    (bf16 transport) and EXACTLY on the coordinate chain (FPS/queries read
    the raw f32 cloud; sa1 has no feature table to pack)."""
    cfg = tiny_config()
    pts = jnp.asarray(rng.randn(2, cfg.point_num, 3), jnp.float32)
    m = VoteNet(cfg)
    v = m.init(jax.random.PRNGKey(0), pts, train=True)
    out0, _ = m.apply(v, pts, train=True, mutable=["batch_stats"])
    with packing("bf16_hilo"):
        out1, _ = m.apply(v, pts, train=True, mutable=["batch_stats"])
    np.testing.assert_array_equal(
        np.asarray(out0["seeds_xyz"]), np.asarray(out1["seeds_xyz"])
    )
    a = np.asarray(out0["proposals_output"])
    b = np.asarray(out1["proposals_output"])
    assert np.isfinite(b).all()
    # bf16 feature transport flips near-tie max-pool winners (the discrete
    # pool-flip mechanism, DESIGN.md mixed-precision post-mortem), so the
    # head deviation is larger than the 0.4% payload rounding — bound it
    # loosely; divergence/NaN is the failure mode this guards
    denom = np.maximum(np.abs(a), 1.0)
    assert np.median(np.abs(a - b) / denom) < 0.3


def test_train_step_runs_and_params_stay_f32(rng):
    from votenet_tpu.data.dataflow import batch_scenes
    from votenet_tpu.data.synthetic import synthetic_scenes
    from votenet_tpu.train.loop import make_train_step
    from votenet_tpu.train.state import create_train_state

    cfg = tiny_config().replace(batch_size=2)
    batch = next(iter(batch_scenes(
        iter(synthetic_scenes(0, cfg, 2)), cfg.batch_size, cfg.max_gt_boxes
    )))
    state = create_train_state(jax.random.PRNGKey(0), cfg, 1)
    model = VoteNet(cfg)
    with packing("bf16_hilo"):
        state1, metrics1 = jax.jit(make_train_step(model, cfg))(state, batch)
        cost1 = float(metrics1["total_cost"])
    assert np.isfinite(cost1)
    for leaf in jax.tree_util.tree_leaves(state1.params):
        assert leaf.dtype == jnp.float32
    # the loss agrees with the unpacked step (transport rounding only; the
    # per-param first Adam step is sign-dominated ±lr and NOT comparable
    # elementwise — gradient agreement is asserted norm-wise below)
    _, metrics0 = jax.jit(make_train_step(model, cfg))(state, batch)
    np.testing.assert_allclose(cost1, float(metrics0["total_cost"]), rtol=2e-2)


def test_gradients_agree_normwise(rng):
    """Packed-transport gradients stay aligned with the f32 gradients:
    global-norm ratio ~1 and high cosine similarity (sign flips of
    near-zero entries are expected; rotation/divergence is not)."""
    from votenet_tpu.data.dataflow import batch_scenes
    from votenet_tpu.data.synthetic import synthetic_scenes
    from votenet_tpu.models.losses import votenet_loss
    from votenet_tpu.train.loop import GT_KEYS
    from votenet_tpu.train.state import create_train_state

    cfg = tiny_config().replace(batch_size=2)
    batch = next(iter(batch_scenes(
        iter(synthetic_scenes(0, cfg, 2)), cfg.batch_size, cfg.max_gt_boxes
    )))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    gt = {k: batch[k] for k in GT_KEYS}
    state = create_train_state(jax.random.PRNGKey(0), cfg, 1)
    model = VoteNet(cfg)

    def loss_fn(params):
        ep, _ = model.apply(
            {"params": params, "batch_stats": state.batch_stats},
            batch["points"], train=True, mutable=["batch_stats"],
        )
        return votenet_loss(ep, gt, cfg, "reference").total

    g0 = jax.jit(jax.grad(loss_fn))(state.params)
    with packing("bf16_hilo"):
        g1 = jax.jit(jax.grad(loss_fn))(state.params)
    v0 = np.concatenate([np.asarray(l).ravel() for l in jax.tree_util.tree_leaves(g0)])
    v1 = np.concatenate([np.asarray(l).ravel() for l in jax.tree_util.tree_leaves(g1)])
    assert np.isfinite(v1).all()
    n0, n1 = np.linalg.norm(v0), np.linalg.norm(v1)
    # at the tiny test scale a flipped max-pool winner reroutes a whole
    # feature-vector's gradient and train-mode BN feeds the shift back
    # into every downstream layer, so real-input agreement is loose
    # (measured: norm ratio 0.887, cos 0.83 at init). These bounds guard
    # against lost/exploding gradient paths; exact plumbing is proven by
    # test_gradients_exact_for_bf16_representable_inputs below, and the
    # convergence arbiter is a training-curve A/B (benchmarks/bf16_curve.py
    # packed mode, DESIGN.md).
    assert 0.75 < n1 / n0 < 1.3, (n0, n1)
    cos = float(v0 @ v1 / (n0 * n1))
    assert cos > 0.75, cos


def test_layer_gradients_exact_for_bf16_representable_inputs(rng):
    """Controlled experiment at the layer level: feed ONE SA module inputs
    that are already exactly representable in bf16 (hi = x exactly, lo = 0,
    features round-trip bit-exact), so the packed transport is
    VALUE-LOSSLESS forward and packed-vs-default may differ only by the
    split-vs-fused CenteredDense reassociation (~1e-6) plus bf16 rounding
    of the backward COTANGENT (the one unavoidable transport effect). This
    pins the gather/skip-prefix/recon/scatter plumbing without the
    pool-flip noise the full-model normwise test tolerates."""
    from votenet_tpu.models.pointnet2 import PointNetSAModule

    B, N, Cf = 2, 128, 16
    xyz = jnp.asarray(rng.randn(B, N, 3), jnp.float32)
    xyz = xyz.astype(jnp.bfloat16).astype(jnp.float32)
    feats = jnp.asarray(rng.randn(B, N, Cf), jnp.float32)
    feats = feats.astype(jnp.bfloat16).astype(jnp.float32)

    mod = PointNetSAModule(
        npoint=32, radius=0.6, nsample=8, mlp=(16, 16), coord_grad=False
    )
    v = mod.init(jax.random.PRNGKey(0), xyz, feats, train=True)

    def loss_fn(params):
        out, _ = mod.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            xyz, feats, train=True, mutable=["batch_stats"],
        )
        _, new_points, _ = out
        return jnp.sum(new_points**2)

    g0 = jax.jit(jax.grad(loss_fn))(v["params"])
    with packing("bf16_hilo"):
        g1 = jax.jit(jax.grad(loss_fn))(v["params"])
    v0 = np.concatenate([np.asarray(l).ravel() for l in jax.tree_util.tree_leaves(g0)])
    v1 = np.concatenate([np.asarray(l).ravel() for l in jax.tree_util.tree_leaves(g1)])
    n0 = np.linalg.norm(v0)
    assert np.linalg.norm(v1 - v0) / n0 < 1e-2
    cos = float(v0 @ v1 / (n0 * np.linalg.norm(v1)))
    assert cos > 0.9999, cos


def test_apply_config_plumbs_gather_packing():
    from votenet_tpu.config import default_config

    cfg = default_config().replace(gather_packing="bf16_hilo")
    prev = dispatch.gather_packing()
    try:
        dispatch.apply_config(cfg)
        assert dispatch.gather_packing() == "bf16_hilo"
    finally:
        dispatch.set_gather_packing(prev)
