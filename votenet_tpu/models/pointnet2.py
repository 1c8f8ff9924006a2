"""PointNet++ set-abstraction / feature-propagation modules.

Rebuilds the reference layer library (``/root/reference/utils.py``) on top of
the fixed-shape ops in :mod:`votenet_tpu.ops`. The reference's 1x1
``Conv2D`` + tensorpack ``BNReLU`` stacks become Dense layers on the channel
axis (identical math; a 1x1 NHWC conv is a per-position matmul) with
BatchNorm configured to tensorpack defaults (momentum 0.9, eps 1e-5); the
layers are :mod:`votenet_tpu.models.layers`.

Reference mapping:
- :func:`sample_and_group`      <- utils.py:25-61 (incl. the ``sample_xyz``
  cross-cloud FPS used by the proposal module, utils.py:42-43)
- :func:`sample_and_group_all`  <- utils.py:64-90
- :class:`PointNetSAModule`     <- utils.py:93-158
- :class:`PointNetSAModuleMSG`  <- utils.py:161-201 (unused by the model,
  kept for API completeness — SURVEY §2 "known reference quirks")
- :class:`PointNetFPModule`     <- utils.py:266-294
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh

from votenet_tpu import ops
from votenet_tpu.models.layers import BatchNorm, Dense, Module, he_normal, relu

BN_MOMENTUM = 0.9
BN_EPS = 1e-5

class CenteredDense(Module):
    """Dense layer with the grouped-xyz center-subtract folded in.

    ``(g - pad(center)) @ W + b == g @ W - center @ W[:3] + b`` — moving the
    subtract after the matmul keeps the narrow (..., 3)-shaped centered
    tensor from ever materializing. The identity is exact
    real math but reassociates the float computation: outputs differ from
    the explicit centered path by matmul rounding (equivalence tests use
    rtol≈2e-2 at meter-scale inputs) — do not expect bitwise-equal evals
    between fused and non-fused checkpoints. Parameter names/shapes match
    :class:`~votenet_tpu.models.layers.Dense` exactly, so checkpoints are
    interchangeable.
    """

    features: int
    dtype: jnp.dtype = jnp.float32

    def __call__(
        self,
        g_raw,
        center: jnp.ndarray,
        idx: Optional[jnp.ndarray] = None,
    ) -> jnp.ndarray:
        """Without ``idx``: g_raw is the grouped (B, M, S, Cin) tensor.

        With ``idx`` (B, M, S): g_raw is the UNGROUPED per-point (B, N, Cin)
        tensor — the layer projects all N points first and gathers the wide
        (features,)-rows afterwards. ``gather ∘ dense == dense ∘ gather``
        (the dense is per-point linear), so the gather/dense commute is
        per-element identical — note the CenteredDense fold itself
        (either order) reassociates ``(g - pad(c)) @ W`` into
        ``g @ W - c @ W[:3]``, which is exact math up to float
        reassociation/matmul rounding, NOT bitwise equal to an explicit
        centered-then-matmul path. The gather meanwhile moves from
        Cin-float rows (12 bytes at sa1 — far
        below a memory sector) to `features`-float rows, and the matmul
        runs over N unique points instead of M*S grouped duplicates.

        Mixed precision: ``g_raw`` may instead be an ``(xyz_src, feat_src)``
        TUPLE (the split path, Config.mixed_precision). Coordinates travel
        f32 end-to-end — the kernel's first 3 rows contract against f32 xyz
        and the f32 center, and the cancellation-sensitive
        ``g_xyz@W3 - c@W3`` subtraction happens in f32 BEFORE any cast —
        while the wide feature operand runs in ``self.dtype`` (bf16):
        feature gathers/matmuls move half the memory bytes. The
        absolute-coordinate quantization that broke
        bf16-everywhere training (DESIGN.md bf16 post-mortem) cannot occur
        here by construction.
        """
        if isinstance(g_raw, tuple):
            return self._split_call(g_raw, center, idx)
        kernel = self.param(
            "kernel", he_normal, (g_raw.shape[-1], self.features), jnp.float32
        )
        bias = self.param("bias", jax.nn.initializers.zeros, (self.features,), jnp.float32)
        g_raw, center, kernel, bias = (
            a.astype(self.dtype) for a in (g_raw, center, kernel, bias)
        )
        h = g_raw @ kernel
        if idx is not None:
            h = ops.group_point(h, idx)  # (B, M, S, features)
        corr = center @ kernel[:3]  # (B, M, features)
        return h - corr[:, :, None, :] + bias

    def _split_call(self, srcs, center, idx):
        """Mixed-precision path: f32 coordinates, self.dtype (bf16) features.

        srcs = (xyz_src, feat_src). With ``idx``: per-point (B, N, 3)/(B, N,
        Cf) sources, features projected before the gather. Without: already
        grouped (B, M, S, 3)/(B, M, S, Cf). Same parameters as the fused
        path (one (3+Cf, features) kernel), so checkpoints stay
        interchangeable across modes.
        """
        xyz_src, feat_src = srcs
        cin = 3 + feat_src.shape[-1]
        kernel = self.param("kernel", he_normal, (cin, self.features), jnp.float32)
        bias = self.param("bias", jax.nn.initializers.zeros, (self.features,), jnp.float32)
        k_xyz = kernel[:3]  # f32
        k_feat = kernel[3:].astype(self.dtype)
        feat_src = feat_src.astype(self.dtype)
        if idx is not None:
            h_feat = ops.group_point(feat_src @ k_feat, idx)  # wide, bf16
            g_xyz = ops.group_point(xyz_src, idx)  # narrow, f32
        else:
            h_feat = feat_src @ k_feat
            g_xyz = xyz_src
        # exact f32 geometry: (g_xyz - c) @ W3, folded; cast only AFTER the
        # subtraction (the centered offsets are small-scale — bf16-safe)
        h_xyz = g_xyz @ k_xyz - (center @ k_xyz)[:, :, None, :]
        return h_xyz.astype(self.dtype) + h_feat + bias.astype(self.dtype)


class MLPStack(Module):
    """Shared per-point MLP: Dense + BN + ReLU per width.

    ``final_activation=False`` leaves the last layer linear (the reference's
    mlp2 stacks end with ``activation=None``, utils.py:153). When ``center``
    is passed, the first layer is a :class:`CenteredDense` consuming the
    *uncentered* grouped tensor (same math as centering first, post-matmul).
    """

    widths: Sequence[int]
    final_activation: bool = True
    use_bn: bool = True
    dtype: jnp.dtype = jnp.float32
    bn_momentum: float = BN_MOMENTUM
    bn_eps: float = BN_EPS

    def __call__(
        self,
        x,
        train: bool,
        center: Optional[jnp.ndarray] = None,
        idx: Optional[jnp.ndarray] = None,
    ):
        for i, w in enumerate(self.widths):
            last = i == len(self.widths) - 1
            if i == 0 and center is not None:
                x = CenteredDense(w, dtype=self.dtype, name="dense0")(x, center, idx)
            else:
                x = Dense(w, dtype=self.dtype, name=f"dense{i}")(x)
            if self.final_activation or not last:
                if self.use_bn:
                    x = BatchNorm(
                        use_running_average=not train,
                        momentum=self.bn_momentum,
                        epsilon=self.bn_eps,
                        dtype=self.dtype,
                        name=f"bn{i}",
                    )(x)
                x = relu(x)
        return x


def sample_and_group(
    npoint: int,
    radius: float,
    nsample: int,
    xyz: jnp.ndarray,
    points: Optional[jnp.ndarray],
    knn: bool = False,
    use_xyz: bool = True,
    sample_xyz: Optional[jnp.ndarray] = None,
):
    """FPS -> gather -> ball query (or kNN) -> group -> center-subtract.

    Mirrors reference utils.py:25-61. When ``sample_xyz`` is given, FPS runs
    on that cloud while gathering from ``xyz`` (the proposal module samples
    votes at seed-FPS locations, utils.py:42-43).

    Returns (new_xyz (B,npoint,3), new_points (B,npoint,nsample,C'),
    idx (B,npoint,nsample), grouped_xyz).
    """
    fps_src = sample_xyz if sample_xyz is not None else xyz
    new_xyz = ops.gather_point(xyz, ops.farthest_point_sample(npoint, fps_src))
    if knn:
        _, idx = ops.knn_point(nsample, xyz, new_xyz)
    else:
        idx, _ = ops.query_ball_point(radius, nsample, xyz, new_xyz)
    if points is not None:
        # single fused gather of [xyz ‖ features] (one wide gather instead
        # of two)
        both = ops.group_point(jnp.concatenate([xyz, points], axis=-1), idx)
        grouped_xyz = both[..., :3] - new_xyz[:, :, None, :]
        grouped_points = both[..., 3:]
        if use_xyz:
            new_points = jnp.concatenate([grouped_xyz, grouped_points], axis=-1)
        else:
            new_points = grouped_points
    else:
        grouped_xyz = ops.group_point(xyz, idx) - new_xyz[:, :, None, :]
        new_points = grouped_xyz
    return new_xyz, new_points, idx, grouped_xyz


def sample_and_group_all(xyz: jnp.ndarray, points: Optional[jnp.ndarray], use_xyz: bool = True):
    """Single group of all points centered at the origin (utils.py:64-90)."""
    B, N, _ = xyz.shape
    new_xyz = jnp.zeros((B, 1, 3), dtype=xyz.dtype)
    idx = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, None, :], (B, 1, N))
    grouped_xyz = xyz[:, None, :, :]
    if points is not None:
        new_points = jnp.concatenate([xyz, points], axis=-1) if use_xyz else points
        new_points = new_points[:, None, :, :]
    else:
        new_points = grouped_xyz
    return new_xyz, new_points, idx, grouped_xyz


class PointNetSAModule(Module):
    """PointNet Set Abstraction (reference utils.py:93-158).

    group -> shared MLP -> pool -> optional post-MLP (last layer linear).
    """

    npoint: int
    radius: float
    nsample: int
    mlp: Sequence[int]
    mlp2: Optional[Sequence[int]] = None
    group_all: bool = False
    pooling: str = "max"
    knn: bool = False
    use_xyz: bool = True
    use_bn: bool = True
    dtype: jnp.dtype = jnp.float32
    bn_momentum: float = BN_MOMENTUM
    bn_eps: float = BN_EPS
    # mixed precision (Config.mixed_precision): gather/contract the wide
    # feature operand in self.dtype (bf16) while coordinates stay f32 —
    # see CenteredDense._split_call. Requires the fused path.
    split_coords: bool = False
    # coord_grad=False declares the xyz inputs non-differentiable (they are
    # stop_gradient'd): true for the backbone SA layers, whose coordinates
    # derive only from the param-free input cloud, so XLA can drop the
    # coordinate columns' cotangent from the fused gather's backward
    # scatter. Must stay True for the proposal layer (its "xyz" are votes,
    # which carry gradient to the voting MLP).
    coord_grad: bool = True
    # Point-axis (SP) sharding: when set, the layer's O(N) grouping stage
    # (FPS, ball query, gathers) runs point-sharded over this mesh's
    # ``sp_axis`` via parallel/point_sharded.py — bit-identical results,
    # shard-local O(N/devices) working sets, collectives between cards. The
    # MLP/pool (O(npoint), no N dependence) stay replicated over sp_axis.
    # ``sp_batch_axis`` additionally shards the batch (dp x sp). Only the
    # ball-query grouping modes are supported (no knn/group_all).
    sp_mesh: Optional[Mesh] = None
    sp_axis: str = "points"
    sp_batch_axis: Optional[str] = None

    def _mlp_stack(self, widths, name, final_activation=True):
        return MLPStack(
            widths, final_activation=final_activation, use_bn=self.use_bn,
            dtype=self.dtype, bn_momentum=self.bn_momentum, bn_eps=self.bn_eps,
            name=name,
        )

    def __call__(
        self,
        xyz: jnp.ndarray,
        points: Optional[jnp.ndarray],
        train: bool,
        sample_xyz: Optional[jnp.ndarray] = None,
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        # Fused fast path: gather the *uncentered* [xyz ‖ feat] group and fold
        # the center-subtract into the first MLP matmul (CenteredDense). Only
        # the weighted_avg pooling needs the centered grouped_xyz explicitly.
        fused = (
            not self.group_all
            and self.use_xyz
            and self.pooling != "weighted_avg"
            and len(self.mlp) > 0
        )
        if self.sp_mesh is not None:
            if self.group_all or self.knn:
                raise ValueError(
                    "sp_mesh supports ball-query grouping only (no knn/group_all)"
                )
            if self.split_coords:
                raise ValueError(
                    "sp_mesh + split_coords (mixed precision) is not wired; "
                    "run SP in f32"
                )
            from votenet_tpu.parallel.point_sharded import (
                farthest_point_sample_sharded,
                gather_point_sharded,
                group_point_sharded,
                query_ball_point_sharded,
                sample_and_group_sharded,
            )

            mesh, ax, bax = self.sp_mesh, self.sp_axis, self.sp_batch_axis
            if fused:
                fps_src = sample_xyz if sample_xyz is not None else xyz
                fps_idx = farthest_point_sample_sharded(
                    self.npoint, fps_src, mesh, ax, bax
                )
                new_xyz = gather_point_sharded(xyz, fps_idx, mesh, ax, bax)
                idx, _ = query_ball_point_sharded(
                    self.radius, self.nsample, xyz, new_xyz, mesh, ax, bax
                )
                gather_xyz = xyz if self.coord_grad else lax.stop_gradient(xyz)
                both = (
                    jnp.concatenate([gather_xyz, points], axis=-1)
                    if points is not None
                    else gather_xyz
                )
                # gather-first at train AND infer: project-before-gather
                # would run dense0 over the sharded N axis (cheap) but its
                # single-chip win rode the replicated gather's byte savings
                # — unmeasured on a real pod, so SP keeps the one exact
                # formulation. Forward numerics match the single-device
                # train path bit-for-bit (same gathers, same matmuls).
                g_raw = group_point_sharded(both, idx, mesh, ax, bax)
                new_points = self._mlp_stack(self.mlp, "mlp")(
                    g_raw, train, center=new_xyz
                )
                grouped_xyz = None
            else:
                new_xyz, new_points, idx, grouped_xyz = sample_and_group_sharded(
                    self.npoint, self.radius, self.nsample, xyz, points,
                    mesh, ax, use_xyz=self.use_xyz, batch_axis=bax,
                )
                new_points = self._mlp_stack(self.mlp, "mlp")(new_points, train)
        elif fused:
            fps_src = sample_xyz if sample_xyz is not None else xyz
            new_xyz = ops.gather_point(
                xyz, ops.farthest_point_sample(self.npoint, fps_src)
            )
            if self.knn:
                _, idx = ops.knn_point(self.nsample, xyz, new_xyz)
            else:
                idx, _ = ops.query_ball_point(self.radius, self.nsample, xyz, new_xyz)
            gather_xyz = xyz if self.coord_grad else lax.stop_gradient(xyz)
            both = (
                jnp.concatenate([gather_xyz, points], axis=-1)
                if points is not None
                else gather_xyz
            )
            # Inference: project-before-gather — dense0 runs over the N
            # unique points and the gather moves after it (CenteredDense
            # docstring). Training keeps gather-first: project-first's
            # backward must scatter the wide dense0 output gradient back to
            # (B, N, w0) at EVERY SA layer — including sa1, which otherwise
            # has no backward scatter at all (xyz carries no gradient).
            # The gather/dense commute is per-element identical forward
            # (dense is per-point linear), so the train/infer switch does
            # not itself change numerics. (Both paths share the
            # CenteredDense fold, whose reassociation of the center
            # subtract is exact math but not bitwise vs an explicit
            # centered path — see CenteredDense docstring.)
            if self.split_coords and points is not None:
                # mixed precision: separate narrow-f32 xyz and wide-bf16
                # feature gathers (the fused wide gather would force one
                # common dtype — f32 coords with bf16 features need two)
                feat_src = points.astype(self.dtype)
                if train:
                    g = (ops.group_point(xyz, idx), ops.group_point(feat_src, idx))
                    new_points = self._mlp_stack(self.mlp, "mlp")(
                        g, train, center=new_xyz
                    )
                else:
                    new_points = self._mlp_stack(self.mlp, "mlp")(
                        (xyz, feat_src), train, center=new_xyz, idx=idx
                    )
            elif train:
                from votenet_tpu.ops.dispatch import gather_packing

                if (
                    gather_packing() == "bf16_hilo"
                    and points is not None
                    and not self.coord_grad
                ):
                    # Packed transport (opt-in, ops/dispatch.py): ONE bf16
                    # gather of [xyz_hi ‖ xyz_lo ‖ feat] — (6+C)*2 bytes/row
                    # vs (3+C)*4, halving the sa2+ grouped-tensor traffic —
                    # then f32 coordinate reconstruction (hi+lo, ~16
                    # mantissa bits) feeding the same f32 CenteredDense math
                    # via the split path. Backbone-only (coord_grad=False):
                    # the hi/lo channels are dead in backward.
                    # The optimization barrier is load-bearing: XLA's bf16
                    # propagation may fold the f32->bf16->f32 round trip to
                    # identity, which would make lo all-zeros (silently
                    # degrading coords to plain bf16)
                    hi = gather_xyz.astype(jnp.bfloat16)
                    lo = (
                        gather_xyz
                        - lax.optimization_barrier(hi).astype(jnp.float32)
                    ).astype(jnp.bfloat16)
                    table = jnp.concatenate(
                        [hi, lo, points.astype(jnp.bfloat16)], axis=-1
                    )
                    g = ops.group_point(table, idx)
                    g_xyz = g[..., :3].astype(jnp.float32) + g[
                        ..., 3:6
                    ].astype(jnp.float32)
                    new_points = self._mlp_stack(self.mlp, "mlp")(
                        (g_xyz, g[..., 6:]), train, center=new_xyz
                    )
                else:
                    g_raw = ops.group_point(both, idx)
                    new_points = self._mlp_stack(self.mlp, "mlp")(
                        g_raw, train, center=new_xyz
                    )
            else:
                new_points = self._mlp_stack(self.mlp, "mlp")(
                    both, train, center=new_xyz, idx=idx
                )
            grouped_xyz = None  # never materialized on this path
        else:
            if self.group_all:
                new_xyz, new_points, idx, grouped_xyz = sample_and_group_all(
                    xyz, points, self.use_xyz
                )
            else:
                new_xyz, new_points, idx, grouped_xyz = sample_and_group(
                    self.npoint, self.radius, self.nsample, xyz, points,
                    self.knn, self.use_xyz, sample_xyz,
                )
            new_points = self._mlp_stack(self.mlp, "mlp")(new_points, train)

        if self.pooling == "max":
            new_points = jnp.max(new_points, axis=2)
        elif self.pooling == "avg":
            new_points = jnp.mean(new_points, axis=2)
        elif self.pooling == "weighted_avg":
            # exp(-5d) inverse-distance weights (utils.py:135-142)
            dists = jnp.linalg.norm(grouped_xyz, axis=-1, keepdims=True)
            exp_dists = jnp.exp(-dists * 5)
            weights = exp_dists / jnp.sum(exp_dists, axis=2, keepdims=True)
            new_points = jnp.sum(new_points * weights, axis=2)
        elif self.pooling == "max_and_avg":
            new_points = jnp.concatenate(
                [jnp.mean(new_points, axis=2), jnp.max(new_points, axis=2)], axis=-1
            )
        else:
            raise ValueError(f"unknown pooling {self.pooling!r}")

        if self.mlp2 is not None:
            new_points = self._mlp_stack(
                self.mlp2, "mlp2", final_activation=False
            )(new_points, train)

        return new_xyz, new_points, idx


class PointNetSAModuleMSG(Module):
    """Multi-scale-grouping SA module (reference utils.py:161-201).

    Present for API completeness; the VoteNet model never calls it (SURVEY
    §2 "known reference quirks").
    """

    npoint: int
    radius_list: Sequence[float]
    nsample_list: Sequence[int]
    mlp_list: Sequence[Sequence[int]]
    use_xyz: bool = True
    use_bn: bool = True
    dtype: jnp.dtype = jnp.float32
    bn_momentum: float = BN_MOMENTUM
    bn_eps: float = BN_EPS

    def __call__(self, xyz, points, train: bool):
        new_xyz = ops.gather_point(xyz, ops.farthest_point_sample(self.npoint, xyz))
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radius_list, self.nsample_list)):
            idx, _ = ops.query_ball_point(radius, nsample, xyz, new_xyz)
            grouped_xyz = ops.group_point(xyz, idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = ops.group_point(points, idx)
                if self.use_xyz:
                    # note reversed concat order vs single-scale (utils.py:190)
                    grouped = jnp.concatenate([grouped, grouped_xyz], axis=-1)
            else:
                grouped = grouped_xyz
            grouped = MLPStack(
                self.mlp_list[i], use_bn=self.use_bn, dtype=self.dtype,
                bn_momentum=self.bn_momentum, bn_eps=self.bn_eps,
                name=f"mlp_scale{i}",
            )(grouped, train)
            outs.append(jnp.max(grouped, axis=2))
        return new_xyz, jnp.concatenate(outs, axis=-1)


class PointNetFPModule(Module):
    """Feature propagation: 3-NN inverse-distance upsampling + MLP
    (reference utils.py:266-294). Stays fully on device — the reference
    bounced to CPU here (its three_nn/three_interpolate are CPU-only ops).
    """

    mlp: Sequence[int]
    use_bn: bool = True
    dtype: jnp.dtype = jnp.float32
    bn_momentum: float = BN_MOMENTUM
    bn_eps: float = BN_EPS

    def __call__(self, xyz1, xyz2, points1, points2, train: bool):
        # three_nn + weights always run on f32 coordinates; under mixed
        # precision only the (wide) feature interpolation/concat runs in the
        # feature dtype — weights are O(1), bf16-safe
        dist, idx = ops.three_nn(xyz1, xyz2)
        dist = jnp.maximum(dist, 1e-10)  # squared dists (utils.py:279)
        inv = 1.0 / dist
        weight = inv / jnp.sum(inv, axis=2, keepdims=True)
        points2 = points2.astype(self.dtype)
        if points1 is not None:
            points1 = points1.astype(self.dtype)
        interpolated = ops.three_interpolate(points2, idx, weight.astype(self.dtype))
        if points1 is not None:
            new_points = jnp.concatenate([interpolated, points1], axis=2)
        else:
            new_points = interpolated
        return MLPStack(
            self.mlp, use_bn=self.use_bn, dtype=self.dtype,
            bn_momentum=self.bn_momentum, bn_eps=self.bn_eps, name="mlp",
        )(new_points, train)
