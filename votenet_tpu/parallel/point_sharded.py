"""Point-axis sharding: the model's sequence-parallel (SP) analogue.

The reference handles N=20480 points on one GPU; this model family's
"long-context" axis is the point count (SURVEY §5 / §2.3 names within-scene
point-dimension sharding as the stretch goal). Beyond the
single-chip dense/streaming byte budgets (``ops.common``) a scene can
instead be sharded over a mesh axis: every O(N) working set — the ball
query's (B, M, N) hit mask, FPS's min-distance cache, three_nn's distance
matrix, group_point's source table — lives shard-local, so the reachable
point count scales linearly with the mesh axis while queries/outputs (all
O(M)) stay replicated.

Exactness: every op here returns BIT-IDENTICAL results to its single-device
twin (tested in tests/test_point_sharded.py on the virtual 8-device CPU
mesh):

- ball query: each shard runs the dense first-k query on its index slab;
  slabs merge in ascending global-index order with the same ordered merge
  the streaming variant uses (``ops.grouping.merge_first_k``) — the
  reference's first-nsample-in-index-order semantics are preserved by
  construction (tf_grouping_g.cu:13-35).
- three_nn: per-shard 3-NN candidates merge by (distance, global index)
  lexicographic order, matching the dense argmin's lowest-index tie rule
  (tf_interpolate.cpp:73-90).
- FPS: the per-step global argmax decomposes into per-shard argmax (lowest
  local index on ties) + a cross-shard argmax over the gathered maxima
  (lowest shard id on ties) = the dense rule's lowest global index
  (tf_sampling_g.cu:146-149). Distances are computed from the same f32
  values, so the running min-distance cache is shard-invariant.
- group_point: each shard gathers the indices that land in its slab and
  zero-fills the rest; a psum over the axis assembles the full gather
  (exactly one shard owns every index). Differentiable — the VJP scatters
  each shard's gradient slab locally, psum-free.

Collectives: ``all_gather`` of O(M)-sized partials and one ``psum`` for the
gather — all riding ICI on a real pod. The mesh axis can coexist with the
batch axis (a ('data', 'points') 2-D mesh gives dp x sp): every op takes
``batch_axis`` — when set, the leading (batch) dimension is sharded over
that mesh axis too, the per-shard bodies see only their local batch rows,
and no collective ever crosses the batch axis (the bodies are
batch-elementwise; collectives name only the point axis). This is what lets
the full dp x sp training step run without all-gathering the batch
(``models.pointnet2.PointNetSAModule.sp_mesh`` wires it into the model).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from votenet_tpu.ops.grouping import (
    _query_ball_point_dense,
    finalize_first_k,
    merge_first_k,
)
from votenet_tpu.ops.interpolate import three_nn_dense


def point_sharding(mesh: Mesh, axis: str = "points") -> NamedSharding:
    """Sharding for (B, N, ...) arrays with the POINT axis sharded."""
    return NamedSharding(mesh, P(None, axis))


def _check_divisible(n: int, mesh: Mesh, axis: str, what: str) -> int:
    size = mesh.shape[axis]
    if n % size:
        raise ValueError(
            f"{what}={n} must be divisible by mesh axis {axis!r} (size {size}); "
            f"pad the point cloud (far-away sentinel points are inert for the "
            f"ball query; see ops/grouping.py streaming padding)"
        )
    return size


def query_ball_point_sharded(
    radius: float,
    nsample: int,
    xyz1: jnp.ndarray,
    xyz2: jnp.ndarray,
    mesh: Mesh,
    axis: str = "points",
    batch_axis: Optional[str] = None,
):
    """Ball query with the dataset cloud sharded over ``axis``.

    xyz1: (B, N, 3) dataset (N sharded), xyz2: (B, M, 3) queries
    (replicated over ``axis``). Returns (idx, cnt) replicated over ``axis``
    — bit-identical to
    :func:`votenet_tpu.ops.grouping.query_ball_point_dense`. Honors
    ``ops.dispatch.bq_precision()`` like the single-device op. With
    ``batch_axis`` the batch dimension is additionally sharded over that
    mesh axis (dp x sp); the merge collectives still name only ``axis``.
    """
    from votenet_tpu.ops.dispatch import bq_precision

    nshards = _check_divisible(xyz1.shape[1], mesh, axis, "N")
    shard_n = xyz1.shape[1] // nshards
    mode = bq_precision()

    def local(x1, x2):
        sid = lax.axis_index(axis)
        bidx, bcnt = _query_ball_point_dense(radius, nsample, mode, x1, x2)
        bidx = bidx + sid * shard_n
        # (nshards, B, M, ns) — gather order == ascending global index order
        all_idx = lax.all_gather(bidx, axis)
        all_cnt = lax.all_gather(bcnt, axis)

        def body(carry, part):
            return merge_first_k(carry[0], carry[1], part[0], part[1], nsample), None

        B, M = x2.shape[0], x2.shape[1]
        idx0 = jnp.zeros((B, M, nsample), jnp.int32)
        cnt0 = jnp.zeros((B, M), jnp.int32)
        (idx, cnt), _ = lax.scan(body, (idx0, cnt0), (all_idx, all_cnt))
        idx, cnt = finalize_first_k(idx, cnt, nsample)
        return lax.stop_gradient(idx), lax.stop_gradient(cnt)

    # check_vma=False: every shard computes the identical merge from the
    # same all_gathered partials, so the outputs are replicated by
    # construction — but the vma type system cannot infer that through the
    # scan carry (tests assert exact equality with the dense twin).
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(batch_axis, axis), P(batch_axis)),
        out_specs=(P(batch_axis), P(batch_axis)),
        check_vma=False,
    )(xyz1, xyz2)


def three_nn_sharded(
    xyz1: jnp.ndarray,
    xyz2: jnp.ndarray,
    mesh: Mesh,
    axis: str = "points",
    batch_axis: Optional[str] = None,
):
    """3-NN with the SOURCE cloud sharded over ``axis``.

    xyz1: (B, N, 3) queries (replicated), xyz2: (B, M, 3) sources (M
    sharded, shard size >= 3). Returns replicated (dist2, idx) —
    bit-identical to :func:`votenet_tpu.ops.interpolate.three_nn_dense`.
    """
    nshards = _check_divisible(xyz2.shape[1], mesh, axis, "M")
    shard_m = xyz2.shape[1] // nshards
    if shard_m < 3:
        raise ValueError(f"need >= 3 sources per shard, got {shard_m}")

    def local(x1, x2s):
        sid = lax.axis_index(axis)
        d2, idx = three_nn_dense(x1, x2s)  # (B, N, 3) local top-3
        idx = idx + sid * shard_m
        all_d = lax.all_gather(d2, axis)   # (ns, B, N, 3)
        all_i = lax.all_gather(idx, axis)
        B, Nq = x1.shape[0], x1.shape[1]
        # candidate layout (shard-major, rank-minor): for equal distances,
        # position order == global index order (within a shard candidates
        # are in (d, idx) order; shard blocks are in ascending-index order),
        # so argmin's first-occurrence rule picks the lowest global index —
        # the dense tie rule.
        cd = jnp.moveaxis(all_d, 0, 2).reshape(B, Nq, -1)
        ci = jnp.moveaxis(all_i, 0, 2).reshape(B, Nq, -1)
        pos_iota = lax.broadcasted_iota(jnp.int32, cd.shape, dimension=2)
        dists, idxs = [], []
        d = cd
        for _ in range(3):
            p = jnp.argmin(d, axis=-1).astype(jnp.int32)  # (B, Nq)
            dists.append(jnp.min(d, axis=-1))
            idxs.append(jnp.take_along_axis(ci, p[..., None], axis=-1)[..., 0])
            d = jnp.where(pos_iota == p[..., None], jnp.float32(jnp.inf), d)
        return (
            lax.stop_gradient(jnp.stack(dists, axis=-1)),
            lax.stop_gradient(jnp.stack(idxs, axis=-1)),
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(batch_axis), P(batch_axis, axis)),
        out_specs=(P(batch_axis), P(batch_axis)),
        check_vma=False,  # replicated-by-construction merge (see above)
    )(xyz1, xyz2)


def group_point_sharded(
    points: jnp.ndarray,
    idx: jnp.ndarray,
    mesh: Mesh,
    axis: str = "points",
    batch_axis: Optional[str] = None,
) -> jnp.ndarray:
    """Grouped gather with the source table sharded over ``axis``.

    points: (B, N, C) (N sharded), idx: (B, M, S) global indices
    (replicated). Returns replicated (B, M, S, C). Differentiable w.r.t.
    ``points`` (each shard's VJP is a local scatter of its masked slab).
    """
    nshards = _check_divisible(points.shape[1], mesh, axis, "N")
    shard_n = points.shape[1] // nshards

    def local(pts_l, idx_g):
        sid = lax.axis_index(axis)
        li = idx_g.astype(jnp.int32) - sid * shard_n
        in_range = (li >= 0) & (li < shard_n)
        safe = jnp.clip(li, 0, shard_n - 1)
        B, n_l, C = pts_l.shape
        table = pts_l.reshape(B * n_l, C)
        off = (jnp.arange(B, dtype=jnp.int32) * n_l)[:, None, None]
        flat = (safe + off).reshape(-1)
        g = jnp.take(table, flat, axis=0).reshape(*idx_g.shape, C)
        g = jnp.where(in_range[..., None], g, jnp.zeros((), g.dtype))
        return lax.psum(g, axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(batch_axis, axis), P(batch_axis)),
        out_specs=P(batch_axis),
    )(points, idx)


def gather_point_sharded(
    points: jnp.ndarray,
    idx: jnp.ndarray,
    mesh: Mesh,
    axis: str = "points",
    batch_axis: Optional[str] = None,
) -> jnp.ndarray:
    """(B, N, C) sharded table, (B, M) global indices -> replicated (B, M, C).

    The (B, M)-indexed twin of :func:`group_point_sharded` (reference
    ``gather_point``, tf_sampling_g.cu:172-181). Differentiable.
    """
    return group_point_sharded(points, idx[:, :, None], mesh, axis, batch_axis)[
        :, :, 0, :
    ]


def sample_and_group_sharded(
    npoint: int,
    radius: float,
    nsample: int,
    xyz: jnp.ndarray,
    points: Optional[jnp.ndarray],
    mesh: Mesh,
    axis: str = "points",
    use_xyz: bool = True,
    batch_axis: Optional[str] = None,
):
    """The SA-layer grouping stage with the input cloud sharded over ``axis``.

    FPS -> gather -> ball query -> group -> center-subtract, each O(N) step
    point-sharded; mirrors :func:`votenet_tpu.models.pointnet2.sample_and_group`
    (reference utils.py:25-61) and returns the same
    (new_xyz, new_points, idx, grouped_xyz) — all replicated, all O(M), so
    the downstream MLP/pool (O(M·S·C), no N dependence) runs unsharded.
    Bit-identical to the single-device path (tested).
    """
    fps_idx = farthest_point_sample_sharded(npoint, xyz, mesh, axis, batch_axis)
    new_xyz = gather_point_sharded(xyz, fps_idx, mesh, axis, batch_axis)
    idx, _ = query_ball_point_sharded(
        radius, nsample, xyz, new_xyz, mesh, axis, batch_axis
    )
    if points is not None:
        both = group_point_sharded(
            jnp.concatenate([xyz, points], axis=-1), idx, mesh, axis, batch_axis
        )
        grouped_xyz = both[..., :3] - new_xyz[:, :, None, :]
        grouped_points = both[..., 3:]
        if use_xyz:
            new_points = jnp.concatenate([grouped_xyz, grouped_points], axis=-1)
        else:
            new_points = grouped_points
    else:
        grouped_xyz = (
            group_point_sharded(xyz, idx, mesh, axis, batch_axis)
            - new_xyz[:, :, None, :]
        )
        new_points = grouped_xyz
    return new_xyz, new_points, idx, grouped_xyz


def farthest_point_sample_sharded(
    npoint: int,
    xyz: jnp.ndarray,
    mesh: Mesh,
    axis: str = "points",
    batch_axis: Optional[str] = None,
) -> jnp.ndarray:
    """FPS with the point cloud sharded over ``axis``.

    xyz: (B, N, 3) (N sharded). Returns replicated (B, npoint) int32 global
    indices — bit-identical to the XLA twin (seed index 0, lowest-global-
    index ties). Each of the ``npoint`` steps runs two O(shards)-sized
    all_gathers (the selection is inherently sequential, like the
    reference's kernel loop, tf_sampling_g.cu:105-170); latency scales with
    npoint x collective RTT, so this is for clouds whose min-distance cache
    and coordinate planes cannot live on one chip, not a speed play.
    """
    _check_divisible(xyz.shape[1], mesh, axis, "N")

    def local(x_l):
        x_l = x_l.astype(jnp.float32)
        sid = lax.axis_index(axis)
        B, n_l, _ = x_l.shape

        # seed: global point 0 = shard 0, local 0 (reference seeds at 0)
        first = lax.all_gather(x_l[:, 0, :], axis)[0]  # (B, 3) from shard 0

        def body(i, carry):
            mindist, idxs, center = carry
            d = jnp.sum((x_l - center[:, None, :]) ** 2, axis=-1)  # (B, n_l)
            mindist = jnp.minimum(mindist, d)
            loc = jnp.argmax(mindist, axis=-1).astype(jnp.int32)  # (B,)
            val = jnp.take_along_axis(mindist, loc[:, None], axis=1)[:, 0]
            cand_i = loc + sid * n_l
            cand_x = jnp.take_along_axis(x_l, loc[:, None, None], axis=1)[:, 0]
            vals = lax.all_gather(val, axis)        # (ns, B)
            cands = lax.all_gather(
                jnp.concatenate([cand_x, cand_i[:, None].astype(jnp.float32)], -1),
                axis,
            )  # (ns, B, 4) — one gather for coords + index
            win = jnp.argmax(vals, axis=0)          # (B,) lowest shard on ties
            sel = jnp.take_along_axis(cands, win[None, :, None], axis=0)[0]
            center = sel[:, :3]
            # n_l * nshards <= 2^24 for exact f32 int round-trip: N beyond
            # 16.7M points would need an int all_gather (not a live shape)
            nxt = sel[:, 3].astype(jnp.int32)
            idxs = idxs.at[:, i].set(nxt)
            return mindist, idxs, center

        mindist0 = jnp.full((B, n_l), 1e38, jnp.float32)
        idxs0 = jnp.zeros((B, npoint), jnp.int32)
        if npoint > 1:
            _, idxs, _ = lax.fori_loop(1, npoint, body, (mindist0, idxs0, first))
        else:
            idxs = idxs0
        return lax.stop_gradient(idxs)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(batch_axis, axis),),
        out_specs=P(batch_axis),
        check_vma=False,  # replicated-by-construction selection (see above)
    )(xyz)
