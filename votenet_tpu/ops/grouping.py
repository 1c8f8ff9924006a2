"""Ball-query grouping, feature gather, kNN and partial selection.

Rebuild of the reference CUDA package ``tf_ops/grouping``
(`tf_grouping.py`, `tf_grouping_g.cu`), recast as fixed-shape ops.

Parity-critical semantics of ``query_ball_point`` (tf_grouping_g.cu:13-35):

- a dataset point k is a hit iff ``max(sqrt(dist2), 1e-20) < radius``
  with a *strict* comparison, where ``dist2`` is the f32 difference-square
  sum; every implementation here tests the equivalent
  ``dist2 < radius_sq_threshold(radius)`` (:mod:`votenet_tpu.ops.common`);
- the output takes the FIRST ``nsample`` hits in dataset index order;
- slots past the last hit are filled with the FIRST hit's index (the CUDA
  kernel pre-fills all slots on the first hit, tf_grouping_g.cu:26-29);
- ``pts_cnt`` counts hits but saturates at ``nsample`` (the scan breaks).

If a query ball is empty the reference leaves the row uninitialized (never
happens in the model: every query point is a member of the dataset cloud, so
it always hits itself). We define the empty case as index 0.

Implementations: on a GPU the Pallas-Triton kernel
(:mod:`votenet_tpu.ops.pallas.ballquery`, the reference's scan shape);
elsewhere, or with ``Config.use_pallas=False``, the XLA twins below: the
dense hierarchical query, or the streaming one when the dense (B, M, N)
intermediates exceed :func:`~votenet_tpu.ops.common.dense_bytes_budget`.

RADIUS-BOUNDARY PRECISION (the one authoritative statement; docstrings
elsewhere defer here). The mode is ``ops.dispatch.bq_precision()``:

- "exact" (the default): squared distances use the oracle's own
  difference-square form (:func:`~votenet_tpu.ops.common.pairwise_sqdist`),
  so indices and counts are bit-identical to the reference semantics.
- "fast_bf16": the matmul expansion ``|a|^2+|b|^2-2ab`` at default matmul
  precision, which rounds the coordinate operands (bf16 on some
  accelerators, TF32 on a GPU): a boundary band of centimetres at room
  scale, so it is NOT reference parity. Always the XLA twin.

:func:`query_ball_point_topk` (the oracle) uses the exact form
unconditionally and is reference-identical bit-for-bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from votenet_tpu.ops import common
from votenet_tpu.ops.common import (
    pairwise_sqdist,
    pairwise_sqdist_mm,
    radius_sq_threshold,
)


@functools.partial(jax.jit, static_argnums=(0, 1))
def query_ball_point_topk(radius: float, nsample: int, xyz1: jnp.ndarray, xyz2: jnp.ndarray):
    """Reference XLA formulation via top_k over index keys.

    Simple and exact, but lax.top_k over the full N axis sorts; kept as the
    readable oracle. Use :func:`query_ball_point` in the model path.
    """
    d2 = pairwise_sqdist(xyz2.astype(jnp.float32), xyz1.astype(jnp.float32))
    N = xyz1.shape[1]
    hit = d2 < jnp.float32(radius_sq_threshold(radius))  # (B, M, N), strict
    # first-`nsample`-hits-in-index-order via top_k over negated index keys:
    # hits keep their index, misses get sentinel N; the nsample smallest keys
    # are the first nsample hits (ascending), padded with the sentinel.
    iota = lax.broadcasted_iota(jnp.int32, d2.shape, dimension=2)
    key = jnp.where(hit, iota, N)
    neg_sorted, _ = lax.top_k(-key, nsample)  # descending -key == ascending key
    idx_sorted = -neg_sorted  # (B, M, nsample), sentinel-padded
    first_hit = idx_sorted[..., :1]
    idx = jnp.where(idx_sorted >= N, first_hit, idx_sorted)
    idx = jnp.where(idx >= N, 0, idx)  # fully-empty ball -> 0 (see docstring)
    pts_cnt = jnp.minimum(jnp.sum(hit, axis=-1), nsample).astype(jnp.int32)
    return lax.stop_gradient(idx), lax.stop_gradient(pts_cnt)


_BQ_CHUNK = 128  # chunk width of the hierarchical search


def query_ball_point(radius: float, nsample: int, xyz1: jnp.ndarray, xyz2: jnp.ndarray):
    """Fixed-radius neighborhood query (backend/size-dispatched).

    The GPU kernel when :func:`votenet_tpu.ops.dispatch.use_gpu_kernels`
    holds and the mode is "exact"; otherwise the streaming twin when the
    dense (B, M, N) intermediates exceed the dense budget, else the dense
    twin. Identical semantics every way (exact-equality tested).
    """
    from votenet_tpu.ops.dispatch import bq_precision, use_gpu_kernels

    if use_gpu_kernels() and bq_precision() == "exact":
        from votenet_tpu.ops.pallas.ballquery import query_ball_point_gpu

        return query_ball_point_gpu(radius, nsample, xyz1, xyz2)
    B, N = xyz1.shape[0], xyz1.shape[1]
    M = xyz2.shape[1]
    if common.bq_dense_bytes(B, M, N) > common.dense_bytes_budget():
        return query_ball_point_streaming(radius, nsample, xyz1, xyz2)
    return query_ball_point_dense(radius, nsample, xyz1, xyz2)


def query_ball_point_dense(radius: float, nsample: int, xyz1: jnp.ndarray, xyz2: jnp.ndarray):
    """The dense XLA twin. Reads ``ops.dispatch.bq_precision()`` per call
    and passes it as a static argument of :func:`_query_ball_point_dense`,
    so flipping the mode is never masked by a stale jit cache."""
    from votenet_tpu.ops.dispatch import bq_precision

    return _query_ball_point_dense(radius, nsample, bq_precision(), xyz1, xyz2)


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _query_ball_point_dense(
    radius: float, nsample: int, mode: str, xyz1: jnp.ndarray, xyz2: jnp.ndarray
):
    """Fixed-radius neighborhood query (hierarchical, no sort).

    Args:
      radius: ball radius (static).
      nsample: max points per ball (static).
      mode: "exact" | "fast_bf16" distance precision (static; see module
        docstring).
      xyz1: (B, N, 3) dataset points.
      xyz2: (B, M, 3) query points.

    Returns:
      idx: (B, M, nsample) int32 indices into N.
      pts_cnt: (B, M) int32 number of hits (saturated at nsample).

    Algorithm: "first nsample set bits" extracted with a two-level search
    instead of a top_k/sort over N. Split N into chunks of 128; per-chunk
    hit counts + exclusive cumsum locate, for every output slot s, the
    chunk containing the (s+1)-th hit; a gather of just those chunks'
    masks plus an in-chunk rank match yields the lane. O(M*N) for the mask +
    O(M*nsample*128) for the search. Selection semantics (index order,
    fill-with-first-hit, saturated counts) match the CUDA scan
    (tf_grouping_g.cu:13-35) exactly; the radius test's precision follows
    ``mode`` (module docstring).
    """
    xyz1 = xyz1.astype(jnp.float32)
    xyz2 = xyz2.astype(jnp.float32)
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    C = _BQ_CHUNK
    n_chunks = -(-N // C)
    Np = n_chunks * C

    # Every integer-valued intermediate is carried in bf16 so the heavy
    # reductions run as matmuls (each value here -- hit flags, per-chunk
    # counts <= 128, ranks <= 128 -- is an integer <= 256, exact in bf16).
    bf16 = jnp.bfloat16
    if mode == "exact":
        d2 = pairwise_sqdist(xyz2, xyz1)  # the oracle's rounding sequence
    else:
        d2 = pairwise_sqdist_mm(xyz2, xyz1)  # (B, M, N)
    hit = (d2 < jnp.float32(radius_sq_threshold(radius))).astype(bf16)
    if Np != N:
        hit = jnp.pad(hit, ((0, 0), (0, 0), (0, Np - N)))
    hit_c = hit.reshape(B, M, n_chunks, C)

    # per-chunk hit counts as a matmul against the block-segment matrix
    seg = jnp.repeat(jnp.eye(n_chunks, dtype=bf16), C, axis=0)  # (Np, nc)
    cnt_chunk = jnp.einsum(
        "bmn,nc->bmc", hit, seg, preferred_element_type=jnp.float32
    )  # (B, M, nc), exact ints
    cum = jnp.cumsum(cnt_chunk, axis=-1)  # inclusive
    base = cum - cnt_chunk  # exclusive
    total = cum[..., -1]  # (B, M)

    # chunk containing the (s+1)-th hit: #chunks whose cumulative count <= s
    s_iota = jnp.arange(nsample, dtype=jnp.float32)
    c_s = jnp.sum(cum[..., None, :] <= s_iota[:, None], axis=-1)  # (B, M, ns)
    c_s = jnp.minimum(c_s, n_chunks - 1).astype(jnp.int32)

    # one-hot over chunks drives batched-matmul "gathers". Every
    # (B, M, ns, C)-shaped extraction intermediate below is bf16-exact:
    # hit flags 0/1, in-chunk ranks <= C=128, selected-chunk bases
    # <= nsample-1 <= 63 (the chunk holding the (s+1)-th hit has exclusive
    # cumulative base <= s), lanes <= 127.
    oh = jax.nn.one_hot(c_s, n_chunks, dtype=bf16)  # (B, M, ns, nc)
    sel_mask = jnp.einsum(
        "bmsc,bmck->bmsk", oh, hit_c, preferred_element_type=bf16
    )  # (B, M, ns, C); values 0/1
    base_s = jnp.einsum(
        "bmsc,bmc->bms", oh, base.astype(bf16), preferred_element_type=jnp.float32
    )  # base count of that chunk (selected bases <= 63: exact in bf16)
    t_s = s_iota + 1.0 - base_s  # wanted 1-based rank inside the chunk

    # in-chunk rank via matmul with an upper-triangular ones matrix
    tri = jnp.tril(jnp.ones((C, C), bf16)).T  # tri[k, j] = 1 for j >= k
    local_rank = jnp.einsum(
        "bmsk,kj->bmsj", sel_mask, tri,
        preferred_element_type=bf16,
    )  # inclusive cumsum; counts <= 128, bf16-exact
    is_target = jnp.where(
        (local_rank == t_s[..., None].astype(bf16)) & (sel_mask > 0),
        jnp.ones((), bf16), jnp.zeros((), bf16),
    )
    lane_iota = jnp.arange(C, dtype=jnp.float32).astype(bf16)
    lane = jnp.einsum(
        "bmsk,k->bms", is_target, lane_iota, preferred_element_type=jnp.float32
    )  # one-hot dot: exactly one 1 per row -> exact lane value
    idx_s = (c_s * C + lane.astype(jnp.int32)).astype(jnp.int32)

    # fill-with-first-hit semantics for slots past the last hit
    cnt = jnp.minimum(total, nsample).astype(jnp.int32)  # (B, M)
    first_hit = idx_s[..., :1]
    idx = jnp.where(s_iota.astype(jnp.int32) < cnt[..., None], idx_s, first_hit)
    idx = jnp.where(cnt[..., None] > 0, idx, 0)  # empty ball -> 0
    return lax.stop_gradient(idx), lax.stop_gradient(cnt)


def group_point(points: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather grouped features: (B, N, C), (B, M, S) -> (B, M, S, C).

    A flat row gather from a (B*N, C) table. Differentiable w.r.t.
    ``points``: the VJP is XLA's scatter-add, the reference's own atomic
    design (tf_grouping_g.cu:61-78). On a GPU its accumulation order, and
    so the last bits of the gradient, may vary from run to run.
    """
    B, N, C = points.shape
    _, M, S = idx.shape
    table = points.reshape(B * N, C)
    off = (jnp.arange(B, dtype=jnp.int32) * N)[:, None, None]
    flat = (idx.astype(jnp.int32) + off).reshape(-1)
    return jnp.take(table, flat, axis=0).reshape(B, M, S, C)


def query_ball_point_streaming(
    radius: float,
    nsample: int,
    xyz1: jnp.ndarray,
    xyz2: jnp.ndarray,
    block: int = 4096,
):
    """Ball query for large N (streaming). Reads ``bq_precision()`` per call
    (outside the jit cache) like :func:`query_ball_point_dense`; see
    :func:`_query_ball_point_streaming`."""
    from votenet_tpu.ops.dispatch import bq_precision

    return _query_ball_point_streaming(
        radius, nsample, bq_precision(), xyz1, xyz2, block
    )


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 5))
def _query_ball_point_streaming(
    radius: float,
    nsample: int,
    mode: str,
    xyz1: jnp.ndarray,
    xyz2: jnp.ndarray,
    block: int = 4096,
):
    """Ball query for point counts too large for the (B, M, N) hit mask.

    The "long-context" axis of this model is the point count (SURVEY §5): at
    N >> 20480 the dense hierarchical query's (B, M, N) intermediates exceed
    the device-memory budget. This variant scans dataset blocks of ``block`` points in
    ascending index order under a ``lax.scan`` — peak memory O(B·M·block) —
    and merges each block's first-k hits into the running per-query state.
    Because blocks are visited in index order and per-block hits come out in
    index order, the merge preserves the reference's
    first-``nsample``-in-index-order semantics exactly (tf_grouping_g.cu:
    13-35), including the fill-with-first-hit rule and saturated counts.

    Same signature/returns as :func:`query_ball_point` plus ``block``
    (static). Exact-equality tested against the dense twin.
    """
    xyz1 = xyz1.astype(jnp.float32)
    xyz2 = xyz2.astype(jnp.float32)
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    nb = -(-N // block)
    if nb * block != N:
        # pad with far-away points: never within radius of finite queries
        xyz1 = jnp.pad(
            xyz1, ((0, 0), (0, nb * block - N), (0, 0)), constant_values=1e9
        )
    blocks = xyz1.reshape(B, nb, block, 3).transpose(1, 0, 2, 3)  # (nb,B,blk,3)

    def body(carry, args):
        idx_st, cnt_st = carry  # (B,M,ns) int32, (B,M) int32
        j, blk = args
        bidx, bcnt = _query_ball_point_dense(radius, nsample, mode, blk, xyz2)
        return merge_first_k(idx_st, cnt_st, bidx + j * block, bcnt, nsample), None

    idx0 = jnp.zeros((B, M, nsample), jnp.int32)
    cnt0 = jnp.zeros((B, M), jnp.int32)
    (idx, cnt), _ = lax.scan(
        body, (idx0, cnt0), (jnp.arange(nb, dtype=jnp.int32), blocks)
    )
    idx, cnt = finalize_first_k(idx, cnt, nsample)
    return lax.stop_gradient(idx), lax.stop_gradient(cnt)


def merge_first_k(idx_st, cnt_st, bidx, bcnt, nsample: int):
    """Merge one partial first-k result into a running (idx, cnt) state.

    ``(idx_st, cnt_st)`` hold the first ``cnt_st`` hits found so far (in
    dataset index order); ``(bidx, bcnt)`` is a partial result over a LATER
    index range (all its indices exceed everything already stored —
    streaming blocks / mesh shards are visited in ascending index order).
    Slots ``>= bcnt`` of ``bidx`` are fill values and are masked off via the
    counts. Returns the merged (idx, cnt); counts saturate at ``nsample``.
    """
    s_iota = jnp.arange(nsample, dtype=jnp.int32)
    take = jnp.minimum(nsample - cnt_st, bcnt)  # (B, M)
    shift = jnp.clip(s_iota[None, None, :] - cnt_st[..., None], 0, nsample - 1)
    shifted = jnp.take_along_axis(bidx, shift, axis=-1)
    merged = jnp.where(s_iota[None, None, :] < cnt_st[..., None], idx_st, shifted)
    return merged, cnt_st + take


def finalize_first_k(idx, cnt, nsample: int):
    """Apply the reference padding semantics to a merged first-k state:
    slots past the last hit repeat the FIRST hit; fully-empty balls -> index
    0 (see the query_ball_point docstring)."""
    s_iota = jnp.arange(nsample, dtype=jnp.int32)
    first_hit = idx[..., :1]
    idx = jnp.where(s_iota[None, None, :] < cnt[..., None], idx, first_hit)
    idx = jnp.where(cnt[..., None] > 0, idx, 0)
    return idx, cnt


@functools.partial(jax.jit, static_argnums=0)
def select_top_k(k: int, dist: jnp.ndarray):
    """Partial selection sort of each row (reference tf_grouping.py:22-31).

    Returns (idx, dist_out) of the same (B, M, N) shape where the first k
    entries of each row are the k smallest distances in ascending order (the
    reference leaves the remaining N-k entries in unspecified order; we
    return a full ascending sort, a strict refinement).
    """
    order = jnp.argsort(dist, axis=-1, stable=True).astype(jnp.int32)
    return order, jnp.take_along_axis(dist, order, axis=-1)


@functools.partial(jax.jit, static_argnums=0)
def knn_point(k: int, xyz1: jnp.ndarray, xyz2: jnp.ndarray):
    """k nearest neighbors by squared distance (reference tf_grouping.py:48-73).

    xyz1: (B, N, 3) dataset, xyz2: (B, M, 3) queries.
    Returns (dist2, idx) each (B, M, k), ascending. Unused by the VoteNet
    model (it always ball-queries) but part of the reference API surface.
    """
    d2 = pairwise_sqdist(xyz2, xyz1)  # (B, M, N)
    neg, idx = lax.top_k(-d2, k)
    return -neg, idx.astype(jnp.int32)
