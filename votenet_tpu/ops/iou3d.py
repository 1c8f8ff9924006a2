"""Exact oriented 3D box IoU, vectorized for XLA.

Rebuilds the convex polygon-clip IoU used in two places in the reference:
the C++ NMS kernel (tf_ops/3d_nms/tf_nms3d.cpp:43-192: point-in-polygon +
segment intersections + atan2 sort + triangle-fan area) and the shapely-based
eval IoU (evaluator.py:26-39). Both compute the same quantity: the exact
intersection area of the two top-face x/z quadrilaterals times the y overlap,
over the union volume.

The reference clips one polygon pair at a time on the CPU; here the whole
pairwise (N, M) IoU matrix is computed at once on device with fixed shapes:
the intersection polygon of two convex quads has at most 4+4+16 = 24
candidate vertices (corners of each quad inside the other plus edge-pair
intersections), which we mask, sort by angle around their centroid, and
integrate with a masked cyclic shoelace.

Box corner layout (must match model decode, reference model.py:100-112):
corners 0-3 = top face (+h/2), corners 4-7 = bottom face; top-face polygon is
corners[:4] in (x, z); y extent is corners[0].y (top) to corners[4].y.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_EPS = 1e-12


def _cross2(o, a, b):
    """2D cross product (a-o) x (b-o); broadcasts over leading dims."""
    return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
        a[..., 1] - o[..., 1]
    ) * (b[..., 0] - o[..., 0])


def quad_signed_area(quad: jnp.ndarray) -> jnp.ndarray:
    """Shoelace signed area of a quad, (..., 4, 2) -> (...,)."""
    x, z = quad[..., 0], quad[..., 1]
    xn, zn = jnp.roll(x, -1, axis=-1), jnp.roll(z, -1, axis=-1)
    return 0.5 * jnp.sum(x * zn - xn * z, axis=-1)


def _points_in_quad(pts: jnp.ndarray, quad: jnp.ndarray) -> jnp.ndarray:
    """pts (..., P, 2) inside convex quad (..., 4, 2) -> (..., P) bool.

    Orientation-agnostic: a point is inside iff all edge cross products share
    the polygon's orientation sign (boundary inclusive, matching the
    reference's pointInPolygon boundary behavior, tf_nms3d.cpp:53-67).
    """
    sign = jnp.sign(quad_signed_area(quad))[..., None, None]  # (..., 1, 1)
    a = quad[..., None, :, :]  # (..., 1, 4, 2)
    b = jnp.roll(quad, -1, axis=-2)[..., None, :, :]
    p = pts[..., :, None, :]  # (..., P, 1, 2)
    cr = _cross2(a, b, p)  # (..., P, 4)
    return jnp.all(sign * cr >= -_EPS, axis=-1)


def _edge_intersections(P: jnp.ndarray, Q: jnp.ndarray):
    """All 16 edge-pair intersection points of two quads.

    P, Q: (..., 4, 2). Returns (points (..., 16, 2), valid (..., 16)).
    Standard parametric segment-segment intersection (the reference's
    getIntersectionPoint, tf_nms3d.cpp:69-100).
    """
    a1 = P[..., :, None, :]  # (..., 4, 1, 2)
    a2 = jnp.roll(P, -1, axis=-2)[..., :, None, :]
    b1 = Q[..., None, :, :]  # (..., 1, 4, 2)
    b2 = jnp.roll(Q, -1, axis=-2)[..., None, :, :]
    da = a2 - a1
    db = b2 - b1
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]  # (..., 4, 4)
    dab = b1 - a1
    t = (dab[..., 0] * db[..., 1] - dab[..., 1] * db[..., 0]) / jnp.where(
        jnp.abs(denom) < _EPS, 1.0, denom
    )
    u = (dab[..., 0] * da[..., 1] - dab[..., 1] * da[..., 0]) / jnp.where(
        jnp.abs(denom) < _EPS, 1.0, denom
    )
    valid = (jnp.abs(denom) >= _EPS) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pt = a1 + t[..., None] * da  # (..., 4, 4, 2)
    shp = pt.shape[:-3] + (16, 2)
    return pt.reshape(shp), valid.reshape(shp[:-1])


def convex_quad_intersection_area(P: jnp.ndarray, Q: jnp.ndarray) -> jnp.ndarray:
    """Exact intersection area of two convex quads, (..., 4, 2) -> (...,).

    Candidate-vertex method with *rank-based* angular ordering: the (at most
    24) candidate vertices — P corners inside Q, Q corners inside P, and the
    16 edge-pair intersections — are ordered around their centroid not by a
    sort (an XLA sort over 24-vertex rows of an (8,256,256) NMS matrix is
    slow) but by computing each candidate's angular *rank* via
    a 24x24 pairwise comparison, and then evaluating the cyclic shoelace as
    a pairwise rank-adjacency sum:

        area = 1/2 | sum_{i,j} [rank_j == (rank_i + 1) mod cnt] cross(v_i, v_j) |

    Everything is fused element-wise math + reductions — no sort, gather, or
    sequential stage. Duplicate candidates (corner exactly on an edge) are
    angular ties broken by index; adjacent duplicates contribute zero cross
    terms, so the area is unaffected.
    """
    P, Q = jnp.broadcast_arrays(P, Q)
    p_in_q = _points_in_quad(P, Q)  # (..., 4)
    q_in_p = _points_in_quad(Q, P)  # (..., 4)
    inter_pts, inter_valid = _edge_intersections(P, Q)  # (..., 16, 2)

    pts = jnp.concatenate([P, Q, inter_pts], axis=-2)  # (..., 24, 2)
    valid = jnp.concatenate([p_in_q, q_in_p, inter_valid], axis=-1)  # (..., 24)

    cnt = jnp.sum(valid, axis=-1)  # (...,)
    vf = valid[..., None].astype(pts.dtype)
    centroid = jnp.sum(pts * vf, axis=-2) / jnp.maximum(cnt, 1)[..., None]

    ang = jnp.arctan2(
        pts[..., 1] - centroid[..., None, 1], pts[..., 0] - centroid[..., None, 0]
    )
    ang = jnp.where(valid, ang, jnp.inf)  # invalids rank last

    idx = lax.broadcasted_iota(jnp.int32, ang.shape, ang.ndim - 1)
    a_j = ang[..., :, None]  # j varies over rows
    a_i = ang[..., None, :]
    before = (a_j < a_i) | ((a_j == a_i) & (idx[..., :, None] < idx[..., None, :]))
    # rank among valid candidates (invalids get rank >= cnt and are masked)
    rank = jnp.sum(
        before & valid[..., :, None] & valid[..., None, :], axis=-2
    )  # (..., V) — counts valid j strictly before i

    nxt_rank = jnp.where(rank + 1 >= cnt[..., None], 0, rank + 1)
    adj = (
        valid[..., :, None]
        & valid[..., None, :]
        & (rank[..., None, :] == nxt_rank[..., :, None])
    )  # (..., V_i, V_j): j directly follows i in the cycle
    cross = (
        pts[..., :, None, 0] * pts[..., None, :, 1]
        - pts[..., None, :, 0] * pts[..., :, None, 1]
    )  # (..., V_i, V_j)
    total = jnp.sum(jnp.where(adj, cross, 0.0), axis=(-1, -2))
    area = 0.5 * jnp.abs(total)
    return jnp.where(cnt >= 3, area, 0.0)


def convex_quad_intersection_area_edgeclip(P: jnp.ndarray, Q: jnp.ndarray) -> jnp.ndarray:
    """Exact intersection area via directed boundary-segment clipping.

    The boundary of P∩Q (both convex) consists of sub-segments of P's edges
    that lie inside Q plus sub-segments of Q's edges that lie inside P.
    Each edge, parametrized x(t) = a + t·d for t ∈ [0,1], is clipped against
    the other quad's four half-planes — each constraint is LINEAR in t, so
    the clip is just interval arithmetic (max of lower bounds, min of upper
    bounds), no vertex collection at all. The shoelace integral over a
    closed curve decomposes over its directed sub-segments
    (area = ½ Σ cross(x_start, x_end)), and consecutive boundary segments
    share endpoints, so summing the per-segment cross products in ANY order
    gives the exact area — no angular rank/sort step.

    Same exact-polygon-clip quantity as the reference (tf_nms3d.cpp:122-175)
    and the rank-based method above, at ~1/10 the element count: the rank
    method materializes (pairs, 24, 24) comparison tensors; this one peaks
    at (pairs, 4, 4). Values agree with the rank method to float rounding
    (cross-validated in tests); NMS keep masks are unchanged except for
    pairs whose IoU sits within rounding distance of the threshold.
    """
    P, Q = jnp.broadcast_arrays(P, Q)
    # Orientation is handled by SIGN MULTIPLIERS, not by reversing vertex
    # order: for a clockwise quad, "inside" flips the cross-product sign
    # (fold sigma into the half-plane constraint) and its boundary traversal
    # runs backwards (multiply its shoelace contribution by sigma — equal to
    # traversing each clipped segment reversed). Reversal-free on purpose:
    # a [..., ::-1, :] here crashed an XLA fusion emitter
    # (ReverseInput::TransformWindow check failure) at NMS-matrix shapes.
    sp = jnp.sign(quad_signed_area(P))  # (...,) +-1 (0 only if degenerate)
    sq = jnp.sign(quad_signed_area(Q))

    def boundary_contrib(A, B, s_b):
        """Σ cross(x0, x1) over A's edges clipped to the inside of B
        (s_b = B's orientation sign; segments keep A's traversal order)."""
        a = A  # (..., 4, 2) edge starts
        d = jnp.roll(A, -1, axis=-2) - A  # edge directions
        q = B[..., None, :, :]  # (..., 1, 4, 2) clip-plane anchors
        e = (jnp.roll(B, -1, axis=-2) - B)[..., None, :, :]  # plane directions
        am = a[..., :, None, :] - q  # (..., 4A, 4B, 2)
        # inside(t): s_b * cross(e, x(t) - q) = c0 + t*c1 >= 0
        sb = s_b[..., None, None]
        c0 = sb * (e[..., 0] * am[..., 1] - e[..., 1] * am[..., 0])
        c1 = sb * (
            e[..., 0] * d[..., :, None, 1] - e[..., 1] * d[..., :, None, 0]
        )
        pos = c1 > _EPS
        neg = c1 < -_EPS
        t_at = -c0 / jnp.where(pos | neg, c1, 1.0)
        lo = jnp.max(jnp.where(pos, t_at, 0.0), axis=-1)  # (..., 4A)
        hi = jnp.min(jnp.where(neg, t_at, 1.0), axis=-1)
        # parallel-and-outside: edge direction parallel to the plane with
        # the start strictly outside -> the whole edge is clipped away
        dead = jnp.any(~pos & ~neg & (c0 < -_EPS), axis=-1)
        lo = jnp.clip(lo, 0.0, 1.0)
        hi = jnp.clip(hi, 0.0, 1.0)
        valid = (hi > lo) & ~dead
        x0 = a + lo[..., None] * d
        x1 = a + hi[..., None] * d
        cr = x0[..., 0] * x1[..., 1] - x1[..., 0] * x0[..., 1]
        return jnp.sum(jnp.where(valid, cr, 0.0), axis=-1)

    area = 0.5 * (
        sp * boundary_contrib(P, Q, sq) + sq * boundary_contrib(Q, P, sp)
    )
    # exact-math no-op clamps; they bound float error and neutralize the
    # degenerate-quad case (a zero-area quad has no interior, but its
    # all-degenerate half-planes clip nothing above)
    cap = jnp.minimum(
        jnp.abs(quad_signed_area(P)), jnp.abs(quad_signed_area(Q))
    )
    return jnp.clip(area, 0.0, cap)


_SH_CAP = 12  # vertex capacity through the 4 clip stages (final is <= 8)


def convex_quad_intersection_area_sh(P: jnp.ndarray, Q: jnp.ndarray) -> jnp.ndarray:
    """Sutherland–Hodgman formulation: clip P by Q's four half-planes with a
    fixed-capacity vertex buffer and one-hot compaction. A third independent
    implementation kept for cross-validation (its per-stage gathers and
    scatters make it slower than the rank method above).
    """
    P, Q = jnp.broadcast_arrays(P, Q)
    P = P.astype(jnp.float32)
    Q = Q.astype(jnp.float32)

    # normalize clip polygon to CCW so "inside" is a fixed sign
    ccw = quad_signed_area(Q) >= 0
    Q = jnp.where(ccw[..., None, None], Q, Q[..., ::-1, :])

    V = _SH_CAP
    batch = P.shape[:-2]
    pts = jnp.concatenate(
        [P, jnp.zeros(batch + (V - 4, 2), P.dtype)], axis=-2
    )  # (..., V, 2)
    cnt = jnp.full(batch, 4, jnp.int32)

    slot = jax.lax.broadcasted_iota(jnp.int32, batch + (V,), len(batch))
    out_slot_eq = slot[..., None, :]  # (..., V_in -> broadcast, V_out)

    for e in range(4):
        a = Q[..., e, :]  # (..., 2)
        b = Q[..., (e + 1) % 4, :]
        ex = (b - a)[..., 0:1]  # (..., 1) broadcast over slots
        ez = (b - a)[..., 1:2]
        p = pts  # (..., V, 2)
        nxt = jnp.where(slot + 1 >= cnt[..., None], 0, slot + 1)
        q = jnp.take_along_axis(pts, nxt[..., None], axis=-2)
        valid = slot < cnt[..., None]
        side_p = ex * (p[..., 1] - a[..., 1:2]) - ez * (p[..., 0] - a[..., 0:1]) >= 0
        side_q = ex * (q[..., 1] - a[..., 1:2]) - ez * (q[..., 0] - a[..., 0:1]) >= 0
        emit_v = valid & side_p
        emit_x = valid & (side_p != side_q)
        # p + t (q - p) with the clip line
        d = q - p
        denom = ex * d[..., 1] - ez * d[..., 0]
        safe = jnp.where(jnp.abs(denom) < _EPS, 1.0, denom)
        t = (ex * (a[..., 1:2] - p[..., 1]) - ez * (a[..., 0:1] - p[..., 0])) / safe
        x = p + t[..., None] * d  # (..., V, 2)

        counts = emit_v.astype(jnp.int32) + emit_x.astype(jnp.int32)
        offs = jnp.cumsum(counts, axis=-1) - counts  # exclusive
        pos_v = offs
        pos_x = offs + emit_v.astype(jnp.int32)
        new_cnt = offs[..., -1] + counts[..., -1]

        oh_v = (emit_v[..., None] & (pos_v[..., None] == out_slot_eq)).astype(
            jnp.float32
        )  # (..., V_in, V_out)
        oh_x = (emit_x[..., None] & (pos_x[..., None] == out_slot_eq)).astype(
            jnp.float32
        )
        pts = jnp.einsum("...ik,...id->...kd", oh_v, p) + jnp.einsum(
            "...ik,...id->...kd", oh_x, x
        )
        cnt = new_cnt

    # masked cyclic shoelace over the valid prefix
    nxt = jnp.where(slot + 1 >= cnt[..., None], 0, slot + 1)
    q = jnp.take_along_axis(pts, nxt[..., None], axis=-2)
    valid = (slot < cnt[..., None]).astype(jnp.float32)
    cross = pts[..., 0] * q[..., 1] - q[..., 0] * pts[..., 1]
    area = 0.5 * jnp.abs(jnp.sum(cross * valid, axis=-1))
    return jnp.where(cnt >= 3, area, 0.0)


def convex_quad_intersection_area_sort(P: jnp.ndarray, Q: jnp.ndarray) -> jnp.ndarray:
    """Angular-sort formulation (candidate vertices + atan2 sort + shoelace),
    mirroring the reference's C++ approach (tf_nms3d.cpp:122-175). Kept as a
    second independent implementation for cross-validation; its sort makes
    it the slowest of the three.
    """
    P, Q = jnp.broadcast_arrays(P, Q)
    p_in_q = _points_in_quad(P, Q)  # (..., 4)
    q_in_p = _points_in_quad(Q, P)  # (..., 4)
    inter_pts, inter_valid = _edge_intersections(P, Q)  # (..., 16, 2)

    pts = jnp.concatenate([P, Q, inter_pts], axis=-2)  # (..., 24, 2)
    valid = jnp.concatenate([p_in_q, q_in_p, inter_valid], axis=-1)  # (..., 24)

    cnt = jnp.sum(valid, axis=-1)  # (...,)
    vf = valid[..., None].astype(pts.dtype)
    centroid = jnp.sum(pts * vf, axis=-2) / jnp.maximum(cnt, 1)[..., None]

    ang = jnp.arctan2(
        pts[..., 1] - centroid[..., None, 1], pts[..., 0] - centroid[..., None, 0]
    )
    ang = jnp.where(valid, ang, jnp.inf)  # invalid sort to the back
    order = jnp.argsort(ang, axis=-1)
    pts_sorted = jnp.take_along_axis(pts, order[..., None], axis=-2)

    iota = lax.broadcasted_iota(jnp.int32, valid.shape, valid.ndim - 1)
    in_cycle = iota < cnt[..., None]
    first = pts_sorted[..., :1, :]
    cyc = jnp.where(in_cycle[..., None], pts_sorted, first)

    x, z = cyc[..., 0], cyc[..., 1]
    xn, zn = jnp.roll(x, -1, axis=-1), jnp.roll(z, -1, axis=-1)
    area = 0.5 * jnp.abs(jnp.sum(x * zn - xn * z, axis=-1))
    return jnp.where(cnt >= 3, area, 0.0)


def box3d_iou_pairwise(c1: jnp.ndarray, c2: jnp.ndarray) -> jnp.ndarray:
    """Elementwise 3D IoU of aligned box arrays: (..., 8, 3) x2 -> (...,).

    Uses the edge-clip area (the fastest of the four formulations: its peak
    intermediate is (pairs, 4, 4) vs the rank method's (pairs, 24, 24) —
    the NMS IoU matrix is elementwise-bound, so element count is the cost).
    """
    quad1 = jnp.stack([c1[..., :4, 0], c1[..., :4, 2]], axis=-1)
    quad2 = jnp.stack([c2[..., :4, 0], c2[..., :4, 2]], axis=-1)
    inter_area = convex_quad_intersection_area_edgeclip(quad1, quad2)
    y1t, y1b = c1[..., 0, 1], c1[..., 4, 1]
    y2t, y2b = c2[..., 0, 1], c2[..., 4, 1]
    y_overlap = jnp.maximum(0.0, jnp.minimum(y1t, y2t) - jnp.maximum(y1b, y2b))
    inter_vol = inter_area * y_overlap
    vol1 = jnp.abs(quad_signed_area(quad1)) * (y1t - y1b)
    vol2 = jnp.abs(quad_signed_area(quad2)) * (y2t - y2b)
    denom = vol1 + vol2 - inter_vol
    return jnp.where(denom > _EPS, inter_vol / jnp.where(denom > _EPS, denom, 1.0), 0.0)


@jax.jit
def box3d_iou_matrix(c1: jnp.ndarray, c2: jnp.ndarray) -> jnp.ndarray:
    """Full pairwise IoU matrix: (..., N, 8, 3), (..., M, 8, 3) -> (..., N, M)."""
    return box3d_iou_pairwise(c1[..., :, None, :, :], c2[..., None, :, :, :])
