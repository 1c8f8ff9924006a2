"""Oriented 3D non-max suppression as a fixed-shape device op.

Rebuilds the reference's CPU-only ``NonMaxSuppression3D``
(tf_ops/3d_nms/tf_nms3d.cpp:202-308) with the variable-length output
(SURVEY §3.2 calls this out as the key static-shape forcing function)
replaced by a
fixed-size keep mask.

Reference semantics matched:

- candidates are boxes whose objectness logit[1] > logit[0] (strict,
  tf_nms3d.cpp:228-234);
- greedy selection in descending score order; a candidate is suppressed if
  any already-selected box *in the same batch element* has 3D IoU strictly
  greater than the threshold (tf_nms3d.cpp:240-264). The reference orders
  its priority queue globally across the batch, but since suppression is
  same-batch-only the greedy outcome is identical per batch element
  (SURVEY §7 "hard parts"), so we run the loop per batch row, in parallel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from votenet_tpu.ops.iou3d import box3d_iou_matrix


# Candidate-compaction tiers: the full (B, N, N) IoU matrix is only needed
# when many boxes pass the objectness gate. If at most K candidates pass in
# every batch row, the exact greedy outcome is computable on the K
# highest-priority boxes alone (suppression only flows from higher priority
# to lower; non-candidates neither keep nor suppress, tf_nms3d.cpp:228-234).
# lax.cond picks the smallest tier that fits at runtime — a trained model
# gates hard (tens of candidates -> the 64 tier, 16x fewer IoU pairs).
_COMPACT_TIERS = (64, 160)


def _jacobi_greedy(iou, cand_f, higher, iou_threshold) -> jnp.ndarray:
    """Greedy "keep i iff no higher-priority kept box overlaps it" via
    Jacobi fixpoint iteration: each round is one batched matmul over the
    suppression matrix, converging after at most longest-suppression-chain
    rounds (a handful in practice). The fixpoint is exactly the greedy
    solution (tf_nms3d.cpp:240-264)."""
    supp = jnp.where(higher & (iou > iou_threshold), 1.0, 0.0) * cand_f[:, :, None]

    def cond(state):
        kept, changed = state
        return changed

    def body(state):
        kept, _ = state
        blocked = jnp.einsum("bj,bji->bi", kept, supp)  # suppression pressure
        new_kept = cand_f * jnp.where(blocked > 0, 0.0, 1.0)
        return new_kept, jnp.any(new_kept != kept)

    kept, _ = lax.while_loop(cond, body, (cand_f, jnp.bool_(True)))
    return kept


def _nms3d_dense(corners, scores, cand, iou_threshold) -> jnp.ndarray:
    B, N = scores.shape
    iou = box3d_iou_matrix(corners, corners)  # (B, N, N)
    # priority: score desc, ties by lower index
    iota = lax.broadcasted_iota(jnp.int32, (B, N), 1)
    s_j = scores[:, :, None]
    s_i = scores[:, None, :]
    higher = (s_j > s_i) | ((s_j == s_i) & (iota[:, :, None] < iota[:, None, :]))
    return _jacobi_greedy(iou, cand.astype(jnp.float32), higher, iou_threshold) > 0


def _nms3d_compact(corners, scores, cand, order, iou_threshold, k: int):
    """Exact NMS on the K highest-priority boxes (valid iff every batch row
    has <= K candidates — checked by the caller's lax.cond)."""
    B, N = scores.shape
    sel = order[:, :k]  # (B, K) highest-priority first
    b_iota = jnp.arange(B, dtype=jnp.int32)[:, None]
    c_k = corners[b_iota, sel]  # (B, K, 8, 3)
    cand_k = cand[b_iota, sel]
    iou = box3d_iou_matrix(c_k, c_k)  # (B, K, K)
    # position in `order` IS the (score desc, index asc) priority
    pos = lax.broadcasted_iota(jnp.int32, (B, k), 1)
    higher = pos[:, :, None] < pos[:, None, :]
    kept_k = _jacobi_greedy(iou, cand_k.astype(jnp.float32), higher, iou_threshold)
    keep = jnp.zeros((B, N), kept_k.dtype).at[b_iota, sel].set(kept_k)
    return keep > 0


@jax.jit
def nms3d(
    corners: jnp.ndarray,
    scores: jnp.ndarray,
    objectness: jnp.ndarray,
    iou_threshold,
) -> jnp.ndarray:
    """Greedy oriented 3D NMS (exact, via parallel fixpoint iteration).

    Args:
      corners: (B, N, 8, 3) box corners (top face = corners 0-3).
      scores: (B, N) ranking scores (the model passes max semantic logit,
        model.py:133).
      objectness: (B, N, 2) objectness logits.
      iou_threshold: scalar.

    Returns:
      keep: (B, N) bool mask of surviving boxes.

    Pair IoUs are computed only over the boxes that can matter: boxes are
    ordered by (candidate first, score desc, index asc) and a lax.cond
    routes to the smallest compaction tier whose K covers the batch's max
    candidate count (`_COMPACT_TIERS`), falling back to the dense (B, N, N)
    matrix only when more than max(tiers) candidates pass the objectness
    gate. All paths produce the identical greedy keep mask (exactness
    tested); only the amount of IoU work differs. Ties: the reference's
    priority queue compares scores only (tf_nms3d.cpp:222-226), so its
    equal-score order is heap-unspecified; our deterministic
    lower-index-first rule is a *refinement* of that contract (one valid
    resolution of it), not strict parity.
    """
    B, N = scores.shape
    cand = objectness[..., 1] > objectness[..., 0]  # (B, N), strict

    tiers = [k for k in _COMPACT_TIERS if k < N]
    if not tiers:
        return _nms3d_dense(corners, scores, cand, iou_threshold)

    # candidates first, score desc, index asc (stable argsort of -key)
    key = jnp.where(cand, scores.astype(jnp.float32), -jnp.inf)
    order = jnp.argsort(-key, axis=1, stable=True).astype(jnp.int32)
    ncand_max = jnp.max(jnp.sum(cand.astype(jnp.int32), axis=1))

    def make_branch(k):
        return lambda: _nms3d_compact(corners, scores, cand, order, iou_threshold, k)

    def dense_branch():
        return _nms3d_dense(corners, scores, cand, iou_threshold)

    # nested conds: smallest fitting tier wins
    branch = dense_branch
    for k in reversed(tiers):
        branch = (
            lambda k=k, nxt=branch: lax.cond(
                ncand_max <= k, make_branch(k), nxt
            )
        )
    return branch()


def nms3d_indices(corners, scores, objectness, iou_threshold) -> np.ndarray:
    """Host-side wrapper returning (K, 2) int32 (batch, box) pairs.

    Mirrors the reference op's variable-length output format
    (tf_nms3d.cpp:266-283): pairs ordered by descending score globally across
    the batch, like the reference's single priority queue.
    """
    keep = np.asarray(nms3d(corners, scores, objectness, iou_threshold))
    scores = np.asarray(scores)
    b_idx, n_idx = np.nonzero(keep)
    sel_scores = scores[b_idx, n_idx]
    order = np.argsort(-sel_scores, kind="stable")
    return np.stack([b_idx[order], n_idx[order]], axis=1).astype(np.int32)
