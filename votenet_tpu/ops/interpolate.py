"""Three-nearest-neighbor inverse-distance interpolation.

Rebuild of the reference CPU package ``tf_ops/3d_interpolation``
(`tf_interpolate.py`, `tf_interpolate.cpp`). In the reference these ops are
registered CPU-only, forcing a GPU->CPU->GPU round trip per FP module
(SURVEY §3.1); here they stay on device — the largest single speed lever.

Semantics matched:

- ``three_nn`` returns **squared** distances of the 3 nearest neighbors in
  ascending order with first-index tie-breaking (tf_interpolate.cpp:60-103)
  and is non-differentiable (tf_interpolate.py:18) — outputs are
  stop-gradiented so no gradient leaks through the distance matrix (the new
  framework would otherwise differentiate through it, unlike the reference).
- ``three_interpolate`` computes a weighted sum of 3 source rows; its VJP
  w.r.t. ``points`` is the scatter of grad*weight (tf_interpolate.cpp:131-153),
  which JAX derives automatically from take_along_axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from votenet_tpu.ops import common
from votenet_tpu.ops.common import pairwise_sqdist

def three_nn(xyz1: jnp.ndarray, xyz2: jnp.ndarray):
    """3 nearest neighbors of each xyz1 point among xyz2 points.

    xyz1: (B, N, 3) query points; xyz2: (B, M, 3) source points.
    Returns (dist2, idx) each (B, N, 3): squared distances ascending, int32
    indices into M. Both stop-gradiented (see module docstring).

    Dispatches to :func:`three_nn_streaming` when the dense (B, N, M)
    distance matrix exceeds :func:`~votenet_tpu.ops.common.dense_bytes_budget`
    (the only O(N) intermediate here; identical results —
    query rows are independent).
    """
    B, N = xyz1.shape[0], xyz1.shape[1]
    M = xyz2.shape[1]
    if common.three_nn_dense_bytes(B, N, M) > common.dense_bytes_budget():
        return three_nn_streaming(xyz1, xyz2)
    return three_nn_dense(xyz1, xyz2)


@jax.jit
def three_nn_dense(xyz1: jnp.ndarray, xyz2: jnp.ndarray):
    """Dense three_nn over the full (B, N, M) distance matrix.

    Three masked argmin passes instead of ``lax.top_k``, which sorts.
    argmin's lowest-index tie rule reproduces the reference scan's strict-<
    update (tf_interpolate.cpp:73-90): equal-distance neighbors come out in
    index order.
    """
    d2 = pairwise_sqdist(xyz1, xyz2)  # (B, N, M)
    iota = lax.broadcasted_iota(jnp.int32, d2.shape, dimension=2)
    d = d2
    dists, idxs = [], []
    for _ in range(3):
        i = jnp.argmin(d, axis=-1).astype(jnp.int32)  # (B, N)
        dists.append(jnp.min(d, axis=-1))
        d = jnp.where(iota == i[..., None], jnp.float32(jnp.inf), d)
        idxs.append(i)
    dist2 = jnp.stack(dists, axis=-1)
    idx = jnp.stack(idxs, axis=-1)
    return lax.stop_gradient(dist2), lax.stop_gradient(idx)


@functools.partial(jax.jit, static_argnums=(2,))
def three_nn_streaming(xyz1: jnp.ndarray, xyz2: jnp.ndarray, block: int = 8192):
    """three_nn for query counts too large for the (B, N, M) matrix.

    Scans ``block``-sized query slabs under a ``lax.scan`` — peak memory
    O(B·block·M) — and concatenates. Each query row is independent, so the
    result is exactly equal to the dense twin (tested). ``block`` is static.
    """
    B, N, _ = xyz1.shape
    nb = -(-N // block)
    xp = xyz1
    if nb * block != N:
        xp = jnp.pad(xyz1, ((0, 0), (0, nb * block - N), (0, 0)))
    slabs = xp.reshape(B, nb, block, 3).transpose(1, 0, 2, 3)  # (nb,B,blk,3)

    def body(_, blk):
        return None, three_nn_dense(blk, xyz2)

    _, (d2, idx) = lax.scan(body, None, slabs)  # (nb, B, blk, 3) each
    d2 = d2.transpose(1, 0, 2, 3).reshape(B, nb * block, 3)[:, :N]
    idx = idx.transpose(1, 0, 2, 3).reshape(B, nb * block, 3)[:, :N]
    return d2, idx


def three_interpolate(points: jnp.ndarray, idx: jnp.ndarray, weight: jnp.ndarray) -> jnp.ndarray:
    """Weighted 3-neighbor interpolation.

    points: (B, M, C) source features; idx: (B, N, 3) neighbor indices;
    weight: (B, N, 3) interpolation weights.
    Returns (B, N, C): ``out[b,n] = sum_j weight[b,n,j] * points[b,idx[b,n,j]]``
    (reference tf_interpolate.cpp:107-127).
    """
    B, N, _ = idx.shape
    Msrc, C = points.shape[1], points.shape[-1]
    table = points.reshape(B * Msrc, C)
    off = (jnp.arange(B, dtype=jnp.int32) * Msrc)[:, None, None]
    flat = (idx.astype(jnp.int32) + off).reshape(-1)
    gathered = jnp.take(table, flat, axis=0).reshape(B, N, 3, C)
    return jnp.sum(gathered * weight[..., None], axis=2)
