"""Farthest-point sampling, point gather, and probability sampling.

Rebuild of the reference CUDA package ``tf_ops/sampling``
(`tf_sampling.py`, `tf_sampling_g.cu`). Semantics matched exactly:

- ``farthest_point_sample``: iterative FPS seeded at index 0, maintaining a
  per-point running min squared distance to the selected set and picking the
  argmax each step (tf_sampling_g.cu:105-170). No gradient
  (tf_sampling.py:22) — outputs are integer indices.
- ``gather_point``: index gather with scatter-add gradient
  (tf_sampling_g.cu:172-192); here the gather's VJP provides the
  scatter-add automatically.
- ``prob_sample``: inverse-CDF sampling (cumsum + binary search,
  tf_sampling_g.cu:7-104). Unused by the model; kept for API completeness.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


def farthest_point_sample(npoint: int, xyz: jnp.ndarray) -> jnp.ndarray:
    """Iterative farthest point sampling (backend-dispatched).

    On a GPU this is the Pallas-Triton kernel
    (:mod:`votenet_tpu.ops.pallas.fps`), which runs the whole selection loop
    in one launch; elsewhere, or when the kernels are switched off via
    :func:`votenet_tpu.ops.dispatch.set_use_pallas`, the XLA fori_loop twin
    below. Identical semantics either way.

    Args:
      npoint: number of points to select (static).
      xyz: (B, N, 3) float32 point coordinates. (Argument order npoint-first
        matches the reference wrapper tf_sampling.py:48.)

    Returns:
      (B, npoint) int32 indices into N. First index is always 0 (the
      reference seeds FPS at index 0, tf_sampling_g.cu:114-116).
    """
    from votenet_tpu.ops.dispatch import use_gpu_kernels

    if use_gpu_kernels():
        from votenet_tpu.ops.pallas.fps import farthest_point_sample_gpu

        return farthest_point_sample_gpu(npoint, xyz)
    return farthest_point_sample_xla(npoint, xyz)


@functools.partial(jax.jit, static_argnums=0)
def farthest_point_sample_xla(npoint: int, xyz: jnp.ndarray) -> jnp.ndarray:
    """XLA fori_loop FPS (reference semantics tf_sampling_g.cu:105-170)."""
    xyz = xyz.astype(jnp.float32)
    B, N, _ = xyz.shape

    def body(i, carry):
        mindist, idxs, last = carry
        # distance of every point to the most recently selected point
        ref = jnp.take_along_axis(xyz, last[:, None, None], axis=1)  # (B,1,3)
        d = jnp.sum((xyz - ref) ** 2, axis=-1)  # (B, N)
        mindist = jnp.minimum(mindist, d)
        # argmax picks the lowest index among ties, like the reference's
        # strictly-greater scan (tf_sampling_g.cu:146-149)
        nxt = jnp.argmax(mindist, axis=-1).astype(jnp.int32)  # (B,)
        idxs = idxs.at[:, i].set(nxt)
        return mindist, idxs, nxt

    mindist0 = jnp.full((B, N), 1e38, dtype=jnp.float32)
    idxs0 = jnp.zeros((B, npoint), dtype=jnp.int32)  # slot 0 stays 0 (seed)
    last0 = jnp.zeros((B,), dtype=jnp.int32)
    if npoint > 1:
        _, idxs, _ = lax.fori_loop(1, npoint, body, (mindist0, idxs0, last0))
    else:
        idxs = idxs0
    return lax.stop_gradient(idxs)


def gather_point(inp: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather points by index: (B, N, C), (B, M) -> (B, M, C).

    Flat row-gather from a (B*N, C) table (see group_point).
    Differentiable w.r.t. ``inp``: the VJP is XLA's scatter-add, like the
    reference's atomicAdd kernel (tf_sampling_g.cu:183-192).
    """
    B, N, C = inp.shape
    M = idx.shape[1]
    table = inp.reshape(B * N, C)
    off = (jnp.arange(B, dtype=jnp.int32) * N)[:, None]
    flat = (idx.astype(jnp.int32) + off).reshape(-1)
    return jnp.take(table, flat, axis=0).reshape(B, M, C)


def prob_sample(inp_p: jnp.ndarray, inp_r: jnp.ndarray) -> jnp.ndarray:
    """Inverse-CDF categorical sampling (reference tf_sampling.py:50-57).

    Args:
      inp_p: (B, N) unnormalized probabilities (the reference cumsums these
        on device, tf_sampling_g.cu:7-88).
      inp_r: (B, M) uniform samples in [0, sum(p)).

    Returns:
      (B, M) int32 sampled indices.
    """
    cdf = jnp.cumsum(inp_p, axis=-1)  # (B, N)
    # first index whose cdf value exceeds r — binary-search semantics of
    # tf_sampling_g.cu:90-104
    idx = jax.vmap(lambda c, r: jnp.searchsorted(c, r, side="right"))(cdf, inp_r)
    N = inp_p.shape[-1]
    return jnp.clip(idx, 0, N - 1).astype(jnp.int32)
