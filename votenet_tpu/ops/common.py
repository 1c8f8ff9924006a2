"""Shared helpers for the point-cloud ops."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Budget of the dense XLA ball-query / three_nn paths where the backend
# reports no memory limit (the CPU). Their (B, M, N)-shaped intermediates
# are the O(N) memory; above the budget the ops stream in blocks.
_HOST_DENSE_BYTES = 4 * 1024**3


def dense_bytes_budget() -> int:
    """Bytes the dense paths' (B, M, N) intermediates may take.

    A quarter of what the default device lets this process allocate
    (``memory_stats()["bytes_limit"]``), leaving the rest to the model and
    its activations; the dispatch is byte-based, so a small batch keeps the
    dense path at point counts where a full batch must stream.
    """
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) // 4 if limit else _HOST_DENSE_BYTES


def bq_dense_bytes(B: int, M: int, N: int) -> int:
    """Peak bytes of the dense ball query's (B, M, N) intermediates:
    f32 distances (4) + bf16 hit mask (2), conservatively co-resident."""
    return B * M * N * 6


def three_nn_dense_bytes(B: int, N: int, M: int) -> int:
    """Peak bytes of dense three_nn's (B, N, M) f32 distance matrix
    (the masked argmin passes mutate it in place under XLA fusion)."""
    return B * N * M * 4


@functools.lru_cache(maxsize=None)
def radius_sq_threshold(radius: float) -> float:
    """The f32 bound ``t`` with ``d2 < t`` exactly when the reference's
    test ``max(sqrt(d2), 1e-20) < radius`` holds (tf_grouping_g.cu:22-24).

    ``sqrt`` is monotone and correctly rounded, so the hit set is
    ``d2 < t`` for ``t`` the smallest f32 whose square root is not below
    ``radius``. ``t`` sits within an ulp of ``radius**2`` but can differ
    from it (for r = 0.2 the float just below r*r already rounds to r), so
    comparing against ``radius**2`` would flip boundary hits.
    """
    r = np.float32(radius)
    t = np.float32(r * r)
    while np.sqrt(t) >= r and t > 0:
        t = np.nextafter(t, np.float32(0))
    while np.sqrt(t) < r:
        t = np.nextafter(t, np.float32(np.inf))
    return float(t)


def pairwise_sqdist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Exact squared euclidean distances between two point sets.

    a: (..., M, 3), b: (..., N, 3) -> (..., M, N).

    Computed as an explicit difference-square-sum (XLA fuses this into a
    single loop, nothing 4-D is written) rather than the matmul expansion
    ``|a|^2+|b|^2-2ab``: the direct form is the oracle's own rounding
    sequence. Used by the oracle / parity paths (query_ball_point_topk,
    knn_point, three_nn) and by the "exact" ball query; see the
    RADIUS-BOUNDARY PRECISION note in :mod:`votenet_tpu.ops.grouping`.
    """
    diff = a[..., :, None, :] - b[..., None, :, :]
    return jnp.sum(diff * diff, axis=-1)


def pairwise_sqdist_mm(a: jnp.ndarray, b: jnp.ndarray, precision=None) -> jnp.ndarray:
    """Squared distances via the matmul expansion ``|a|^2+|b|^2-2ab``.

    ``precision`` is forwarded to the cross-term einsum. At the default
    precision a GPU runs the f32 product in TF32 (about three decimal
    digits), and even ``lax.Precision.HIGHEST`` reassociates the sum, so
    this form is never safe for strict index decisions; the ball query uses
    it only in its opt-in "fast_bf16" mode.
    """
    a2 = jnp.sum(a * a, axis=-1)
    b2 = jnp.sum(b * b, axis=-1)
    ab = jnp.einsum("...md,...nd->...mn", a, b, precision=precision)
    return a2[..., :, None] + b2[..., None, :] - 2.0 * ab
