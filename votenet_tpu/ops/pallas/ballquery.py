"""Exact ball query as one Pallas-Triton kernel for NVIDIA GPUs.

The shape of the reference CUDA kernel (tf_grouping_g.cu:13-35): each
query scans the dataset points in index order, takes the first ``nsample``
hits and stops. Here a program owns a tile of ``_TILE_Q`` queries of one
batch row and walks the points in chunks of ``_TILE_P``:

- the hit test is the oracle's, on unfused f32 squared distances
  (``fps.sqdist3``) against :func:`~votenet_tpu.ops.common.radius_sq_threshold`;
- an in-chunk prefix count gives every hit its rank among the query's hits,
  and hits ranked below ``nsample`` are stored straight into their slot;
- the scan stops once every query of the tile holds ``nsample`` hits.

Nothing (B, M, N)-shaped is ever written: the twin
(:func:`votenet_tpu.ops.grouping.query_ball_point_dense`) materialises
distances and hit masks of that shape. The reference's fill rule (slots past
the last hit repeat the first hit; an empty ball gives index 0) runs after
the kernel on the small (B, M, nsample) output, shared with the streaming
twin via :func:`~votenet_tpu.ops.grouping.finalize_first_k`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from votenet_tpu.ops.common import radius_sq_threshold
from votenet_tpu.ops.pallas.fps import sqdist3

_TILE_Q = 32   # queries per program
_TILE_P = 128  # points per chunk
_FAR = 1e9     # coordinate of padding points: outside every ball


def _bq_kernel(
    r2: float, nsample: int, m_valid: int, nchunks: int, interpret: bool,
    x_ref, y_ref, z_ref,     # (Np,) point planes of one batch row
    qx_ref, qy_ref, qz_ref,  # (_TILE_Q,) query planes of this tile
    idx_ref,                 # (Mp, nsample + 1) int32; the last column is a
                             # sink for lanes that store nothing
    cnt_ref,                 # (_TILE_Q,) int32
):
    tq, tp = _TILE_Q, _TILE_P
    q0 = pl.program_id(1) * tq
    rows = q0 + lax.broadcasted_iota(jnp.int32, (tq, tp), 0)
    lane = lax.broadcasted_iota(jnp.int32, (tq, tp), 1)
    # padded queries count as full, so they never hold up the early exit
    pad_q = q0 + lax.broadcasted_iota(jnp.int32, (tq,), 0) >= m_valid
    qx, qy, qz = qx_ref[...][:, None], qy_ref[...][:, None], qz_ref[...][:, None]

    def not_done(carry):
        c, cnt = carry
        return (c < nchunks) & (jnp.min(jnp.where(pad_q, nsample, cnt)) < nsample)

    def scan_chunk(carry):
        c, cnt = carry
        start = pl.multiple_of(c * tp, tp)
        sl = pl.ds(start, tp)
        d2 = sqdist3(
            qx - x_ref[sl][None, :], qy - y_ref[sl][None, :],
            qz - z_ref[sl][None, :], interpret,
        )
        hit = d2 < jnp.float32(r2)
        h = hit.astype(jnp.int32)
        rank = cnt[:, None] + jnp.cumsum(h, axis=1) - 1
        keep = hit & (rank < nsample)
        plgpu.store(
            idx_ref.at[rows, jnp.where(keep, rank, nsample)],
            start + lane,
            mask=keep,
        )
        return c + 1, cnt + jnp.sum(h, axis=1)

    _, cnt = lax.while_loop(
        not_done, scan_chunk, (jnp.int32(0), jnp.zeros((tq,), jnp.int32))
    )
    cnt_ref[...] = jnp.minimum(cnt, nsample)


@functools.partial(jax.jit, static_argnums=(0, 1, 4))
def query_ball_point_gpu(
    radius: float,
    nsample: int,
    xyz1: jnp.ndarray,
    xyz2: jnp.ndarray,
    interpret: bool = False,
):
    """Pallas-Triton ball query: (B,N,3) points, (B,M,3) queries ->
    idx (B,M,nsample) int32, cnt (B,M) int32; bit-identical to the numpy
    oracle and the XLA twins. ``interpret=True`` runs on the CPU (tests)."""
    from votenet_tpu.ops.grouping import finalize_first_k

    # index selection has no gradient (tf_grouping.py:21): cut tangents
    # before the pallas_call, which has no JVP rule
    xyz1 = lax.stop_gradient(xyz1.astype(jnp.float32))
    xyz2 = lax.stop_gradient(xyz2.astype(jnp.float32))
    B, N, _ = xyz1.shape
    M = xyz2.shape[1]
    nchunks = -(-N // _TILE_P)
    Np = nchunks * _TILE_P
    Mp = -(-M // _TILE_Q) * _TILE_Q
    planes = jnp.pad(
        jnp.transpose(xyz1, (2, 0, 1)), ((0, 0), (0, 0), (0, Np - N)),
        constant_values=_FAR,
    )
    qplanes = jnp.pad(jnp.transpose(xyz2, (2, 0, 1)), ((0, 0), (0, 0), (0, Mp - M)))
    pspec = pl.BlockSpec((None, Np), lambda b, i: (b, 0))
    qspec = pl.BlockSpec((None, _TILE_Q), lambda b, i: (b, i))
    idx, cnt = pl.pallas_call(
        functools.partial(
            _bq_kernel, radius_sq_threshold(radius), nsample, M, nchunks, interpret
        ),
        grid=(B, Mp // _TILE_Q),
        in_specs=[pspec] * 3 + [qspec] * 3,
        out_specs=(
            pl.BlockSpec((None, Mp, nsample + 1), lambda b, i: (b, 0, 0)),
            qspec,
        ),
        out_shape=(
            jax.ShapeDtypeStruct((B, Mp, nsample + 1), jnp.int32),
            jax.ShapeDtypeStruct((B, Mp), jnp.int32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="ball_query",
    )(planes[0], planes[1], planes[2], qplanes[0], qplanes[1], qplanes[2])
    idx, cnt = finalize_first_k(idx[:, :M, :nsample], cnt[:, :M], nsample)
    return lax.stop_gradient(idx), lax.stop_gradient(cnt)
